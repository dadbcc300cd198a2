"""Readers AND writers for the reference's cereal binary golden archives.

The port's own copy of ``parfastaai_tpu/etl/goldens.py`` (struct + numpy),
so that ``tools.rebuild_master_db`` runs without the JAX package.

The reference serializes its test goldens with cereal's PortableBinary-style
layout (little-endian, no padding):

* ``std::vector<T>``  -> uint64 element count, then packed elements
  (tests/pfaai_tests.cpp golden load paths).
* ``DPair<int,int>``  -> two int32 (reference utils.hpp:222-224).
* ``ETriple<int>``    -> three int32: proteinIndex, genomeA, genomeB
  (reference interface.hpp:118-120).
* ``JACTuple``        -> int32 genomeA, int32 genomeB, float64 S, int32 N
  (reference interface.hpp:72-74) — 20 bytes packed.
* ``DMatrix<T>``      -> uint64 nrows, uint64 ncols, then the data vector
  (reference utils.hpp:285-287).

The readers exist for parity testing against the bundled goldens; the
writers pin NEW fixtures (synthetic databases, rebuilt-master artifacts) in
the reference's own serialization so they can be cross-checked against the
rebuilt reference binary (interface.hpp:72-74, utils.hpp:285-287 are the
cereal hooks the reference would load them with).  Each writer is the exact
byte inverse of its reader (tests/test_goldens_roundtrip.py proves
read->write reproduces every bundled archive byte-for-byte for the
original; tests/test_torch_tools.py holds this copy's bytes against it).  Nothing in
the production path depends on this module.
"""

from __future__ import annotations

import struct

import numpy as np

_U64 = struct.Struct("<Q")


def _read_count(buf: bytes, off: int = 0) -> tuple[int, int]:
    (count,) = _U64.unpack_from(buf, off)
    return count, off + 8


def read_i32_vector(path: str) -> np.ndarray:
    buf = open(path, "rb").read()
    count, off = _read_count(buf)
    return np.frombuffer(buf, dtype="<i4", count=count, offset=off)


def read_f64_vector(path: str) -> np.ndarray:
    buf = open(path, "rb").read()
    count, off = _read_count(buf)
    return np.frombuffer(buf, dtype="<f8", count=count, offset=off)


def read_pair_vector(path: str) -> np.ndarray:
    """F-array of DPair(proteinIndex, genomeId) -> int32 array (n, 2)."""
    buf = open(path, "rb").read()
    count, off = _read_count(buf)
    flat = np.frombuffer(buf, dtype="<i4", count=2 * count, offset=off)
    return flat.reshape(count, 2)


def read_triple_vector(path: str) -> np.ndarray:
    """E-array of ETriple(proteinIndex, genomeA, genomeB) -> int32 (n, 3)."""
    buf = open(path, "rb").read()
    count, off = _read_count(buf)
    flat = np.frombuffer(buf, dtype="<i4", count=3 * count, offset=off)
    return flat.reshape(count, 3)


_JAC_DTYPE = np.dtype(
    [("genome_a", "<i4"), ("genome_b", "<i4"), ("s", "<f8"), ("n", "<i4")]
)


def read_jac_vector(path: str) -> np.ndarray:
    """JAC tuples -> structured array with fields genome_a, genome_b, s, n."""
    buf = open(path, "rb").read()
    count, off = _read_count(buf)
    return np.frombuffer(buf, dtype=_JAC_DTYPE, count=count, offset=off)


def read_dmatrix_i32(path: str) -> np.ndarray:
    buf = open(path, "rb").read()
    nrows, off = _read_count(buf)
    ncols, off = _read_count(buf, off)
    count, off = _read_count(buf, off)
    assert count == nrows * ncols, (count, nrows, ncols)
    return np.frombuffer(buf, dtype="<i4", count=count, offset=off).reshape(
        nrows, ncols
    )


# --- writers (exact byte inverses of the readers above) ---


def write_i32_vector(path: str, values: np.ndarray) -> None:
    values = np.ascontiguousarray(values, dtype="<i4").reshape(-1)
    with open(path, "wb") as fp:
        fp.write(_U64.pack(len(values)))
        fp.write(values.tobytes())


def write_f64_vector(path: str, values: np.ndarray) -> None:
    values = np.ascontiguousarray(values, dtype="<f8").reshape(-1)
    with open(path, "wb") as fp:
        fp.write(_U64.pack(len(values)))
        fp.write(values.tobytes())


def write_pair_vector(path: str, pairs: np.ndarray) -> None:
    """F-array of DPair(proteinIndex, genomeId) from an int32 (n, 2) array."""
    pairs = np.ascontiguousarray(pairs, dtype="<i4")
    assert pairs.ndim == 2 and pairs.shape[1] == 2, pairs.shape
    with open(path, "wb") as fp:
        fp.write(_U64.pack(len(pairs)))
        fp.write(pairs.tobytes())


def write_triple_vector(path: str, triples: np.ndarray) -> None:
    """E-array of ETriple(proteinIndex, genomeA, genomeB) from int32 (n, 3)."""
    triples = np.ascontiguousarray(triples, dtype="<i4")
    assert triples.ndim == 2 and triples.shape[1] == 3, triples.shape
    with open(path, "wb") as fp:
        fp.write(_U64.pack(len(triples)))
        fp.write(triples.tobytes())


def write_jac_vector(
    path: str,
    genome_a: np.ndarray,
    genome_b: np.ndarray,
    s: np.ndarray,
    n: np.ndarray,
) -> None:
    """JAC tuples in the reference's packed 20-byte layout; accepts either
    a structured array (pass as genome_a with the other args None-free via
    field access at the call site) or four parallel vectors."""
    rec = np.empty(len(genome_a), dtype=_JAC_DTYPE)
    rec["genome_a"] = genome_a
    rec["genome_b"] = genome_b
    rec["s"] = s
    rec["n"] = n
    with open(path, "wb") as fp:
        fp.write(_U64.pack(len(rec)))
        fp.write(rec.tobytes())


def write_dmatrix_i32(path: str, mat: np.ndarray) -> None:
    mat = np.ascontiguousarray(mat, dtype="<i4")
    assert mat.ndim == 2, mat.shape
    with open(path, "wb") as fp:
        fp.write(_U64.pack(mat.shape[0]))
        fp.write(_U64.pack(mat.shape[1]))
        fp.write(_U64.pack(mat.size))
        fp.write(mat.tobytes())
