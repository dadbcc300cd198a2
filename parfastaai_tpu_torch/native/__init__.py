"""Loader for the native host runtime (pfaai_native.cpp) via ctypes.

The shared library is built on demand with g++ (-O3 -fopenmp) from the two
sources beside this file into ``parfastaai_tpu_torch/_build/``, keyed by a
hash of the sources (set PARFASTAAI_NO_NATIVE=1 to force the pure-NumPy
fallbacks).  Every native entry point has a NumPy twin in the callers, so a
missing compiler only costs speed, never correctness.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRCS = [
    os.path.join(os.path.dirname(__file__), "pfaai_native.cpp"),
    os.path.join(os.path.dirname(__file__), "pfaai_sqlite.cpp"),
]
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
_LIB = None
_TRIED = False
built_now = False  # True once this process compiled the library itself


def _build_and_load() -> ctypes.CDLL | None:
    global built_now
    if os.environ.get("PARFASTAAI_NO_NATIVE"):
        return None
    try:
        h = hashlib.sha256()
        for src in _SRCS:
            with open(src, "rb") as fp:
                h.update(fp.read())
        tag = h.hexdigest()[:16]
    except OSError:
        return None
    cache = BUILD_DIR
    so_path = os.path.join(cache, f"pfaai_native_{tag}.so")
    if not os.path.exists(so_path):
        try:
            os.makedirs(cache, exist_ok=True)
            tmp = so_path + f".tmp{os.getpid()}"
            subprocess.run(
                [
                    "g++", "-O3", "-march=native", "-fopenmp", "-shared",
                    "-fPIC", "-std=c++17", *_SRCS, "-o", tmp, "-ldl",
                ],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so_path)
            built_now = True
        except (OSError, subprocess.CalledProcessError):
            return None
    try:
        lib = ctypes.CDLL(so_path)
    except OSError:
        return None
    lib.jaccard_finish_f64.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.jaccard_finish_block_f64.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.unpack_presence.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.format_f64_row.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_char,
        ctypes.POINTER(ctypes.c_char),
    ]
    lib.format_f64_row.restype = ctypes.c_int64
    lib.format_f64_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char,
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.sqlite_available.restype = ctypes.c_int32
    lib.etl_widths.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_int64,
    ]
    lib.etl_widths.restype = ctypes.c_int32
    lib.etl_ids.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_int64,
    ]
    lib.etl_ids.restype = ctypes.c_int32
    lib.etl_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_int64,
    ]
    lib.etl_load.restype = ctypes.c_int32
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The native library, building it on first call; None if unavailable."""
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _build_and_load()
        _TRIED = True
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def native_jaccard_finish(
    counts: np.ndarray, ta: np.ndarray, tb: np.ndarray
) -> tuple[np.ndarray, np.ndarray] | None:
    """Native (S, N) finish; None when the library is unavailable.

    Bit-for-bit identical to the NumPy path: both accumulate f64 in ascending
    protein order per pair.  Accepts int16 or int32 counts directly — no
    (P, n) widening copy."""
    lib = get_lib()
    if lib is None:
        return None
    P, n = counts.shape
    if counts.dtype not in (np.int16, np.int32):
        counts = counts.astype(np.int32)
    counts = np.ascontiguousarray(counts)
    ta = np.ascontiguousarray(ta, dtype=np.int32)
    tb = np.ascontiguousarray(tb, dtype=np.int32)
    s = np.empty(n, dtype=np.float64)
    nsh = np.empty(n, dtype=np.int32)
    lib.jaccard_finish_f64(
        counts.ctypes.data_as(ctypes.c_void_p),
        counts.dtype.itemsize,
        _ptr(ta, ctypes.c_int32),
        _ptr(tb, ctypes.c_int32),
        P,
        n,
        _ptr(s, ctypes.c_double),
        _ptr(nsh, ctypes.c_int32),
    )
    return s, nsh


def native_jaccard_finish_block(
    counts: np.ndarray, ta: np.ndarray, tb: np.ndarray
) -> tuple[np.ndarray, np.ndarray] | None:
    """Banded-block (S, N) finish: counts (P, A, B) int16/int32 with the
    denominator T columns factored per axis (ta (P, A), tb (P, B)); None when
    the library is unavailable.  Bit-for-bit identical to the per-pair finish
    (same ascending-protein f64 accumulation)."""
    lib = get_lib()
    if lib is None:
        return None
    P, A, B = counts.shape
    if counts.dtype not in (np.int16, np.int32):
        counts = counts.astype(np.int32)
    counts = np.ascontiguousarray(counts)
    ta = np.ascontiguousarray(ta, dtype=np.int32)
    tb = np.ascontiguousarray(tb, dtype=np.int32)
    s = np.empty((A, B), dtype=np.float64)
    nsh = np.empty((A, B), dtype=np.int32)
    lib.jaccard_finish_block_f64(
        counts.ctypes.data_as(ctypes.c_void_p),
        counts.dtype.itemsize,
        _ptr(ta, ctypes.c_int32),
        _ptr(tb, ctypes.c_int32),
        P,
        A,
        B,
        _ptr(s, ctypes.c_double),
        _ptr(nsh, ctypes.c_int32),
    )
    return s, nsh


_FORMAT_VALIDATED: bool | None = None


def _validate_formatter(lib) -> bool:
    """One-time self-test: the native formatter must be byte-identical to
    io/fmtfloat.format_double over a value corpus covering every notation
    branch (the CSV parity guarantee rides on it)."""
    from ..io.fmtfloat import format_double

    rng = np.random.default_rng(0)
    corpus = np.concatenate(
        [
            rng.random(200),
            rng.random(50) * 1e-5,
            rng.random(50) * 1e-17,
            rng.random(50) * 1e17,
            -rng.random(50),
            np.array(
                [0.0, -0.0, 1.0, 0.5, 1e-4, 9.999e-5, 1e16, 1e15 + 0.5,
                 np.nan, np.inf, -np.inf, 5e-324, 1.7976931348623157e308]
            ),
        ]
    )
    want = ",".join(format_double(v) for v in corpus).encode()
    buf = ctypes.create_string_buffer(len(corpus) * 32)
    n = lib.format_f64_row(
        _ptr(np.ascontiguousarray(corpus), ctypes.c_double),
        len(corpus),
        b",",
        buf,
    )
    return buf.raw[:n] == want


def native_format_row(vals: np.ndarray, sep: str) -> bytes | None:
    """One CSV row of shortest-round-trip doubles; None when the native lib
    is unavailable or failed its byte-compat self-test."""
    global _FORMAT_VALIDATED
    lib = get_lib()
    if lib is None:
        return None
    if _FORMAT_VALIDATED is None:
        _FORMAT_VALIDATED = _validate_formatter(lib)
    if not _FORMAT_VALIDATED:
        return None
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    buf = ctypes.create_string_buffer(max(1, len(vals)) * 32)
    n = lib.format_f64_row(
        _ptr(vals, ctypes.c_double), len(vals), sep.encode(), buf
    )
    return buf.raw[:n]


def native_format_matrix(mat: np.ndarray, sep: str) -> list[bytes] | None:
    """All CSV rows of a (rows, cols) f64 matrix, formatted in parallel
    (OpenMP over rows — format_f64_matrix); None when the native lib is
    unavailable or failed its byte-compat self-test."""
    global _FORMAT_VALIDATED
    lib = get_lib()
    if lib is None:
        return None
    if _FORMAT_VALIDATED is None:
        _FORMAT_VALIDATED = _validate_formatter(lib)
    if not _FORMAT_VALIDATED:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.float64)
    rows, cols = mat.shape
    stride = max(1, cols) * 26
    # Chunked: one small reused buffer instead of a rows*stride allocation
    # (a 4096x4096 matrix would need a 436 MB scratch whose page faults cost
    # more than the formatting itself).
    chunk = max(1, min(rows, (8 << 20) // stride + 1))
    buf = np.empty(chunk * stride, dtype=np.uint8)
    lens = np.empty(chunk, dtype=np.int64)
    out: list[bytes] = []
    for r0 in range(0, rows, chunk):
        sub = mat[r0 : r0 + chunk]
        lib.format_f64_matrix(
            _ptr(sub, ctypes.c_double),
            len(sub),
            cols,
            sep.encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
            stride,
            _ptr(lens, ctypes.c_int64),
        )
        out.extend(
            buf[r * stride : r * stride + lens[r]].tobytes()
            for r in range(len(sub))
        )
    return out


def _sqlite_lib() -> ctypes.CDLL | None:
    lib = get_lib()
    return lib if lib is not None and lib.sqlite_available() else None


def _protein_names(protein_set: tuple[str, ...]):
    return (ctypes.c_char_p * len(protein_set))(
        *[p.encode() for p in protein_set])


def native_widths(
    db_path: str, protein_set: tuple[str, ...], n_threads: int | None = None
) -> np.ndarray | None:
    """Per-protein row counts of the '{SCP}_tetras' tables (int32 (P,), the
    compacted presence widths; pfaai_sqlite.cpp ``etl_widths``).  None when
    the native library or libsqlite3 is unavailable, or on any read error
    (the caller falls back to the stdlib-sqlite3 ETL)."""
    lib = _sqlite_lib()
    if lib is None:
        return None
    widths = np.zeros(len(protein_set), dtype=np.int32)
    err = ctypes.create_string_buffer(512)
    failed = lib.etl_widths(
        db_path.encode(), _protein_names(protein_set), len(protein_set),
        _ptr(widths, ctypes.c_int32), int(n_threads or 0), err, len(err),
    )
    return None if failed else widths


def native_tetramer_ids(
    db_path: str,
    protein_set: tuple[str, ...],
    widths: np.ndarray,
    n_threads: int | None = None,
) -> np.ndarray | None:
    """The '{SCP}_tetras' tables' tetramer ids, ascending, without their
    blobs: int32 (P, max(1, max(widths))), row p's first ``widths[p]``
    entries (pfaai_sqlite.cpp ``etl_ids``).  A row count other than
    ``widths[p]`` fails; None on any failure, as ``native_widths``."""
    lib = _sqlite_lib()
    if lib is None:
        return None
    widths = np.ascontiguousarray(widths, dtype=np.int32)
    P = len(protein_set)
    tets = np.zeros((P, max(1, int(widths.max()) if P else 1)), np.int32)
    err = ctypes.create_string_buffer(512)
    failed = lib.etl_ids(
        db_path.encode(), _protein_names(protein_set), P, tets.shape[1],
        _ptr(widths, ctypes.c_int32), _ptr(tets, ctypes.c_int32),
        int(n_threads or 0), err, len(err),
    )
    return None if failed else tets


def native_fill(
    db_path: str,
    protein_set: tuple[str, ...],
    n_genomes: int,
    widths: np.ndarray,
    m: np.ndarray,
    t: np.ndarray,
    tets: np.ndarray,
    n_threads: int | None = None,
    col_map: np.ndarray | None = None,
    row0: int = 0,
) -> bool:
    """Fused native ETL of one database (pfaai_sqlite.cpp ``etl_load``: read
    + scatter + T in one C++ pass, OpenMP over proteins) into the zeroed
    presence ``m`` (P, G_out, K_out) uint8 and T ``t`` (P, G_out) int32, its
    genome g on row ``row0 + g`` — the framework's native data loader, the
    counterpart of the reference's C++ row streaming (scp_db.hpp:121-262).

    Without ``col_map``, '_tetras' row j of protein p is column j and its
    tetramer id is written to ``tets[p, j]``.  With ``col_map`` (int32, the
    shape of ``tets``), row j goes to column ``col_map[p, j]``, and ``tets``
    holds the ids the map was built from (``native_tetramer_ids``): a row
    whose id differs fails.  Genome ids are checked against ``n_genomes``,
    row counts against ``widths``.

    False when the native library or libsqlite3 is unavailable, or on any
    read error — the caller falls back to the stdlib-sqlite3 ETL, which
    reproduces the identical tensors (same queries, same C library) and
    raises the proper PFAAIError for genuinely corrupt databases."""
    lib = _sqlite_lib()
    if lib is None:
        return False
    P = len(protein_set)
    G_out, K_out = m.shape[1], m.shape[2]
    widths = np.ascontiguousarray(widths, dtype=np.int32)
    # The C loop writes at row0 + g (g < n_genomes) and at column j <
    # widths[p] or col_map[p, j] unguarded: hold them inside the buffers.
    if not (
        m.dtype == np.uint8 and m.flags.c_contiguous and m.shape[0] == P
        and t.dtype == np.int32 and t.flags.c_contiguous
        and t.shape == (P, G_out) and tets.dtype == np.int32
        and tets.flags.c_contiguous and tets.shape[0] == P
        and widths.shape == (P,) and 0 <= row0
        and row0 + n_genomes <= G_out
        and (P == 0 or int(widths.max()) <= tets.shape[1])
    ):
        raise ValueError("native_fill: buffers do not hold the database")
    if col_map is None:
        if P and int(widths.max()) > K_out:
            raise ValueError("native_fill: widths exceed the presence's K")
    else:
        col_map = np.ascontiguousarray(col_map, dtype=np.int32)
        if col_map.shape != tets.shape or (
            col_map.size
            and not 0 <= int(col_map.min()) <= int(col_map.max()) < K_out
        ):
            raise ValueError("native_fill: column map outside the presence")
    err = ctypes.create_string_buffer(512)
    failed = lib.etl_load(
        db_path.encode(), _protein_names(protein_set), P, int(n_genomes),
        tets.shape[1], _ptr(widths, ctypes.c_int32), _ptr(m, ctypes.c_uint8),
        _ptr(tets, ctypes.c_int32), _ptr(t, ctypes.c_int32),
        int(n_threads or 0),
        None if col_map is None else _ptr(col_map, ctypes.c_int32),
        int(row0), G_out, K_out, err, len(err),
    )
    return not failed


def native_unpack_presence(
    gids: np.ndarray,
    col_offsets: np.ndarray,
    m_out: np.ndarray,
    col_map: np.ndarray | None = None,
    row0: int = 0,
) -> bool:
    """Scatter one protein's genome-id blobs into m_out (G, K) uint8: a 1 at
    row ``row0 + g`` of column ``col_map[j]`` (or j) for each id g of blob j.
    The caller has checked the ids and the map against m_out.

    Returns False when the native library is unavailable (caller falls back).
    """
    lib = get_lib()
    if lib is None:
        return False
    gids = np.ascontiguousarray(gids, dtype=np.int32)
    col_offsets = np.ascontiguousarray(col_offsets, dtype=np.int64)
    assert m_out.dtype == np.uint8 and m_out.flags.c_contiguous
    if col_map is not None:
        col_map = np.ascontiguousarray(col_map, dtype=np.int32)
    lib.unpack_presence(
        _ptr(gids, ctypes.c_int32),
        _ptr(col_offsets, ctypes.c_int64),
        len(col_offsets) - 1,
        _ptr(m_out, ctypes.c_uint8),
        m_out.shape[1],
        None if col_map is None else _ptr(col_map, ctypes.c_int32),
        int(row0),
    )
    return True
