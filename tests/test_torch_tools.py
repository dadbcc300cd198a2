"""The port's host tooling against the JAX package's originals, on
synthetic databases (no bundled data): the cereal archive readers and
writers (``etl.goldens``), the subset tool (``tools.subset_db``), the
master rebuild from F / Lc archives (``tools.rebuild_master_db``) and the
public count ops (``ops.intersection_counts`` / ``ops.pair_counts``).
Bytes equal, tables equal row for row, integers equal."""

import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from parfastaai_tpu import ops as jax_ops
from parfastaai_tpu.etl import goldens as jax_goldens
from parfastaai_tpu.tools import rebuild_master_db as jax_rebuild
from parfastaai_tpu.tools import subset_db as jax_subset
from parfastaai_tpu_torch import ops
from parfastaai_tpu_torch.etl import goldens
from parfastaai_tpu_torch.etl.database import SCPDatabase
from parfastaai_tpu_torch.etl.derive import derive_single
from parfastaai_tpu_torch.tools import rebuild_master_db, subset_db
from parfastaai_tpu_torch.tools.synth_db import generate
from parfastaai_tpu_torch.types import PFAAIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def master(tmp_path_factory):
    """A 24-genome synthetic master (6 proteins, pool 200, ~60 tetramers
    per genome)."""
    path = str(tmp_path_factory.mktemp("tools") / "master.db")
    generate(path, n_genomes=24, n_proteins=6, pool_size=200,
             tetras_per_genome=60, seed=11)
    return path


def _dump(path):
    with sqlite3.connect(path) as conn:
        return list(conn.iterdump())


def _presence(path):
    db = SCPDatabase(path)
    try:
        return db.load_presence()
    finally:
        db.close()


# --- goldens -------------------------------------------------------------

def _golden_arrays(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    return {
        "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "f64": rng.standard_normal(n),
        "pair": rng.integers(0, 1000, (n, 2)).astype(np.int32),
        "triple": rng.integers(0, 1000, (n, 3)).astype(np.int32),
        "jac": (rng.integers(0, 50, n), rng.integers(0, 50, n),
                rng.random(n), rng.integers(0, 80, n)),
        "dmatrix": rng.integers(-99, 99, (int(rng.integers(0, 6)),
                                          int(rng.integers(0, 7)))),
    }


WRITERS = {
    "i32": ("write_i32_vector", "read_i32_vector"),
    "f64": ("write_f64_vector", "read_f64_vector"),
    "pair": ("write_pair_vector", "read_pair_vector"),
    "triple": ("write_triple_vector", "read_triple_vector"),
    "jac": ("write_jac_vector", "read_jac_vector"),
    "dmatrix": ("write_dmatrix_i32", "read_dmatrix_i32"),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", sorted(WRITERS))
def test_goldens_bytes_and_round_trip_match(tmp_path, kind, seed):
    """Each writer's bytes equal the original's; the port's reader gives
    back the arrays, and reads the original's file the same way."""
    write, read = WRITERS[kind]
    value = _golden_arrays(seed)[kind]
    args = value if kind == "jac" else (value,)
    got, want = tmp_path / "port.bin", tmp_path / "jax.bin"
    getattr(goldens, write)(str(got), *args)
    getattr(jax_goldens, write)(str(want), *args)
    assert got.read_bytes() == want.read_bytes()
    back = getattr(goldens, read)(str(got))
    ref = getattr(jax_goldens, read)(str(want))
    assert back.dtype == ref.dtype and back.shape == ref.shape
    np.testing.assert_array_equal(back, ref)
    if kind == "jac":
        for field, col in zip(("genome_a", "genome_b", "s", "n"), value):
            np.testing.assert_array_equal(back[field], col)
    else:
        np.testing.assert_array_equal(back, np.asarray(value).reshape(
            back.shape))


# --- subset_db -----------------------------------------------------------

@pytest.mark.parametrize(
    "pick", [[0, 5, 3, 17, 22], list(range(23, -1, -1)), [9]],
    ids=["five", "reversed", "one"])
def test_subset_db_equals_the_jax_subset(master, tmp_path, pick):
    """The same name list through both tools: equal tables, row for
    row, and the subset's presence is the master's rows in list order."""
    names = [f"synthetic_genome_{i:05d}.fna.gz" for i in pick]
    got, want = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    subset_db.build_subset_db(master, got, names)
    jax_subset.build_subset_db(master, want, names)
    assert _dump(got) == _dump(want)
    sub = _presence(got)
    full = _presence(master)
    assert sub.meta.genome_set == tuple(names)
    np.testing.assert_array_equal(sub.m.sum(axis=2, dtype=np.int32),
                                  full.t[:, pick])
    np.testing.assert_array_equal(sub.t, full.t[:, pick])


def test_subset_db_cli_and_refusals(master, tmp_path):
    names_file = tmp_path / "names.txt"
    names_file.write_text("synthetic_genome_00004.fna.gz\n"
                          "synthetic_genome_00001.fna.gz\n")
    out = str(tmp_path / "sub.db")
    assert subset_db.main([master, out, "-g", str(names_file)]) == 0
    want = str(tmp_path / "jax.db")
    assert jax_subset.main([master, want, "-g", str(names_file)]) == 0
    assert _dump(out) == _dump(want)
    with pytest.raises(FileExistsError):
        subset_db.build_subset_db(master, out, ["synthetic_genome_00004.fna.gz"])
    with pytest.raises(ValueError, match="not in source database"):
        subset_db.build_subset_db(master, str(tmp_path / "x.db"), ["nope"])


# --- rebuild_master_db ---------------------------------------------------

@pytest.fixture(scope="module")
def archives(master, tmp_path_factory):
    """F and Lc of the master (the port's derive) in the reference's
    cereal layout (the port's writers), and a CSV header naming the
    genomes in id order."""
    d = tmp_path_factory.mktemp("archives")
    db = SCPDatabase(master)
    try:
        lc, _, f, _ = derive_single(db)
        names = db.meta.genome_set
    finally:
        db.close()
    goldens.write_pair_vector(str(d / "f.bin"), f)
    goldens.write_i32_vector(str(d / "lc.bin"), lc)
    (d / "aji.csv").write_text("," + ",".join(names) + "\n")
    return d


@pytest.mark.parametrize("donor", [False, True], ids=["bare", "donor"])
def test_rebuild_master_db_equals_the_jax_rebuild(master, archives, tmp_path,
                                                  donor):
    """Both tools rebuild the same tables from the same archives, and the
    rebuilt database's presence is the master's."""
    argv = ["--f-array", str(archives / "f.bin"),
            "--lc-array", str(archives / "lc.bin"),
            "--genome-names-csv", str(archives / "aji.csv"),
            "--proteins-from-db", master]
    if donor:
        argv += ["--donor-metadata-db", master]
    got, want = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    assert rebuild_master_db.main([got, *argv]) == 0
    assert jax_rebuild.main([want, *argv]) == 0
    assert _dump(got) == _dump(want)
    rebuilt, source = _presence(got), _presence(master)
    assert rebuilt.meta.genome_set == source.meta.genome_set
    assert rebuilt.meta.protein_set == source.meta.protein_set
    np.testing.assert_array_equal(rebuilt.m, source.m)
    np.testing.assert_array_equal(rebuilt.t, source.t)
    for a, b in zip(rebuilt.tetramer_ids, source.tetramer_ids):
        np.testing.assert_array_equal(a, b)


def test_rebuild_master_db_refusals(master, archives, tmp_path):
    f, lc = str(archives / "f.bin"), str(archives / "lc.bin")
    names = rebuild_master_db.genome_names_from_csv_header(
        str(archives / "aji.csv"))
    prots = rebuild_master_db.protein_names_from_db(master)
    assert prots == jax_rebuild.protein_names_from_db(master)
    with pytest.raises(ValueError, match="proteins"):
        rebuild_master_db.rebuild_master_db(
            str(tmp_path / "a.db"), f, lc, names, prots[:-1])
    with pytest.raises(ValueError, match="genome ids"):
        rebuild_master_db.rebuild_master_db(
            str(tmp_path / "b.db"), f, lc, names[:-1], prots)
    with pytest.raises(ValueError, match="Inconsistent"):
        rebuild_master_db.rebuild_master_db(
            str(tmp_path / "c.db"), f, f, names, prots)
    (tmp_path / "d.db").write_bytes(b"")
    with pytest.raises(FileExistsError):
        rebuild_master_db.rebuild_master_db(
            str(tmp_path / "d.db"), f, lc, names, prots)


# --- ops.intersect -------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 50, 128), (1, 7, 40), (4, 130, 300)])
def test_intersection_counts_equal_the_jax_op(shape):
    rng = np.random.default_rng(sum(shape))
    m = (rng.random(shape) < 0.3).astype(np.uint8)
    got = ops.intersection_counts(m, device="cpu")
    want = jax_ops.intersection_counts(m)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # a tensor input gives the same
    np.testing.assert_array_equal(
        ops.intersection_counts(torch.from_numpy(m), device="cpu"), want)


@pytest.mark.parametrize("tile", [128, 7, 1])
@pytest.mark.parametrize("mode", ["triu", "random", "rect"])
def test_pair_counts_equal_the_jax_op(tile, mode):
    rng = np.random.default_rng(tile)
    P, G = 3, 60
    m = (rng.random((P, G, 256)) < 0.25).astype(np.uint8)
    if mode == "triu":
        a, b = np.triu_indices(G, k=1)
    elif mode == "random":
        a, b = rng.integers(0, G, 500), rng.integers(0, G, 500)
    else:
        a, b = (x.ravel() for x in np.meshgrid(np.arange(5, 12),
                                               np.arange(G), indexing="ij"))
    a, b = a.astype(np.int32), b.astype(np.int32)
    got = ops.pair_counts(m, a, b, tile=tile, device="cpu")
    want = jax_ops.pair_counts(m, a, b, tile=tile)
    assert got.dtype == np.int32 and got.shape == (P, len(a))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["intersection_counts", "pair_counts"])
def test_count_ops_default_to_cuda_and_raise_without_it(monkeypatch, fn):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = np.ones((1, 4, 8), np.uint8)
    args = (m,) if fn == "intersection_counts" else (m, [0], [1])
    with pytest.raises(PFAAIError, match="CUDA is not available"):
        getattr(ops, fn)(*args)


def test_tools_run_without_the_jax_package(master, tmp_path):
    """A new interpreter runs the port's subset tool as a module and
    imports the other tooling modules, loading no ``jax*`` module and
    nothing of ``parfastaai_tpu``."""
    names_file = tmp_path / "names.txt"
    names_file.write_text("synthetic_genome_00002.fna.gz\n")
    code = (
        "import runpy, sys\n"
        "import parfastaai_tpu_torch.tools.rebuild_master_db\n"
        "import parfastaai_tpu_torch.etl.goldens\n"
        "from parfastaai_tpu_torch.ops import intersection_counts\n"
        "sys.argv = ['subset_db', *sys.argv[1:]]\n"
        "try:\n"
        "    runpy.run_module('parfastaai_tpu_torch.tools.subset_db',\n"
        "                     run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'parfastaai_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = tmp_path / "sub.db"
    res = subprocess.run(
        [sys.executable, "-c", code, master, str(out), "-g", str(names_file)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "clean"
    assert _presence(str(out)).meta.genome_set == (
        "synthetic_genome_00002.fna.gz",)
