"""The port's CLI against the JAX package's CLI, in process on the CPU, on
small synthetic databases: byte-identical default CSVs in all three modes,
``--fast`` within 1e-6, the same error codes, exit code 3 for every flag and
route the port does not run yet, and no jax in a port run."""

import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from parfastaai_tpu.cli import run as jax_run
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu_torch.cli import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 48-genome target DB, a 24-genome query DB with disjoint genome
    names (5 proteins, pool 300, ~100 tetramers per genome), and a
    query-subset list in non-DB order."""
    d = tmp_path_factory.mktemp("torch_cli")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=48, n_proteins=5, pool_size=300,
             tetras_per_genome=100, seed=3)
    generate(query, n_genomes=24, n_proteins=5, pool_size=300,
             tetras_per_genome=100, seed=4)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    qfile = d / "queries.txt"
    qfile.write_text(
        "\n".join(f"synthetic_genome_{i:05d}.fna.gz" for i in (30, 2, 17)) + "\n"
    )
    return {"target": target, "query": query, "qfile": str(qfile)}


def _mode_args(mode, dbs):
    if mode == "qt":
        return ["-r", dbs["query"]]
    if mode == "qsub":
        return ["-q", dbs["qfile"]]
    if mode == "sep":
        return ["-s", ";"]
    return []


def _read_csv(path, sep=","):
    with open(path) as fp:
        lines = fp.read().splitlines()
    return np.array([[float(v) for v in ln.split(sep)[1:]] for ln in lines[1:]])


@pytest.mark.parametrize("mode", ["all", "qsub", "qt", "sep"])
def test_default_csv_byte_identical(mode, dbs, tmp_path):
    extra = _mode_args(mode, dbs)
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_run([dbs["target"], str(want), "--quiet", *extra]) == 0
    assert run([dbs["target"], str(got), "--quiet", "--device", "cpu", *extra]) == 0
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("mode", ["all", "qsub", "qt"])
def test_fast_csv_matches_jax(mode, dbs, tmp_path):
    extra = _mode_args(mode, dbs)
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_run([dbs["target"], str(want), "--quiet", "--fast", *extra]) == 0
    assert run(
        [dbs["target"], str(got), "--quiet", "--fast", "--device", "cpu", *extra]
    ) == 0
    w, g = _read_csv(want), _read_csv(got)
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)


def test_dump_files_byte_identical(dbs, tmp_path):
    paths = {}
    for name, fn, dev in (("jax", jax_run, []), ("port", run, ["--device", "cpu"])):
        jac, e = tmp_path / f"{name}_jac.csv", tmp_path / f"{name}_e.csv"
        out = tmp_path / f"{name}.csv"
        assert fn([dbs["target"], str(out), "--quiet", "--dump-jac", str(jac),
                   "--dump-e", str(e), *dev]) == 0
        paths[name] = (out, jac, e)
    for a, b in zip(paths["jax"], paths["port"]):
        assert a.read_bytes() == b.read_bytes()


def test_error_codes_match_jax(dbs, tmp_path):
    bad_q = tmp_path / "bad.txt"
    bad_q.write_text("definitely_not_a_genome\n")
    cases = [
        ["/nonexistent/x.db"],  # missing DB
        [dbs["target"], "-q", str(bad_q)],  # unknown query genome
        [dbs["target"], "-q", str(tmp_path / "missing.txt")],  # no query file
        [dbs["target"], "-r", dbs["target"] + ".copy"],  # missing query DB
    ]
    # overlapping genome sets: a query DB that is a copy of the target
    overlap = tmp_path / "overlap.db"
    overlap.write_bytes(open(dbs["target"], "rb").read())
    cases.append([dbs["target"], "-r", str(overlap)])
    for case in cases:
        db, extra = case[0], case[1:]
        want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
        rc_jax = jax_run([db, str(want), "--quiet", *extra])
        rc = run([db, str(got), "--quiet", "--device", "cpu", *extra])
        assert rc == rc_jax != 0, case
        assert not got.exists()


@pytest.mark.parametrize(
    "flags",
    [
        ["--streamed"],
        ["--streamed", "--exact"],
        ["--exact"],
        ["--fast", "--staged"],
        ["--staged"],
        ["--mesh", "2"],
        ["--mesh", "0,1"],
        ["--resume"],
        ["--profile", "trace_dir"],
        ["--approx"],
    ],
)
def test_uncovered_flags_exit_3(flags, dbs, tmp_path, capsys):
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--quiet", "--device", "cpu", *flags]) == 3
    assert not out.exists()
    assert "CONSTRUCT_ERROR" in capsys.readouterr().err


def test_banded_exact_auto_route_exits_3(dbs, tmp_path, monkeypatch, capsys):
    """Where the JAX CLI would route the default path to the banded exact
    engine, the port stops and says so; --fast still runs."""
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--quiet", "--device", "cpu"]) == 3
    assert not out.exists()
    err = capsys.readouterr().err
    assert "--fast" in err and "PARFASTAAI_EXACT_HOST_BYTES" in err
    assert run([dbs["target"], str(out), "--quiet", "--device", "cpu",
                "--fast"]) == 0
    assert out.exists()


def test_cuda_without_cuda_exits_nonzero(dbs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--quiet", "--device", "cuda"]) != 0
    assert not out.exists()


def test_port_run_never_loads_jax(dbs, tmp_path):
    """A fresh process running the port CLI (default and --fast) ends
    without jax in sys.modules."""
    code = (
        "import sys\n"
        "from parfastaai_tpu_torch.cli import run\n"
        "db, out = sys.argv[1], sys.argv[2]\n"
        "rcs = [run([db, out, '--quiet', '--device', 'cpu', *f])"
        " for f in ([], ['--fast'])]\n"
        "print('RCS', rcs, 'JAX', 'jax' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, dbs["target"], str(tmp_path / "x.csv")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "RCS [0, 0] JAX False" in proc.stdout
