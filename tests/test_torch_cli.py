"""The port's CLI against the JAX package's CLI, in process on the CPU, on
small synthetic databases: byte-identical default CSVs in all three modes,
on the dense path and on the banded exact engine (auto-routed under a low
PARFASTAAI_EXACT_HOST_BYTES, and ``--streamed --exact`` with ``--resume``),
``--fast`` within 1e-6, ``--streamed`` (the f32 streamed engine) to its
stated tolerance, ``--staged`` and PARFASTAAI_STAGED against the JAX
CLI's staged runs, ``--profile`` on every route, ``--mesh`` of one
device byte-identical to the JAX CLI's, the streamed engines on it too
(the multi-process meshes are in test_torch_multiproc.py and
test_torch_multiproc_streamed.py), the same error codes, exit code 3 for
the flag combinations the JAX CLI refuses, for a mesh larger than the
process group and for ``--streamed --approx`` off the card, and no jax in
a port run."""

import json
import os
import shutil
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from parfastaai_tpu.cli import run as jax_run
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu_torch.cli import run
from parfastaai_tpu_torch.types import ErrorCode, PFAAIError

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
    # the same pair with each database's 'scp_data' in an order of its own:
    # the target's genome-major over a shuffled protein order, the query's
    # protein-major in reverse and without one protein
    target_scp, query_scp = str(d / "target_scp.db"), str(d / "query_scp.db")
    shutil.copy(target, target_scp)
    shutil.copy(query, query_scp)
    for path, order in ((target_scp,
                         "genome_id, instr('40132', substr(SCP_acc, 7, 1))"),
                        (query_scp, "SCP_acc DESC, genome_id")):
        with sqlite3.connect(path) as conn:
            conn.execute("CREATE TABLE scp_rows AS SELECT * FROM scp_data "
                         f"ORDER BY {order}")
            conn.execute("DELETE FROM scp_data")
            conn.execute("INSERT INTO scp_data SELECT * FROM scp_rows")
            conn.execute("DROP TABLE scp_rows")
    with sqlite3.connect(query_scp) as conn:
        conn.execute("DELETE FROM scp_data WHERE SCP_acc = 'PF90002.1'")
    return {"target": target, "query": query, "qfile": str(qfile),
            "target_scp": target_scp, "query_scp": query_scp}


def _mode_args(mode, dbs):
    if mode == "qt":
        return ["-r", dbs["query"]]
    if mode == "qt_scp_order":
        return ["-r", dbs["query_scp"]]
    if mode == "qsub":
        return ["-q", dbs["qfile"]]
    if mode == "sep":
        return ["-s", ";"]
    return []


def _read_csv(path, sep=","):
    with open(path) as fp:
        lines = fp.read().splitlines()
    return np.array([[float(v) for v in ln.split(sep)[1:]] for ln in lines[1:]])


@pytest.mark.parametrize("mode", ["all", "qsub", "qt", "sep", "qt_scp_order"])
def test_default_csv_byte_identical(mode, dbs, tmp_path):
    extra = _mode_args(mode, dbs)
    target = dbs["target_scp" if mode == "qt_scp_order" else "target"]
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_run([target, str(want), "--quiet", *extra]) == 0
    assert run([target, str(got), "--quiet", "--device", "cpu", *extra]) == 0
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


@pytest.mark.parametrize(
    "flags",
    [["--mesh", "1"], ["--mesh", "1,1"], ["--mesh", "1", "--fast"],
     # the JAX CLI's mesh route does not read --precise either
     ["--mesh", "1", "--fast", "--precise"]],
    ids=["rows", "rows_scp", "fast", "fast_precise"],
)
@pytest.mark.parametrize("mode", ["all", "qsub", "qt"])
def test_one_process_mesh_byte_identical(mode, flags, dbs, tmp_path):
    """A mesh of one device in one process: the JAX CLI's bytes at the
    same mesh (the plain version's IEEE f32 terms in ascending proteins
    are its scan's)."""
    extra = _mode_args(mode, dbs)
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_run([dbs["target"], str(want), "--quiet", *flags, *extra]) == 0
    assert run([dbs["target"], str(got), "--quiet", "--device", "cpu",
                *flags, *extra]) == 0
    assert got.read_bytes() == want.read_bytes()


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
        ["--streamed", "--mesh", "2"],
        ["--exact"],
        ["--exact", "--resume"],
        ["--streamed", "--exact", "--precise"],
        ["--streamed", "--exact", "--mesh", "2"],
        ["--staged"],
        ["--staged", "--mesh", "2"],
        ["--staged", "--exact"],
        ["--staged", "--resume"],
        ["--staged", "--precise"],
        ["--mesh", "2"],  # two mesh devices, one process
        ["--mesh", "0,1"],
        ["--profile", "trace_dir", "--mesh", "2"],
        ["--approx"],
        ["--streamed", "--approx"],  # the kernel's divide: on cuda only
    ],
)
def test_uncovered_flags_exit_3(flags, dbs, tmp_path, capsys):
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--quiet", "--device", "cpu", *flags]) == 3
    assert not out.exists()
    assert "CONSTRUCT_ERROR" in capsys.readouterr().err


@pytest.mark.parametrize(
    "flags",
    [["--streamed", "--mesh", "1"], ["--streamed", "--exact", "--mesh", "1"],
     ["--streamed", "--staged", "--mesh", "1,1"]],
    ids=["streamed", "streamed_exact", "streamed_staged"],
)
def test_streamed_one_process_mesh_matches_jax(flags, dbs, tmp_path,
                                                monkeypatch):
    """The streamed engines on a mesh of one device, in one process: the
    JAX CLI's bytes at the same mesh (its device leg, as in the staged
    tests below) and the port's bytes without the mesh."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    want, got, plain = (tmp_path / f"{k}.csv" for k in ("jax", "port", "one"))
    assert jax_run([dbs["target"], str(want), "--quiet", *flags]) == 0
    assert run([dbs["target"], str(got), "--quiet", "--device", "cpu",
                *flags]) == 0
    at = flags.index("--mesh")
    assert run([dbs["target"], str(plain), "--quiet", "--device", "cpu",
                *flags[:at], *flags[at + 2:]]) == 0
    assert got.read_bytes() == want.read_bytes() == plain.read_bytes()


def _staged_cli_runs(argv, dbs, tmp_path, capfd) -> tuple[bytes, bytes, str]:
    """(port CSV, JAX CSV, what the port printed) of one run of each CLI
    with ``argv``; the JAX CLI on its device leg, where it stages too."""
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    os.environ["PARFASTAAI_FORCE_DEVICE"] = "1"
    try:
        assert jax_run([dbs["target"], str(want), "--quiet", *argv]) == 0
    finally:
        del os.environ["PARFASTAAI_FORCE_DEVICE"]
    capfd.readouterr()
    assert run([dbs["target"], str(got), "--device", "cpu", *argv]) == 0
    return got.read_bytes(), want.read_bytes(), capfd.readouterr().out


@pytest.mark.parametrize(
    "flags",
    [
        ["--streamed", "--staged"],
        ["--streamed", "--fast", "--staged"],
        ["--streamed", "--exact", "--staged"],
        ["--fast", "--staged"],
    ],
    ids=["streamed", "streamed_fast", "streamed_exact", "fast"],
)
def test_staged_flags_match_jax(flags, dbs, tmp_path, capfd):
    """--staged runs the staged slab engines, says what they uploaded, and
    writes the JAX CLI's staged CSV: the same bytes on the banded exact
    engine, the stated tolerance on the f32 ones.  Here no bucket is split
    into chunks, so the f32 bytes are those of the resident run too."""
    got, want, text = _staged_cli_runs(
        [*flags, "--band", "7", "--col-chunk", "5"], dbs, tmp_path, capfd)
    assert "staged slabs" in text and "uploaded" in text
    resident = tmp_path / "resident.csv"
    assert run([dbs["target"], str(resident), "--quiet", "--device", "cpu",
                *[f for f in flags if f != "--staged"], "--band", "7",
                "--col-chunk", "5"]) == 0
    assert got == resident.read_bytes()
    if "--exact" in flags:
        assert got == want
    else:
        assert_streamed_close(got, want)


@pytest.mark.parametrize("value,staged", [
    ("1", True), ("yes", True), ("0", False), ("False", False), ("", False)])
@pytest.mark.parametrize("flags", [[], ["--streamed"], ["--fast"]])
def test_staged_env_is_read_as_the_reference_reads_it(
        value, staged, flags, dbs, tmp_path, capfd, monkeypatch):
    """PARFASTAAI_STAGED asks for staged slabs unless it is "0", "false",
    "no" or empty.  Where it asks, the banded engines stage (the dense
    default path uploads the whole tensor, as in the JAX package) and the
    CSV is the JAX CLI's under the same variable: its bytes on the exact
    path, the stated tolerance on the f32 ones.  Either way the port
    writes the bytes of a run without the variable (no bucket is split at
    this size)."""
    plain = tmp_path / "plain.csv"
    monkeypatch.delenv("PARFASTAAI_STAGED", raising=False)
    assert run([dbs["target"], str(plain), "--quiet", "--device", "cpu",
                *flags]) == 0
    monkeypatch.setenv("PARFASTAAI_STAGED", value)
    got, want, text = _staged_cli_runs(flags, dbs, tmp_path, capfd)
    assert ("staged slabs" in text) == (staged and bool(flags))
    assert got == plain.read_bytes()
    if flags:
        assert_streamed_close(got, want)
    else:
        assert got == want


def assert_streamed_close(got: bytes, want: bytes, sep=",") -> None:
    """The f32 streamed engine's stated tolerance between two CSVs: the
    same header and row names as bytes, a cell is the text ``0`` in one
    exactly where it is in the other, values within rtol 1e-6."""
    g, w = (text.decode().split("\n") for text in (got, want))
    assert g[0] == w[0] and len(g) == len(w) and g[-1] == w[-1] == ""
    g, w = ([ln.split(sep) for ln in x[1:-1]] for x in (g, w))
    assert [r[0] for r in g] == [r[0] for r in w]
    g, w = (np.array([r[1:] for r in x], dtype=object) for x in (g, w))
    assert g.shape == w.shape
    np.testing.assert_array_equal(g == "0", w == "0")
    np.testing.assert_allclose(
        g.astype(np.float64), w.astype(np.float64), rtol=1e-6, atol=0)


@pytest.mark.parametrize("jax_leg", ["host", "device"])
@pytest.mark.parametrize("mode", ["all", "qsub", "qt", "qt_noswap", "sep"])
def test_streamed_csv_matches_jax(mode, jax_leg, dbs, tmp_path, monkeypatch):
    """``--streamed`` against the JAX CLI's, on its default CPU leg (host
    block) and on its device leg, with ragged bands and chunks."""
    if jax_leg == "device":
        monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    extra = (["-r", dbs["query"], "--no-compat-qt-t-swap"]
             if mode == "qt_noswap" else _mode_args(mode, dbs))
    extra = [*extra, "--streamed", "--band", "7", "--col-chunk", "5"]
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_run([dbs["target"], str(want), "--quiet", *extra]) == 0
    assert run([dbs["target"], str(got), "--quiet", "--device", "cpu", *extra]) == 0
    assert_streamed_close(got.read_bytes(), want.read_bytes(),
                          ";" if mode == "sep" else ",")


@pytest.mark.parametrize(
    "flags",
    [
        ["--fast"],  # the streamed branch comes first, as in the JAX CLI
        ["--precise"],  # the plain version divides in IEEE f32 already
        ["--band", "7", "--col-chunk", "5"],
        ["--band", "1", "--col-chunk", "1"],
    ],
    ids=["fast", "precise", "band7x5", "band1x1"],
)
def test_streamed_variants_write_the_same_bytes(flags, dbs, tmp_path):
    want, got = tmp_path / "plain.csv", tmp_path / "port.csv"
    base = [dbs["target"], "--quiet", "--device", "cpu", "--streamed"]
    assert run([base[0], str(want), *base[1:]]) == 0
    assert run([base[0], str(got), *base[1:], *flags]) == 0
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("mode", ["all", "qsub", "qt"])
def test_streamed_resume(mode, dbs, tmp_path):
    """--streamed --resume from a file cut inside its second band restores
    the bytes (the JAX CLI: to the stated tolerance)."""
    args = ["--quiet", "--streamed", "--band", "2", *_mode_args(mode, dbs)]
    full, got, want = (tmp_path / n for n in ("full.csv", "port.csv", "jax.csv"))
    assert run([dbs["target"], str(full), "--device", "cpu", *args]) == 0
    whole = full.read_bytes()
    cut = b"\n".join(whole.split(b"\n")[: 1 + 2]) + b"\nsynthetic_genome_000"
    got.write_bytes(cut)
    want.write_bytes(cut)
    assert run([dbs["target"], str(got), "--device", "cpu", *args, "--resume"]) == 0
    assert jax_run([dbs["target"], str(want), *args, "--resume"]) == 0
    assert got.read_bytes() == whole
    assert_streamed_close(want.read_bytes(), whole)


def test_streamed_says_so(dbs, tmp_path, capfd):
    """The engine's stages and the JAX CLI's closing line plus the device;
    a symmetric run under PARFASTAAI_MIRROR_BYTES=1 says so on stderr."""
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--device", "cpu", "--streamed"]) == 0
    text = capfd.readouterr().out
    for stage in ("gather", "kernel", "AJI mask", "D2H", "host assembly",
                  "CSV write", "producer wait", "writer wait"):
        assert f"  {stage}" in text
    assert f"Wrote 48 x 48 AJI matrix to {out} (streamed) on cpu" in text
    assert "genome-pair AJI values" not in text and "banded exact" not in text


def test_streamed_approx_exits_3_in_both_clis(dbs, tmp_path, capsys):
    """The raw reciprocal exists only in the device kernels: on the CPU
    both CLIs stop with CONSTRUCT_ERROR and write no CSV."""
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    flags = ["--quiet", "--streamed", "--approx"]
    assert jax_run([dbs["target"], str(want), *flags]) == 3
    assert run([dbs["target"], str(got), "--device", "cpu", *flags]) == 3
    assert not want.exists() and not got.exists()
    assert capsys.readouterr().err.count("CONSTRUCT_ERROR") == 2


PROFILED = {
    "dense": ([], {}),
    "fast": (["--fast"], {}),
    "banded": (["--streamed", "--exact"], {}),
    "banded_auto": ([], {"PARFASTAAI_EXACT_HOST_BYTES": "1"}),
    "streamed": (["--streamed"], {}),
}


@pytest.mark.parametrize("route", sorted(PROFILED))
def test_profile_writes_a_trace_and_the_same_csv(route, dbs, tmp_path, monkeypatch):
    """--profile DIR on every route: DIR is created, holds one Chrome trace
    that parses as JSON with events in it, and the CSV's bytes are those of
    the run without the flag."""
    from parfastaai_tpu_torch.cli import PROFILE_TRACE

    flags, env = PROFILED[route]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    plain, got = tmp_path / "plain.csv", tmp_path / "profiled.csv"
    trace_dir = tmp_path / "traces" / route
    base = ["--quiet", "--device", "cpu", *flags]
    assert run([dbs["target"], str(plain), *base]) == 0
    assert run([dbs["target"], str(got), *base, "--profile", str(trace_dir)]) == 0
    assert got.read_bytes() == plain.read_bytes()
    assert [p.name for p in trace_dir.iterdir()] == [PROFILE_TRACE]
    trace = json.loads((trace_dir / PROFILE_TRACE).read_text())
    assert len(trace["traceEvents"]) > 0


def test_profile_of_a_failing_run_closes_the_profiler(dbs, tmp_path, monkeypatch):
    """A run that fails under --profile (here its block engine, mid-run)
    exits with its own code, and the next profiled run works: the profiler
    was closed."""
    from parfastaai_tpu_torch import engine

    real = engine._block_sn

    def failing(*args, **kwargs):
        raise PFAAIError(ErrorCode.CONSTRUCT_ERROR, "injected block fault")

    monkeypatch.setattr(engine, "_block_sn", failing)
    out = tmp_path / "x.csv"
    args = [dbs["target"], str(out), "--quiet", "--device", "cpu", "--streamed"]
    assert run([*args, "--profile", str(tmp_path / "t1")]) == 3
    monkeypatch.setattr(engine, "_block_sn", real)
    assert run([*args, "--profile", str(tmp_path / "t2")]) == 0
    assert (tmp_path / "t2").is_dir() and out.exists()


BANDED = {
    # the default call above the host budget, and the flags that ask for it
    "auto": ([], {"PARFASTAAI_EXACT_HOST_BYTES": "1"}),
    "streamed_exact": (["--streamed", "--exact"], {}),
}
# every route into an engine that writes the CSV in bands
BANDED_AND_STREAMED = {**BANDED, "streamed": (["--streamed"], {})}


@pytest.mark.parametrize("route", sorted(BANDED))
@pytest.mark.parametrize("mode", ["all", "qsub", "qt", "sep"])
def test_banded_exact_csv_byte_identical(mode, route, dbs, tmp_path, monkeypatch):
    """The banded exact engine through the CLI, with bands and chunks that
    leave ragged edges: the bytes of the JAX CLI on the same route and of
    the port's dense default call."""
    flags, env = BANDED[route]
    extra = [*_mode_args(mode, dbs), *flags, "--band", "7", "--col-chunk", "5"]
    dense = tmp_path / "dense.csv"
    assert run([dbs["target"], str(dense), "--quiet", "--device", "cpu",
                *_mode_args(mode, dbs)]) == 0
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    assert jax_run([dbs["target"], str(want), "--quiet", *extra]) == 0
    assert run([dbs["target"], str(got), "--quiet", "--device", "cpu", *extra]) == 0
    assert got.read_bytes() == want.read_bytes() == dense.read_bytes()


def test_banded_exact_auto_route_says_so(dbs, tmp_path, monkeypatch, capfd):
    """The auto-route prints the JAX CLI's note, the engine's stages and
    its closing line; the dense call prints none of them."""
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--device", "cpu"]) == 0
    text = capfd.readouterr().out
    assert "genome-pair AJI values" in text and "banded exact" not in text
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    assert run([dbs["target"], str(out), "--device", "cpu"]) == 0
    text = capfd.readouterr().out
    assert "routing through the banded exact engine" in text
    assert "PARFASTAAI_EXACT_HOST_BYTES overrides" in text
    assert "genome-pair AJI values" not in text
    for stage in ("Gram", "D2H", "host finish", "CSV write", "producer wait",
                  "worker wait"):
        assert f"  {stage}" in text
    assert f"Wrote 48 x 48 AJI matrix to {out} (banded exact) on cpu" in text


@pytest.mark.parametrize("mirror_bytes", [None, "1"])
def test_banded_exact_mirror_on_and_off(mirror_bytes, dbs, tmp_path, monkeypatch):
    dense, got = tmp_path / "dense.csv", tmp_path / "port.csv"
    assert run([dbs["target"], str(dense), "--quiet", "--device", "cpu"]) == 0
    if mirror_bytes:
        monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", mirror_bytes)
    assert run([dbs["target"], str(got), "--quiet", "--device", "cpu",
                "--streamed", "--exact", "--band", "9"]) == 0
    assert got.read_bytes() == dense.read_bytes()


@pytest.mark.parametrize("route", sorted(BANDED))
def test_banded_exact_resume(route, dbs, tmp_path, monkeypatch):
    """--resume from a file cut inside its third band restores the bytes,
    on both routes into the engine, as in the JAX CLI."""
    flags, env = BANDED[route]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    args = ["--quiet", *flags, "--band", "10"]
    full, got, want = (tmp_path / n for n in ("full.csv", "port.csv", "jax.csv"))
    assert run([dbs["target"], str(full), "--device", "cpu", *args]) == 0
    whole = full.read_bytes()
    cut = b"\n".join(whole.split(b"\n")[: 1 + 25]) + b"\nsynthetic_genome_000"
    got.write_bytes(cut)
    want.write_bytes(cut)
    assert run([dbs["target"], str(got), "--device", "cpu", *args, "--resume"]) == 0
    assert jax_run([dbs["target"], str(want), *args, "--resume"]) == 0
    assert got.read_bytes() == want.read_bytes() == whole


def test_resume_without_the_banded_engine_is_ignored(dbs, tmp_path):
    """On the dense default path --resume changes nothing, as in the JAX
    CLI: the file is written anew."""
    want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
    got.write_bytes(b"stale\n")
    assert jax_run([dbs["target"], str(want), "--quiet", "--resume"]) == 0
    assert run([dbs["target"], str(got), "--quiet", "--device", "cpu",
                "--resume"]) == 0
    assert got.read_bytes() == want.read_bytes()


def test_dump_jac_pins_the_dense_path(dbs, tmp_path, monkeypatch, capfd):
    """--dump-jac needs the per-pair result: under a budget that would
    route to the banded engine the run stays dense and writes both files
    as the JAX CLI does."""
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    files = {}
    for name, fn, dev in (("jax", jax_run, []), ("port", run, ["--device", "cpu"])):
        out, jac = tmp_path / f"{name}.csv", tmp_path / f"{name}_jac.csv"
        assert fn([dbs["target"], str(out), "--dump-jac", str(jac), *dev]) == 0
        files[name] = (out.read_bytes(), jac.read_bytes())
    assert files["port"] == files["jax"]
    text = capfd.readouterr().out
    assert text.count("genome-pair AJI values") == 2
    assert "banded exact" not in text


def test_banded_route_validates_like_the_dense_one(dbs, tmp_path, monkeypatch):
    """Unknown query genomes and overlapping databases stop the banded
    route with the dense route's code, before any CSV."""
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    bad_q = tmp_path / "bad.txt"
    bad_q.write_text("definitely_not_a_genome\n")
    overlap = tmp_path / "overlap.db"
    overlap.write_bytes(open(dbs["target"], "rb").read())
    for extra in (["-q", str(bad_q)], ["-r", str(overlap)]):
        want, got = tmp_path / "jax.csv", tmp_path / "port.csv"
        rc_jax = jax_run([dbs["target"], str(want), "--quiet", *extra])
        rc = run([dbs["target"], str(got), "--quiet", "--device", "cpu", *extra])
        assert rc == rc_jax == 3, extra
        assert not got.exists()


def test_cuda_without_cuda_exits_nonzero(dbs, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--quiet", "--device", "cuda"]) != 0
    assert not out.exists()


@pytest.mark.parametrize("route", sorted(BANDED_AND_STREAMED))
def test_banded_cuda_without_cuda_exits_nonzero(route, dbs, tmp_path, monkeypatch):
    """No card: the banded routes stop as the dense one does, with no CSV
    and no move to the CPU."""
    flags, env = BANDED_AND_STREAMED[route]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.csv"
    assert run([dbs["target"], str(out), "--quiet", "--device", "cuda",
                *flags]) == 3
    assert not out.exists()


def test_port_run_never_loads_jax(dbs, tmp_path):
    """A fresh process running the port CLI (default, --fast, the banded
    exact engine by its flags and by the auto-route, the streamed engine
    under --profile) ends without jax in sys.modules."""
    code = (
        "import os, sys\n"
        "from parfastaai_tpu_torch.cli import run\n"
        "db, out = sys.argv[1], sys.argv[2]\n"
        "rcs = [run([db, out, '--quiet', '--device', 'cpu', *f])"
        " for f in ([], ['--fast'], ['--streamed', '--exact'],"
        " ['--streamed', '--profile', out + '.trace'])]\n"
        "os.environ['PARFASTAAI_EXACT_HOST_BYTES'] = '1'\n"
        "rcs.append(run([db, out, '--quiet', '--device', 'cpu']))\n"
        "print('RCS', rcs, 'JAX', 'jax' in sys.modules)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", code, dbs["target"], str(tmp_path / "x.csv")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "RCS [0, 0, 0, 0, 0] JAX False" in proc.stdout
