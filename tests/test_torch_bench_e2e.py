"""The port's bench in e2e mode (``PARFASTAAI_BENCH_MODE=e2e python -m
parfastaai_tpu_torch.bench``, counterpart of bench.py's ``main_e2e``) on
the CPU, at G=40 on the bench's generator: one JSON line with bench.py's
keys (``upload_presence_bytes`` in place of the packed upload) plus
``legs`` and ``device_kind``; the exact and mesh legs' CSVs byte-equal to
the JAX CLI's default CSV on the same database, the fused and streamed
ones within 1e-6 of it; a two-process gloo launch writing the same bytes;
the download byte counts against the blocks the engines copy; and no file
or environment variable touched outside the output directory.

G=40 is used by no other test: the JAX bench's own e2e test runs G=64 and
writes fixed names under /tmp."""

import contextlib
import hashlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from parfastaai_tpu.cli import run as jax_run
from parfastaai_tpu.tools.synth_db import generate as jax_generate
from parfastaai_tpu_torch import bench, engine
from parfastaai_tpu_torch.etl.database import SCPDatabase
from parfastaai_tpu_torch.parallel.mesh import parse_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G = 40
REF_KEYS = {
    "metric", "value", "unit", "vs_baseline", "phases",
    "streamed_wall_seconds", "reference_extrapolated_seconds", "wire_bytes",
    "exact_wall_seconds",
}
WIRE_KEYS = {"upload_presence_bytes", "streamed_download_bytes",
             "exact_download_bytes"}
PHASE_KEYS = {"db_open", "etl", "fused_aji", "csv", "streamed_aji_csv",
              "banded_exact_csv", "banded_exact_mesh_csv",
              "banded_exact_mesh_bytes_identical"}
LEG_KEYS = {"seconds", "wall_seconds", "pairs_per_sec", "pairs_per_sec_wall",
            "split_ms", "kernel_launches"}
NAMES = {"fused": "", "streamed": "_streamed", "exact": "_exact",
         "exact_mesh": "_exact_mesh"}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def e2e_db(tmp_path_factory):
    """The bench's database at G=40 (made by the port's generator, as the
    bench makes it) and the JAX CLI's default CSV on it."""
    d = tmp_path_factory.mktemp("bench_e2e")
    db = str(d / "synth40.db")
    bench.bench_db({"PARFASTAAI_BENCH_DB": db}, G)
    want = str(d / "jax_default.csv")
    assert jax_run([db, want, "--quiet"]) == 0
    return db, want


def _env(db, out, **extra):
    return {"PARFASTAAI_BENCH_MODE": "e2e", "PARFASTAAI_BENCH_DEVICE": "cpu",
            "PARFASTAAI_BENCH_G": str(G), "PARFASTAAI_BENCH_DB": db,
            "PARFASTAAI_BENCH_OUT": str(out), **extra}


def _run(env):
    """bench.main(env): (result, the lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = bench.main(env)
    return result, buf.getvalue().splitlines()


def _csv(out, leg):
    return os.path.join(str(out), f"pfaai_bench_e2e_{G}{NAMES[leg]}.csv")


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _values(path):
    """(header, row names, the matrix as f64) of an AJI CSV."""
    with open(path) as fp:
        header = fp.readline()
        rows = [line.rstrip("\n").split(",") for line in fp]
    return header, [r[0] for r in rows], np.array(
        [[float(v) for v in r[1:]] for r in rows])


@pytest.fixture(scope="module")
def full_run(e2e_db, tmp_path_factory):
    """One e2e run with every leg (EXACT, EXACT_MESH=1,1)."""
    db, _ = e2e_db
    out = tmp_path_factory.mktemp("bench_e2e_out")
    result, lines = _run(_env(db, out, PARFASTAAI_BENCH_EXACT="1",
                              PARFASTAAI_BENCH_EXACT_MESH="1,1"))
    return result, lines, out


def test_one_json_line_with_the_reference_keys(full_run, e2e_db):
    result, lines, _ = full_run
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == REF_KEYS | {"legs", "device_kind"}
    assert set(result["wire_bytes"]) == WIRE_KEYS
    assert set(result["phases"]) == PHASE_KEYS
    assert result["phases"]["banded_exact_mesh_bytes_identical"] is True
    assert set(result["legs"]) == set(NAMES)
    for leg in result["legs"].values():
        assert set(leg) == LEG_KEYS
        assert leg["seconds"] > 0 and leg["pairs_per_sec"] > 0
        assert leg["wall_seconds"] > leg["seconds"]
        # the plain versions on the CPU: no hand-written kernel
        assert leg["kernel_launches"] == {"sn_rect": 0, "sn_square_wgmma": 0}
    assert result["device_kind"] == "cpu" and result["unit"] == "s"
    assert "G=40 P=80, 780 pairs, fused path" in result["metric"]
    assert result["value"] == result["legs"]["fused"]["wall_seconds"]
    assert result["streamed_wall_seconds"] == (
        result["legs"]["streamed"]["wall_seconds"])
    assert result["exact_wall_seconds"] == (
        result["legs"]["exact"]["wall_seconds"])
    assert result["reference_extrapolated_seconds"] == pytest.approx(
        780 / bench.BASELINE_PAIRS_PER_SEC)
    # the engines' own splits reach each leg
    assert {"kernel", "CSV write", "pair gather"} <= set(
        result["legs"]["fused"]["split_ms"])
    assert {"kernel", "CSV write", "writer wait"} <= set(
        result["legs"]["streamed"]["split_ms"])
    assert {"Gram", "host finish", "CSV write"} <= set(
        result["legs"]["exact"]["split_ms"])
    assert "count gather" in result["legs"]["exact_mesh"]["split_ms"]


def test_wire_bytes_count_what_the_port_moves(full_run, e2e_db):
    """The upload is the int8 width buckets, the downloads the engines'
    blocks: at G=40 one 40 x 40 f32 block and one (80, 40, 40) int16
    count block."""
    result, _, _ = full_run
    db = SCPDatabase(e2e_db[0])
    try:
        presence = db.load_presence()
    finally:
        db.close()
    assert result["wire_bytes"] == {
        "upload_presence_bytes": engine.presence_device_bytes(presence),
        "streamed_download_bytes": 4 * G * G,
        "exact_download_bytes": 2 * 80 * G * G,
    }


@pytest.mark.parametrize("leg", ["exact", "exact_mesh"])
def test_exact_legs_byte_equal_the_jax_cli(full_run, e2e_db, leg):
    _, _, out = full_run
    assert _read(_csv(out, leg)) == _read(e2e_db[1])


@pytest.mark.parametrize("leg", ["fused", "streamed"])
def test_f32_legs_within_1e_6_of_the_jax_cli(full_run, e2e_db, leg):
    _, _, out = full_run
    header, names, got = _values(_csv(out, leg))
    want_header, want_names, want = _values(e2e_db[1])
    assert header == want_header and names == want_names
    assert got.shape == (G, G)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_streamed_only_leaves_out_the_fused_leg(e2e_db, tmp_path):
    result, lines = _run(_env(e2e_db[0], tmp_path,
                              PARFASTAAI_BENCH_STREAMED_ONLY="1"))
    assert len(lines) == 1
    assert "fused_aji" not in result["phases"]
    assert "csv" not in result["phases"]
    assert set(result["legs"]) == {"streamed"}
    assert "exact_wall_seconds" not in result
    assert "streamed path" in result["metric"]
    assert result["value"] == result["streamed_wall_seconds"]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(
        _csv(tmp_path, "streamed"))]


@pytest.mark.parametrize("spec", ["2x1", "0", "1,0", "1,2,3", "-1", "a,b",
                                  ","])
def test_bad_mesh_spec_exits(e2e_db, tmp_path, spec):
    """bench.py's ``int(x) for x in spec.split(",")`` fails on "2" and on
    spaces; the port reads the spec by the CLI's --mesh rule and exits
    non-zero with its message before any work."""
    with pytest.raises(SystemExit, match="ROWS or ROWS,SCP") as exc:
        _run(_env(e2e_db[0], tmp_path / "out",
                  PARFASTAAI_BENCH_EXACT_MESH=spec))
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("spec", ["2", "2,1", "1,2"])
def test_mesh_larger_than_the_launch_exits(e2e_db, tmp_path, spec):
    with pytest.raises(SystemExit, match="Need 2 devices, have 1"):
        _run(_env(e2e_db[0], tmp_path, PARFASTAAI_BENCH_EXACT_MESH=spec))


@pytest.mark.parametrize(
    "spec,want",
    [("2", (2, 1)), ("2,1", (2, 1)), (" 1 , 2 ", (1, 2)), ("3,4", (3, 4))])
def test_parse_mesh_reads_the_cli_rule(spec, want):
    assert parse_mesh(spec) == want


@pytest.mark.parametrize("keep", [False, True])
def test_no_file_or_environment_touched_outside_the_output(
        monkeypatch, tmp_path, keep):
    """With no database, output directory or temporary directory named:
    the database appears in the temporary directory under its final name
    alone, the CSVs in a fresh directory there, removed at the end unless
    PARFASTAAI_BENCH_KEEP is set; nothing lands in the working directory
    and os.environ is unchanged."""
    tmp, cwd = tmp_path / "tmp", tmp_path / "cwd"
    tmp.mkdir()
    cwd.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    monkeypatch.chdir(cwd)
    before = dict(os.environ)
    env = {"PARFASTAAI_BENCH_MODE": "e2e", "PARFASTAAI_BENCH_DEVICE": "cpu",
           "PARFASTAAI_BENCH_G": str(G), "PARFASTAAI_BENCH_EXACT": "1"}
    if keep:
        env["PARFASTAAI_BENCH_KEEP"] = "1"
    result, lines = _run(env)
    assert len(lines) == 1 and result["exact_wall_seconds"] > 0
    assert dict(os.environ) == before
    assert os.listdir(cwd) == []
    db = f"pfaai_bench_synth{G}.db"
    kept = sorted(set(os.listdir(tmp)) - {db})
    assert db in os.listdir(tmp)
    if keep:
        assert len(kept) == 1 and kept[0].startswith("pfaai_bench_e2e_")
        assert sorted(os.listdir(tmp / kept[0])) == sorted(
            os.path.basename(_csv(".", leg))
            for leg in ("fused", "streamed", "exact"))
    else:
        assert kept == []


def test_generated_database_is_the_jax_bench_file(tmp_path):
    """The e2e database the port generates has the bytes of the one the
    JAX bench generates (same generator, same arguments), so the shared
    name in the temporary directory is safe."""
    got = tmp_path / "port.db"
    want = tmp_path / "jax.db"
    bench.bench_db({"PARFASTAAI_BENCH_DB": str(got)}, 24)
    jax_generate(str(want), n_genomes=24, n_proteins=80, pool_size=1200,
                 tetras_per_genome=400, seed=0)
    assert (hashlib.sha256(got.read_bytes()).hexdigest()
            == hashlib.sha256(want.read_bytes()).hexdigest())


@pytest.mark.parametrize(
    "band,chunk,mirror",
    [(1024, 4096, None), (7, 5, None), (8, 8, None), (7, 5, "1"),
     (16, 3, "1")])
def test_download_bytes_equal_the_engines_blocks(e2e_db, tmp_path,
                                                 monkeypatch, band, chunk,
                                                 mirror):
    """The bench's download counts against the bytes of every block the
    two engines hand to ``_BlockDownloads.fetch``, symmetric mirror on and
    off (PARFASTAAI_MIRROR_BYTES=1)."""
    if mirror:
        monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", mirror)
    seen = []
    fetch = engine._BlockDownloads.fetch

    def counting(self, compute_block):
        def block():
            b = compute_block()
            seen.append(b.numel() * b.element_size())
            return b
        return fetch(self, block)

    monkeypatch.setattr(engine._BlockDownloads, "fetch", counting)
    db = SCPDatabase(e2e_db[0])
    try:
        presence = db.load_presence()
    finally:
        db.close()
    ids = np.arange(G, dtype=np.int32)
    names = tuple(presence.meta.genome_set)
    cpu = torch.device("cpu")
    engine.compute_streamed(presence, ids, ids, str(tmp_path / "s.csv"),
                            names, names, cpu, band=band, col_chunk=chunk)
    assert sum(seen) == bench.streamed_download_bytes(G, band, chunk)
    seen.clear()
    engine.compute_streamed_exact(presence, ids, ids, str(tmp_path / "e.csv"),
                                  names, names, cpu, band=band,
                                  col_chunk=chunk)
    assert sum(seen) == bench.exact_download_bytes(80, G, 2, band, chunk)


def test_default_device_exits_without_cuda(monkeypatch, tmp_path, e2e_db):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = _env(e2e_db[0], tmp_path / "out")
    del env["PARFASTAAI_BENCH_DEVICE"]
    with pytest.raises(SystemExit) as exc:
        _run(env)
    assert exc.value.code not in (0, None)
    assert not (tmp_path / "out").exists()


def test_two_process_launch_writes_the_same_bytes(e2e_db, tmp_path):
    """Two gloo processes with EXACT_MESH=2,1: process 0 runs the ETL and
    the direct legs, broadcasts the presence, both join the mesh leg; only
    process 0 prints, and the exact and mesh CSVs are the JAX CLI's
    bytes."""
    db, want = e2e_db
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {k: v for k, v in os.environ.items()
            if k not in ("PARFASTAAI_COORDINATOR", "MASTER_ADDR", "RANK",
                         "WORLD_SIZE", "LOCAL_RANK")}
    env = _env(db, tmp_path, PARFASTAAI_BENCH_EXACT_MESH="2,1")
    procs = [subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-m",
         "parfastaai_tpu_torch.bench"],
        env={**base, **env, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
             "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
             "PARFASTAAI_NUM_PROCESSES": "2",
             "PARFASTAAI_PROCESS_ID": str(rank)},
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    ) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=60)
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert outs[1][0] == ""
    lines = outs[0][0].splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert result["phases"]["banded_exact_mesh_bytes_identical"] is True
    assert result["phases"]["presence_broadcast"] > 0
    assert set(result["legs"]) == set(NAMES)
    for leg in ("exact", "exact_mesh"):
        assert _read(_csv(tmp_path, leg)) == _read(want)
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(_csv(tmp_path, leg)) for leg in NAMES)
