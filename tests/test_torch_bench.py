"""The port's bench module (``python -m parfastaai_tpu_torch.bench``) on the
CPU: its workload equals bench.py's, its plain-version run prints bench.py's
JSON keys, and its default device exits without CUDA."""

import json

import numpy as np
import pytest
import torch

from parfastaai_tpu_torch import bench

BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "int8_mac_per_s", "mfu",
    "device_kind",
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_workload_equals_bench_py_draw():
    """Slab by slab gives bench.py's one-shot ``rng.random((P, g, pool))``
    draw (main) and its two K-blocked draws (main_kb)."""
    g = 64
    rng = np.random.default_rng(0)
    want = (rng.random((80, g, 1280)) < (400 / 1280)).astype(np.int8)
    m, t = bench.workload(g)
    assert m.shape == (80, g, 1280)
    np.testing.assert_array_equal(m.view(np.int8), want)
    np.testing.assert_array_equal(t, want.sum(axis=2, dtype=np.int32))

    rng = np.random.default_rng(0)
    want_a = (rng.random((2, 8, 300)) < 0.3125).astype(np.int8)
    want_b = (rng.random((2, 5, 300)) < 0.3125).astype(np.int8)
    rng = np.random.default_rng(0)
    got_a = bench.draw_presence(rng, (2, 8, 300), bench.KB_DENSITY)
    got_b = bench.draw_presence(rng, (2, 5, 300), bench.KB_DENSITY)
    np.testing.assert_array_equal(got_a.view(np.int8), want_a)
    np.testing.assert_array_equal(got_b.view(np.int8), want_b)


@pytest.mark.parametrize(
    "env",
    [
        {"PARFASTAAI_BENCH_G": "256"},
        {"PARFASTAAI_BENCH_MODE": "kb", "PARFASTAAI_BENCH_KB_P": "1",
         "PARFASTAAI_BENCH_KB_A": "8", "PARFASTAAI_BENCH_KB_B": "8",
         "PARFASTAAI_BENCH_KB_K": "32832"},
        *({"PARFASTAAI_BENCH_G": "256", "PARFASTAAI_BENCH_VARIANT": v}
          for v in ("pipe", "mxu_outer", "f32gram")),
    ],
    ids=["kernel", "kb", "pipe", "mxu_outer", "f32gram"],
)
def test_cpu_plain_run_prints_one_json_line(capsys, env):
    env = {"PARFASTAAI_BENCH_DEVICE": "cpu", "PARFASTAAI_BENCH_STEPS": "1",
           "PARFASTAAI_BENCH_REPS": "1", **env}
    result = bench.main(env)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0]) == result
    assert set(result) == BENCH_KEYS
    assert result["mfu"] is None and result["device_kind"] == "cpu"
    assert result["value"] > 0 and result["int8_mac_per_s"] > 0
    assert "plain cpu" in result["metric"]
    variant = env.get("PARFASTAAI_BENCH_VARIANT")
    assert (f"variant={variant}" in result["metric"]) == bool(variant)


@pytest.mark.parametrize(
    "variant,kernel,macs",
    [
        ("lean", "sn_square_wgmma", 528 * 128 * 128 * 80 * 1280),
        ("base", "sn_square_wgmma", 528 * 128 * 128 * 80 * 1280),
        ("fused", "sn_square_wgmma", 528 * 128 * 128 * 80 * 1280),
        ("counts", "sn_square_wgmma", 528 * 128 * 128 * 80 * 1280),
        ("pipe", "sn_square_wgmma", 528 * 128 * 128 * 80 * 1280),
        ("mxu_outer", "sn_square_wgmma", 528 * 128 * 128 * 80 * 1280),
        ("f32gram", "sn_square_wgmma", 528 * 128 * 128 * 80 * 1280),
    ],
)
def test_cuda_run_counts_the_macs_of_the_kernel_that_ran(variant, kernel,
                                                         macs):
    """On the card the bench names the variant's kernel and counts the MACs
    of that kernel's tiles: 528 triu tiles of 128 on the wgmma kernel, for
    every variant ('f32gram' runs lean's body): 8.858e11; a call that took
    the time of the card's dense int8 peak would read that peak."""
    assert bench.cuda_kernel_and_macs(variant, 4096) == (kernel, macs)
    peak_ms = macs / bench.int8_peak("NVIDIA H100 80GB HBM3") * 1e3
    result = bench._result("m", 1.0, macs, peak_ms, torch.device("cpu"))
    assert result["int8_mac_per_s"] == pytest.approx(989.5e12)


def test_default_device_exits_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main({})
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize(
    "env,match",
    [
        ({"PARFASTAAI_BENCH_APPROX": "1", "PARFASTAAI_BENCH_PRECISE": "1"},
         "both"),
        ({"PARFASTAAI_BENCH_MODE": "e2e"}, "not ported"),
        ({"PARFASTAAI_BENCH_MODE": "kb", "PARFASTAAI_BENCH_KB_K": "1280"},
         "exists for"),
    ],
    ids=["approx_precise", "e2e", "kb_narrow"],
)
def test_bad_knobs_exit(env, match):
    with pytest.raises(SystemExit, match=match):
        bench.main({"PARFASTAAI_BENCH_DEVICE": "cpu", **env})


def test_int8_peaks():
    assert bench.int8_peak("NVIDIA H100 80GB HBM3") == 989.5e12
    assert bench.int8_peak("NVIDIA H100 PCIe") == 756.5e12
    assert bench.int8_peak("NVIDIA A100-SXM4-80GB") is None


MESH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "direct_ms",
    "direct_pairs_per_sec", "mesh_vs_direct_1gpu", "shapes", "device_kind",
}
MESH_ENV = {"PARFASTAAI_BENCH_MODE": "mesh", "PARFASTAAI_BENCH_DEVICE": "cpu",
            "PARFASTAAI_BENCH_G": "64", "PARFASTAAI_BENCH_STEPS": "1",
            "PARFASTAAI_BENCH_REPS": "1"}


@pytest.mark.parametrize(
    "world,g,want",
    [(1, 4096, [(1, 1)]),
     (2, 4096, [(1, 1), (2, 1)]),
     (3, 4096, [(1, 1), (2, 1)]),
     (4, 4096, [(1, 1), (2, 1), (4, 1), (2, 2)]),
     (8, 4096, [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2)]),
     (4, 6, [(1, 1), (2, 1), (2, 2)])],
)
def test_mesh_shapes_as_bench_py_sweeps_them(world, g, want):
    assert bench.mesh_shapes(world, g) == want


def test_mesh_mode_one_process(capsys):
    """One process: the (1, 1) mesh and the direct leg, one JSON line."""
    result = bench.main(MESH_ENV)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == MESH_KEYS
    assert [e["mesh"] for e in result["shapes"]] == ["1x1"]
    assert result["shapes"][0]["efficiency_vs_1gpu"] == 1.0
    assert result["value"] == result["shapes"][0]["pairs_per_sec"] > 0
    assert result["direct_pairs_per_sec"] > 0
    assert "1 process(es)" in result["metric"]


def test_mesh_mode_two_processes(tmp_path):
    """Two gloo processes: process 0 prints the sweep (1x1, 2x1), the
    other prints nothing; both exit 0."""
    import os
    import socket
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {k: v for k, v in os.environ.items()
            if k not in ("PARFASTAAI_COORDINATOR", "MASTER_ADDR", "RANK",
                         "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        ["nice", "-n", "10", sys.executable, "-m",
         "parfastaai_tpu_torch.bench"],
        env={**base, **MESH_ENV, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1",
             "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
             "PARFASTAAI_NUM_PROCESSES": "2",
             "PARFASTAAI_PROCESS_ID": str(rank)},
        cwd=repo, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    ) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=120)
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    assert outs[1][0] == ""
    result = json.loads(outs[0][0])
    assert [e["mesh"] for e in result["shapes"]] == ["1x1", "2x1"]
    assert "2 process(es), gloo" in result["metric"]
