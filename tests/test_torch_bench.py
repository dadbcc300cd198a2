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
