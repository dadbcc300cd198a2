"""The harness on the card at a tiny size: a traced run of each cell
reads the device, and the control fails there too.  Skips without a
card; run on the card with

    python -m pytest port_bench/tests/test_pb_cuda.py -q
"""

import os

import pytest
import torch

from port_bench import control, gen, harness
from port_bench.tests.pb_tiny import CELLS, tiny_cell


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_card(monkeypatch, name):
    need_card()
    if name == "avsa-g4096-exact":
        monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    cell = tiny_cell(name, n_genomes=300)
    r = harness.run_cell(cell, 2**31 + 17, 1.0, True, device="cuda",
                         log=open(os.devnull, "w"))
    assert r["correct"], r
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] < r["device"]["window_s"]
    metrics = r["metrics"]
    assert 0 < metrics["device_idle_pct"]["value"] < 100
    assert 0 < metrics["count_roofline_pct"]["value"] <= 100
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(tmp_path, name):
    need_card()
    cell = tiny_cell(name)
    dbs = gen.make(cell.config, 2**31 + 18, str(tmp_path))
    numbers = control.control_numbers(cell, dbs, 2**31 + 18, "cuda")
    _, limits = harness.compared(cell)
    assert not harness.passes(
        {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()})
