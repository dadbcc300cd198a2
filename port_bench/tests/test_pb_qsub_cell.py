"""The query-subset cell as BENCHMARK.json has it: its configuration, its
pair count, the metrics it reports, and the three readers of the dense
engine's finish split and Gram use on synthetic recorded calls and on a
tiny traced run on the CPU."""

import collections
import dataclasses
import os

import pytest

from parfastaai_tpu_torch import cli
from parfastaai_tpu_torch.utils import timing
from port_bench import harness
from port_bench.tests.pb_tiny import tiny_cell
from port_bench.tests.test_pb_program_spans import (
    BANDED, WARM, program_call, row, synthetic_run)

NAME = "qsub-q512-g4096-exact"
NEW = ("finish_gather_ms", "finish_sum_ms", "gram_used_pct")


def test_find_cell_gives_the_query_subset_cell():
    cell = harness.find_cell(harness.load_benchmark(), NAME)
    config = cell.config
    assert (config["mode"], config["n_query_genomes"], cell.chips) == (
        "query_subset", 512, 1)
    assert cell.traffic["flags"] == [] and cell.traffic["output"] == "exact"
    # avsa-g4096's sets, so its database byte for byte
    avsa = harness.find_cell(harness.load_benchmark(),
                             "avsa-g4096-exact").config
    for key in ("n_genomes", "n_proteins", "tetramers_mean", "size_log_sd",
                "change_rate", "calibration"):
        assert config[key] == avsa[key], key
    assert config["reduced"] == {}
    reported = {m["name"] for m in cell.per_layer}
    assert set(NEW) | {"etl_ms", "csv_write_ms", "count_roofline_pct",
                       "device_idle_pct"} == reported
    assert {m["name"] for m in cell.end_to_end} == {
        "pairs_per_s", "peak_host_rss_gib", "setup_s"}


def test_pairs_a_call_and_the_dense_route():
    config = harness.find_cell(harness.load_benchmark(), NAME).config
    pairs = harness.pairs_per_call(config)
    assert pairs == 512 * (4096 - 512) + 512 * 511 // 2 == 1_965_824
    assert pairs == config["sizes"]["pairs_per_call"]
    # 1.46 GiB of dense host footprint: the default call stays dense
    assert not cli._route_banded_exact(pairs, config["n_proteins"])


def test_the_dense_cells_list_the_new_metrics():
    bench = harness.load_benchmark()
    for name in NEW:
        (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert entry["workloads"] == ["qdb-q256-t4096-exact", NAME]
        assert entry["moves"] == "pairs_per_s"


# A dense -q call inside the second benchmark call of ``synthetic_run``
# ([20.5, 30] on the host clock): 4 proteins, G = 100, 500 pairs.
DENSE_QSUB = program_call(2, [
    row("cli.run", None, 20.6, 29.9),
    row("cli.open", "cli.run", 20.6, 20.7),
    row("cli.queries", "cli.run", 20.7, 20.8, {"queries": 5}),
    row("cli.pairs", "cli.run", 20.8, 21.0, {"pairs": 500}),
    row("etl", "cli.run", 21.0, 24.0),
    row("engine", "cli.run", 24.0, 29.0),
    row("engine.upload", "engine", 24.0, 24.5),
    row("engine.gram", "engine", 24.5, 25.0,
        {"gram_cells": 4 * 100 * 100, "gathered": 4 * 500}),
    row("engine.d2h", "engine", 25.0, 25.2),
    row("engine.finish", "engine", 25.2, 28.9),
    row("engine.finish.gather", "engine.finish", 25.2, 26.6),
    row("engine.finish.sum", "engine.finish", 26.6, 28.8),
    row("csv", "cli.run", 29.0, 29.5, {"rows": 5, "mirrored": 10}),
])
EXPECTED = {"finish_gather_ms": 1400, "finish_sum_ms": 2200,
            "gram_used_pct": 100 * 500 / (100 * 100)}


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_reads_its_span_or_counters(metric, monkeypatch):
    monkeypatch.setattr(timing, "calls",
                        collections.deque([WARM, BANDED, DENSE_QSUB]))
    got = harness.reader(metric)(synthetic_run())
    assert got == pytest.approx(EXPECTED[metric], rel=1e-9)
    # the banded call has neither span nor counters: nothing read
    monkeypatch.setattr(timing, "calls", collections.deque([WARM, BANDED]))
    assert harness.reader(metric)(synthetic_run()) is None


@pytest.mark.parametrize("metric", NEW)
def test_readers_give_none_without_the_recorder(metric, monkeypatch):
    """The parent's program records no such span or counter; a program
    without the recorder; a run without spans: None, nothing raised."""
    run = synthetic_run()
    parent = timing.Call(DENSE_QSUB.id, 0.0, 0, [
        dataclasses.replace(s, counters={}) for s in DENSE_QSUB.spans
        if not s.name.startswith("engine.finish.")])
    monkeypatch.setattr(timing, "calls", collections.deque([parent]))
    assert harness.reader(metric)(run) is None
    monkeypatch.delattr(timing, "calls")
    assert harness.reader(metric)(run) is None
    monkeypatch.setattr(timing, "calls", collections.deque([DENSE_QSUB]),
                        raising=False)
    run.spans = run.trace = None
    assert harness.reader(metric)(run) is None


def test_a_tiny_traced_run_reads_the_new_metrics():
    cell = tiny_cell(NAME)
    g, q = cell.config["n_genomes"], cell.config["n_query_genomes"]
    r = harness.run_cell(cell, 2**31 + 2207, 0.3, True, device="cpu",
                         log=open(os.devnull, "w"))
    assert r["correct"], r
    metrics = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(metrics)
    pairs = q * (g - q) + q * (q - 1) // 2
    assert metrics["gram_used_pct"] == pytest.approx(100 * pairs / g**2)
    assert metrics["finish_gather_ms"] > 0 and metrics["finish_sum_ms"] > 0
