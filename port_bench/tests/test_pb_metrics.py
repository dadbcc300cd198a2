"""The metric arithmetic: the counts' MACs and bytes from shapes, and the
device readings from a synthetic profiler trace."""

import json

import numpy as np
import pytest

from port_bench import harness, peaks, trace

H100 = "NVIDIA H100 80GB HBM3"


def test_counts_from_shapes():
    widths = np.full(80, 1200)
    avsa = harness.pairs_per_call({"mode": "all_vs_all", "n_genomes": 4096})
    qdb = harness.pairs_per_call({"mode": "query_target", "n_genomes": 4096,
                                  "n_query_genomes": 256})
    assert (avsa, qdb) == (8386560, 1048576)
    assert peaks.count_macs(widths, avsa) == 80 * 1200 * 8386560
    assert peaks.count_bytes(widths, 4096, avsa) == (
        80 * 1200 * 4096 + 8 * 8386560)
    # all-vs-all is bound by its operations, the query set by its bytes
    assert peaks.least_seconds(widths, 4096, avsa, H100) == pytest.approx(
        80 * 1200 * 8386560 / 989.5e12)
    assert peaks.least_seconds(widths, 4352, qdb, H100) == pytest.approx(
        (80 * 1200 * 4352 + 8 * 1048576) / 3.35e12)
    assert peaks.least_seconds(widths, 4096, avsa, "cpu") is None
    # uneven widths count each protein's own
    assert peaks.count_macs(np.array([3, 5]), 7) == 56


def test_interval_arithmetic():
    u = trace.union([(5, 6), (0, 2), (1, 3), (3, 4)])
    assert u == [(0, 4), (5, 6)]
    assert trace.gaps(u, -1, 8) == [(-1, 0), (4, 5), (6, 8)]
    assert trace.clip(u, 1, 5.5) == [(1, 4), (5, 5.5)]
    assert trace.length(u) == 5


def synthetic_trace(path):
    """A window of 10 s (us 1e6..11e6) with two calls: a kernel and a copy
    that overlap, a memset, a kernel outside the window, and the spans."""
    def x(cat, name, t0, t1):
        return {"ph": "X", "cat": cat, "name": name, "ts": t0 * 1e6,
                "dur": (t1 - t0) * 1e6}

    events = [
        x("user_annotation", "pb.window", 1, 11),
        x("user_annotation", "pb.call", 1, 6),
        x("user_annotation", "pb.etl", 1, 3),
        x("user_annotation", "pb.engine", 3, 6),
        x("user_annotation", "pb.call", 6, 10.5),
        x("user_annotation", "pb.etl", 6, 8),
        x("user_annotation", "pb.engine", 8, 10),
        x("user_annotation", "other", 0, 12),
        x("cpu_op", "aten::mm", 3, 4),
        x("kernel", "gemm", 3.0, 3.5),
        x("gpu_memcpy", "Memcpy DtoH", 3.25, 3.75),
        x("kernel", "gemm", 8.0, 8.5),
        x("gpu_memset", "Memset", 9.0, 9.25),
        x("kernel", "late", 11.5, 12),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 2e6},
    ]
    with open(path, "w") as fp:
        json.dump({"traceEvents": events}, fp)


def test_device_readings_from_a_trace(tmp_path):
    path = str(tmp_path / "t.json")
    synthetic_trace(path)
    tr = trace.read_trace(path)
    assert tr.window_s == pytest.approx(10)
    busy = trace.length(tr.busy())
    assert busy == pytest.approx(0.75 + 0.5 + 0.25)
    run = harness.Run(cell=None, device_name=H100, seconds=10,
                      pairs_per_call=8386560, widths=np.full(80, 1200),
                      n_genomes=4096, calls=[(True, 5), (True, 4.5)],
                      trace=tr)
    idle = harness.reader("device_idle_pct")(run)
    assert idle == pytest.approx(100 * (1 - 1.5 / 10))
    kernel_s = 1.0  # both gemms; copies and memsets left out
    roof = harness.reader("count_roofline_pct")(run)
    assert roof == pytest.approx(
        100 * 2 * 80 * 1200 * 8386560 / 989.5e12 / kernel_s)
    assert tr.top_ops(2) == [["gemm", pytest.approx(1.0)],
                             ["Memcpy DtoH", pytest.approx(0.5)]]
    by = dict(tr.idle_by_span())
    assert by["etl"] == pytest.approx(4.0)
    assert by["engine"] == pytest.approx(5.0 - 1.5)
    assert by["cli"] == pytest.approx(0.5)
    assert by["loop"] == pytest.approx(0.5)
    assert sum(by.values()) == pytest.approx(10 - 1.5)


def test_readers_find_nothing_where_nothing_ran():
    run = harness.Run(cell=None, device_name="cpu", seconds=1,
                      pairs_per_call=10, widths=np.ones(2), n_genomes=4)
    for name in ("etl_ms", "finish_ms", "csv_write_ms", "device_idle_pct",
                 "count_roofline_pct", "pairs_per_s", "peak_host_rss_gib"):
        assert harness.reader(name)(run) is None


def test_span_readers():
    spans = trace.Spans()
    spans.records = [(0, "etl", 0.0, 1.0), (0, "csv", 2.0, 2.5),
                     (1, "etl", 3.0, 5.0), (1, "csv", 6.0, 6.25)]
    spans.phases = [(0, {"host finish": 0.4, "Gram": 0.1}),
                    (1, {"host finish": 0.6})]
    run = harness.Run(cell=None, device_name="cpu", seconds=1,
                      pairs_per_call=10, widths=np.ones(2), n_genomes=4,
                      spans=spans)
    assert harness.reader("etl_ms")(run) == pytest.approx(1500)
    assert harness.reader("finish_ms")(run) == pytest.approx(500)
    assert harness.reader("csv_write_ms")(run) == pytest.approx(375)
    spans.phases.append((1, {"CSV write": 0.2}))
    assert harness.reader("csv_write_ms")(run) == pytest.approx(200)


def test_rate_over_the_window():
    run = harness.Run(cell=None, device_name="cpu", seconds=10,
                      pairs_per_call=1000, widths=np.ones(2), n_genomes=4,
                      window_s=12.0, calls=[(True, 4), (True, 4), (False, 1),
                                            (True, 3)])
    assert harness.reader("pairs_per_s")(run) == pytest.approx(3000 / 12)
