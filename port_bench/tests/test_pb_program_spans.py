"""The readers of the program's own spans (``program_spans.py`` and the
metrics that use it) on synthetic program calls and a synthetic trace:
the clock offset, each reader's value, and None where the run holds no
such span or the program has no recorder."""

import collections

import numpy as np
import pytest

from parfastaai_tpu_torch.utils import timing
from port_bench import harness, program_spans, trace

OFF = 1000.123456  # trace clock minus host clock, seconds


def program_call(number: int, spans: list[tuple]) -> timing.Call:
    """A recorded call from ``(name, parent name, start, end, counters,
    thread)`` rows; a parent is the latest span of that name before it."""
    c = timing.Call(id=number, perf_anchor=0.0, wall_anchor_ns=0)
    ids: dict[str, int] = {}
    for i, (name, parent, t0, t1, counters, thread) in enumerate(spans):
        ids[name] = 100 * number + i
        c.spans.append(timing.Span(name, ids[name], ids.get(parent), number,
                                   thread, t0, t1, None, dict(counters)))
    return c


def row(name, parent, t0, t1, counters=(), thread="MainThread"):
    return (name, parent, t0, t1, dict(counters), thread)


BANDED = program_call(1, [
    row("cli.run", None, 10.1, 19.9),
    row("cli.open", "cli.run", 10.1, 10.3),
    row("cli.pairs", "cli.run", 10.3, 10.4, {"pairs": 8386560}),
    row("etl", "cli.run", 10.4, 13.4,
        {"presence_bytes": 1000, "useful_bytes": 400}),
    row("etl.widths", "etl", 10.4, 11.0),
    row("etl.alloc", "etl", 11.0, 11.1),
    row("etl.fill", "etl", 11.1, 13.0),
    row("engine", "cli.run", 13.4, 19.5, {"blocks": 36, "mirrored": 28}),
    row("engine.bucketize", "engine", 13.4, 14.4),
    row("engine.upload", "engine", 14.4, 14.6),
    row("engine.producer_wait", "engine", 15.0, 15.5),
    row("engine.producer_wait", "engine", 16.0, 16.25),
    row("engine.tail", "engine", 18.0, 19.5),
    row("worker.wait", "engine", 14.6, 19.5, thread="pfaai-exact-finish"),
    row("cli.free", "cli.run", 19.5, 19.9),
])
DENSE_QT = program_call(2, [
    row("cli.run", None, 20.6, 29.9),
    row("cli.open", "cli.run", 20.6, 22.6),
    row("cli.pairs", "cli.run", 22.6, 22.8, {"pairs": 1048576}),
    row("etl", "cli.run", 22.8, 26.8,
        {"presence_bytes": 3000, "useful_bytes": 1400}),
    row("etl.widths", "etl", 22.8, 23.0),
    row("etl.alloc", "etl", 23.0, 23.1),
    row("etl.fill", "etl", 23.1, 24.5),
    row("etl.widths", "etl", 24.5, 24.6),
    row("etl.alloc", "etl", 24.6, 24.7),
    row("etl.fill", "etl", 24.7, 25.3),
    row("etl.merge", "etl", 25.3, 26.8),
    row("engine", "cli.run", 26.8, 29.0),
    row("engine.upload", "engine", 26.8, 27.0),
    row("engine.gram", "engine", 27.0, 27.5),
    row("engine.d2h", "engine", 27.5, 27.6),
    row("engine.finish", "engine", 27.6, 28.9),
    row("csv", "cli.run", 29.0, 29.5, {"rows": 256}),
    row("cli.free", "cli.run", 29.5, 29.9),
])
# A call outside the window's calls (the warm call): never read.
WARM = program_call(3, [row("cli.run", None, 1.0, 2.0),
                        row("etl.fill", "cli.run", 1.0, 2.0)])


def synthetic_run(jitter: float = 0.0) -> harness.Run:
    """Two benchmark calls (host clock [10, 20] and [20.5, 30]) in a window
    of [9.5, 30.5], with the trace's stamps ``OFF`` later (plus
    ``jitter``): a copy during the first call's worker, a kernel in the
    first call's ``etl`` outside its children, and one in the second
    call's ``engine.gram``."""
    rng = np.random.default_rng(7)
    spans = trace.Spans(records=[(0, "call", 10.0, 20.0),
                                 (1, "call", 20.5, 30.0)])
    noise = rng.uniform(-jitter, jitter, size=4)
    device_ops = [("memcpy", "gpu_memcpy", 15.0 + OFF, 16.0 + OFF),
                  ("gemm", "kernel", 13.1 + OFF, 13.3 + OFF),
                  ("gemm", "kernel", 27.0 + OFF, 27.5 + OFF)]
    tr = trace.Trace(
        window=(9.5 + OFF, 30.5 + OFF), device_ops=device_ops,
        spans=[("call", 10.0 + OFF + noise[0], 20.0 + OFF + noise[1]),
               ("call", 20.5 + OFF + noise[2], 30.0 + OFF + noise[3])])
    return harness.Run(cell=None, device_name="NVIDIA H100 80GB HBM3",
                       seconds=21, pairs_per_call=1, widths=np.ones(2),
                       n_genomes=2, calls=[(True, 10), (True, 9.5)],
                       spans=spans, trace=tr)


@pytest.fixture
def recorded(monkeypatch):
    monkeypatch.setattr(timing, "calls",
                        collections.deque([WARM, BANDED, DENSE_QT]))


def test_offset_recovered_within_a_microsecond(recorded):
    run = synthetic_run(jitter=0.4e-6)
    assert abs(program_spans.offset(run) - OFF) < 1e-6
    assert [n for n, _ in program_spans.recorded(run)] == [0, 1]


EXPECTED = {
    "cli_ms": (300 + 2200) / 2,
    "etl_fill_ms": (1900 + 2000) / 2,
    "etl_merge_ms": 1500,
    "presence_fill_pct": 100 * 1800 / 4000,
    "bucketize_ms": 1000,
    "h2d_ms": (200 + 200) / 2,
    "producer_wait_ms": 750,
    "worker_tail_ms": 1500,
    # idle 21 - 1.7 = 19.3 s; in no leaf: [9.5, 10.1], the etl gap [13.0,
    # 13.4] less its kernel, [19.9, 20.6], [28.9, 29.0], [29.9, 30.5]
    "idle_unexplained_pct": 100 * (0.6 + 0.2 + 0.7 + 0.1 + 0.6) / 19.3,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_each_reader_reads_its_spans(metric, recorded):
    got = harness.reader(metric)(synthetic_run())
    assert got == pytest.approx(EXPECTED[metric], rel=1e-9)


ABSENT = {
    "etl_merge_ms": "etl.merge", "bucketize_ms": "engine.bucketize",
    "producer_wait_ms": "engine.producer_wait",
    "worker_tail_ms": "engine.tail", "h2d_ms": "engine.upload",
    "etl_fill_ms": "etl.fill", "cli_ms": ("cli.open", "cli.pairs"),
    "presence_fill_pct": "etl",
}


@pytest.mark.parametrize("metric", sorted(ABSENT))
def test_a_reader_gives_none_without_its_span(metric, monkeypatch):
    gone = ABSENT[metric]
    gone = {gone} if isinstance(gone, str) else set(gone)
    calls = []
    for c in (BANDED, DENSE_QT):
        kept = timing.Call(c.id, 0.0, 0,
                           [s for s in c.spans if s.name not in gone])
        calls.append(kept)
    monkeypatch.setattr(timing, "calls", collections.deque(calls))
    assert harness.reader(metric)(synthetic_run()) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_readers_give_none_without_a_recorder(metric, monkeypatch):
    """A program without the recorder (the parent of the change that
    brought it), a run without spans, and a run whose calls recorded
    nothing: None, and nothing raised."""
    run = synthetic_run()
    monkeypatch.delattr(timing, "calls")
    assert harness.reader(metric)(run) is None
    monkeypatch.setattr(timing, "calls", collections.deque([WARM]),
                        raising=False)
    assert harness.reader(metric)(run) is None
    monkeypatch.setattr(timing, "calls", collections.deque([BANDED]))
    run.spans = run.trace = None
    assert harness.reader(metric)(run) is None


def test_overlap_of_interval_lists():
    a = [(0, 2), (3, 5), (8, 9)]
    b = [(1, 4), (4.5, 8.5)]
    assert program_spans.overlap(a, b) == pytest.approx(1 + 1 + 0.5 + 0.5)
    assert program_spans.overlap(a, []) == 0
