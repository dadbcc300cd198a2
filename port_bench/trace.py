"""The traced run's instruments: spans around the CLI's calls into each
layer, the device trace of ``torch.profiler``, and the card's clock and
power samples.

Spans come from the benchmark's own wrappers: for the traced window only,
the names that ``parfastaai_tpu_torch.cli`` calls (the databases'
``load_presence``, the engine entries and ``write_aji_csv``) are replaced
by wrappers that time the call on the host clock, mark it in the profiler
(``record_function``), and keep the ``phases`` dict that the CLI hands the
engine.  The wrappers change no argument, so the traced calls take the
timed calls' route.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time
from dataclasses import dataclass, field

# The engine entries the CLI calls, by their names in its module.
ENGINES = ("compute", "compute_fast", "compute_sharded", "compute_streamed",
           "compute_streamed_exact")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "pb."


@dataclass
class Spans:
    """Host-clock spans ``(call, name, start, end)`` and the engines'
    ``phases`` dicts ``(call, phases)`` of the calls so far."""

    call: int = -1
    records: list = field(default_factory=list)
    phases: list = field(default_factory=list)

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        try:
            with record_function(PREFIX + name):
                yield
        finally:
            self.records.append((self.call, name, t0, time.perf_counter()))

    def per_call(self, name: str) -> list[float]:
        """Seconds in span ``name`` of each call that has one."""
        out: dict[int, float] = {}
        for call, n, t0, t1 in self.records:
            if n == name:
                out[call] = out.get(call, 0.0) + t1 - t0
        return list(out.values())

    def phase_per_call(self, key: str) -> list[float]:
        """Seconds of the engines' phase ``key`` in each call that has it."""
        out: dict[int, float] = {}
        for call, phases in self.phases:
            if key in phases:
                out[call] = out.get(call, 0.0) + phases[key]
        return list(out.values())


@contextlib.contextmanager
def instrument(cli, spans: Spans):
    """Wrap the CLI module's calls into the ETL, the engines and the CSV
    writer with spans ``etl``, ``engine`` and ``csv``; restored on exit."""
    saved = []

    def patch(owner, name, wrapper):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, wrapper)

    def engine(fn):
        def wrapped(*args, **kwargs):
            try:
                with spans.span("engine"):
                    return fn(*args, **kwargs)
            finally:
                if kwargs.get("phases") is not None:
                    spans.phases.append((spans.call, dict(kwargs["phases"])))
        return wrapped

    def spanned(fn, name):
        def wrapped(*args, **kwargs):
            with spans.span(name):
                return fn(*args, **kwargs)
        return wrapped

    try:
        for name in ENGINES:
            patch(cli, name, engine(getattr(cli, name)))
        patch(cli, "write_aji_csv", spanned(cli.write_aji_csv, "csv"))
        for cls in (cli.SCPDatabase, cli.QueryTargetDatabase):
            patch(cls, "load_presence", spanned(cls.load_presence, "etl"))
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def union(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def gaps(busy, lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that the disjoint sorted ``busy`` leaves."""
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


@dataclass
class Trace:
    """What the profiler saw, in its own clock (seconds): the window's
    bounds, every device operation ``(name, cat, start, end)`` and every
    benchmark span ``(name, start, end)``."""

    window: tuple[float, float]
    device_ops: list
    spans: list

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, cats=DEVICE_CATS) -> list[tuple[float, float]]:
        """The union of the window's device operations of ``cats``."""
        return clip(union((t0, t1) for _, c, t0, t1 in self.device_ops
                          if c in cats), *self.window)

    def top_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time, by name."""
        total: dict[str, float] = {}
        for name, _, t0, t1 in self.device_ops:
            if t1 > self.window[0] and t0 < self.window[1]:
                total[name] = total.get(name, 0.0) + (t1 - t0)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], seconds] for name, seconds in ranked]

    def idle_by_span(self, n: int = 10) -> list[list]:
        """The device's idle seconds in the window, by the benchmark span
        the host was in (the innermost one: ``etl``, ``engine``, ``csv``;
        ``cli`` in a call outside them, ``loop`` between calls)."""
        idle = gaps(self.busy(), *self.window)
        layers = [(t0, t1, name) for name, t0, t1 in self.spans
                  if name != "call"]
        calls = union((t0, t1) for name, t0, t1 in self.spans
                      if name == "call")
        total: dict[str, float] = {}
        for g0, g1 in idle:
            covered = 0.0
            for t0, t1, name in layers:
                part = min(g1, t1) - max(g0, t0)
                if part > 0:
                    total[name] = total.get(name, 0.0) + part
                    covered += part
            in_call = length(clip(calls, g0, g1))
            total["cli"] = total.get("cli", 0.0) + max(0.0, in_call - covered)
            total["loop"] = total.get("loop", 0.0) + (g1 - g0) - in_call
        ranked = sorted(((k, v) for k, v in total.items() if v > 0),
                        key=lambda kv: -kv[1])
        return [[k, v] for k, v in ranked[:n]]


def read_trace(path: str) -> Trace:
    """A Chrome trace of ``torch.profiler`` over the window, whose
    benchmark spans carry ``PREFIX`` and whose window span is
    ``PREFIX + "window"``."""
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    ops, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        t0 = float(e["ts"]) / 1e6
        t1 = t0 + float(e.get("dur", 0)) / 1e6
        cat, name = e.get("cat"), str(e.get("name", ""))
        if cat in DEVICE_CATS:
            ops.append((name, cat, t0, t1))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            if name == PREFIX + "window":
                window = (t0, t1)
            else:
                spans.append((name[len(PREFIX):], t0, t1))
    if window is None:
        raise RuntimeError(f"{path}: no {PREFIX}window span in the trace")
    return Trace(window=window, device_ops=ops, spans=spans)


class CardSampler:
    """``nvidia-smi``'s SM clock, power draw, power limit and temperature,
    sampled each second while it runs; nothing where there is no
    ``nvidia-smi``."""

    QUERY = "clocks.sm,power.draw,power.limit,temperature.gpu"

    def __init__(self):
        self._proc = None
        self.samples: list[str] = []

    def start(self) -> None:
        try:
            self._proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader", "-lms", "1000"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._proc = None

    def stop(self) -> list[str]:
        if self._proc is not None:
            self._proc.terminate()
            try:
                out, _ = self._proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                out, _ = self._proc.communicate()
            self.samples = [l.strip() for l in out.splitlines() if l.strip()]
            self._proc = None
        return self.samples


def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, one a line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
