"""Phase timing, peak-RSS reporting, and the program's span recorder.

``phase_timer`` is the equivalent of the reference's timer_impl /
PRINT_RUNTIME_MEMUSED (utils.hpp:100-200): every pipeline phase prints
elapsed wall-clock and peak resident set size.

The recorder keeps spans of one CLI call in memory.  A span has a name, an
id, its parent's id, the call's id, the thread's name, its start and end on
``time.perf_counter()`` and a few integer counters.  ``call`` opens a
recorded call (``cli.run`` does, where a ``torch.profiler`` session records
on its thread, where it has ``--profile``, or inside ``recording()``); each
finished call goes to ``calls``, which keeps the last ``CALLS_KEPT``.
Outside a recorded call ``span`` returns a shared object that does nothing,
unless the caller hands it a ``phases`` dict, which then gets the span's
seconds under ``key`` either way.  Worker threads take part through
``handoff`` (on the starting thread) and ``attached`` (in the worker).
Spans of the calling thread are also ``record_function("pfaai.<name>")``
ranges, so a profiler trace shows them on the device's clock;
``append_to_chrome_trace`` adds every span, worker threads' too, to an
exported trace.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import resource
import sys
import threading
import time
from dataclasses import dataclass, field

# Finished calls kept in ``calls``.
CALLS_KEPT = 64
# The prefix of the spans' ``record_function`` ranges.
PREFIX = "pfaai."


def peak_rss_mb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


@dataclass
class Span:
    name: str
    id: int
    parent: int | None
    call: int
    thread: str
    start: float = 0.0
    end: float = 0.0
    key: str | None = None  # the ``phases`` key its seconds went to
    counters: dict[str, int] = field(default_factory=dict)


@dataclass
class Call:
    """One recorded call: its spans, in the order they closed, and the
    (perf_counter, time_ns) pair read at its start, which maps its spans
    onto the wall clock."""

    id: int
    perf_anchor: float
    wall_anchor_ns: int
    spans: list[Span] = field(default_factory=list)


calls: collections.deque[Call] = collections.deque(maxlen=CALLS_KEPT)
_ids = itertools.count(1)
_local = threading.local()


class _Frame:
    """A thread's place in a recorded call: its open spans, and the parent
    of its outermost span (a worker's: the span that started it)."""

    __slots__ = ("call", "parent", "stack", "main")

    def __init__(self, call: Call, parent: int | None, main: bool):
        self.call, self.parent, self.main = call, parent, main
        self.stack: list[Span] = []

    def top(self) -> int | None:
        return self.stack[-1].id if self.stack else self.parent


class _Null:
    """The span outside a recorded call with no ``phases``: nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


class _Open:
    __slots__ = ("_frame", "_phases", "_key", "_span", "_rf", "_t0")

    def __init__(self, name, frame, phases, key):
        self._frame, self._phases, self._key = frame, phases, key
        self._span = self._rf = None
        if frame is not None:
            self._span = Span(name, next(_ids), frame.top(), frame.call.id,
                              threading.current_thread().name, key=key)

    def __enter__(self):
        if self._span is not None:
            self._frame.stack.append(self._span)
            if self._frame.main:
                from torch.profiler import record_function

                self._rf = record_function(PREFIX + self._span.name)
                self._rf.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self._phases is not None:
            self._phases[self._key] = (
                self._phases.get(self._key, 0.0) + (t1 - self._t0))
        if self._span is not None:
            self._span.start, self._span.end = self._t0, t1
            self._frame.stack.pop()
            self._frame.call.spans.append(self._span)
            if self._rf is not None:
                self._rf.__exit__(*exc)
        return False


def span(name: str, phases: dict | None = None, key: str | None = None):
    """A context manager timing its body as span ``name`` of this thread's
    recorded call, if any; with ``phases``, the body's seconds are added to
    ``phases[key]`` too (the same seconds as the span's)."""
    frame = getattr(_local, "frame", None)
    if frame is None and phases is None:
        return _NULL
    return _Open(name, frame, phases, key)


def record(name: str, start: float, end: float,
           phases: dict | None = None, key: str | None = None) -> None:
    """A span timed by the caller (``start``, ``end`` on perf_counter),
    child of this thread's open span; ``phases[key]`` gets its seconds."""
    if phases is not None:
        phases[key] = phases.get(key, 0.0) + (end - start)
    frame = getattr(_local, "frame", None)
    if frame is not None:
        frame.call.spans.append(
            Span(name, next(_ids), frame.top(), frame.call.id,
                 threading.current_thread().name, start, end, key))


def count(**counters) -> None:
    """Adds to the counters of this thread's innermost open span."""
    frame = getattr(_local, "frame", None)
    if frame is not None and frame.stack:
        top = frame.stack[-1]
        for k, v in counters.items():
            top.counters[k] = top.counters.get(k, 0) + int(v)


def active() -> bool:
    """True inside a recorded call on this thread."""
    return getattr(_local, "frame", None) is not None


def _profiling() -> bool:
    """True where a ``torch.profiler`` session records on this thread."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


@contextlib.contextmanager
def recording():
    """Records every call that its body opens on this thread (``call``),
    as a profiler session would."""
    before = getattr(_local, "forced", False)
    _local.forced = True
    try:
        yield
    finally:
        _local.forced = before


@contextlib.contextmanager
def call(force: bool = False):
    """One call, recorded as span ``cli.run`` under a new call id where
    ``force``, ``recording()`` or a profiler session on this thread asks for
    it; gives the ``Call`` or, unrecorded, None.  A call opened inside a
    recorded one is part of it."""
    if active() or not (force or getattr(_local, "forced", False)
                        or _profiling()):
        yield None
        return
    c = Call(next(_ids), time.perf_counter(), time.time_ns())
    _local.frame = _Frame(c, None, main=True)
    try:
        with span("cli.run"):
            yield c
    finally:
        _local.frame = None
        calls.append(c)


def handoff():
    """What a thread that this one starts needs to record into this
    thread's call under its innermost open span (None when unrecorded)."""
    frame = getattr(_local, "frame", None)
    return None if frame is None else (frame.call, frame.top())


@contextlib.contextmanager
def attached(handed):
    """The body (a worker thread's) records into the call of ``handoff``'s
    result; a no-op for None."""
    if handed is None:
        yield
        return
    _local.frame = _Frame(handed[0], handed[1], main=False)
    try:
        yield
    finally:
        _local.frame = None


@contextlib.contextmanager
def phase_timer(label: str, out=sys.stdout, enabled: bool = True,
                name: str | None = None):
    """Prints ``label``'s wall and the peak RSS when ``enabled`` and the body
    ends without an error; records the body as span ``name`` where given."""
    with span(name) if name else _NULL:
        start = time.monotonic()
        yield
        if enabled:
            elapsed_ms = (time.monotonic() - start) * 1000.0
            print(
                f"{label}: {elapsed_ms:.1f} ms; peak RSS {peak_rss_mb():.1f} MB",
                file=out,
            )


def chrome_events(c: Call, base_ns: int = 0) -> list:
    """The spans of call ``c`` as Chrome trace events: ``X`` events in µs
    since ``base_ns`` on the wall clock (the profiler's
    ``baseTimeNanoseconds``), one thread id a thread, named by ``M``
    events."""
    pid = os.getpid()
    # Track ids of their own, clear of the profiler's (the OS's) thread ids.
    tids: dict[str, int] = {}
    events = []

    def us(t: float) -> float:
        return (c.wall_anchor_ns - base_ns + (t - c.perf_anchor) * 1e9) / 1e3

    for s in c.spans:
        if s.thread not in tids:
            tids[s.thread] = 0x7FFF0000 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tids[s.thread],
                           "args": {"name": "pfaai " + s.thread}})
        events.append({
            "ph": "X", "cat": "pfaai_span", "name": s.name, "pid": pid,
            "tid": tids[s.thread], "ts": us(s.start),
            "dur": (s.end - s.start) * 1e6,
            "args": {"id": s.id, "parent": s.parent, "call": s.call,
                     **s.counters}})
    return events


def append_to_chrome_trace(path: str, c: Call) -> None:
    """Adds the spans of call ``c`` to the Chrome trace at ``path`` (one of
    ``torch.profiler``'s, whose ``ts`` plus ``baseTimeNanoseconds`` / 1e3
    is the wall clock in µs)."""
    with open(path) as fp:
        trace = json.load(fp)
    trace["traceEvents"].extend(
        chrome_events(c, int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as fp:
        json.dump(trace, fp)
