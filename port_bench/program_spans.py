"""The program's own spans in a traced run.

Inside the traced window ``torch.profiler`` records on the calling thread,
so each ``cli.run`` call of the program records its spans
(``parfastaai_tpu_torch.utils.timing``: name, id, parent, call, thread,
start and end on ``time.perf_counter()``, counters), worker threads'
included, and keeps its last calls in memory.  This module reads them
after the window, gives each to the benchmark call whose ``call`` span
(``run.spans.records``, host clock) contains its ``cli.run`` span, and maps
them onto the profiler trace's clock by the median offset between the
``call`` spans' host stamps and their trace stamps (``run.trace.spans``).

A program without the recorder (or a run without spans) gives nothing:
every function here returns an empty result, and each reader None.
"""

from __future__ import annotations

import statistics

from . import trace


def recorded(run) -> list:
    """``(benchmark call number, program call)`` for each call the program
    recorded inside one of the window's calls, in call order."""
    if run.spans is None:
        return []
    try:
        from parfastaai_tpu_torch.utils import timing

        calls = list(timing.calls)
    except (ImportError, AttributeError):
        return []
    windows = [(call, t0, t1) for call, name, t0, t1 in run.spans.records
               if name == "call"]
    out = []
    for c in calls:
        root = next((s for s in c.spans if s.name == "cli.run"), None)
        if root is None:
            continue
        for number, t0, t1 in windows:
            if t0 <= root.start and root.end <= t1:
                out.append((number, c))
                break
    return out


def per_call(run, *names: str) -> list[float]:
    """Seconds in the spans ``names`` of each benchmark call that has one,
    summed within the call."""
    out: dict[int, float] = {}
    for number, c in recorded(run):
        for s in c.spans:
            if s.name in names:
                out[number] = out.get(number, 0.0) + (s.end - s.start)
    return list(out.values())


def mean_ms(run, *names: str) -> float | None:
    """Milliseconds a call in the spans ``names``, the mean over the calls
    that have one; None where none has."""
    seconds = per_call(run, *names)
    return 1e3 * sum(seconds) / len(seconds) if seconds else None


def counter_total(run, name: str, key: str) -> int | None:
    """The sum of counter ``key`` over every span ``name``; None where no
    such span has it."""
    values = [s.counters[key] for _, c in recorded(run) for s in c.spans
              if s.name == name and key in s.counters]
    return sum(values) if values else None


def offset(run) -> float | None:
    """Seconds to add to a host-clock stamp to put it on the trace's clock:
    the median over the window's calls of the trace's ``call`` span minus
    the benchmark's, at its start and at its end."""
    if run.spans is None or run.trace is None:
        return None
    host = sorted((t0, t1) for _, name, t0, t1 in run.spans.records
                  if name == "call")
    dev = sorted((t0, t1) for name, t0, t1 in run.trace.spans
                 if name == "call")
    diffs = [d - h for hs, ds in zip(host, dev) for h, d in zip(hs, ds)]
    return statistics.median(diffs) if diffs else None


def leaves(run) -> list[tuple[float, float]]:
    """Every leaf span (one that is no span's parent) of the recorded
    calls, on any thread, as ``(start, end)`` on the trace's clock."""
    shift = offset(run)
    if shift is None:
        return []
    out = []
    for _, c in recorded(run):
        parents = {s.parent for s in c.spans}
        out += [(s.start + shift, s.end + shift) for s in c.spans
                if s.id not in parents]
    return out


def overlap(a, b) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_unexplained_share(run) -> float | None:
    """Of the window's device-idle seconds, the share in no leaf program
    span; None without a trace, idle time or recorded calls."""
    if run.trace is None:
        return None
    spans = leaves(run)
    if not spans:
        return None
    idle = trace.gaps(run.trace.busy(), *run.trace.window)
    idle_s = trace.length(idle)
    if idle_s <= 0:
        return None
    return 1.0 - overlap(idle, trace.union(spans)) / idle_s
