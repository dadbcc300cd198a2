"""Milliseconds of the engine's own ``host finish`` phase per call (the
f64 finish; in the banded exact engine the worker's busy time), the mean
over the window's calls that have one."""


def read(run):
    per_call = run.spans.phase_per_call("host finish") if run.spans else []
    return 1e3 * sum(per_call) / len(per_call) if per_call else None
