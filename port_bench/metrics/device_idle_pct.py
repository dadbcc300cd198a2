"""Share of the traced window in which the device ran no kernel, copy or
memset (the complement of the union of the profiler's device activity)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    from port_bench import trace

    busy = trace.length(run.trace.busy())
    return 100.0 * (1.0 - busy / run.trace.window_s)
