"""The intersection counts' share of their roofline: the least time the
card could take for the window's counts (per call the larger of
sum_p K_p x pairs MACs over the int8 peak and the presence plus one f64 AJI
a pair over the memory bandwidth; ``peaks.py``), over the device time of
every kernel of the window (the union of the profiler's kernels, copies
left out).  Nothing where no kernel ran or the card has no listed peak."""


def read(run):
    if run.trace is None:
        return None
    from port_bench import peaks, trace

    kernel_s = trace.length(run.trace.busy(cats=("kernel",)))
    least = peaks.least_seconds(run.widths, run.n_genomes,
                                run.pairs_per_call, run.device_name)
    calls = sum(ok for ok, _ in run.calls)
    if kernel_s <= 0 or least is None or not calls:
        return None
    return 100.0 * least * calls / kernel_s
