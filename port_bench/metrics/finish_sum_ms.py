"""Milliseconds a call of the dense exact engine spends in its f64
ascending-protein accumulation (``jaccard_finish``): the program's span
``engine.finish.sum``, the mean over the window's calls that have one."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "engine.finish.sum")
