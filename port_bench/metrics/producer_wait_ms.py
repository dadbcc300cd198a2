"""Milliseconds a call's block producer waits on the banded engine's full
queue or for a free page-locked buffer: the program's spans
``engine.producer_wait`` summed within the call, the mean over the
window's calls."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "engine.producer_wait")
