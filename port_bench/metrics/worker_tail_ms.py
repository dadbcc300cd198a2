"""Milliseconds from the banded engine's end mark to its worker's join:
the finish and CSV left after the last block, the program's span
``engine.tail``, the mean over the window's calls."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "engine.tail")
