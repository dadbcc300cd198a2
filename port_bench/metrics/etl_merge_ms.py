"""Milliseconds a call spends merging the two databases' presences into
one column space (``-r``): the program's span ``etl.merge``, the mean over
the window's calls that have one."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "etl.merge")
