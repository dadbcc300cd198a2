"""Milliseconds a call of the dense exact engine spends gathering each
pair's denominators out of T (``t[:, denom_a]`` and ``t[:, denom_b]``, two
(P, n_pairs) arrays): the program's span ``engine.finish.gather``, the mean
over the window's calls that have one."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "engine.finish.gather")
