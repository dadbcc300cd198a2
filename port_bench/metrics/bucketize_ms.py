"""Milliseconds a call spends copying the presence into width buckets on
the host: the program's span ``engine.bucketize``, the mean over the
window's calls that have one."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "engine.bucketize")
