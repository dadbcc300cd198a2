"""Share of the window's device-idle seconds that no leaf span of the
program covers on any thread, the spans put on the trace's clock
(``program_spans.py``): where it is high, code runs that no span names."""


def read(run):
    from port_bench import program_spans

    share = program_spans.idle_unexplained_share(run)
    return None if share is None else 100.0 * share
