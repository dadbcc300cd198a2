"""Milliseconds a call spends putting the presence on the card (page-locked
copy, transfer and synchronisation): the program's span ``engine.upload``,
the mean over the window's calls."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "engine.upload")
