"""Milliseconds a call spends filling the presence: the program's spans
``etl.fill`` (the native loader's second SQLite pass, with the first touch
of the zeroed presence's pages), summed over the call's databases, the mean
over the window's calls."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "etl.fill")
