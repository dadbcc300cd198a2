"""Milliseconds a call spends in the CLI's own work: the program's spans
``cli.open`` (database open and metadata; ``-r``: the ATTACH and the SCP
join) and ``cli.pairs`` (the pair space and the route), the mean over the
window's calls."""


def read(run):
    from port_bench import program_spans

    return program_spans.mean_ms(run, "cli.open", "cli.pairs")
