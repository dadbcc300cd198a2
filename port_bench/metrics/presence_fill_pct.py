"""Share of the presence tensor's bytes that hold a tetramer column of
their protein: the program's ``etl`` span counters, 100 x ``useful_bytes``
(G x the sum of the proteins' widths) over ``presence_bytes`` (P x G x K,
padded to the widest protein), summed over the window's calls."""


def read(run):
    from port_bench import program_spans

    useful = program_spans.counter_total(run, "etl", "useful_bytes")
    allocated = program_spans.counter_total(run, "etl", "presence_bytes")
    if not useful or not allocated:
        return None
    return 100.0 * useful / allocated
