"""Share of the entries that the dense exact engine's per-protein G x G
Grams compute which its pairs keep: the program's ``engine.gram`` span
counters, 100 x ``gathered`` (P x pairs) over ``gram_cells`` (P x G x G),
summed over the window's calls."""


def read(run):
    from port_bench import program_spans

    gathered = program_spans.counter_total(run, "engine.gram", "gathered")
    computed = program_spans.counter_total(run, "engine.gram", "gram_cells")
    if not gathered or not computed:
        return None
    return 100.0 * gathered / computed
