"""Tiny cells for the benchmark's CPU tests: the cells of BENCHMARK.json,
and the two cells whose files are kept for a later benchmark (the streamed
mix on the all-vs-all configuration, and the two-database configuration),
with their sizes cut, run on the CPU."""

from __future__ import annotations

import numpy as np

from port_bench import gen, harness

# A change rate well above the configurations' 1%, so that tiny sets
# still differ from genome to genome.
TINY = dict(n_genomes=40, n_proteins=5, tetramers_mean=24, size_log_sd=0.46,
            change_rate=0.2)
CELLS = ("avsa-g4096-exact", "qdb-q256-t4096-exact", "avsa-g4096-streamed")
KEPT = {
    "avsa-g4096-streamed": (
        {"name": "avsa-g4096-streamed", "config": "avsa-g4096",
         "traffic": "streamed", "chips": 1, "why": "--streamed"}, None),
    "qdb-q256-t4096-exact": (
        {"name": "qdb-q256-t4096-exact", "config": "qdb-q256-t4096",
         "traffic": "exact", "chips": 1, "why": "-r"},
        {"name": "qdb-q256-t4096", "source": "-", "reduced": ["n_genomes"],
         "file": "port_bench/configs/qdb-q256-t4096.json", "why": "-r"}),
}


def tiny_cell(name: str, **sizes) -> harness.Cell:
    bench = harness.load_benchmark()
    if name in KEPT:
        workload, config = KEPT[name]
        bench["workloads"].append(workload)
        if config is not None:
            bench["configs"].append(config)
    cell = harness.find_cell(bench, name)
    cell.config.update(TINY, **sizes)
    if cell.config.get("n_query_genomes"):
        cell.config["n_query_genomes"] = 12
    return cell


def write_sets(path: str, sets: list[list[set[int]]], prefix: str = "") -> None:
    """A database whose genome g holds ``sets[g][p]`` for protein p."""
    keys = [np.array(sorted(g * gen.NTETRAMERS + t for g, per in enumerate(sets)
                            for t in per[p]), dtype=np.int64)
            for p in range(len(sets[0]))]
    names = gen.genome_names(prefix, len(sets))
    gen.write_db(path, gen.Collection(names, keys), 0, 0)
