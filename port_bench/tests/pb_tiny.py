"""Tiny cells for the benchmark's CPU tests: the cells of BENCHMARK.json,
the streamed mix on the all-vs-all configuration (its files are kept for a
later cell), and the query-subset cell that a later configuration adds
(the all-vs-all configuration's sets in ``query_subset`` mode), with their
sizes cut, run on the CPU."""

from __future__ import annotations

import numpy as np

from port_bench import gen, harness

# A change rate well above the configurations' 1%, so that tiny sets
# still differ from genome to genome.
TINY = dict(n_genomes=40, n_proteins=5, tetramers_mean=24, size_log_sd=0.46,
            change_rate=0.2)
CELLS = ("avsa-g4096-exact", "qdb-q256-t4096-exact", "avsa-g4096-streamed",
         "qsub-q512-g4096-exact")
# name: (workload entry, configuration entry or None, configuration keys
# set over its file's)
KEPT = {
    "avsa-g4096-streamed": (
        {"name": "avsa-g4096-streamed", "config": "avsa-g4096",
         "traffic": "streamed", "chips": 1, "why": "--streamed"}, None, {}),
    "qdb-q256-t4096-exact": (
        {"name": "qdb-q256-t4096-exact", "config": "qdb-q256-t4096",
         "traffic": "exact", "chips": 1, "why": "-r"},
        {"name": "qdb-q256-t4096", "source": "-", "reduced": ["n_genomes"],
         "file": "port_bench/configs/qdb-q256-t4096.json", "why": "-r"}, {}),
    "qsub-q512-g4096-exact": (
        {"name": "qsub-q512-g4096-exact", "config": "qsub-q512-g4096",
         "traffic": "exact", "chips": 1, "why": "-q"},
        {"name": "qsub-q512-g4096", "source": "-", "reduced": [],
         "file": "port_bench/configs/avsa-g4096.json", "why": "-q"},
        {"mode": "query_subset", "n_query_genomes": 512}),
}


def tiny_cell(name: str, **sizes) -> harness.Cell:
    bench = harness.load_benchmark()
    keys = {}
    if name in KEPT:
        workload, config, keys = KEPT[name]
        bench["workloads"].append(workload)
        if config is not None:
            bench["configs"].append(config)
    cell = harness.find_cell(bench, name)
    cell.config.update({**keys, **TINY, **sizes})
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
