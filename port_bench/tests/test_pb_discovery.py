"""A configuration, a traffic mix and a metric are added by adding files
and entries: the harness finds them by name, and no file that was there
changes."""

import hashlib
import json
import os
import shutil

from port_bench import harness

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HOME)


def digests(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_files_make_a_new_cell(tmp_path):
    home = tmp_path / "port_bench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(home)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    old = json.loads(json.dumps(bench))

    # a configuration, a traffic mix and a per-layer metric: new files
    config = json.load(open(home / "configs" / "avsa-g4096.json"))
    config.update(name="avsa-g40", n_genomes=40, n_proteins=4,
                  tetramers_mean=20, change_rate=0.2)
    (home / "configs" / "avsa-g40.json").write_text(json.dumps(config))
    (home / "traffic" / "fast.json").write_text(json.dumps(
        {"flags": ["--fast"], "loop": "closed", "in_flight": 1,
         "output": "f32", "max_abs_gap": 1e-5, "why": "--fast"}))
    (home / "metrics" / "calls_n.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    # ... and entries
    bench["configs"].append({
        "name": "avsa-g40", "source": "test", "reduced": ["n_genomes"],
        "file": "port_bench/configs/avsa-g40.json", "why": "test"})
    bench["workloads"].append({
        "name": "avsa-g40-fast", "config": "avsa-g40", "traffic": "fast",
        "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "calls_n", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "CLI", "moves": "pairs_per_s",
        "workloads": ["avsa-g40-fast"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(bench, "avsa-g40-fast", root=str(tmp_path),
                             home=str(home))
    assert cell.traffic["flags"] == ["--fast"]
    assert cell.config["n_genomes"] == 40
    assert [m["name"] for m in cell.per_layer][-1] == "calls_n"
    result = harness.run_cell(cell, 2**31 + 3, 0.3, True, device="cpu",
                              log=open(os.devnull, "w"))
    assert result["correct"], result
    assert result["metrics"]["calls_n"]["value"] >= 1
    assert {"etl_ms", "csv_write_ms"} <= set(result["metrics"])
    assert "max_abs_gap" in result["checks"]
    plain = harness.run_cell(cell, 2**31 + 4, 0.3, False, device="cpu",
                             log=open(os.devnull, "w"))
    assert set(plain["metrics"]) == {"pairs_per_s", "peak_host_rss_gib",
                                     "setup_s"}

    # nothing that was there changed; the old entries are as they were
    after = digests(home)
    assert {k: after[k] for k in before} == before
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert bench[key][:len(old[key])] == old[key]


def test_new_query_subset_files_make_a_new_cell(tmp_path):
    """A query-subset configuration file and a workload entry, nothing
    else: the cell runs, and the query list reaches the CLI and the
    reference."""
    home = tmp_path / "port_bench"
    shutil.copytree(HOME, home, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(home)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fp:
        bench = json.load(fp)
    config = json.load(open(home / "configs" / "avsa-g4096.json"))
    config.update(name="qsub-q12-g40", mode="query_subset", n_genomes=40,
                  n_query_genomes=12, n_proteins=4, tetramers_mean=20,
                  change_rate=0.2)
    (home / "configs" / "qsub-q12-g40.json").write_text(json.dumps(config))
    bench["configs"].append({
        "name": "qsub-q12-g40", "source": "test", "reduced": ["n_genomes"],
        "file": "port_bench/configs/qsub-q12-g40.json", "why": "test"})
    bench["workloads"].append({
        "name": "qsub-q12-g40-exact", "config": "qsub-q12-g40",
        "traffic": "exact", "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.find_cell(bench, "qsub-q12-g40-exact", root=str(tmp_path),
                             home=str(home))
    result = harness.run_cell(cell, 2**31 + 5, 0.3, False, device="cpu",
                              log=open(os.devnull, "w"))
    assert result["correct"], result
    assert {k: c["value"] for k, c in result["checks"].items()} == {
        "labels_differing": 0, "values_differing": 0,
        "text_rows_differing": 0}
    assert result["attempted"] >= 2 and result["failed"] == 0
    assert result["metrics"]["pairs_per_s"]["value"] > 0
    after = digests(home)
    assert set(after) - set(before) == {"configs/qsub-q12-g40.json"}
    assert {k: after[k] for k in before} == before
