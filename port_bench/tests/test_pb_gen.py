"""The benchmark's generator: determinism, one or two databases and a
query list from a seed, the calibration to the source's statistics, the
schema that the port's ETL reads; and what the harness makes of a
configuration's mode (its pair count and the CLI's arguments)."""

import hashlib
import json
import os
import sqlite3

import numpy as np
import pytest

from port_bench import gen, harness
from port_bench.tests.pb_tiny import TINY, tiny_cell

AVSA = dict(TINY, n_genomes=40, mode="all_vs_all")
QDB = dict(AVSA, n_query_genomes=12, mode="query_target")
QSUB = dict(AVSA, n_query_genomes=12, mode="query_subset")


def dump(path):
    conn = sqlite3.connect(path)
    try:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        return {t: conn.execute(f"SELECT * FROM '{t}'").fetchall()
                for t in tables}
    finally:
        conn.close()


def schema(path):
    conn = sqlite3.connect(path)
    try:
        return sorted(conn.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master").fetchall())
    finally:
        conn.close()


@pytest.mark.parametrize("config", [AVSA, QDB], ids=["one", "two"])
def test_same_seed_same_databases(tmp_path, config):
    a, b, c = (tmp_path / x for x in "abc")
    for d in (a, b, c):
        d.mkdir()
    da = gen.make(config, 2**31 + 5, str(a))
    db = gen.make(config, 2**31 + 5, str(b))
    dc = gen.make(config, 2**31 + 6, str(c))
    for name in ("target.db", "query.db") if config is QDB else ("target.db",):
        assert dump(a / name) == dump(b / name)
        assert dump(a / name) != dump(c / name)
    assert np.array_equal(da.widths, db.widths)
    assert (da.query is not None) == (config is QDB) == (dc.query is not None)


def sets_of(rows):
    return {g: set(np.frombuffer(b, "<i4").tolist()) for g, b in rows}


def test_two_databases_share_ancestors_and_proteins(tmp_path):
    d = gen.make(QDB, 11, str(tmp_path))
    t, q = dump(d.target), dump(d.query)
    assert t["protein_index"] == q["protein_index"]
    t_names = {r[0] for r in t["genome_metadata"]}
    q_names = {r[0] for r in q["genome_metadata"]}
    assert len(t_names) == 40 and len(q_names) == 12
    assert not t_names & q_names
    ancestral = gen.ancestors(11, QDB)
    for p, prot in enumerate(gen.protein_names(QDB["n_proteins"])):
        anc = set(ancestral[p].tolist())
        union = set()
        for db in (t, q):
            sets = sets_of(db[f"{prot}_genomes"])
            kept = [len(s & anc) / len(anc) for s in sets.values()]
            assert np.mean(kept) > 0.6 and min(kept) > 0.3
            union |= set().union(*sets.values())
        assert d.widths[p] == len(union)
    assert d.n_genomes == 52


def test_every_seed_draws_the_same_sizes():
    cfg = dict(AVSA, n_proteins=12)
    a, b = gen.ancestors(1, cfg), gen.ancestors(2, cfg)
    sizes_a, sizes_b = ([len(x) for x in a], [len(x) for x in b])
    assert sorted(sizes_a) == sorted(sizes_b)
    assert sizes_a != sizes_b  # in another order
    assert sorted(sizes_a) == gen.set_sizes(12, 24, 0.46).tolist()


@pytest.mark.parametrize("config", [AVSA, QDB], ids=["one", "two"])
def test_every_seed_has_the_same_widths(tmp_path, config):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    wa = gen.make(config, 2**32 + 7, str(a)).widths
    wb = gen.make(config, 2**32 + 8, str(b)).widths
    n = config["n_genomes"] + config.get("n_query_genomes", 0)
    sizes = gen.set_sizes(config["n_proteins"], config["tetramers_mean"],
                          config["size_log_sd"])
    want = sizes + np.rint(n * sizes * config["change_rate"]).astype(int)
    assert sorted(wa) == sorted(wb) == sorted(want)


def test_sets_are_consistent_and_sized(tmp_path):
    cfg = dict(AVSA, n_genomes=200, tetramers_mean=40)
    d = gen.make(cfg, 3, str(tmp_path))
    db = dump(d.target)
    ancestral = gen.ancestors(3, cfg)
    for p, prot in enumerate(gen.protein_names(AVSA["n_proteins"])):
        by_genome = sets_of(db[f"{prot}_genomes"])
        by_tetra = {}
        for tet, blob in db[f"{prot}_tetras"]:
            gids = np.frombuffer(blob, "<i4")
            assert (np.diff(gids) > 0).all()
            for g in gids.tolist():
                by_tetra.setdefault(g, set()).add(tet)
        assert by_genome == by_tetra
        sizes = np.array([len(s) for s in by_genome.values()])
        size = len(ancestral[p])
        assert abs(sizes.mean() - size) < 0.1 * size + 1
        counts = {g: k for g, p, _, k in db["scp_data"] if p == prot}
        assert counts == {g: len(s) for g, s in by_genome.items()}
    for _, blob in db[f"{gen.protein_names(1)[0]}_genomes"]:
        assert (np.diff(np.frombuffer(blob, "<i4")) > 0).all()


@pytest.mark.parametrize("name", ["avsa-g4096", "qdb-q256-t4096"])
def test_calibrated_to_the_source(name):
    """The configurations' sets read what the upstream's Xanthomonas data
    reads: 194 tetramers a set on average, set sizes from ~58 to ~558 over
    the SCPs, about 191 of 194 shared by two genomes and an AJI of about
    0.95 (the configuration files cite each)."""
    with open(os.path.join(harness.HERE, "configs", name + ".json")) as fp:
        cfg = json.load(fp)
    sizes = gen.set_sizes(cfg["n_proteins"], cfg["tetramers_mean"],
                          cfg["size_log_sd"])
    assert 50 <= sizes.min() <= 65 and 520 <= sizes.max() <= 600
    assert abs(sizes.mean() - 194) < 1
    ancestral = gen.ancestors(5, cfg)
    coll, = gen.collections(5, [gen.genome_names("", 12)], ancestral,
                            cfg["change_rate"])
    shared, aji = [], np.zeros((12, 12))
    for keys in coll.sets:
        g, t = np.divmod(keys, gen.NTETRAMERS)
        s = [set(t[g == i].tolist()) for i in range(12)]
        for a in range(12):
            for b in range(a + 1, 12):
                n = len(s[a] & s[b])
                shared.append(n)
                aji[a, b] += n / len(s[a] | s[b]) / len(coll.sets)
    per_set = np.mean(shared) * 194 / sizes.mean()
    assert 188 <= per_set <= 192
    assert 0.947 <= aji[np.triu_indices(12, 1)].mean() <= 0.975


def test_schema_is_synth_dbs(tmp_path):
    from parfastaai_tpu_torch.tools import synth_db

    gen.make(AVSA, 1, str(tmp_path))
    synth = str(tmp_path / "synth.db")
    synth_db.generate(synth, n_genomes=40, n_proteins=AVSA["n_proteins"],
                      pool_size=120, tetras_per_genome=24, seed=0)
    assert schema(tmp_path / "target.db") == schema(synth)


def test_port_etl_reads_it(tmp_path):
    from parfastaai_tpu_torch.etl.database import SCPDatabase

    d = gen.make(AVSA, 9, str(tmp_path))
    db = SCPDatabase(d.target)
    try:
        presence = db.load_presence()
    finally:
        db.close()
    assert list(db.meta.genome_set) == gen.genome_names("", 40)
    assert list(db.meta.protein_set) == gen.protein_names(AVSA["n_proteins"])
    assert np.array_equal(presence.widths, d.widths)
    rows = dump(d.target)
    for p, prot in enumerate(db.meta.protein_set):
        for g, blob in rows[f"{prot}_genomes"]:
            assert presence.t[p, g] == len(blob) // 4
    assert os.path.getsize(d.target) > 0


def test_query_subset_writes_one_database_and_a_list(tmp_path):
    d = gen.make(QSUB, 2**31 + 41, str(tmp_path))
    assert d.query is None
    assert sorted(os.listdir(tmp_path)) == ["queries.txt", "target.db"]
    with open(d.query_list) as fp:
        lines = fp.read().split("\n")
    assert lines[-1] == ""
    names = lines[:-1]
    in_db = [r[0] for r in dump(d.target)["genome_metadata"]]
    assert len(names) == len(set(names)) == 12
    assert set(names) <= set(in_db)
    assert names != sorted(names, key=in_db.index)  # not database order
    assert d.n_genomes == 40 and len(d.widths) == QSUB["n_proteins"]


def test_query_subset_database_is_all_vs_alls(tmp_path):
    """At one seed and G the query subset's database is the all-vs-all
    one, byte for byte, with the same widths."""
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    da = gen.make(AVSA, 2**31 + 42, str(a))
    db = gen.make(QSUB, 2**31 + 42, str(b))
    with open(da.target, "rb") as fa, open(db.target, "rb") as fb:
        assert fa.read() == fb.read()
    assert np.array_equal(da.widths, db.widths)
    assert da.n_genomes == db.n_genomes and da.query_list is None


def test_query_list_follows_the_seed(tmp_path):
    lists = []
    for i, seed in enumerate([2**31 + 43, 2**31 + 43, 2**31 + 44]):
        d = tmp_path / str(i)
        d.mkdir()
        with open(gen.make(QSUB, seed, str(d)).query_list) as fp:
            lists.append(fp.read())
    assert lists[0] == lists[1] != lists[2]
    assert lists[0].split() == gen.query_names(2**31 + 43, QSUB)


@pytest.mark.parametrize("config", [
    dict(QSUB, n_query_genomes=0), dict(QSUB, n_query_genomes=40),
    dict(QSUB, n_query_genomes=41), {k: v for k, v in QSUB.items()
                                      if k != "n_query_genomes"},
    dict(QDB, n_query_genomes=0), dict(AVSA, n_query_genomes=3),
    dict(AVSA, mode="subset"), {k: v for k, v in AVSA.items()
                                if k != "mode"}],
    ids=["q0", "q=g", "q>g", "qsub-no-q", "qdb-q0", "avsa-q", "unknown",
         "no-mode"])
def test_bad_mode_or_query_count_raises(tmp_path, config):
    with pytest.raises(ValueError, match="mode|n_query_genomes"):
        gen.make(config, 1, str(tmp_path))
    with pytest.raises(ValueError, match="mode|n_query_genomes"):
        harness.pairs_per_call(config)
    assert os.listdir(tmp_path) == []


def test_find_cell_checks_the_mode(tmp_path):
    bench = harness.load_benchmark()
    (tmp_path / "bad.json").write_text(json.dumps(dict(QSUB, n_genomes=12)))
    bench["configs"].append({"name": "bad", "file": "bad.json"})
    bench["workloads"].append({"name": "bad-exact", "config": "bad",
                               "traffic": "exact", "chips": 1})
    with pytest.raises(ValueError, match="n_query_genomes"):
        harness.find_cell(bench, "bad-exact", root=str(tmp_path))


def test_pairs_per_call():
    q, g = 512, 4096
    qsub = dict(mode="query_subset", n_genomes=g, n_query_genomes=q)
    assert harness.pairs_per_call(qsub) == 512 * 3584 + 512 * 511 // 2
    assert harness.pairs_per_call(qsub) == 1_965_824
    assert harness.pairs_per_call(dict(QSUB)) == 12 * 28 + 12 * 11 // 2
    with pytest.raises(ValueError, match="unknown mode"):
        harness.pairs_per_call(dict(qsub, mode="all-vs-all"))


def test_argv_names_the_query_list(tmp_path):
    cell = tiny_cell("qsub-q512-g4096-exact")
    d = gen.make(cell.config, 2**31 + 45, str(tmp_path))
    out = str(tmp_path / "o.csv")
    assert harness._argv(cell, d, out, "cpu") == [
        d.target, out, "-q", d.query_list, "--quiet", "--device", "cpu"]


def content_digest(path):
    """The rows of every table, in name and row order (the file's bytes
    also hold the SQLite library's version)."""
    conn = sqlite3.connect(path)
    try:
        h = hashlib.sha256()
        for (t,) in conn.execute("SELECT name FROM sqlite_master WHERE "
                                 "type='table' ORDER BY name"):
            rows = conn.execute(f"SELECT * FROM '{t}' ORDER BY rowid")
            h.update(repr((t, rows.fetchall())).encode())
        return h.hexdigest()
    finally:
        conn.close()


# What the two cells of BENCHMARK.json made before the harness took a third
# mode, at tiny sizes and seed 2**31 + 21: the databases' rows, the widths,
# the CLI's arguments, and the pairs a call at the cells' own sizes.
MADE_BEFORE = {
    "avsa-g4096-exact": dict(
        target="09b214a3cd8f7092973ba5bff9f266f661b9e64c6bc8a892c31e4f2d5fdef21b",
        query=None, widths=[360, 153, 252, 198, 108], n_genomes=40,
        argv=["target.db", "o.csv", "--quiet", "--device", "cuda"],
        pairs_tiny=780, pairs_full=8386560),
    "qdb-q256-t4096-exact": dict(
        target="3325eb1391d6842751c2982e0eb4435562dc0580f136465718dc222c418a38ba",
        query="62e8f394b6007bb88d85777629d6f8c648bebb215211eff07387b5098a6692c1",
        widths=[456, 194, 319, 251, 137], n_genomes=52,
        argv=["target.db", "o.csv", "-r", "query.db", "--quiet", "--device",
              "cuda"],
        pairs_tiny=480, pairs_full=1048576),
}


@pytest.mark.parametrize("name", sorted(MADE_BEFORE))
def test_existing_cells_make_what_they_made(tmp_path, name):
    cell = tiny_cell(name)
    d = gen.make(cell.config, 2**31 + 21, str(tmp_path))
    argv = harness._argv(cell, d, str(tmp_path / "o.csv"), "cuda")
    full = harness.find_cell(harness.load_benchmark(), name).config
    assert dict(
        target=content_digest(d.target),
        query=content_digest(d.query) if d.query else None,
        widths=d.widths.tolist(), n_genomes=d.n_genomes,
        argv=[os.path.relpath(a, tmp_path) if a.startswith(str(tmp_path))
              else a for a in argv],
        pairs_tiny=harness.pairs_per_call(cell.config),
        pairs_full=harness.pairs_per_call(full)) == MADE_BEFORE[name]
    assert d.query_list is None
