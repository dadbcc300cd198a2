"""The benchmark's generator: determinism, one or two databases from a
seed, the calibration to the source's statistics, and the schema that the
port's ETL reads."""

import json
import os
import sqlite3

import numpy as np
import pytest

from port_bench import gen, harness
from port_bench.tests.pb_tiny import TINY

AVSA = dict(TINY, n_genomes=40)
QDB = dict(AVSA, n_query_genomes=12)


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
