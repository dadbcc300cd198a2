"""The port's own host modules against the JAX package's originals.

Each module that ``parfastaai_tpu_torch`` keeps as its own copy (ETL and
width buckets, the three pair spaces and their axes, E derivation, the
native f64 finish, the float formatter, the CSV writer, the synthetic
database generator) is held against its original on the same inputs, made
from a seed on synthetic databases: arrays equal, floats bit-equal, files
byte-equal.  A last test starts a fresh interpreter, imports the port's
entry modules, runs its CLI on the CPU and checks that neither ``jax`` nor
anything of ``parfastaai_tpu`` was loaded.
"""

import dataclasses
import hashlib
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest

from parfastaai_tpu import constants as jax_constants
from parfastaai_tpu import engine as jax_engine
from parfastaai_tpu import modes as jax_modes
from parfastaai_tpu import native as jax_native
from parfastaai_tpu import types as jax_types
from parfastaai_tpu.etl import database as jax_database
from parfastaai_tpu.etl import derive as jax_derive
from parfastaai_tpu.io import csv_writer as jax_csv
from parfastaai_tpu.io.fmtfloat import format_double as jax_format_double
from parfastaai_tpu.tools import synth_db as jax_synth
from parfastaai_tpu_torch import constants, engine, modes, native, types
from parfastaai_tpu_torch.etl import database, derive
from parfastaai_tpu_torch.io import csv_writer
from parfastaai_tpu_torch.io.fmtfloat import format_double
from parfastaai_tpu_torch.tools import synth_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = [f"synthetic_genome_{i:05d}.fna.gz" for i in (21, 3, 12)]


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 32-genome target DB and a 16-genome query DB with disjoint genome
    names (5 proteins, pool 300, ~100 tetramers per genome)."""
    d = tmp_path_factory.mktemp("torch_host")
    target, query = str(d / "target.db"), str(d / "query.db")
    synth_db.generate(target, n_genomes=32, n_proteins=5, pool_size=300,
                      tetras_per_genome=100, seed=5)
    synth_db.generate(query, n_genomes=16, n_proteins=5, pool_size=300,
                      tetras_per_genome=100, seed=6)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    return target, query


def assert_same_record(got, want):
    """Two dataclass instances of the two packages, field by field."""
    names = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == names
    for name in names:
        assert_same_value(getattr(got, name), getattr(want, name), name)


def assert_same_value(g, w, name=""):
    if dataclasses.is_dataclass(w):
        assert_same_record(g, w)
    elif isinstance(w, np.ndarray):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    elif isinstance(w, list):
        assert len(g) == len(w), name
        for a, b in zip(g, w):
            assert_same_value(a, b, name)
    else:
        assert g == w, name


def _dump(path):
    with sqlite3.connect(path) as conn:
        return "\n".join(conn.iterdump())


def test_constants_and_types_match():
    for name in ("NTETRAMERS", "DEFAULT_SEPARATOR", "LANE", "K_BLOCK",
                 "MAX_K_SINGLE_BLOCK"):
        assert getattr(constants, name) == getattr(jax_constants, name)
    assert {c.name: int(c) for c in types.ErrorCode} == {
        c.name: int(c) for c in jax_types.ErrorCode}
    assert types.PFAAIError is not jax_types.PFAAIError
    err = types.PFAAIError(types.ErrorCode.CONSTRUCT_ERROR, "x")
    ref = jax_types.PFAAIError(jax_types.ErrorCode.CONSTRUCT_ERROR, "x")
    assert str(err) == str(ref) and int(err.code) == int(ref.code)


def test_synth_db_same_rows(tmp_path):
    got, want = str(tmp_path / "port.db"), str(tmp_path / "jax.db")
    kw = dict(n_genomes=12, n_proteins=3, pool_size=120, tetras_per_genome=40,
              seed=9)
    synth_db.generate(got, **kw)
    jax_synth.generate(want, **kw)
    assert _dump(got) == _dump(want)


@pytest.mark.parametrize(
    "widths",
    [
        [58, 558, 130, 131, 400, 90, 300],
        [128],
        [100, 100, 100, 100, 100],
        [1200, 33000, 40000, 70, 1190, 51200],
        list(range(10, 800, 37)),
    ],
)
@pytest.mark.parametrize("max_buckets", [1, 4])
def test_bucket_bounds_match(widths, max_buckets):
    w = np.array(widths, dtype=np.int32)
    order, bounds = database.bucket_bounds(w, max_buckets)
    order_ref, bounds_ref = jax_database.bucket_bounds(w, max_buckets)
    np.testing.assert_array_equal(order, order_ref)
    assert order.dtype == order_ref.dtype
    assert bounds == bounds_ref


def test_presence_single_db_matches(dbs):
    target, _ = dbs
    db, ref = database.SCPDatabase(target), jax_database.SCPDatabase(target)
    try:
        assert_same_record(db.meta, ref.meta)
        np.testing.assert_array_equal(db.load_t_matrix(), ref.load_t_matrix())
        assert_same_record(db.load_presence(), ref.load_presence())
    finally:
        db.close()
        ref.close()


def test_presence_query_target_matches(dbs):
    db = database.QueryTargetDatabase(*dbs)
    ref = jax_database.QueryTargetDatabase(*dbs)
    try:
        assert_same_record(db.meta, ref.meta)
        np.testing.assert_array_equal(db.load_t_matrix(), ref.load_t_matrix())
        assert_same_record(db.load_presence(), ref.load_presence())
    finally:
        db.close()
        ref.close()


def test_presence_without_native_matches(dbs, monkeypatch):
    """The stdlib-sqlite3 ETL (no native library) gives the same tensors as
    the native one."""
    target, _ = dbs
    db = database.SCPDatabase(target)
    try:
        want = db.load_presence()
        monkeypatch.setenv("PARFASTAAI_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_TRIED", False)
        monkeypatch.setattr(native, "_LIB", None)
        assert native.get_lib() is None
        assert_same_record(db.load_presence(), want)
    finally:
        db.close()


def _no_native(monkeypatch):
    monkeypatch.setenv("PARFASTAAI_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.get_lib() is None


def _fail_second_fill(monkeypatch):
    """The native loader fills the target, then fails on the query: the
    Python path refills a fresh union."""
    real, fills = native.native_fill, []

    def fill(*args, **kwargs):
        fills.append(args[0])
        return len(fills) == 1 and real(*args, **kwargs)

    monkeypatch.setattr(native, "native_fill", fill)
    return fills


# (target, query) generator arguments; the query's genome names get a prefix
UNION_PAIRS = {
    # a query from the target's seed shares protein 0's pool and draws the
    # others' afresh; a wider pool adds tetramers the target lacks
    "query_shares_and_adds": (
        dict(n_genomes=32, n_proteins=5, pool_size=300, tetras_per_genome=100,
             seed=5),
        dict(n_genomes=16, n_proteins=5, pool_size=300, tetras_per_genome=100,
             seed=5)),
    "query_wider_pool": (
        dict(n_genomes=32, n_proteins=5, pool_size=300, tetras_per_genome=100,
             seed=5),
        dict(n_genomes=16, n_proteins=5, pool_size=700, tetras_per_genome=150,
             seed=8)),
    # each side under 128 columns, their union over
    "union_crosses_a_lane": (
        dict(n_genomes=24, n_proteins=4, pool_size=100, tetras_per_genome=40,
             seed=11),
        dict(n_genomes=12, n_proteins=4, pool_size=100, tetras_per_genome=40,
             seed=12)),
}


def _make_pair(d, case):
    target, query = str(d / f"{case}_t.db"), str(d / f"{case}_q.db")
    kw_t, kw_q = UNION_PAIRS[case]
    synth_db.generate(target, **kw_t)
    synth_db.generate(query, **kw_q)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    return target, query


@pytest.fixture(scope="module")
def union_pairs(dbs, tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_union")
    return {"fixture": dbs, **{c: _make_pair(d, c) for c in UNION_PAIRS}}


@pytest.mark.parametrize("path", ["native", "no_native", "native_fails_late"])
@pytest.mark.parametrize("case", ["fixture", *UNION_PAIRS])
def test_union_fill_matches(union_pairs, case, path, monkeypatch):
    """The ``-r`` presence filled straight into the union's columns equals
    the JAX package's per-database load and column merge, field by field,
    on the native loader, without it, and where it fails after the target's
    fill."""
    target, query = union_pairs[case]
    fills = []
    if path == "no_native":
        _no_native(monkeypatch)
    elif path == "native_fails_late":
        fills = _fail_second_fill(monkeypatch)
    db = database.QueryTargetDatabase(target, query)
    ref = jax_database.QueryTargetDatabase(target, query)
    try:
        got, want = db.load_presence(), ref.load_presence()
    finally:
        db.close()
        ref.close()
    assert_same_record(got, want)
    assert fills == ([target, query] if path == "native_fails_late" else [])
    if case == "union_crosses_a_lane":
        sides = [database.SCPDatabase(p) for p in (target, query)]
        try:
            side_widths = [s.load_presence().widths for s in sides]
        finally:
            for s in sides:
                s.close()
        assert max(w.max() for w in side_widths) <= constants.LANE
        assert got.widths.max() > constants.LANE
        assert got.m.shape[2] == 2 * constants.LANE


def _corrupt_copy(src, dst, gid):
    """A copy of ``src`` whose first protein's first '_tetras' blob also
    holds genome id ``gid``."""
    with sqlite3.connect(src) as a, sqlite3.connect(dst) as b:
        a.backup(b)
    with sqlite3.connect(dst) as conn:
        (prot,) = conn.execute(
            "SELECT SCP_acc FROM scp_data LIMIT 1").fetchone()
        tet, blob = conn.execute(
            f"SELECT tetramer, genomes FROM '{prot}_tetras' "
            "ORDER BY tetramer LIMIT 1").fetchone()
        conn.execute(f"UPDATE '{prot}_tetras' SET genomes = ? "
                     "WHERE tetramer = ?",
                     (blob + np.int32(gid).tobytes(), tet))


@pytest.mark.parametrize("path", ["native", "no_native"])
@pytest.mark.parametrize("side", ["query", "target"])
def test_union_fill_rejects_an_id_past_its_database(dbs, tmp_path, side,
                                                    path, monkeypatch):
    """A genome id at its own database's genome count, which would still
    fit the union's rows (the query's past them, the target's in the
    query's), is rejected with CONSTRUCT_ERROR, as on a database of its own;
    neither fill writes outside its database's rows."""
    target, query = dbs
    with sqlite3.connect(target) as conn:
        nt = conn.execute("SELECT COUNT(*) FROM genome_metadata").fetchone()[0]
    with sqlite3.connect(query) as conn:
        nq = conn.execute("SELECT COUNT(*) FROM genome_metadata").fetchone()[0]
    bad = str(tmp_path / "bad.db")
    if side == "query":
        _corrupt_copy(query, bad, nq)
        query = bad
    else:
        _corrupt_copy(target, bad, nt)
        target = bad
    if path == "no_native":
        _no_native(monkeypatch)
    db = database.QueryTargetDatabase(target, query)
    try:
        with pytest.raises(types.PFAAIError) as e:
            db.load_presence()
        assert e.value.code == types.ErrorCode.CONSTRUCT_ERROR
        prots = db.meta.protein_set
    finally:
        db.close()
    ref = jax_database.QueryTargetDatabase(target, query)
    try:
        with pytest.raises(jax_types.PFAAIError) as e:
            ref.load_presence()
        assert int(e.value.code) == int(types.ErrorCode.CONSTRUCT_ERROR)
    finally:
        ref.close()

    # the bad database's fill alone, into a zeroed union
    path_bad, n, row0 = (query, nq, nt) if side == "query" else (target, nt, 0)
    ids, widths = [], []
    for p in (target, query):
        w = native.native_widths(p, prots) if path == "native" else None
        if path == "native":
            tets = native.native_tetramer_ids(p, prots, w)
            ids.append([tets[i, :k] for i, k in enumerate(w)])
        else:
            with sqlite3.connect(p) as conn:
                ids.append([np.asarray([r[0] for r in conn.execute(
                    f"SELECT tetramer FROM '{q}_tetras' ORDER BY tetramer")],
                    np.int32) for q in prots])
        widths.append(np.asarray([len(i) for i in ids[-1]], np.int32))
    _, union_w, maps = database._union_columns(ids)
    k = 1 if side == "query" else 0
    m = np.zeros((len(prots), nt + nq, database._padded_width(union_w)),
                 np.uint8)
    t = np.zeros(m.shape[:2], np.int32)
    others = slice(0, nt) if side == "query" else slice(nt, nt + nq)
    if path == "native":
        tets = np.zeros(maps[k].shape, np.int32)
        for i, row in enumerate(ids[k]):
            tets[i, : len(row)] = row
        assert not native.native_fill(path_bad, prots, n, widths[k], m, t,
                                      tets, col_map=maps[k], row0=row0)
    else:
        with sqlite3.connect(path_bad) as conn:
            blobs = [np.frombuffer(b, "<i4") for (b,) in conn.execute(
                f"SELECT genomes FROM '{prots[0]}_tetras' ORDER BY tetramer")]
        with pytest.raises(types.PFAAIError) as e:
            database._scatter_presence(m[0], blobs, n, maps[k][0], row0)
        assert e.value.code == types.ErrorCode.CONSTRUCT_ERROR
    assert not m[:, others].any() and not t[:, others].any()


def test_bucketize_presence_matches(dbs):
    target, _ = dbs
    db, ref = database.SCPDatabase(target), jax_database.SCPDatabase(target)
    try:
        got = database.bucketize_presence(db.load_presence(), max_buckets=3)
        want = jax_database.bucketize_presence(ref.load_presence(),
                                               max_buckets=3)
    finally:
        db.close()
        ref.close()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_value(list(g), list(w))
        assert g[1].flags.c_contiguous


def _metas(dbs):
    target, query = dbs
    db = database.SCPDatabase(target)
    qt = database.QueryTargetDatabase(target, query)
    try:
        return db.meta, qt.meta
    finally:
        db.close()
        qt.close()


def _jax_meta(meta):
    return jax_types.DBMetaData(**dataclasses.asdict(meta))


@pytest.mark.parametrize("mode", ["all", "qsub", "qt", "qt_noswap"])
def test_pair_spaces_match(dbs, mode):
    single, qt = _metas(dbs)
    if mode == "all":
        got = modes.all_vs_all(single)
        want = jax_modes.all_vs_all(_jax_meta(single))
    elif mode == "qsub":
        got = modes.query_subset(single, QUERIES)
        want = jax_modes.query_subset(_jax_meta(single), QUERIES)
    else:
        swap = mode == "qt"
        got = modes.query_target(qt, compat_qt_t_swap=swap)
        want = jax_modes.query_target(_jax_meta(qt), compat_qt_t_swap=swap)
    assert got.n_pairs == want.n_pairs > 0
    assert_same_record(got, want)


@pytest.mark.parametrize("mode", ["all", "qsub", "qt"])
def test_stream_axes_match(dbs, mode):
    single, qt = _metas(dbs)
    if mode == "all":
        got = modes.all_vs_all_axes(single)
        want = jax_modes.all_vs_all_axes(_jax_meta(single))
    elif mode == "qsub":
        got = modes.query_subset_axes(single, QUERIES)
        want = jax_modes.query_subset_axes(_jax_meta(single), QUERIES)
    else:
        got = modes.query_target_axes(qt)
        want = jax_modes.query_target_axes(_jax_meta(qt))
    assert_same_record(got, want)


@pytest.mark.parametrize(
    "bad", [["definitely_not_a_genome"], [QUERIES[0], QUERIES[0]]])
def test_query_subset_rejects_like_the_original(dbs, bad):
    single, _ = _metas(dbs)
    with pytest.raises(jax_types.PFAAIError) as want:
        jax_modes.query_subset(_jax_meta(single), bad)
    with pytest.raises(types.PFAAIError) as got:
        modes.query_subset(single, bad)
    assert int(got.value.code) == int(want.value.code)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", ["single", "qsub", "qt"])
def test_derive_matches(dbs, mode):
    target, query = dbs
    if mode == "qt":
        db = database.QueryTargetDatabase(target, query)
        ref = jax_database.QueryTargetDatabase(target, query)
    else:
        db, ref = database.SCPDatabase(target), jax_database.SCPDatabase(target)
    try:
        if mode == "single":
            got, want = derive.derive_single(db), jax_derive.derive_single(ref)
        elif mode == "qsub":
            got = derive.derive_qsub(db, QUERIES)
            want = jax_derive.derive_qsub(ref, QUERIES)
        else:
            got, want = derive.derive_qt(db), jax_derive.derive_qt(ref)
    finally:
        db.close()
        ref.close()
    assert len(got) == len(want) == 4
    assert len(got[3]) > 0
    for g, w in zip(got, want):
        assert_same_value(g, w)


# The reference's shared-protein join (db_helper.hpp:140-143), the oracle of
# the protein order of a ``-r`` pair.
SCP_JOIN = (
    "SELECT DISTINCT target_table.SCP_acc"
    "  FROM scp_data as target_table, QueryDB.scp_data as query_table"
    "  WHERE target_table.SCP_acc = query_table.SCP_acc")


def _scp_db(path, n_genomes, proteins, layout, seed, *, dup=False,
            index=False, analyze=False):
    """A database of ``genome_metadata`` and ``scp_data`` alone, in the
    benchmark generator's schema: one ``scp_data`` row per (genome,
    protein), written protein-major, genome-major or shuffled; ``dup``
    writes one (genome, protein) row twice; ``index`` adds an index on
    ``SCP_acc``, ``analyze`` runs ANALYZE."""
    rng = np.random.default_rng(seed)
    rows = [(g, p, 100.0 + g, 190) for p in proteins for g in range(n_genomes)]
    if layout == "genome":
        rows.sort(key=lambda r: r[0])
    elif layout == "shuffled":
        rows = [rows[i] for i in rng.permutation(len(rows))]
    if dup:
        rows.insert(len(rows) // 2, rows[-1])
    conn = sqlite3.connect(path)
    try:
        conn.execute(
            "CREATE TABLE 'genome_metadata' (genome_name TEXT, genome_id "
            "INTEGER PRIMARY KEY, genome_length INTEGER, genome_class "
            "INTEGER, SCP_count INTEGER)")
        conn.executemany(
            "INSERT INTO genome_metadata VALUES (?, ?, 3500000, 0, ?)",
            [(f"{os.path.basename(path)}_{g}", g, len(proteins))
             for g in range(n_genomes)])
        conn.execute(
            "CREATE TABLE 'scp_data' (genome_id INTEGER, SCP_acc TEXT, "
            "SCP_score REAL, tetra_count INTEGER)")
        conn.executemany("INSERT INTO scp_data VALUES (?, ?, ?, ?)", rows)
        if index:
            conn.execute("CREATE INDEX scp_acc_index ON scp_data (SCP_acc)")
        if analyze:
            conn.execute("ANALYZE")
        conn.commit()
    finally:
        conn.close()


def _proteins(seed, n, start=0):
    """``n`` accessions from ``start`` on, in a seeded order."""
    names = [f"PF{90000 + i}.1" for i in range(start, start + n)]
    return [names[i] for i in np.random.default_rng(seed).permutation(n)]


# case: ((target genomes, proteins, layout, options),
#        (query genomes, proteins, layout, options))
SCP_PAIRS = {
    "protein_major": ((40, _proteins(1, 12), "protein", {}),
                      (8, _proteins(2, 12), "protein", {})),
    "genome_major": ((40, _proteins(3, 12), "genome", {}),
                     (8, _proteins(4, 12), "genome", {})),
    "shuffled": ((40, _proteins(5, 12), "shuffled", {}),
                 (8, _proteins(6, 12), "shuffled", {})),
    "layouts_differ": ((40, _proteins(7, 12), "genome", {}),
                       (8, _proteins(8, 12), "shuffled", {})),
    "some_in_one_db_only": ((24, _proteins(9, 10), "shuffled", {}),
                            (24, _proteins(10, 10, start=4), "genome", {})),
    "duplicated_row": ((24, _proteins(11, 8), "shuffled", {"dup": True}),
                       (12, _proteins(12, 8), "protein", {"dup": True})),
    "query_larger": ((6, _proteins(13, 9), "shuffled", {}),
                     (60, _proteins(14, 9), "shuffled", {})),
    "query_smaller": ((60, _proteins(15, 9), "genome", {}),
                      (6, _proteins(16, 9), "shuffled", {})),
    "same_size": ((20, _proteins(17, 9), "shuffled", {}),
                  (20, _proteins(18, 9), "genome", {})),
    "indexed_and_analyzed": (
        (40, _proteins(19, 12), "shuffled", {"index": True, "analyze": True}),
        (8, _proteins(20, 12), "shuffled", {"index": True, "analyze": True})),
    # statistics on one side: SQLite 3.40's join then scans the query table
    # first, in an order that a scan of the target does not give
    "target_analyzed": ((40, _proteins(21, 12), "genome", {"analyze": True}),
                        (8, _proteins(22, 12), "shuffled", {})),
    "query_analyzed_target_indexed": (
        (20, _proteins(23, 12), "shuffled", {"index": True}),
        (60, _proteins(24, 12), "genome", {"analyze": True})),
    "nothing_shared": ((16, _proteins(25, 6), "shuffled", {}),
                       (16, _proteins(26, 6, start=6), "shuffled", {})),
}


@pytest.mark.parametrize("case", sorted(SCP_PAIRS))
def test_shared_proteins_in_the_joins_order(case, tmp_path):
    """The ``-r`` protein set equals the reference's join run on the same
    ATTACHed connection, and the JAX package's, tuple for tuple."""
    (nt, pt, lt, kt), (nq, pq, lq, kq) = SCP_PAIRS[case]
    target, query = str(tmp_path / "target.db"), str(tmp_path / "query.db")
    _scp_db(target, nt, pt, lt, seed=nt, **kt)
    _scp_db(query, nq, pq, lq, seed=nq + 1, **kq)
    db = database.QueryTargetDatabase(target, query)
    ref = jax_database.QueryTargetDatabase(target, query)
    try:
        joined = tuple(r[0] for r in db.conn.execute(SCP_JOIN))
        got, want = db.meta.protein_set, ref.meta.protein_set
    finally:
        db.close()
        ref.close()
    assert got == joined == want
    assert set(got) == set(pt) & set(pq)
    assert (len(got) == 0) == (case == "nothing_shared")


def _finish_inputs(dtype):
    rng = np.random.default_rng(11)
    P, n = 7, 501
    ta = rng.integers(1, 400, size=(P, n), dtype=np.int32)
    tb = rng.integers(1, 400, size=(P, n), dtype=np.int32)
    counts = (rng.random((P, n)) * np.minimum(ta, tb)).astype(dtype)
    counts[:, ::5] = 0  # pairs that share nothing for some proteins
    return counts, ta, tb


def _finish_reference(counts, ta, tb):
    """Ascending-protein f64 accumulation, one pair at a time."""
    P, n = counts.shape
    s = np.zeros(n, np.float64)
    nsh = np.zeros(n, np.int32)
    for j in range(n):
        for p in range(P):
            c = int(counts[p, j])
            if c > 0:
                s[j] += np.float64(c) / np.float64(int(ta[p, j]) + int(tb[p, j]) - c)
                nsh[j] += 1
    return s, nsh


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_native_jaccard_finish_bit_equal(dtype):
    counts, ta, tb = _finish_inputs(dtype)
    got = native.native_jaccard_finish(counts, ta, tb)
    want = jax_native.native_jaccard_finish(counts, ta, tb)
    assert got is not None and want is not None
    s_ref, n_ref = _finish_reference(counts, ta, tb)
    for (s, n) in (got, want):
        assert s.dtype == np.float64 and n.dtype == np.int32
        assert s.tobytes() == s_ref.tobytes()
        np.testing.assert_array_equal(n, n_ref)


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_jaccard_finish_without_native_bit_equal(dtype, monkeypatch):
    """PARFASTAAI_NO_NATIVE keeps its meaning: no library, and the NumPy
    twin gives the same f64 bits as the native finish and as the JAX
    package's twin."""
    counts, ta, tb = _finish_inputs(dtype)
    with_lib = native.native_jaccard_finish(counts, ta, tb)
    assert with_lib is not None
    monkeypatch.setenv("PARFASTAAI_NO_NATIVE", "1")
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_TRIED", False)
        monkeypatch.setattr(mod, "_LIB", None)
    assert native.get_lib() is None
    assert native.native_jaccard_finish(counts, ta, tb) is None
    s, n = engine.jaccard_finish(counts, ta, tb)
    s_ref, n_ref = jax_engine.jaccard_finish(counts, ta, tb)
    assert s.tobytes() == s_ref.tobytes() == with_lib[0].tobytes()
    np.testing.assert_array_equal(n, n_ref)
    np.testing.assert_array_equal(n, with_lib[1])


def test_native_library_lives_in_the_port_build_dir():
    """Built from the port's two sources into the port's _build directory,
    under the hash of those sources."""
    assert native.get_lib() is not None
    h = hashlib.sha256()
    for src in native._SRCS:
        assert os.path.dirname(src) == os.path.join(
            REPO, "parfastaai_tpu_torch", "native")
        with open(src, "rb") as fp:
            h.update(fp.read())
    so = os.path.join(REPO, "parfastaai_tpu_torch", "_build",
                      f"pfaai_native_{h.hexdigest()[:16]}.so")
    assert native.BUILD_DIR == os.path.dirname(so)
    assert os.path.exists(so)


DOUBLES = [
    0.0, -0.0, 1.0, 0.5, 1e-4, 9.999e-5, 1e16, 1e15 + 0.5, 5e-324,
    1.7976931348623157e308, 0.9468103868455618, 0.1, 1 / 3, 2 / 3, 123456.789,
    1e-7, 1e22, 1e21, 123456789012345680.0, -0.25, -1e-10,
    float("nan"), float("inf"), float("-inf"),
]


@pytest.mark.parametrize("value", DOUBLES, ids=[repr(v) for v in DOUBLES])
def test_format_double_matches(value):
    assert format_double(value) == jax_format_double(value)


def test_format_double_matches_random():
    rng = np.random.default_rng(3)
    vals = np.concatenate([rng.random(300), rng.random(100) * 1e-6,
                           rng.random(100) * 1e18])
    for v in vals:
        assert format_double(v) == jax_format_double(v)


def test_native_formatter_matches_python(monkeypatch):
    rng = np.random.default_rng(4)
    mat = rng.random((9, 13))
    mat[2, 3] = np.nan
    mat[0, 0] = 0.0
    rows = native.native_format_matrix(mat, ",")
    assert rows is not None
    assert rows == jax_native.native_format_matrix(mat, ",")
    assert [r.decode() for r in rows] == [
        ",".join(format_double(v) for v in row) for row in mat]
    assert native.native_format_row(mat[1], ";") == ";".join(
        format_double(v) for v in mat[1]).encode()


@pytest.mark.parametrize("mode", ["all", "qsub", "qt"])
@pytest.mark.parametrize("sep", [",", ";", "::"])
def test_write_aji_csv_bytes_equal(dbs, tmp_path, mode, sep):
    single, qt = _metas(dbs)
    if mode == "all":
        pairs = modes.all_vs_all(single)
        ref = jax_modes.all_vs_all(_jax_meta(single))
    elif mode == "qsub":
        pairs = modes.query_subset(single, QUERIES)
        ref = jax_modes.query_subset(_jax_meta(single), QUERIES)
    else:
        pairs = modes.query_target(qt)
        ref = jax_modes.query_target(_jax_meta(qt))
    rng = np.random.default_rng(8)
    aji = rng.random(pairs.n_pairs)
    aji[::7] = np.nan
    got, want = tmp_path / "port.csv", tmp_path / "jax.csv"
    csv_writer.write_aji_csv(str(got), pairs, aji, sep)
    jax_csv.write_aji_csv(str(want), ref, aji, sep)
    assert got.read_bytes() == want.read_bytes()
    assert got.stat().st_size > 0


_FRESH = r"""
import sys
import parfastaai_tpu_torch.cli, parfastaai_tpu_torch.engine
import parfastaai_tpu_torch.bench, parfastaai_tpu_torch.ops.sn_square
import parfastaai_tpu_torch.api as api
import parfastaai_tpu_torch.parallel.distributed
from parfastaai_tpu_torch.cli import run
db, out = sys.argv[1:3]
for engine in ("exact", "fast", "sharded", "streamed", "streamed-exact"):
    api.aji_to_csv(out, db, engine=engine, device="cpu")
for flags in (["--streamed", "--profile", out + ".trace"], [], ["--fast"],
              ["--mesh", "1"], ["--streamed", "--mesh", "1"],
              ["--streamed", "--exact", "--mesh", "1"]):
    rc = run([db, out, "--quiet", "--device", "cpu", *flags])
    assert rc == 0, rc
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "parfastaai_tpu"))
assert not bad, bad
print("clean", len(open(out).read().splitlines()))
"""


def test_fresh_process_loads_no_jax_package(dbs, tmp_path):
    """A new interpreter that imports the port's entry modules and runs its
    library API (every engine) and its CLI on the CPU (the mesh too, with
    the streamed engines) loads no ``jax*`` module and nothing of
    ``parfastaai_tpu``."""
    target, _ = dbs
    out = tmp_path / "aji.csv"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-c", _FRESH, target, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["clean", "33"]
