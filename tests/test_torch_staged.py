"""Staged presence slabs in the port (``engine._use_staged``,
``_SlabStore``, the ``_Staged`` placement under ``_block_sn`` and
``_block_counts``, ``_staged_col_group`` and the staged branches of the
three banded engines) against the JAX package's, on the CPU, on small synthetic
databases (``tools/synth_db``) and a hand-made presence of several width
buckets.

Stated tolerances: the banded exact engine writes the JAX package's bytes
and the resident run's; the f32 engines hold the JAX package's staged
result within rtol 1e-6 with the text ``0`` in the same cells (N equal
for ``compute_fast``), and the resident run's bytes wherever no bucket is
cut into chunks of several proteins.  The JAX package caches its slab
store on the presence object and keys slabs by (bucket, chunk, genomes),
so every JAX call here gets a presence object of its own."""

import dataclasses
import sqlite3
import threading

import numpy as np
import pytest
import torch

from parfastaai_tpu import engine as jax_engine
from parfastaai_tpu import modes as jax_modes
from parfastaai_tpu.etl.database import (
    PresenceData,
    QueryTargetDatabase,
    SCPDatabase,
    bucket_bounds,
)
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu.types import DBMetaData
from parfastaai_tpu_torch import engine, modes

CPU = torch.device("cpu")
RTOL = 1e-6
QUERIES = (31, 0, 7, 12, 5)  # another order than the database's


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 40-genome target DB (7 proteins, pool 300, ~100 tetramers per
    genome: one width bucket of 384) and a 24-genome query DB with
    disjoint genome names."""
    d = tmp_path_factory.mktemp("torch_staged")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=40, n_proteins=7, pool_size=300,
             tetras_per_genome=100, seed=1)
    generate(query, n_genomes=24, n_proteins=7, pool_size=300,
             tetras_per_genome=100, seed=2)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    return target, query


def _hand_presence(m: np.ndarray, widths: np.ndarray) -> PresenceData:
    P, G, _ = m.shape
    return PresenceData(
        meta=DBMetaData(protein_set=tuple(f"P{p}" for p in range(P)),
                        genome_set=tuple(f"g{i:02d}" for i in range(G))),
        m=m, t=m.sum(2).astype(np.int32), widths=widths,
        tetramer_ids=[np.arange(w, dtype=np.int32) for w in widths],
    )


def _bucketed() -> PresenceData:
    """13 genomes whose 7 proteins fall into several width buckets in
    another order than the proteins' own; one genome lacks a protein and
    one genome is empty (T = 0: the clamp matters)."""
    rng = np.random.default_rng(5)
    widths = np.array([300, 20, 280, 10, 140, 260, 30], np.int32)
    m = np.zeros((7, 13, 384), np.uint8)
    for p, w in enumerate(widths):
        m[p, :, :w] = rng.random((13, w)) < 0.4
    m[3, 4] = 0
    m[:, 9] = 0
    return _hand_presence(m, widths)


def _case(mode: str, dbs):
    """(presence, port axes, JAX axes) of one run mode; a fresh presence
    object per call."""
    target, query = dbs
    if mode == "bucketed":
        presence = _bucketed()
        meta = presence.meta
    else:
        db = (QueryTargetDatabase(target, query) if mode.startswith("qt")
              else SCPDatabase(target))
        presence = db.load_presence()
        db.close()
        meta = db.meta
    if mode.startswith("qt"):
        compat = mode == "qt"
        return (presence, modes.query_target_axes(meta, compat_qt_t_swap=compat),
                jax_modes.query_target_axes(meta, compat_qt_t_swap=compat))
    if mode == "qsub":
        names = [meta.genome_set[i] for i in QUERIES]
        return (presence, modes.query_subset_axes(meta, names),
                jax_modes.query_subset_axes(meta, names))
    return (presence, modes.all_vs_all_axes(meta),
            jax_modes.all_vs_all_axes(meta))


def _fresh(presence) -> PresenceData:
    """The same tensors in a presence object without any cache."""
    return dataclasses.replace(presence)


def _kb_max(presence) -> int:
    return max(kb for _, _, kb in bucket_bounds(presence.widths)[1])


def _csv(fn, tmp_path, presence, axes, name, **kw) -> bytes:
    """The CSV of one banded engine call, the port's (``fn`` from
    ``engine``) or the JAX package's (``fn`` from ``jax_engine``)."""
    out = tmp_path / f"{name}.csv"
    args = (presence, axes.row_db_ids, axes.col_db_ids, str(out),
            axes.query_names, axes.target_names)
    if fn.__module__.startswith("parfastaai_tpu_torch"):
        args = (*args, CPU)
    fn(*args, row_denom_ids=axes.row_denom_ids,
       col_denom_ids=axes.col_denom_ids, **kw)
    return out.read_bytes()


def assert_streamed_close(got: bytes, want: bytes) -> None:
    """The f32 engines' stated tolerance between two CSVs: the same header
    and row names as bytes, the text ``0`` in the same cells, values
    within rtol 1e-6."""
    g, w = (text.decode().split("\n") for text in (got, want))
    assert g[0] == w[0] and len(g) == len(w) and g[-1] == w[-1] == ""
    g, w = ([ln.split(",") for ln in x[1:-1]] for x in (g, w))
    assert [r[0] for r in g] == [r[0] for r in w]
    g, w = (np.array([r[1:] for r in x], dtype=object) for x in (g, w))
    assert g.shape == w.shape
    np.testing.assert_array_equal(g == "0", w == "0")
    np.testing.assert_allclose(
        g.astype(np.float64), w.astype(np.float64), rtol=RTOL, atol=0)


# A budget whose store cap (15000 B) holds one or two slabs, and a slab
# target that cuts a bucket of 384 at 8 genomes into chunks of 3 proteins.
def _churn(monkeypatch, presence, proteins_per_slab: int | None = 3) -> None:
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "20000")
    if proteins_per_slab is None:
        monkeypatch.delenv("PARFASTAAI_SLAB_BYTES", raising=False)
    else:
        monkeypatch.setenv("PARFASTAAI_SLAB_BYTES",
                           str(proteins_per_slab * 8 * _kb_max(presence)))


# --- budget, slab size, split and column groups: the reference's rules --

ENVS = {
    "none": {},
    "slab_10k": {"PARFASTAAI_SLAB_BYTES": "10000"},
    "slab_1e6": {"PARFASTAAI_SLAB_BYTES": "1e6"},
    "hbm_1": {"PARFASTAAI_HBM_BYTES": "1"},
    "hbm_6e8": {"PARFASTAAI_HBM_BYTES": "6e8"},
    "hbm_2e10": {"PARFASTAAI_HBM_BYTES": "2e10"},
    "hbm_2e10_slab_5e5": {"PARFASTAAI_HBM_BYTES": "2e10",
                          "PARFASTAAI_SLAB_BYTES": "5e5"},
}


@pytest.mark.parametrize("env", sorted(ENVS))
def test_slab_target_and_split_plan_equal_jax(env, monkeypatch):
    for name in ("PARFASTAAI_HBM_BYTES", "PARFASTAAI_SLAB_BYTES"):
        monkeypatch.delenv(name, raising=False)
    for name, value in ENVS[env].items():
        monkeypatch.setenv(name, value)
    assert engine._slab_target_bytes(CPU) == jax_engine._slab_target_bytes()
    for P in (1, 5, 13, 80):
        for kbs in ((128,), (128, 4096), (384, 53248)):
            cuts = np.linspace(0, P, len(kbs) + 1).astype(int)
            order = np.random.default_rng(P).permutation(P).astype(np.int32)
            plan = [(order[a:b], kb) for a, b, kb in zip(cuts, cuts[1:], kbs)]
            for n_ids in (1, 7, 1024):
                got = [(bi, pci, idx.tolist(), kb) for bi, pci, idx, kb
                       in engine._split_plan(plan, n_ids, CPU)]
                want = [(bi, pci, idx.tolist(), kb) for bi, pci, idx, kb
                        in jax_engine._split_plan(plan, n_ids)]
                assert got == want, (P, kbs, n_ids)
                seen = sorted(p for _, _, idx, _ in got for p in idx)
                assert seen == list(range(P))


@pytest.mark.parametrize("staged_env", [None, "1", "yes", "0", "no", ""])
@pytest.mark.parametrize("hbm", [None, "1", "1e18"])
def test_use_staged_equals_jax(staged_env, hbm, dbs, monkeypatch):
    """The explicit argument, then PARFASTAAI_STAGED, then the budget;
    the CPU reports none, so it stages only when asked or under
    PARFASTAAI_HBM_BYTES."""
    presence, _, _ = _case("all", dbs)
    for name, value in (("PARFASTAAI_STAGED", staged_env),
                        ("PARFASTAAI_HBM_BYTES", hbm)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for staged in (None, True, False):
        assert engine._use_staged(presence, CPU, staged) == \
            jax_engine._use_staged(presence, staged)
    if staged_env is None and hbm is None:
        assert not engine._use_staged(presence, CPU)


@pytest.mark.parametrize("hbm", [None, "1", "20000", "60000", "1e9"])
def test_staged_col_group_equals_jax(hbm, monkeypatch):
    presence = _bucketed()
    if hbm is None:
        monkeypatch.delenv("PARFASTAAI_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("PARFASTAAI_HBM_BYTES", hbm)
    for band in (1, 4, 8):
        for col_chunk in (1, 3, 8):
            for n_chunks in (1, 2, 5):
                for staged in (None, True, False):
                    args = (band, col_chunk, n_chunks, staged)
                    place = engine._placement(
                        presence, CPU, engine._use_staged(presence, CPU,
                                                          staged))
                    assert engine._staged_col_group(place, *args[:3]) \
                        == jax_engine._staged_col_group(presence, *args), args


# --- the slab store --------------------------------------------------------


def test_slab_holds_its_proteins_genomes_and_zero_padding():
    """A slab is the gather of its proteins and genomes over the bucket's
    own K columns, zero past the tensor's width; a fetch of the same
    content is served from the store, one of other proteins is not."""
    presence = _bucketed()
    store = engine._placement(presence, CPU, True)._store
    ids = np.array([3, 0, 9, 3, 12])
    for idx, kb in (([1, 3], 128), ([4, 5, 0], 384), ([6], 512)):
        idx = np.array(idx)
        slab = store.fetch(idx, kb, ids)
        assert slab.dtype == torch.int8 and tuple(slab.shape) == (
            len(idx), len(ids), kb)
        want = np.zeros((len(idx), len(ids), kb), np.uint8)
        kw = min(kb, presence.m.shape[2])
        want[:, :, :kw] = presence.m[idx[:, None], ids[None, :], :kw]
        np.testing.assert_array_equal(slab.numpy().view(np.uint8), want)
        assert store.fetch(idx, kb, ids) is slab
    before = store.stats()
    store.fetch(np.array([1]), 128, ids)  # a different protein set
    after = store.stats()
    assert after["slabs"] == before["slabs"] + 1
    assert after["hits"] == before["hits"] == 3
    assert engine.slab_stats(presence, CPU) == after
    assert engine.slab_stats(_bucketed(), CPU) is None


@pytest.mark.parametrize("mode", ["all", "bucketed"])
def test_store_holds_at_most_its_cap_plus_the_live_slab(
        mode, dbs, tmp_path, monkeypatch):
    """Eviction comes before the upload, and spares only the most recent
    slab: after every fetch the store holds at most its cap plus one
    slab."""
    presence, axes, _ = _case(mode, dbs)
    _churn(monkeypatch, presence)
    held = []
    real = engine._SlabStore.fetch

    def fetch(self, idx, kb, ids):
        slab = real(self, idx, kb, ids)
        held.append((self.held, self.cap(), slab.numel()))
        return slab

    monkeypatch.setattr(engine._SlabStore, "fetch", fetch)
    _csv(engine.compute_streamed, tmp_path, presence, axes, "s", band=8,
         col_chunk=8, staged=True)
    _csv(engine.compute_streamed_exact, tmp_path, presence, axes, "e",
         band=8, col_chunk=8, staged=True)
    biggest = max(nb for _, _, nb in held)
    assert all(h <= cap + biggest for h, cap, _ in held)
    assert any(h > cap - biggest for h, cap, _ in held)  # the cap binds
    stats = engine.slab_stats(presence, CPU)
    assert stats["peak"] <= stats["cap"] + biggest
    assert stats["uploaded"] > engine.presence_device_bytes(presence)


# --- the engines against the JAX package ---------------------------------

STAGED_MODES = ["all", "qsub", "qt", "qt_noswap", "bucketed"]
SPLITS = {"whole": None, "chunks_of_3": 3}


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("mode", STAGED_MODES)
def test_staged_streamed_matches_jax(mode, split, dbs, tmp_path, monkeypatch):
    """compute_streamed, staged under a budget whose cap churns the store,
    with ragged bands and chunks: the JAX package's staged run to the
    stated tolerance; without cut buckets, the resident run's bytes."""
    presence, axes, jax_axes = _case(mode, dbs)
    resident = _csv(engine.compute_streamed, tmp_path, presence, axes,
                    "resident", band=8, col_chunk=5)
    _churn(monkeypatch, presence, SPLITS[split])
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    got = _csv(engine.compute_streamed, tmp_path, _fresh(presence), axes,
               "port", band=8, col_chunk=5, staged=True)
    want = _csv(jax_engine.compute_streamed, tmp_path, _fresh(presence),
                jax_axes, "jax", band=8, col_chunk=5, staged=True)
    assert_streamed_close(got, want)
    assert_streamed_close(got, resident)
    if split == "whole":
        assert got == resident


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("mode", STAGED_MODES)
def test_staged_exact_bytes_equal_jax(mode, split, dbs, tmp_path, monkeypatch):
    """compute_streamed_exact, staged: the JAX package's staged bytes and
    the resident run's, whatever the split (counts are integers)."""
    presence, axes, jax_axes = _case(mode, dbs)
    resident = _csv(engine.compute_streamed_exact, tmp_path, presence, axes,
                    "resident", band=8, col_chunk=5)
    _churn(monkeypatch, presence, SPLITS[split])
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    got = _csv(engine.compute_streamed_exact, tmp_path, _fresh(presence),
               axes, "port", band=8, col_chunk=5, staged=True)
    want = _csv(jax_engine.compute_streamed_exact, tmp_path,
                _fresh(presence), jax_axes, "jax", band=8, col_chunk=5,
                staged=True)
    assert got == want == resident


def _pairs(mode: str, dbs):
    """(presence, port PairSpace, JAX PairSpace) of one mode."""
    target, query = dbs
    if mode.startswith("qt"):
        db = QueryTargetDatabase(target, query)
        compat = mode == "qt"
        port = modes.query_target(db.meta, compat_qt_t_swap=compat)
        jax = jax_modes.query_target(db.meta, compat_qt_t_swap=compat)
    else:
        db = SCPDatabase(target)
        names = [db.meta.genome_set[i] for i in QUERIES]
        port = (modes.query_subset(db.meta, names) if mode == "qsub"
                else modes.all_vs_all(db.meta))
        jax = (jax_modes.query_subset(db.meta, names) if mode == "qsub"
               else jax_modes.all_vs_all(db.meta))
    presence = db.load_presence()
    db.close()
    return presence, port, jax


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("mode", ["all", "qsub", "qt", "qt_noswap"])
def test_staged_fast_matches_jax(mode, split, dbs, monkeypatch):
    """compute_fast, staged, on the column-group walk: N equal and S within
    rtol 1e-6 of the JAX package's staged run (the two-database modes
    with and without the T swap); without cut buckets, the resident S and
    N bit for bit."""
    presence, pairs, jax_pairs = _pairs(mode, dbs)
    resident = engine.compute_fast(presence, pairs, CPU)
    _churn(monkeypatch, presence, SPLITS[split])
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    got = engine.compute_fast(_fresh(presence), pairs, CPU, staged=True)
    want = jax_engine.compute_fast(_fresh(presence), jax_pairs, staged=True)
    np.testing.assert_array_equal(got.n, want.n)
    np.testing.assert_allclose(got.s, want.s, rtol=RTOL, atol=0)
    np.testing.assert_array_equal(got.n, resident.n)
    if split == "whole":
        np.testing.assert_array_equal(got.s, resident.s)
    else:
        np.testing.assert_allclose(got.s, resident.s, rtol=RTOL, atol=0)


# --- within the port ------------------------------------------------------


@pytest.mark.parametrize("mode", ["all", "qt", "bucketed"])
def test_one_protein_per_slab_gives_the_resident_bytes(
        mode, dbs, tmp_path, monkeypatch):
    """Chunks of one protein, summed within their bucket in protein order,
    add each cell's terms in the resident kernel's order: the f32 engines
    write the resident bytes (and S, N of compute_fast), as the exact one
    does under any split."""
    presence, axes, _ = _case(mode, dbs)
    want = {name: _csv(getattr(engine, name), tmp_path, presence, axes,
                       f"resident_{name}", band=6, col_chunk=4)
            for name in ("compute_streamed", "compute_streamed_exact")}
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", "1")
    for name, resident in want.items():
        fresh = _fresh(presence)
        assert _csv(getattr(engine, name), tmp_path, fresh, axes, name,
                    band=6, col_chunk=4) == resident
        assert engine.slab_stats(fresh, CPU)["slabs"] > 0
    ids = np.arange(presence.m.shape[1])
    s0, n0 = engine._banded_sn(presence, ids, ids, ids, ids, CPU, band=6,
                               col_chunk=4, staged=False)
    s1, n1 = engine._banded_sn(_fresh(presence), ids, ids, ids, ids, CPU,
                               band=6, col_chunk=4)
    np.testing.assert_array_equal(n1, n0)
    np.testing.assert_array_equal(s1, s0)


def test_two_block_widths_on_one_presence(dbs, tmp_path, monkeypatch):
    """The reference fault's probe in the port: two staged calls on one
    presence whose block widths cut the bucket differently (3, then 2
    proteins a slab) reuse the store's slabs only where they hold the same
    proteins and genomes.  The exact engine writes the resident bytes both
    times; the f32 engine writes, both times, the bytes of a call on a
    fresh presence, within rtol 1e-6 of the resident run."""
    presence, axes, _ = _case("all", dbs)
    resident = {
        name: _csv(getattr(engine, name), tmp_path, presence, axes,
                   f"resident_{name}", band=8, col_chunk=8)
        for name in ("compute_streamed", "compute_streamed_exact")
    }
    monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(24 * _kb_max(presence)))
    shared = _fresh(presence)
    for col_chunk in (8, 12):
        kw = dict(band=8, col_chunk=col_chunk, staged=True)
        exact = _csv(engine.compute_streamed_exact, tmp_path, shared, axes,
                     "exact", **kw)
        assert exact == resident["compute_streamed_exact"]
        f32 = _csv(engine.compute_streamed, tmp_path, shared, axes, "f32",
                   **kw)
        alone = _csv(engine.compute_streamed, tmp_path, _fresh(presence),
                     axes, "alone", **kw)
        assert f32 == alone
        assert_streamed_close(f32, resident["compute_streamed"])
    assert engine.slab_stats(shared, CPU)["hits"] > 0


def test_jax_slab_key_fault_raises(dbs, tmp_path, monkeypatch):
    """Records a fault of the reference: its slab store keys a slab by
    (bucket, chunk, genomes), so a second staged call on one presence
    whose block width cuts the bucket otherwise is served the first
    call's slabs and fails (or, where the sizes happen to agree, computes
    with other proteins).  The port keys slabs by content
    (test_two_block_widths_on_one_presence)."""
    presence, _, jax_axes = _case("all", dbs)
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(24 * _kb_max(presence)))
    _csv(jax_engine.compute_streamed, tmp_path, presence, jax_axes, "first",
         band=8, col_chunk=8, staged=True)
    with pytest.raises(ValueError, match="different leading axis sizes"):
        _csv(jax_engine.compute_streamed, tmp_path, presence, jax_axes,
             "second", band=8, col_chunk=12, staged=True)


def test_column_group_walk_uploads_less(monkeypatch):
    """Twin of the JAX package's test_banded_sn_column_group_traversal_
    cuts_uploads: under a store that holds about three slabs, the
    column-group walk uploads materially fewer bytes than the row-major
    walk (one group of every chunk), with the same S and N."""
    rng = np.random.default_rng(0)
    m = (rng.random((4, 32, 128)) < 0.3).astype(np.uint8)
    widths = np.full(4, 128, np.int32)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "20000")
    assert engine._staged_col_group(
        engine._placement(_hand_presence(m, widths), CPU, True), 8, 8, 4) == 2
    ids = np.arange(32)
    dcol = (ids + 1) % 32  # not symmetric: both walks compute every block

    def run(group_n=None):
        presence = _hand_presence(m, widths)
        if group_n is not None:
            monkeypatch.setattr(engine, "_staged_col_group",
                                lambda *a: group_n)
        out = engine._banded_sn(presence, ids, ids, ids, dcol, CPU, band=8,
                                col_chunk=8, staged=True)
        monkeypatch.undo()
        monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "20000")
        return out, engine.slab_stats(presence, CPU)["uploaded"]

    (s_row, n_row), up_row = run(group_n=4)
    (s_grp, n_grp), up_grp = run()
    np.testing.assert_array_equal(n_grp, n_row)
    np.testing.assert_array_equal(s_grp, s_row)
    assert up_grp < 0.75 * up_row, (up_grp, up_row)


def test_streamed_snake_order(dbs, tmp_path, monkeypatch):
    """Staged streamed runs walk the column chunks right to left in every
    other band (resident runs always left to right), and write the same
    bytes either way."""
    presence, axes, _ = _case("qsub", dbs)
    walks = {}
    for name, staged in (("resident", False), ("staged", True)):
        seen = []
        real = engine._block_sn

        def block(place, rids, cids, *a, _real=real):
            seen.append((int(rids[0]), int(cids[0])))
            return _real(place, rids, cids, *a)

        monkeypatch.setattr(engine, "_block_sn", block)
        out = _csv(engine.compute_streamed, tmp_path, _fresh(presence), axes,
                   name, band=2, col_chunk=9, staged=staged)
        monkeypatch.undo()
        walks[name] = (seen, out)
    chunk_starts = [int(axes.col_db_ids[c]) for c in range(0, 40, 9)]
    resident, staged = walks["resident"][0], walks["staged"][0]
    assert [c for _, c in resident[:5]] == chunk_starts
    assert [c for _, c in staged[:5]] == chunk_starts
    assert [c for _, c in staged[5:10]] == chunk_starts[::-1]
    assert [c for _, c in staged[10:15]] == chunk_starts
    assert walks["staged"][1] == walks["resident"][1]


@pytest.mark.parametrize("which", ["compute_streamed", "compute_streamed_exact"])
def test_failure_inside_a_staged_run_reaches_the_caller(
        which, dbs, tmp_path, monkeypatch):
    """A slab fetch that fails mid-run stops the producer, reaches the
    caller, leaves no thread behind and no partial band in the CSV."""
    presence, axes, _ = _case("all", dbs)
    calls = []
    real = engine._SlabStore.fetch

    def fetch(self, idx, kb, ids):
        calls.append(1)
        if len(calls) == 9:
            raise RuntimeError("injected slab fault")
        return real(self, idx, kb, ids)

    monkeypatch.setattr(engine._SlabStore, "fetch", fetch)
    _churn(monkeypatch, presence)
    with pytest.raises(RuntimeError, match="injected slab fault"):
        _csv(getattr(engine, which), tmp_path, presence, axes, "port",
             band=8, col_chunk=8, staged=True)
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("pfaai-")]
    lines = (tmp_path / "port.csv").read_bytes().split(b"\n")
    assert lines[-1] == b"" and (len(lines) - 2) % 8 == 0
