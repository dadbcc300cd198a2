"""The port's engine against the JAX package's, on the CPU, in all three
modes, on small synthetic databases (tools/synth_db)."""

import sqlite3

import numpy as np
import pytest
import torch

from parfastaai_tpu import engine as jax_engine
from parfastaai_tpu.etl.database import (
    QueryTargetDatabase,
    SCPDatabase,
    bucketize_presence,
)
from parfastaai_tpu.modes import all_vs_all, query_subset, query_target
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu_torch import engine
from parfastaai_tpu_torch.ops import sn_rect

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 40-genome target DB and a 24-genome query DB with disjoint genome
    names (6 proteins, pool 300, ~100 tetramers per genome)."""
    d = tmp_path_factory.mktemp("torch_engine")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=40, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=1)
    generate(query, n_genomes=24, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=2)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    return target, query


def _mode(name, dbs):
    """(presence, pairs) of one run mode."""
    target, query = dbs
    if name == "qt":
        db = QueryTargetDatabase(target, query)
        pairs = query_target(db.meta)
    else:
        db = SCPDatabase(target)
        if name == "qsub":
            names = [db.meta.genome_set[i] for i in (7, 0, 31)]
            pairs = query_subset(db.meta, names)
        else:
            pairs = all_vs_all(db.meta)
    presence = db.load_presence()
    db.close()
    return presence, pairs


MODES = ["all", "qsub", "qt"]


def test_to_device_buckets_reproduces_bucketize(dbs):
    presence, _ = _mode("all", dbs)
    want = bucketize_presence(presence)
    got = engine.to_device_buckets(presence, CPU)
    assert len(got) == len(want) > 0
    for (gi, gm, gt), (wi, wm, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm.numpy(), wm)
        assert gt.dtype == torch.float32
        np.testing.assert_array_equal(gt.numpy(), np.maximum(wt, 1))
    assert engine.to_device_buckets(presence, CPU) is got  # cached


@pytest.mark.parametrize("mode", MODES)
def test_compute_bit_equal_to_jax(mode, dbs):
    presence, pairs = _mode(mode, dbs)
    want = jax_engine.compute(presence, pairs)
    phases = {}
    got = engine.compute(presence, pairs, CPU, phases=phases)
    np.testing.assert_array_equal(got.genome_a, want.genome_a)
    np.testing.assert_array_equal(got.genome_b, want.genome_b)
    np.testing.assert_array_equal(got.n, want.n)
    np.testing.assert_array_equal(got.s, want.s)
    assert set(phases) == {"H2D", "Gram", "D2H", "host finish"}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("divide", [{}, {"approx": True}, {"precise": True}])
def test_compute_fast_matches_jax(mode, divide, dbs):
    """N exact; S within 1e-6 relative (f32 accumulation over proteins)."""
    presence, pairs = _mode(mode, dbs)
    want = jax_engine.compute_fast(presence, pairs, **divide)
    phases = {}
    got = engine.compute_fast(presence, pairs, CPU, phases=phases, **divide)
    np.testing.assert_array_equal(got.genome_a, want.genome_a)
    np.testing.assert_array_equal(got.n, want.n)
    np.testing.assert_allclose(got.s, want.s, rtol=1e-6)
    assert {"H2D", "gather", "kernel", "D2H"} <= set(phases)


def test_block_engine_gathers_only_partial_axes(dbs, monkeypatch):
    """An axis that is every genome in order reaches the kernel as the
    resident bucket itself; any other axis is gathered."""
    presence, _ = _mode("all", dbs)
    seen = []

    def spy(ma, mb, ta, tb, approx=False, precise=False):
        seen.append((ma, mb, ta, tb))
        return sn_rect.fused_sn_block_plain(ma, mb, ta, tb)

    monkeypatch.setattr(engine, "fused_sn_block", spy)
    G = presence.m.shape[1]
    place = engine._placement(presence, CPU, False)
    everyone, rows = np.arange(G), np.arange(5, 21)
    engine._block_sn(place, rows, everyone, rows, everyone)
    buckets = engine.to_device_buckets(presence, CPU)
    assert len(seen) == len(buckets)
    for (ma, mb, ta, tb), (_, md, td) in zip(seen, buckets):
        # the bucket itself, viewed as int8: its own memory, no gather
        assert mb.data_ptr() == md.data_ptr() and mb.shape == md.shape
        assert mb.dtype == torch.int8 and tb is td
        assert ma.shape[1] == ta.shape[1] == len(rows)
        assert torch.equal(ma, md[:, 5:21])


def test_banded_sn_pads_and_mirrors(dbs):
    """Bands and chunks that do not divide G, on the symmetric walk: the
    padded, sliced and transpose-filled blocks equal one whole block."""
    presence, _ = _mode("all", dbs)
    ids = np.arange(presence.m.shape[1], dtype=np.int32)
    whole = engine._banded_sn(presence, ids, ids, ids, ids, CPU)
    banded = engine._banded_sn(
        presence, ids, ids, ids, ids, CPU, band=16, col_chunk=12
    )
    np.testing.assert_array_equal(banded[1], whole[1])
    np.testing.assert_allclose(banded[0], whole[0], rtol=1e-6)
    np.testing.assert_array_equal(whole[0], whole[0].T)


def test_staged_size_raises(dbs, monkeypatch):
    """Presence above the device budget (1 byte) goes to the staged slab
    engine, with no word from the caller, and gives the resident run's
    S and N bit for bit in every mode (no bucket is split into chunks at
    this size)."""
    for mode in MODES:
        presence, pairs = _mode(mode, dbs)
        monkeypatch.delenv("PARFASTAAI_HBM_BYTES", raising=False)
        want = engine.compute_fast(presence, pairs, CPU)
        assert engine.slab_stats(presence, CPU) is None
        monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
        got = engine.compute_fast(presence, pairs, CPU)
        assert engine.slab_stats(presence, CPU)["uploaded"] > 0
        np.testing.assert_array_equal(got.n, want.n)
        np.testing.assert_array_equal(got.s, want.s)
