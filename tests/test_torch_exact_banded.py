"""The port's banded exact engine (``compute_streamed_exact``) on the CPU,
on small synthetic databases: its CSV must equal, byte for byte (no
tolerance), the port's dense exact path (``compute`` + ``write_aji_csv``)
and the JAX package's banded exact engine on its device count path
(PARFASTAAI_FORCE_DEVICE=1, as tests/test_exact_banded.py runs it), in
every mode, at band and chunk shapes that leave ragged edges, with the
symmetric mirror on and off, after a resume, and after a failure on either
side of the pipeline.  ``_resume_point`` and ``jaccard_finish_block`` are
held to the JAX package's on the same numpy inputs from a seed."""

import dataclasses
import sqlite3

import numpy as np
import pytest
import torch

from parfastaai_tpu import engine as jax_engine
from parfastaai_tpu import modes as jax_modes
from parfastaai_tpu.etl.database import (
    PresenceData,
    QueryTargetDatabase,
    SCPDatabase,
)
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu.types import DBMetaData
from parfastaai_tpu_torch import engine, modes
from parfastaai_tpu_torch.io.csv_writer import write_aji_csv

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _jax_device_counts(monkeypatch):
    """The JAX engine takes its device count path (jit on the CPU backend),
    the one the port's engine is the counterpart of."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """(meta, presence) of a 40-genome DB (6 proteins, pool 300, ~100
    tetramers per genome; one width bucket)."""
    path = str(tmp_path_factory.mktemp("torch_banded") / "target.db")
    generate(path, n_genomes=40, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=1)
    db = SCPDatabase(path)
    presence = db.load_presence()
    db.close()
    return db.meta, presence


@pytest.fixture(scope="module")
def two_db(tmp_path_factory):
    """(meta, presence) of a 24-genome query DB against a 40-genome target
    DB with disjoint genome names."""
    d = tmp_path_factory.mktemp("torch_banded_qt")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=40, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=1)
    generate(query, n_genomes=24, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=2)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    db = QueryTargetDatabase(target, query)
    presence = db.load_presence()
    db.close()
    return db.meta, presence


def _dense(tmp_path, presence, pairs) -> bytes:
    """The port's dense exact path's CSV."""
    out = tmp_path / "dense.csv"
    write_aji_csv(str(out), pairs, engine.compute(presence, pairs, CPU).aji)
    return out.read_bytes()


def _axes_args(axes):
    return (axes.row_db_ids, axes.col_db_ids), dict(
        row_denom_ids=axes.row_denom_ids, col_denom_ids=axes.col_denom_ids
    )


def _banded(tmp_path, presence, axes, name="port", **kw) -> bytes:
    """The port's banded exact engine's CSV."""
    out = tmp_path / f"{name}.csv"
    ids, denoms = _axes_args(axes)
    engine.compute_streamed_exact(
        presence, *ids, str(out), axes.query_names, axes.target_names, CPU,
        **denoms, **kw,
    )
    return out.read_bytes()


def _jax_banded(tmp_path, presence, axes, name="jax", **kw) -> bytes:
    """The JAX package's banded exact engine's CSV."""
    out = tmp_path / f"{name}.csv"
    ids, denoms = _axes_args(axes)
    jax_engine.compute_streamed_exact(
        presence, *ids, str(out), axes.query_names, axes.target_names,
        **denoms, **kw,
    )
    return out.read_bytes()


@pytest.mark.parametrize(
    "band,col_chunk", [(512, 2048), (3, 2), (3, 5), (1, 1)]
)
def test_all_vs_all_bytes(single, tmp_path, band, col_chunk):
    meta, presence = single
    shape = dict(band=band, col_chunk=col_chunk)
    got = _banded(tmp_path, presence, modes.all_vs_all_axes(meta), **shape)
    assert got == _dense(tmp_path, presence, modes.all_vs_all(meta))
    assert got == _jax_banded(
        tmp_path, presence, jax_modes.all_vs_all_axes(meta), **shape
    )


@pytest.mark.parametrize("band,col_chunk", [(2, 3), (512, 7)])
def test_query_subset_bytes(single, tmp_path, band, col_chunk):
    """Queries in another order than the database's."""
    meta, presence = single
    queries = [meta.genome_set[i] for i in (31, 0, 7, 12, 5)]
    shape = dict(band=band, col_chunk=col_chunk)
    got = _banded(
        tmp_path, presence, modes.query_subset_axes(meta, queries), **shape
    )
    assert got == _dense(tmp_path, presence, modes.query_subset(meta, queries))
    assert got == _jax_banded(
        tmp_path, presence, jax_modes.query_subset_axes(meta, queries), **shape
    )


@pytest.mark.parametrize("compat", [True, False])
def test_query_target_bytes(two_db, tmp_path, compat):
    meta, presence = two_db
    shape = dict(band=5, col_chunk=7)
    got = _banded(
        tmp_path, presence,
        modes.query_target_axes(meta, compat_qt_t_swap=compat), **shape,
    )
    assert got == _dense(
        tmp_path, presence, modes.query_target(meta, compat_qt_t_swap=compat)
    )
    assert got == _jax_banded(
        tmp_path, presence,
        jax_modes.query_target_axes(meta, compat_qt_t_swap=compat), **shape,
    )


@pytest.mark.parametrize("band", [1, 3])
def test_mirror_on_equals_mirror_off(single, tmp_path, monkeypatch, capfd, band):
    """The symmetric walk (blocks on and above the diagonal, the rest
    mirrored) against the full square, which PARFASTAAI_MIRROR_BYTES=1
    forces; band 3 leaves a short last band at 40 genomes.  The full square
    keeps the caller's col_chunk."""
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    seen = []
    real = engine._block_counts

    def spy(place, rids, cids):
        seen.append((len(rids), len(cids)))
        return real(place, rids, cids)

    monkeypatch.setattr(engine, "_block_counts", spy)
    shape = dict(band=band, col_chunk=2 * band)
    mirrored = _banded(tmp_path, presence, axes, "mirrored", **shape)
    n_ch = -(-40 // band)
    assert len(seen) == n_ch * (n_ch + 1) // 2
    assert max(nc for _, nc in seen) == band  # square blocks
    assert "mirror disabled" not in capfd.readouterr().err
    seen.clear()
    monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
    full = _banded(tmp_path, presence, axes, "full", **shape)
    assert len(seen) == n_ch * -(-40 // (2 * band))
    assert max(nc for _, nc in seen) == 2 * band
    assert "symmetric mirror disabled" in capfd.readouterr().err
    assert mirrored == full
    assert full == _jax_banded(
        tmp_path, presence, jax_modes.all_vs_all_axes(meta), **shape
    )


def _hand_presence(
    m: np.ndarray, names, widths=None
) -> tuple[DBMetaData, PresenceData]:
    P, _, K = m.shape
    widths = np.full(P, K, np.int32) if widths is None else widths
    meta = DBMetaData(
        protein_set=tuple(f"P{p}" for p in range(P)), genome_set=tuple(names)
    )
    presence = PresenceData(
        meta=meta, m=m, t=m.sum(2).astype(np.int32), widths=widths,
        tetramer_ids=[np.arange(w, dtype=np.int32) for w in widths],
    )
    return meta, presence


@pytest.fixture(scope="module")
def bucketed():
    """(meta, presence) of 11 genomes whose 5 proteins fall into several
    width buckets in another order than the proteins' own."""
    rng = np.random.default_rng(5)
    widths = np.array([300, 20, 280, 10, 140], np.int32)
    m = np.zeros((5, 11, 384), np.uint8)
    for p, w in enumerate(widths):
        m[p, :, :w] = rng.random((11, w)) < 0.4
    m[3, 4] = 0  # a genome without protein 3
    return _hand_presence(m, [f"g{i}" for i in range(11)], widths)


def test_pair_without_shared_protein_prints_nan(tmp_path):
    m = np.zeros((1, 3, 128), np.uint8)
    m[0, 0, :4] = 1  # a has tetramers; b shares none of them; c is empty
    m[0, 1, 4:8] = 1
    meta, presence = _hand_presence(m, "abc")
    want = _dense(tmp_path, presence, modes.all_vs_all(meta))
    assert b"nan" in want
    assert _banded(tmp_path, presence, modes.all_vs_all_axes(meta), band=1) == want
    assert _jax_banded(
        tmp_path, presence, jax_modes.all_vs_all_axes(meta), band=1
    ) == want


def test_counts_past_int16_travel_as_int32(tmp_path):
    """max(T) >= 2^15: the count blocks reach the host as int32."""
    K = 2**15 + 128
    m = np.zeros((2, 3, K), np.uint8)
    m[0, 0, : 2**15 + 40] = 1
    m[0, 1, 10 : 2**15 + 20] = 1  # shares 32778 > int16's 32767 with a
    m[0, 2, :50] = 1
    m[1, :, :7] = 1
    meta, presence = _hand_presence(m, "abc")
    assert engine._count_wire_dtype(presence) == torch.int32
    block = engine._block_counts(engine._placement(presence, CPU, False),
                                 np.arange(3), np.arange(3))
    assert block.dtype == torch.int32 and int(block[0, 0, 1]) == 2**15 + 10
    want = _dense(tmp_path, presence, modes.all_vs_all(meta))
    assert _banded(tmp_path, presence, modes.all_vs_all_axes(meta), band=2) == want
    assert _jax_banded(
        tmp_path, presence, jax_modes.all_vs_all_axes(meta), band=2
    ) == want


def test_count_blocks_exact_shape_in_protein_order(bucketed):
    """A block has its exact (ragged) shape, the narrow wire dtype, and
    ascending protein order whatever the width buckets' order."""
    _, presence = bucketed
    buckets = engine.to_device_buckets(presence, CPU)
    order = np.concatenate([idx for idx, _, _ in buckets])
    assert len(buckets) > 1 and not np.array_equal(order, np.sort(order))
    rids, cids = np.array([9, 10, 3]), np.array([0, 5, 6, 7, 10])
    block = engine._block_counts(engine._placement(presence, CPU, False),
                                 rids, cids)
    assert block.dtype == torch.int16 and block.is_contiguous()
    m = presence.m.astype(np.int64)
    want = np.einsum("pak,pbk->pab", m[:, rids], m[:, cids])
    np.testing.assert_array_equal(block.numpy(), want)


@pytest.mark.parametrize("band,col_chunk", [(4, 3), (512, 2048)])
def test_width_buckets_bytes(bucketed, tmp_path, band, col_chunk):
    """Several width buckets that permute the proteins: the f64 finish still
    runs in ascending protein order."""
    meta, presence = bucketed
    shape = dict(band=band, col_chunk=col_chunk)
    got = _banded(tmp_path, presence, modes.all_vs_all_axes(meta), **shape)
    assert got == _dense(tmp_path, presence, modes.all_vs_all(meta))
    assert got == _jax_banded(
        tmp_path, presence, jax_modes.all_vs_all_axes(meta), **shape
    )


def test_resume_from_two_bands_and_a_torn_line(single, tmp_path, capfd):
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    full = _banded(tmp_path, presence, axes, "full", band=2)
    lines = full.split(b"\n")
    out = tmp_path / "port.csv"
    # header, two bands of two rows, a third band's first row, a torn line
    out.write_bytes(b"\n".join(lines[:6]) + b"\ngarbage_partial")
    assert _banded(tmp_path, presence, axes, band=2, resume=True) == full
    assert "mirror disabled on --resume" in capfd.readouterr().err
    jax_out = tmp_path / "jax.csv"
    jax_out.write_bytes(b"\n".join(lines[:6]) + b"\ngarbage_partial")
    assert _jax_banded(
        tmp_path, presence, jax_modes.all_vs_all_axes(meta), band=2, resume=True
    ) == full


def test_producer_failure_leaves_whole_bands_and_resumes(
    single, tmp_path, monkeypatch
):
    """A device failure at the third block (the second band's diagonal
    block, after its mirrored chunk) must not write that band: its unfilled
    chunk is uninitialised memory, and --resume would keep a written band
    as a checkpoint."""
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    clean = _banded(tmp_path, presence, axes, "clean", band=20)
    calls = []
    real = engine._block_counts

    def failing(place, rids, cids):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected device failure")
        return real(place, rids, cids)

    monkeypatch.setattr(engine, "_block_counts", failing)
    with pytest.raises(RuntimeError, match="injected device failure"):
        _banded(tmp_path, presence, axes, band=20)
    lines = (tmp_path / "port.csv").read_bytes().split(b"\n")
    assert lines == clean.split(b"\n")[: 1 + 20] + [b""]
    monkeypatch.setattr(engine, "_block_counts", real)
    assert _banded(tmp_path, presence, axes, band=20, resume=True) == clean


def test_worker_fault_reaches_the_caller(single, tmp_path, monkeypatch):
    """PARFASTAAI_TEST_WORKER_FAULT: the finish worker's failure stops the
    producer, is raised after the join and leaves no partial band, as in
    the JAX engine."""
    meta, presence = single
    monkeypatch.setenv("PARFASTAAI_TEST_WORKER_FAULT", "1")
    with pytest.raises(RuntimeError, match="injected finish-worker fault"):
        _banded(tmp_path, presence, modes.all_vs_all_axes(meta), band=4)
    with pytest.raises(RuntimeError, match="injected finish-worker fault"):
        _jax_banded(tmp_path, presence, jax_modes.all_vs_all_axes(meta), band=4)
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert got.count(b"\n") == 1  # the header


def test_device_budget_raises_before_the_csv(single, tmp_path, monkeypatch):
    """A budget of 1 byte stages the counts' slabs, with no word from the
    caller, and the CSV keeps the resident run's bytes."""
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    want = _banded(tmp_path, presence, axes, "resident", band=7, col_chunk=5)
    fresh = dataclasses.replace(presence)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    assert _banded(tmp_path, fresh, axes, band=7, col_chunk=5) == want
    assert engine.slab_stats(fresh, CPU)["uploaded"] > 0


def test_phases_name_every_stage(single, tmp_path):
    meta, presence = single
    phases = {}
    _banded(tmp_path, presence, modes.all_vs_all_axes(meta), band=16,
            phases=phases)
    assert {"Gram", "D2H", "host finish", "CSV write", "producer wait",
            "worker wait"} <= set(phases) <= {
        "host bucketize", "H2D", "Gram", "D2H", "host finish", "CSV write",
        "producer wait", "worker wait"}
    assert all(v >= 0 for v in phases.values()) and phases["Gram"] > 0


RESUME_HEADER = ",a,b,c\n"
RESUME_CASES = {
    # name: (file bytes or None, band, rows kept, bytes left)
    "absent": (None, 2, 0, None),
    "wrong_header": (b",a,b,x\nr0,1,2,3\nr1,1,2,3\n", 2, 0,
                     b",a,b,x\nr0,1,2,3\nr1,1,2,3\n"),
    "torn_header": (b",a,b,c", 2, 0, b",a,b,c"),
    "unaligned_rows": (b",a,b,c\nr0,1\nr1,2\nr2,3\nr3,4\nr4,5\n", 2, 4,
                       b",a,b,c\nr0,1\nr1,2\nr2,3\nr3,4\n"),
    "torn_row": (b",a,b,c\nr0,1\nr1,2\nr2,3\nr3", 3, 3,
                 b",a,b,c\nr0,1\nr1,2\nr2,3\n"),
    "less_than_a_band": (b",a,b,c\nr0,1\n", 2, 0, b",a,b,c\nr0,1\n"),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_point(case, tmp_path):
    """Rows kept and bytes left, equal to the JAX package's function on a
    copy of the same file."""
    content, band, rows, left = RESUME_CASES[case]
    paths = [tmp_path / "port.csv", tmp_path / "jax.csv"]
    if content is not None:
        for p in paths:
            p.write_bytes(content)
    assert engine._resume_point(str(paths[0]), RESUME_HEADER, band) == rows
    assert jax_engine._resume_point(str(paths[1]), RESUME_HEADER, band) == rows
    for p in paths:
        assert (p.read_bytes() if p.exists() else None) == left


@pytest.mark.parametrize("dtype", [np.int16, np.int32])
def test_finish_block(dtype, monkeypatch):
    """``jaccard_finish_block``: the native library and the NumPy fallback,
    bit-equal to each other, to ``jaccard_finish`` on the flattened pair
    list and to the JAX package's function."""
    rng = np.random.default_rng(3)
    P, A, B = 7, 5, 9
    counts = rng.integers(0, 50, (P, A, B)).astype(dtype)
    counts[rng.random((P, A, B)) < 0.3] = 0
    counts[:, 2, 4] = 0  # a pair that shares no protein
    ta = rng.integers(50, 200, (P, A)).astype(np.int32)
    tb = rng.integers(50, 200, (P, B)).astype(np.int32)
    from parfastaai_tpu_torch import native

    assert native.get_lib() is not None
    s_nat, n_nat = engine.jaccard_finish_block(counts, ta, tb)
    monkeypatch.setattr(engine, "native_jaccard_finish_block",
                        lambda *a: None)
    s_np, n_np = engine.jaccard_finish_block(counts, ta, tb)
    monkeypatch.undo()
    s_jax, n_jax = jax_engine.jaccard_finish_block(counts, ta, tb)
    s_pair, n_pair = engine.jaccard_finish(
        counts.reshape(P, A * B), np.repeat(ta, B, axis=1), np.tile(tb, (1, A))
    )
    assert n_nat[2, 4] == 0 and s_nat[2, 4] == 0.0
    for s, n in ((s_np, n_np), (s_jax, n_jax),
                 (s_pair.reshape(A, B), n_pair.reshape(A, B))):
        np.testing.assert_array_equal(s, s_nat)
        np.testing.assert_array_equal(n, n_nat)
        assert s.dtype == np.float64 and n.dtype == np.int32


def test_band_sweep_tool_dry_run(capsys):
    """``tools.exact_band_sweep`` on the CPU at a small size: one line per
    band with every stage, and equal bytes across the bands."""
    from parfastaai_tpu_torch.tools import exact_band_sweep

    exact_band_sweep.main(
        ["--genomes", "20", "--bands", "8,7,8", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[-1] == "all 3 CSVs hold the same bytes"
    for line, band in zip(lines, (8, 7, 8)):
        assert line.startswith(f"G=20 band {band} on cpu: wall ")
        assert all(f"{stage} " in line for stage in exact_band_sweep.STAGES)
