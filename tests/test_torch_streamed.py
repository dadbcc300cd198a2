"""The port's f32 streamed engine (``compute_streamed``) on the CPU, on
small synthetic databases.

Against the JAX package's ``compute_streamed`` in every mode, the JAX side
once on its default CPU leg (the host numpy block) and once on its device
leg (PARFASTAAI_FORCE_DEVICE=1: the XLA-scan ``fused_sn_block`` through
``_bucket_block_engine``).  Stated tolerance: the same header and row names
as bytes; a cell is the text ``0`` in one CSV exactly where it is in the
other (diagonal and N = 0); values within rtol 1e-6.

Within the port the CSV's bytes do not depend on band, chunk, mirror or
resume, and a failure on either side of the pipeline reaches the caller
and leaves no thread behind."""

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
)
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu.types import DBMetaData
from parfastaai_tpu.types import PFAAIError as JaxPFAAIError
from parfastaai_tpu_torch import engine, modes
from parfastaai_tpu_torch.ops import sn_rect
from parfastaai_tpu_torch.types import ErrorCode, PFAAIError

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
def single(tmp_path_factory):
    """(meta, presence) of a 40-genome DB (6 proteins, pool 300, ~100
    tetramers per genome; one width bucket)."""
    path = str(tmp_path_factory.mktemp("torch_streamed") / "target.db")
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
    d = tmp_path_factory.mktemp("torch_streamed_qt")
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


def _hand_presence(m: np.ndarray, names, widths=None):
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
    width buckets in another order than the proteins' own; one genome lacks
    a protein and one genome is empty (its pairs share no protein)."""
    rng = np.random.default_rng(5)
    widths = np.array([300, 20, 280, 10, 140], np.int32)
    m = np.zeros((5, 11, 384), np.uint8)
    for p, w in enumerate(widths):
        m[p, :, :w] = rng.random((11, w)) < 0.4
    m[3, 4] = 0  # a genome without protein 3
    m[:, 9] = 0  # a genome without any tetramer
    return _hand_presence(m, [f"g{i}" for i in range(11)], widths)


def _axes_args(axes):
    return (axes.row_db_ids, axes.col_db_ids), dict(
        row_denom_ids=axes.row_denom_ids, col_denom_ids=axes.col_denom_ids
    )


def _streamed(tmp_path, presence, axes, name="port", **kw) -> bytes:
    """The port's streamed engine's CSV."""
    out = tmp_path / f"{name}.csv"
    ids, denoms = _axes_args(axes)
    engine.compute_streamed(
        presence, *ids, str(out), axes.query_names, axes.target_names, CPU,
        **denoms, **kw,
    )
    return out.read_bytes()


def _jax_streamed(tmp_path, presence, axes, name="jax", **kw) -> bytes:
    """The JAX package's streamed engine's CSV."""
    out = tmp_path / f"{name}.csv"
    ids, denoms = _axes_args(axes)
    jax_engine.compute_streamed(
        presence, *ids, str(out), axes.query_names, axes.target_names,
        **denoms, **kw,
    )
    return out.read_bytes()


def _cells(csv: bytes, sep=","):
    """(header line, row names, cell texts) of a CSV."""
    lines = csv.decode().split("\n")
    assert lines[-1] == ""
    rows = [ln.split(sep) for ln in lines[1:-1]]
    return lines[0], [r[0] for r in rows], [r[1:] for r in rows]


def assert_csv_close(got: bytes, want: bytes, sep=",") -> bool:
    """The stated tolerance.  Returns whether the bytes were equal."""
    g_head, g_names, g_cells = _cells(got, sep)
    w_head, w_names, w_cells = _cells(want, sep)
    assert g_head == w_head and g_names == w_names
    g_txt = np.array(g_cells, dtype=object).reshape(len(g_names), -1)
    w_txt = np.array(w_cells, dtype=object).reshape(len(w_names), -1)
    assert g_txt.shape == w_txt.shape
    np.testing.assert_array_equal(g_txt == "0", w_txt == "0")
    np.testing.assert_allclose(
        g_txt.astype(np.float64), w_txt.astype(np.float64), rtol=RTOL, atol=0
    )
    return got == want


def _mode_axes(mode, single, two_db, mods):
    """(presence, axes) of one run mode, by ``mods`` (either package's
    ``modes`` module)."""
    if mode.startswith("qt"):
        meta, presence = two_db
        return presence, mods.query_target_axes(
            meta, compat_qt_t_swap=mode == "qt"
        )
    meta, presence = single
    if mode == "qsub":
        names = [meta.genome_set[i] for i in QUERIES]
        return presence, mods.query_subset_axes(meta, names)
    return presence, mods.all_vs_all_axes(meta)


MODES = ["all", "qsub", "qt", "qt_noswap"]


@pytest.mark.parametrize("jax_leg", ["host", "device"])
@pytest.mark.parametrize("mode", MODES)
def test_matches_jax(mode, jax_leg, single, two_db, tmp_path, monkeypatch):
    if jax_leg == "device":
        monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    shape = dict(band=7, col_chunk=5)
    presence, axes = _mode_axes(mode, single, two_db, modes)
    got = _streamed(tmp_path, presence, axes, **shape)
    _, jax_axes = _mode_axes(mode, single, two_db, jax_modes)
    want = _jax_streamed(tmp_path, presence, jax_axes, **shape)
    assert_csv_close(got, want)
    if mode == "all":
        _, _, cells = _cells(got)
        assert all(cells[i][i] == "0" for i in range(len(cells)))


def test_denominator_ids_change_the_values(two_db, tmp_path):
    """The two settings of the T swap write different CSVs, so the
    denominator ids reach the kernel's T operands."""
    meta, presence = two_db
    a, b = (
        _streamed(tmp_path, presence,
                  modes.query_target_axes(meta, compat_qt_t_swap=c), str(c))
        for c in (True, False)
    )
    assert a != b


@pytest.mark.parametrize("jax_leg", ["host", "device"])
def test_width_buckets_match_jax(bucketed, jax_leg, tmp_path, monkeypatch):
    """Several width buckets, a genome without a protein and an empty
    genome: buckets summed in bucket order, N = 0 cells print ``0``."""
    if jax_leg == "device":
        monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    meta, presence = bucketed
    assert len(engine.to_device_buckets(presence, CPU)) > 1
    got = _streamed(tmp_path, presence, modes.all_vs_all_axes(meta),
                    band=4, col_chunk=3)
    want = _jax_streamed(tmp_path, presence, jax_modes.all_vs_all_axes(meta),
                         band=4, col_chunk=3)
    assert_csv_close(got, want)
    _, _, cells = _cells(got)
    assert cells[0][9] == cells[9][3] == "0" and b"nan" not in got


@pytest.mark.parametrize(
    "band,col_chunk", [(1, 1), (2, 1), (1, 2), (3, 2), (7, 5), (1024, 4096)]
)
@pytest.mark.parametrize("mode", ["all", "qsub", "qt"])
def test_bytes_independent_of_block_shape(
    mode, band, col_chunk, single, two_db, tmp_path
):
    """Blocks have their exact shape and a cell's value does not depend on
    its block: every band/chunk pair writes the bytes of one whole block,
    with skipped, straddling and short blocks on the symmetric walk."""
    presence, axes = _mode_axes(mode, single, two_db, modes)
    whole = _streamed(tmp_path, presence, axes, "whole", band=10**6,
                      col_chunk=10**6)
    assert _streamed(tmp_path, presence, axes, band=band,
                     col_chunk=col_chunk) == whole


def _spy_blocks(monkeypatch):
    """Shapes of the blocks the engine computes, through a wrapped
    ``_block_sn``."""
    seen = []
    real = engine._block_sn

    def spy(place, rids, cids, *a):
        seen.append((len(rids), len(cids)))
        return real(place, rids, cids, *a)

    monkeypatch.setattr(engine, "_block_sn", spy)
    return seen


@pytest.mark.parametrize("band,col_chunk", [(1, 1), (3, 2), (10, 10), (7, 16)])
def test_mirror_on_equals_mirror_off(
    single, tmp_path, monkeypatch, capfd, band, col_chunk
):
    """The symmetric walk skips the chunks wholly below the diagonal and
    fills them from earlier bands; PARFASTAAI_MIRROR_BYTES=1 forces the
    full square and says so.  The caller's col_chunk is kept either way."""
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    seen = _spy_blocks(monkeypatch)
    shape = dict(band=band, col_chunk=col_chunk)
    mirrored = _streamed(tmp_path, presence, axes, "mirrored", **shape)
    computed = sum(
        1
        for r0 in range(0, 40, band)
        for c0 in range(0, 40, col_chunk)
        if c0 + col_chunk > r0
    )
    n_blocks = -(-40 // band) * -(-40 // col_chunk)
    assert len(seen) == computed and (computed < n_blocks or band >= 40)
    assert max(nc for _, nc in seen) == col_chunk
    assert "mirror disabled" not in capfd.readouterr().err
    seen.clear()
    monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
    full = _streamed(tmp_path, presence, axes, "full", **shape)
    assert len(seen) == n_blocks
    err = capfd.readouterr().err
    assert "NOTE: symmetric mirror disabled (assembled-band store 6400 B " \
           "exceeds PARFASTAAI_MIRROR_BYTES=1); computing the full square" in err
    assert mirrored == full


def test_mirror_note_matches_jax(single, tmp_path, monkeypatch, capfd):
    """The NOTE's two reasons, word for word the JAX engine's."""
    meta, presence = single
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
    notes = {}
    for name, fn, axes in (
        ("port", _streamed, modes.all_vs_all_axes(meta)),
        ("jax", _jax_streamed, jax_modes.all_vs_all_axes(meta)),
    ):
        fn(tmp_path, presence, axes, name, band=10)
        budget = capfd.readouterr().err
        monkeypatch.delenv("PARFASTAAI_MIRROR_BYTES")
        fn(tmp_path, presence, axes, name, band=10, resume=True)
        resumed = capfd.readouterr().err
        monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
        notes[name] = [
            [ln for ln in text.splitlines() if ln.startswith("NOTE:")]
            for text in (budget, resumed)
        ]
    assert notes["port"] == notes["jax"]
    assert len(notes["port"][0]) == len(notes["port"][1]) == 1
    assert "--resume keeps earlier bands" in notes["port"][1][0]


def test_rectangular_runs_take_no_mirror(two_db, tmp_path, monkeypatch, capfd):
    meta, presence = two_db
    seen = _spy_blocks(monkeypatch)
    _streamed(tmp_path, presence, modes.query_target_axes(meta), band=5,
              col_chunk=7)
    assert len(seen) == -(-24 // 5) * -(-40 // 7)
    assert "NOTE" not in capfd.readouterr().err


RESUME_FILES = {
    # header + 2 bands of 3 rows + 1 row of the third + a torn line
    "torn": lambda lines: b"\n".join(lines[:8]) + b"\n" + lines[8][:13],
    "wrong_header": lambda lines: b",wrong,header\n" + b"\n".join(lines[1:7]) + b"\n",
    "complete": lambda lines: b"\n".join(lines),
    "absent": lambda lines: None,
}


@pytest.mark.parametrize("case", sorted(RESUME_FILES))
@pytest.mark.parametrize("mode", ["all", "qt"])
def test_resume_restores_the_bytes(case, mode, single, two_db, tmp_path):
    """--resume from a torn file, a mismatched header, a complete file and
    no file, as the JAX engine does from a copy of the same file."""
    presence, axes = _mode_axes(mode, single, two_db, modes)
    _, jax_axes = _mode_axes(mode, single, two_db, jax_modes)
    shape = dict(band=3, col_chunk=4)
    want = _streamed(tmp_path, presence, axes, "full", **shape)
    start = RESUME_FILES[case](want.split(b"\n"))
    for name in ("port", "jax"):
        if start is not None:
            (tmp_path / f"{name}.csv").write_bytes(start)
    assert _streamed(tmp_path, presence, axes, resume=True, **shape) == want
    resumed = _jax_streamed(tmp_path, presence, jax_axes, resume=True, **shape)
    assert_csv_close(resumed, want)


def test_resume_computes_only_the_missing_bands(single, tmp_path, monkeypatch):
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    want = _streamed(tmp_path, presence, axes, "full", band=10, col_chunk=40)
    (tmp_path / "port.csv").write_bytes(
        b"\n".join(want.split(b"\n")[: 1 + 25]) + b"\n")
    seen = _spy_blocks(monkeypatch)
    assert _streamed(tmp_path, presence, axes, band=10, col_chunk=40,
                     resume=True) == want
    assert seen == [(10, 40), (10, 40)]  # rows 20..39


def test_empty_query_axis_writes_the_header_only(single, tmp_path):
    meta, presence = single
    cols = np.arange(40, dtype=np.int32)
    out = tmp_path / "empty.csv"
    for fn, dev in ((engine.compute_streamed, (CPU,)),
                    (jax_engine.compute_streamed, ())):
        fn(presence, np.zeros(0, np.int32), cols, str(out), (),
           meta.genome_set, *dev)
        assert out.read_bytes() == (
            "," + ",".join(meta.genome_set) + "\n").encode()


def _no_stray_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("pfaai-")]


def test_writer_fault_hook_reaches_the_caller(single, tmp_path, monkeypatch):
    """PARFASTAAI_TEST_WORKER_FAULT: the writer's failure stops the
    producer, is raised after the join and leaves the header alone, as in
    the JAX engine."""
    meta, presence = single
    monkeypatch.setenv("PARFASTAAI_TEST_WORKER_FAULT", "1")
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    with pytest.raises(RuntimeError, match="injected csv-writer fault"):
        _streamed(tmp_path, presence, modes.all_vs_all_axes(meta), band=4)
    with pytest.raises(RuntimeError, match="injected csv-writer fault"):
        _jax_streamed(tmp_path, presence, jax_modes.all_vs_all_axes(meta), band=4)
    got = (tmp_path / "port.csv").read_bytes()
    assert got == (tmp_path / "jax.csv").read_bytes()
    assert got.count(b"\n") == 1  # the header
    assert _no_stray_threads() == []


def test_writer_error_mid_run_reaches_the_caller(single, tmp_path, monkeypatch):
    """The formatter fails at its second call (a full disk, say): the
    caller sees that error, the first band is in the file, the producer did
    not hang and no thread is left."""
    meta, presence = single
    calls = {"n": 0}
    orig = engine.format_matrix

    def boom(mat, sep):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise OSError("disk full (simulated)")
        return orig(mat, sep)

    monkeypatch.setattr(engine, "format_matrix", boom)
    with pytest.raises(OSError, match="disk full"):
        _streamed(tmp_path, presence, modes.all_vs_all_axes(meta), band=1,
                  col_chunk=4)
    assert calls["n"] == 2
    assert (tmp_path / "port.csv").read_bytes().count(b"\n") == 2
    assert _no_stray_threads() == []


def test_producer_failure_leaves_whole_bands_and_resumes(
    single, tmp_path, monkeypatch
):
    """A device failure inside the second band must not write that band
    (its other chunks are uninitialised memory), and --resume finishes
    the file."""
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    shape = dict(band=20, col_chunk=10)
    clean = _streamed(tmp_path, presence, axes, "clean", **shape)
    calls = []
    real = engine._block_sn

    def failing(*a):
        calls.append(1)
        if len(calls) == 6:  # the second band's second computed chunk
            raise RuntimeError("injected device failure")
        return real(*a)

    monkeypatch.setattr(engine, "_block_sn", failing)
    with pytest.raises(RuntimeError, match="injected device failure"):
        _streamed(tmp_path, presence, axes, **shape)
    lines = (tmp_path / "port.csv").read_bytes().split(b"\n")
    assert lines == clean.split(b"\n")[: 1 + 20] + [b""]
    assert _no_stray_threads() == []
    monkeypatch.setattr(engine, "_block_sn", real)
    assert _streamed(tmp_path, presence, axes, resume=True, **shape) == clean


def test_approx_needs_the_cuda_kernel(single, tmp_path):
    """``approx`` exists only in the CUDA kernel: on the CPU the engine
    raises before anything is uploaded or written, as the JAX engine does
    off the TPU; ``precise`` runs (the plain version divides in IEEE)."""
    meta, presence = single
    fresh = PresenceData(meta=presence.meta, m=presence.m, t=presence.t,
                         widths=presence.widths,
                         tetramer_ids=presence.tetramer_ids)
    with pytest.raises(PFAAIError) as e:
        _streamed(tmp_path, fresh, modes.all_vs_all_axes(meta), approx=True)
    assert e.value.code == ErrorCode.CONSTRUCT_ERROR
    assert "--approx requires the CUDA streamed kernel" in str(e.value)
    assert not (tmp_path / "port.csv").exists()
    assert not getattr(fresh, "_torch_cache", None)
    with pytest.raises(JaxPFAAIError) as e:
        _jax_streamed(tmp_path, presence, jax_modes.all_vs_all_axes(meta),
                      approx=True)
    assert int(e.value.code) == int(ErrorCode.CONSTRUCT_ERROR)
    precise = _streamed(tmp_path, presence, modes.all_vs_all_axes(meta),
                        "precise", precise=True)
    assert precise == _streamed(tmp_path, presence, modes.all_vs_all_axes(meta))


def test_device_budget_raises_before_the_csv(single, tmp_path, monkeypatch):
    """A budget of 1 byte stages the blocks' slabs, with no word from the
    caller, and the CSV keeps the resident run's bytes (no bucket is split
    into chunks at this size)."""
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    want = _streamed(tmp_path, presence, axes, "resident", band=7,
                     col_chunk=5)
    fresh = dataclasses.replace(presence)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "1")
    assert _streamed(tmp_path, fresh, axes, band=7, col_chunk=5) == want
    assert engine.slab_stats(fresh, CPU)["uploaded"] > 0


def test_no_kernel_launch_on_the_cpu(single, tmp_path):
    meta, presence = single
    before = sn_rect.LAUNCHES
    _streamed(tmp_path, presence, modes.all_vs_all_axes(meta), band=8)
    assert sn_rect.LAUNCHES == before == 0


def test_phases_name_every_stage(single, tmp_path):
    meta, presence = single
    phases = {}
    _streamed(tmp_path, presence, modes.all_vs_all_axes(meta), band=16,
              phases=phases)
    stages = {"gather", "kernel", "AJI mask", "D2H", "host assembly",
              "CSV write", "producer wait", "writer wait"}
    assert stages <= set(phases) <= stages | {"host bucketize", "H2D"}
    assert all(v >= 0 for v in phases.values()) and phases["kernel"] > 0


def test_mask_aji_bit_equal_to_jax():
    """``_mask_aji`` on numpy inputs from a seed: S / N in IEEE f32 with
    N = 0 cells at 0, bit for bit the JAX function's."""
    rng = np.random.default_rng(11)
    n = rng.integers(0, 80, (37, 53)).astype(np.int32)
    n[rng.random(n.shape) < 0.2] = 0
    s = (rng.random(n.shape) * n).astype(np.float32)
    got = engine._mask_aji(torch.from_numpy(s), torch.from_numpy(n))
    want = np.asarray(jax_engine._mask_aji(s, n))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isnan(got.numpy()).any() and (got.numpy()[n == 0] == 0).all()


@pytest.mark.parametrize("sync", [True, False])
def test_block_engine_clock(sync, bucketed, monkeypatch):
    """``_block_sn`` on the resident placement with a clock that does not
    synchronise returns the values of a synchronising one, calls ``_sync``
    for no block, and still splits its time into ``gather`` and
    ``kernel``."""
    _, presence = bucketed
    place = engine._placement(presence, CPU, False)  # resident before
    syncs = []
    monkeypatch.setattr(engine, "_sync", lambda device: syncs.append(device))
    phases = {}
    clock = engine._StageClock(CPU, phases, sync=sync)
    rows, cols = np.array([9, 10, 3]), np.arange(11)
    s, n = engine._block_sn(place, rows, cols, rows, cols, clock=clock)
    assert bool(syncs) == sync
    clock.close()
    assert set(phases) == {"gather", "kernel"} and phases["kernel"] > 0
    monkeypatch.undo()
    s_ref, n_ref = engine._block_sn(place, rows, cols, rows, cols)
    assert torch.equal(s, s_ref) and torch.equal(n, n_ref)


def test_block_downloads_on_the_cpu_hands_the_memory_over():
    """On the CPU the pool has no stream and no buffer: the block's own
    memory reaches the reader, whatever its dtype and rank."""
    pool = engine._BlockDownloads(CPU, 12, torch.float32, n_buffers=4)
    block = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    download = pool.fetch(lambda: block)
    got = download.wait()
    assert got.dtype == np.float32 and np.shares_memory(got, block.numpy())
    download.release()
    pool.close()
    assert pool.d2h_s == 0.0 and pool.wait_s == 0.0 and pool.compute_s >= 0.0


def test_band_sweep_tool_dry_run(capsys):
    """``tools.streamed_band_sweep`` on the CPU at a small size: one line
    per band with every stage, and equal bytes across the bands."""
    from parfastaai_tpu_torch.tools import streamed_band_sweep

    before = engine._FORMAT_SLAB_BYTES
    streamed_band_sweep.main(
        ["--genomes", "20", "--bands", "8,7,8", "--slab-mib", "16,0.0005,16",
         "--device", "cpu"])
    assert engine._FORMAT_SLAB_BYTES == before
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and lines[-1] == "all 3 CSVs hold the same bytes"
    for line, band, mib in zip(lines, (8, 7, 8), ("16", "0.0005", "16")):
        assert line.startswith(f"G=20 band {band} slab {mib} MiB on cpu: wall ")
        assert all(f"{stage} " in line for stage in streamed_band_sweep.STAGES)


@pytest.mark.parametrize("slab_rows", [1, 3, 16])
def test_bytes_independent_of_the_writers_slabs(
    slab_rows, single, tmp_path, monkeypatch
):
    """The writer formats a band in slabs of rows (one slab at these sizes
    unless the slab is made small): rows keep their order and names."""
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    whole = _streamed(tmp_path, presence, axes, "whole", band=16)
    calls = []
    real = engine.format_matrix
    monkeypatch.setattr(
        engine, "format_matrix",
        lambda mat, sep: calls.append(len(mat)) or real(mat, sep))
    monkeypatch.setattr(engine, "_FORMAT_SLAB_BYTES", 8 * 40 * slab_rows)
    assert _streamed(tmp_path, presence, axes, band=16) == whole
    assert max(calls) == min(slab_rows, 16) and sum(calls) == 40
