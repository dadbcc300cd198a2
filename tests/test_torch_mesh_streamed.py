"""The streamed engines' mesh branches in the port (``engine._use_staged``
with a mesh, ``_MeshSlabStore``, the ``_MeshResident`` and ``_MeshStaged``
placements under ``_block_sn`` and ``_block_counts``) against the JAX
package's, in one process on the CPU.

Every cell of a (rows, scp) mesh runs in turn through the port's bodies
(a ``Mesh`` with the cell's coordinates and no process group, so the scp
all-reduce is left out), the scp partials are added here in ascending
shard order and the row bands stacked, as tests/test_torch_mesh.py does;
the JAX package's engines run on the conftest's 8 virtual CPU devices.
Stated tolerances: counts equal; N equal; S bit-equal where both add the
same terms in the same order (one chunk a cell, whose two scp partials
add in either order, or scp = 1 with no bucket cut into chunks), else
within rtol 1e-6 (the port sums a rank's chunks, bucket by bucket, before
the scp all-reduce; the JAX package psums each chunk first).  The JAX package caches its slab store on the
presence object and keys slabs by (bucket, chunk, genomes), so every JAX
call here gets a presence object of its own.  The multi-process runs are
in test_torch_multiproc_streamed.py."""

import dataclasses

import numpy as np
import pytest
import torch

import parfastaai_tpu.api as jax_api
from parfastaai_tpu import engine as jax_engine
from parfastaai_tpu.etl.database import PresenceData, SCPDatabase, bucket_bounds
from parfastaai_tpu.parallel import mesh as jax_mesh
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu.types import DBMetaData
import parfastaai_tpu_torch.api as api
from parfastaai_tpu_torch import engine
from parfastaai_tpu_torch.parallel.mesh import (
    Mesh,
    assemble_counts,
    pad_rows,
    protein_layout,
    shard_proteins,
)

CPU = torch.device("cpu")
RTOL = 1e-6
MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)]
ROWS = np.array([3, 1, 4, 1, 5, 9, 2, 6, 12])  # a band of 9, one repeated


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """A 30-genome DB, 7 proteins of one width bucket."""
    path = str(tmp_path_factory.mktemp("torch_mesh_streamed") / "t.db")
    generate(path, n_genomes=30, n_proteins=7, pool_size=300,
             tetras_per_genome=100, seed=3)
    return path


def _bucketed() -> PresenceData:
    """13 genomes whose 7 proteins fall into several width buckets in
    another order than the proteins' own; one genome lacks a protein and
    one genome is empty (T = 0: the clamp matters)."""
    rng = np.random.default_rng(7)
    widths = np.array([300, 20, 280, 10, 140, 260, 30], np.int32)
    m = np.zeros((7, 13, 384), np.uint8)
    for p, w in enumerate(widths):
        m[p, :, :w] = rng.random((13, w)) < 0.4
    m[3, 4] = 0
    m[:, 9] = 0
    return PresenceData(
        meta=DBMetaData(protein_set=tuple(f"P{p}" for p in range(7)),
                        genome_set=tuple(f"g{i:02d}" for i in range(13))),
        m=m, t=m.sum(2).astype(np.int32), widths=widths,
        tetramer_ids=[np.arange(w, dtype=np.int32) for w in widths],
    )


def _presence(case: str, db: str) -> PresenceData:
    if case == "bucketed":
        return _bucketed()
    d = SCPDatabase(db)
    try:
        return d.load_presence()
    finally:
        d.close()


def _fresh(presence) -> PresenceData:
    """The same tensors in a presence object without any cache."""
    return dataclasses.replace(presence)


def _bit_equal_to_jax(presence, n_ids: int, staged: bool, scp: int) -> bool:
    """Whether a cell's S is the JAX package's bit for bit: each adds its
    chunks (resident: its buckets) one after another, the JAX package
    psums each over scp first, the port sums a bucket's chunks first."""
    plan = engine._bucket_plan(presence)
    chunks = (len(list(engine._split_plan(plan, n_ids, CPU))) if staged
              else len(plan))
    return chunks == 1 or (scp == 1 and chunks == len(plan))


def _sn(presence, staged, mesh, rids, cids):
    """(S, N) of one block from the placement ``staged`` picks."""
    place = engine._placement(presence, CPU, staged, mesh)
    return engine._block_sn(place, rids, cids, rids, cids)


def _counts(presence, staged, mesh, rids, cids):
    """The count block (with a mesh: and its layout) of one block."""
    return engine._block_counts(engine._placement(presence, CPU, staged,
                                                  mesh), rids, cids)


def _cells_sn(staged, presence, rows, scp, rids, cids):
    """(S, N) of the block from every cell of a (rows, scp) mesh in turn,
    scp partials added in ascending shard order, bands stacked."""
    bands = []
    for r in range(rows):
        s = n = None
        for sh in range(scp):
            s_p, n_p = _sn(presence, staged, Mesh(rows, scp, (r, sh), None),
                           rids, cids)
            s, n = (s_p, n_p) if s is None else (s + s_p, n + n_p)
        bands.append((s, n))
    return (torch.cat([b[0] for b in bands]).numpy()[: len(rids)],
            torch.cat([b[1] for b in bands]).numpy()[: len(rids)])


@pytest.mark.parametrize("rows,scp", MESHES)
@pytest.mark.parametrize("staged", [False, True], ids=["resident", "staged"])
@pytest.mark.parametrize("case", ["bucketed", "db"])
def test_block_engines_match_jax(case, staged, rows, scp, db, monkeypatch):
    """Every cell of the resident and the staged f32 mesh engine against
    the JAX package's staged mesh engine (whose chunks are the width
    buckets when no bucket is cut); staged: slabs of two proteins."""
    presence = _presence(case, db)
    kb = max(k for _, _, k in bucket_bounds(presence.widths)[1])
    G = presence.m.shape[1]
    cids = np.arange(G)[::-1].copy()
    n_ids = max(len(ROWS), G)
    if staged:
        monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(2 * n_ids * kb))
    s, n = _cells_sn(staged, _fresh(presence), rows, scp, ROWS, cids)
    rp = pad_rows(ROWS, rows)
    block_sn = jax_engine._staged_mesh_block_engine(
        _fresh(presence), jax_mesh.make_mesh(rows, scp), False, False)
    s_w, n_w = (np.asarray(x)[: len(ROWS)]
                for x in block_sn(rp, cids, rp, cids, len(rp), G))
    np.testing.assert_array_equal(n, n_w)
    if _bit_equal_to_jax(presence, n_ids, staged, scp):
        np.testing.assert_array_equal(s, s_w)
    else:
        np.testing.assert_allclose(s, s_w, rtol=RTOL, atol=0)
    # one device's engines: a row split changes no value
    s_1, n_1 = (x.numpy()
                for x in _sn(_fresh(presence), staged, None, ROWS, cids))
    np.testing.assert_array_equal(n, n_1)
    if scp == 1:
        np.testing.assert_array_equal(s, s_1)
    else:
        np.testing.assert_allclose(s, s_1, rtol=RTOL, atol=0)


def _cells_counts(staged, presence, rows, scp, rids, cids):
    """The (P, len(rids), len(cids)) count block put together from every
    cell, as process 0 puts the gathered cells together."""
    cells, layout = [], None
    for r in range(rows):
        for sh in range(scp):
            counts, layout = _counts(presence, staged,
                                     Mesh(rows, scp, (r, sh), None), rids,
                                     cids)
            cells.append(counts.numpy())
    return assemble_counts(Mesh(rows, scp, None, None), np.stack(cells),
                           layout, presence.t.shape[0], len(rids))


@pytest.mark.parametrize("rows,scp", MESHES)
@pytest.mark.parametrize("staged", [False, True], ids=["resident", "staged"])
def test_count_engines_match_jax(staged, rows, scp, monkeypatch):
    """Integer counts of every cell, put together, equal the JAX package's
    mesh count engines' (sliced ``[:len(idx)]``) and one device's."""
    presence = _bucketed()
    G = presence.m.shape[1]
    cids = np.arange(G)
    if staged:
        monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(2 * G * 384))
    got = _cells_counts(staged, _fresh(presence), rows, scp, ROWS, cids)
    rp = pad_rows(ROWS, rows)
    jax_make = (jax_engine._staged_mesh_count_engine if staged
                else jax_engine._mesh_count_engine)
    want = np.zeros_like(got)
    for idx, dev in jax_make(_fresh(presence), jax_mesh.make_mesh(rows, scp))(
            rp, cids, len(rp), G):
        want[idx] = np.asarray(dev)[: len(idx), : len(ROWS)]
    np.testing.assert_array_equal(got, want)
    one = _counts(_fresh(presence), False, None, ROWS, cids)
    np.testing.assert_array_equal(got, one.numpy())
    assert got.dtype == np.int16


# placement -> (staged, mesh shape or None, slabs of two proteins)
PLACEMENTS = {
    "resident": (False, None, False),
    "staged": (True, None, True),
    "mesh_resident": (False, (2, 1), False),
    "mesh_staged": (True, (2, 2), False),
}


@pytest.mark.parametrize("body", ["sn", "counts"])
@pytest.mark.parametrize("placement", sorted(PLACEMENTS))
def test_placements_agree_with_the_resident_one(placement, body,
                                               monkeypatch):
    """Each of the four placements under each body, on a presence of
    several width buckets, gives the resident placement's block: counts
    equal (and the einsum's); N equal; S bit-equal where every bucket is
    one chunk and one protein shard, else within RTOL (slabs of two
    proteins cut the buckets, or two shards add their sums)."""
    presence = _bucketed()
    staged, shape, two = PLACEMENTS[placement]
    G = presence.m.shape[1]
    cids = np.arange(G)[::-1].copy()
    if two:
        monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(2 * G * 384))
    if body == "counts":
        want = _counts(_fresh(presence), False, None, ROWS, cids).numpy()
        m = presence.m.astype(np.int64)
        np.testing.assert_array_equal(
            want, np.einsum("pak,pbk->pab", m[:, ROWS], m[:, cids]))
        got = (_counts(_fresh(presence), staged, None, ROWS, cids).numpy()
               if shape is None else
               _cells_counts(staged, _fresh(presence), *shape, ROWS, cids))
        np.testing.assert_array_equal(got, want)
        return
    s_w, n_w = (x.numpy()
                for x in _sn(_fresh(presence), False, None, ROWS, cids))
    if shape is None:
        s, n = (x.numpy()
                for x in _sn(_fresh(presence), staged, None, ROWS, cids))
    else:
        s, n = _cells_sn(staged, _fresh(presence), *shape, ROWS, cids)
    np.testing.assert_array_equal(n, n_w)
    plan = engine._bucket_plan(presence)
    chunks = len(list(engine._split_plan(plan, G, CPU))) if staged else 0
    if (shape is None or shape[1] == 1) and chunks in (0, len(plan)):
        np.testing.assert_array_equal(s, s_w)
    else:
        np.testing.assert_allclose(s, s_w, rtol=RTOL, atol=0)


def test_protein_shards_and_layout():
    """Shards are contiguous, padded with -1 to a multiple of scp, and
    the layout lists each shard's rows chunk after chunk."""
    idx = np.array([5, 2, 7, 0, 3])
    assert shard_proteins(idx, 0, 2).tolist() == [5, 2, 7]
    assert shard_proteins(idx, 1, 2).tolist() == [0, 3, -1]
    assert shard_proteins(idx, 3, 4).tolist() == [-1, -1]
    layout = protein_layout([idx, np.array([1, 4])], 2)
    assert layout.tolist() == [[5, 2, 7, 1], [0, 3, -1, 4]]


def test_rank_past_the_mesh_computes_nothing(monkeypatch):
    """A rank past the mesh gives zero cells of its row's shape, keeps
    the store's books and uploads nothing."""
    presence = _bucketed()
    monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(2 * 13 * 384))
    idle = Mesh(2, 2, None, None)
    cids = np.arange(13)
    for staged in (False, True):
        s, n = _sn(presence, staged, idle, ROWS, cids)
        assert s.shape == n.shape == (5, 13)
        assert not s.any() and not n.any()
    for staged in (False, True):
        counts, layout = _counts(presence, staged, idle, ROWS, cids)
        assert counts.shape == (layout.shape[1], 5, 13) and not counts.any()
    stats = engine.slab_stats(presence, CPU, idle)
    assert stats["slabs"] > 0 and stats["held"] > 0
    store = engine._MeshStaged(presence, CPU, idle)._store
    assert all(slab is None for slab, _ in store._slabs.values())


@pytest.mark.parametrize(
    "budget,scp,staged,env,want",
    [
        (None, 1, None, None, False),  # the CPU has no budget
        ("bytes", 1, None, None, True),  # one shard: all the presence
        ("bytes", 2, None, None, False),  # two shards: half of it each
        ("1", 2, None, None, True),
        ("1", 2, False, None, False),
        (None, 4, True, None, True),
        ("1", 2, None, "0", False),
        (None, 1, None, "yes", True),
    ],
)
def test_use_staged_mesh_decisions(budget, scp, staged, env, want,
                                   monkeypatch):
    """The port's ``_use_staged`` over a mesh decides as the JAX package's
    ``_use_staged_mesh``: the budget against the bucketed presence over
    scp, then ``staged`` and PARFASTAAI_STAGED."""
    presence = _bucketed()
    for var in ("PARFASTAAI_HBM_BYTES", "PARFASTAAI_STAGED"):
        monkeypatch.delenv(var, raising=False)
    if budget == "bytes":
        budget = str(engine.presence_device_bytes(presence) * 3 // 4)
    if budget is not None:
        monkeypatch.setenv("PARFASTAAI_HBM_BYTES", budget)
    if env is not None:
        monkeypatch.setenv("PARFASTAAI_STAGED", env)
    got = engine._use_staged(presence, CPU, staged,
                             Mesh(1, scp, (0, 0), None))
    assert got == jax_engine._use_staged_mesh(presence, scp, staged) == want


def test_mesh_slab_store_keyed_by_content(monkeypatch):
    """Slabs are keyed by what they hold: a second call on one presence
    with another block width (other protein chunks) is served its own
    slabs and gives a fresh presence's values; a repeated call is served
    from the store."""
    presence = _bucketed()
    monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(24 * 384))
    cell = Mesh(1, 2, (0, 1), None)
    cids = np.arange(13)
    for rows in (ROWS[:8], ROWS[:6], ROWS[:8]):
        got = _sn(presence, True, cell, rows, cids[:8])
        want = _sn(_fresh(presence), True, cell, rows, cids[:8])
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    stats = engine.slab_stats(presence, CPU, cell)
    assert stats["hits"] > 0
    fresh = _fresh(presence)
    for rows in (ROWS[:8], ROWS[:6]):
        got, layout = _counts(presence, True, cell, rows, cids[:8])
        want, want_layout = _counts(fresh, True, cell, rows, cids[:8])
        assert torch.equal(got, want)
        np.testing.assert_array_equal(layout, want_layout)


def test_jax_mesh_slab_key_fault_raises(monkeypatch):
    """Records a fault of the reference: its mesh slab store keys a slab
    by (kind, (bucket, chunk), genomes), so a second staged mesh call on
    one presence whose block width cuts the buckets otherwise is served
    the first call's row slabs and fails (or, where the sizes happen to
    agree, computes with other proteins).  The port keys slabs by content
    (test_mesh_slab_store_keyed_by_content)."""
    presence = _bucketed()
    monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(24 * 384))
    jmesh = jax_mesh.make_mesh(1, 2)
    block_sn = jax_engine._staged_mesh_block_engine(presence, jmesh, False,
                                                    False)
    rows, cids = ROWS[:8], np.arange(13)
    block_sn(rows, cids[:8], rows, cids[:8], 8, 8)
    with pytest.raises(ValueError):
        block_sn(rows, cids[:12], rows, cids[:12], 8, 12)


@pytest.mark.parametrize("engine_name", ["streamed", "streamed-exact"])
def test_api_staged_mesh_in_process_matches_jax(engine_name, db, tmp_path,
                                                monkeypatch):
    """``aji_to_csv(engine=..., mesh=(1, 1), staged=True)`` in one process
    writes the JAX API's bytes at the same mesh (the f32 engine: its device
    leg) and the bytes of the port's resident run without a mesh (no bucket
    is cut into chunks here); test_torch_api.py holds the resident mesh."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    paths = {k: tmp_path / f"{k}.csv" for k in ("jax", "port", "plain")}
    jax_api.aji_to_csv(str(paths["jax"]), db, engine=engine_name,
                       mesh=(1, 1), staged=True)
    api.aji_to_csv(str(paths["port"]), db, engine=engine_name, mesh=(1, 1),
                   staged=True, device="cpu")
    api.aji_to_csv(str(paths["plain"]), db, engine=engine_name,
                   device="cpu")
    got = paths["port"].read_bytes()
    assert got == paths["jax"].read_bytes() == paths["plain"].read_bytes()


@pytest.mark.parametrize("engine_name", ["streamed", "streamed-exact"])
def test_api_mesh_larger_than_the_world_raises(engine_name, db, tmp_path):
    out = tmp_path / "x.csv"
    with pytest.raises(ValueError, match="Need 2 devices, have 1"):
        api.aji_to_csv(str(out), db, engine=engine_name, mesh=(2, 1),
                       device="cpu")
    assert not out.exists()
