"""The port's mesh (``parfastaai_tpu_torch.parallel.mesh``) and
``engine.compute_sharded`` against the JAX package's, in one process on the
CPU.

Every cell of a (rows, scp) mesh runs in turn through its own program
(``upload_shard``, ``row_band`` and ``fused_sn_block``, the plain version
of the rectangular kernel on the CPU), the scp partials added in ascending
shard
order as the mesh's all-reduce adds two; the bands, stacked, are held
against ``sharded_fused_sn_rect`` / ``sharded_fused_sn`` /
``sharded_fused_aji`` on the conftest's 8 virtual CPU devices (the XLA
scan body).  N is equal and S bit-equal: per cell both sum the same IEEE
f32 terms in ascending protein order within a shard, and a sum of two
partials does not depend on their order (every mesh here has scp <= 2).
``compute_sharded`` and the library API's ``engine="sharded"`` run at the
one mesh a single process has, (1, 1), against the JAX package at the
same mesh and at row splits, in all three modes (two-database with and
without the compat T-swap: the rectangular branch).  The multi-process
runs are in test_torch_multiproc.py."""

import sqlite3

import numpy as np
import pytest
import torch

import parfastaai_tpu.api as jax_api
from parfastaai_tpu.engine import compute_sharded as jax_compute_sharded
from parfastaai_tpu.etl.database import QueryTargetDatabase as JaxQTDatabase
from parfastaai_tpu.etl.database import SCPDatabase as JaxSCPDatabase
from parfastaai_tpu.modes import all_vs_all as jax_all_vs_all
from parfastaai_tpu.modes import query_subset as jax_query_subset
from parfastaai_tpu.modes import query_target as jax_query_target
from parfastaai_tpu.parallel import mesh as jax_mesh
from parfastaai_tpu.tools.synth_db import generate
import parfastaai_tpu_torch.api as api
from parfastaai_tpu_torch.engine import compute_sharded
from parfastaai_tpu_torch.etl.database import QueryTargetDatabase, SCPDatabase
from parfastaai_tpu_torch.modes import all_vs_all, query_subset, query_target
from parfastaai_tpu_torch.ops.sn_rect import fused_sn_block
from parfastaai_tpu_torch.parallel import mesh

CPU = torch.device("cpu")
# (rows, scp) meshes of the conftest's 8 devices; P=7 and G=45 (A=45,
# B=38) pad to every one of them but (1, 1)
MESHES = [(1, 1), (2, 1), (4, 1), (2, 2), (4, 2), (3, 1)]
QUERIES = [f"synthetic_genome_{i:05d}.fna.gz" for i in (30, 2, 17)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 37-genome target DB (G pads to every row count) and a 23-genome
    query DB with disjoint genome names, 7 proteins."""
    d = tmp_path_factory.mktemp("torch_mesh")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=37, n_proteins=7, pool_size=300,
             tetras_per_genome=100, seed=5)
    generate(query, n_genomes=23, n_proteins=7, pool_size=300,
             tetras_per_genome=100, seed=6)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    return {"target": target, "query": query}


def _presence(rng, P, G, K):
    """0/1 presence with two empty genomes (T = 0: ``clamp_t``'s case)
    and its T."""
    m = (rng.random((P, G, K)) < 0.3).astype(np.uint8)
    m[:, [3, G - 2]] = 0
    return m, m.sum(axis=2, dtype=np.int32)


def _pad(x, p_to, g_to):
    pads = [(0, p_to - x.shape[0]), (0, g_to - x.shape[1])]
    return np.pad(x, pads + [(0, 0)] * (x.ndim - 2))


def _cells(rows, scp, band, run_cell):
    """Every cell's partial, in turn: the scp partials of a row added in
    ascending shard order, the rows stacked."""
    bands = []
    for r in range(rows):
        s = n = None
        for sh in range(scp):
            s_p, n_p = run_cell(r, sh, band)
            s, n = (s_p, n_p) if s is None else (s + s_p, n + n_p)
        bands.append((s, n))
    return (torch.cat([b[0] for b in bands]).numpy(),
            torch.cat([b[1] for b in bands]).numpy())


@pytest.mark.parametrize("rows,scp", MESHES)
def test_square_cells_match_jax(rows, scp):
    rng = np.random.default_rng(10 * rows + scp)
    m, t = _presence(rng, 7, 45, 96)
    pp, gp = -(-7 // scp) * scp, -(-45 // rows) * rows
    m, t = _pad(m, pp, gp), _pad(t, pp, gp)

    def cell(r, sh, band):
        m_loc, t_loc = mesh.upload_shard(m, t, sh, scp, CPU)
        return fused_sn_block(mesh.row_band(m_loc, r, band), m_loc,
                              mesh.row_band(t_loc, r, band), t_loc)

    s, n = _cells(rows, scp, gp // rows, cell)
    jmesh = jax_mesh.make_mesh(rows, scp)
    aji_w, s_w, n_w = (np.asarray(x) for x in jax_mesh.sharded_fused_aji(
        jmesh, m.astype(np.int8), t))
    s_w2, n_w2 = (np.asarray(x) for x in jax_mesh.sharded_fused_sn(
        jmesh, m.astype(np.int8), t))
    np.testing.assert_array_equal(n, n_w)
    np.testing.assert_array_equal(s, s_w)
    np.testing.assert_array_equal(s_w2, s_w)
    np.testing.assert_array_equal(n_w2, n_w)
    with np.errstate(divide="ignore", invalid="ignore"):
        np.testing.assert_array_equal(s / n.astype(np.float32), aji_w)


@pytest.mark.parametrize("rows,scp", MESHES)
def test_rect_cells_match_jax(rows, scp):
    """Rows against other columns, with denominator T other than the
    presence rows' own counts (as the compat T-swap gives them: never
    below the counts), and empty genomes of T = 0."""
    rng = np.random.default_rng(100 + 10 * rows + scp)
    m, t = _presence(rng, 7, 83, 64)
    t = t + rng.integers(0, 4, t.shape, dtype=np.int32) * (t > 0)
    ma, mb = m[:, :45], m[:, 45:]
    ta, tb = t[:, :45], t[:, 45:]
    pp, ap = -(-7 // scp) * scp, -(-45 // rows) * rows
    ma, ta = _pad(ma, pp, ap), _pad(ta, pp, ap)
    mb, tb = _pad(mb, pp, 38), _pad(tb, pp, 38)

    def cell(r, sh, band):
        ma_loc, ta_loc = mesh.upload_shard(ma, ta, sh, scp, CPU)
        mb_loc, tb_loc = mesh.upload_shard(mb, tb, sh, scp, CPU)
        return fused_sn_block(mesh.row_band(ma_loc, r, band), mb_loc,
                              mesh.row_band(ta_loc, r, band), tb_loc)

    s, n = _cells(rows, scp, ap // rows, cell)
    s_w, n_w = (np.asarray(x) for x in jax_mesh.sharded_fused_sn_rect(
        jax_mesh.make_mesh(rows, scp), ma.astype(np.int8),
        mb.astype(np.int8), ta, tb))
    np.testing.assert_array_equal(n, n_w)
    np.testing.assert_array_equal(s, s_w)


def test_one_process_mesh_runs_the_cell_program():
    """A (1, 1) mesh in one process: the sharded functions return the one
    cell's result, which is the whole matrix."""
    rng = np.random.default_rng(5)
    m, t = _presence(rng, 5, 30, 64)
    one = mesh.make_mesh(1, 1)
    assert one.shape == {"rows": 1, "scp": 1} and one.coords == (0, 0)
    phases = {}
    s, n = mesh.sharded_fused_sn(one, m, t, CPU, phases)
    aji, s2, n2 = mesh.sharded_fused_aji(one, m, t, CPU)
    assert set(phases) == {"H2D", "kernel", "scp all-reduce"}
    s_w, n_w = (np.asarray(x) for x in jax_mesh.sharded_fused_sn(
        jax_mesh.make_mesh(1, 1), m.astype(np.int8), t))
    np.testing.assert_array_equal(mesh.gather_rows(one, s), s_w)
    np.testing.assert_array_equal(mesh.gather_rows(one, n), n_w)
    assert torch.equal(s2, s) and torch.equal(n2, n)
    torch.testing.assert_close(aji, s / n.to(torch.float32), rtol=0,
                               atol=0, equal_nan=True)
    s_r, n_r = mesh.sharded_fused_sn_rect(one, m[:, :12], m[:, 12:],
                                          t[:, :12], t[:, 12:], CPU)
    assert torch.equal(s_r, s[:12, 12:]) and torch.equal(n_r, n[:12, 12:])


@pytest.mark.parametrize("rows,scp", [(2, 1), (1, 2), (3, 3)])
def test_make_mesh_error_matches_jax(rows, scp):
    """A mesh larger than the devices: the JAX package's text, with one
    process as the port's device count (the JAX side: 8 devices)."""
    with pytest.raises(ValueError) as got:
        mesh.make_mesh(rows, scp)
    assert str(got.value) == f"Need {rows * scp} devices, have 1"
    if rows * scp > 8:
        with pytest.raises(ValueError) as want:
            jax_mesh.make_mesh(rows, scp)
        assert str(want.value) == f"Need {rows * scp} devices, have 8"


@pytest.mark.parametrize("fn", ["sn", "aji", "rect"])
@pytest.mark.parametrize("P,G", [(4, 9), (3, 8)])
def test_shape_check_errors_match_jax(fn, P, G):
    """Shapes that do not divide by a (2, 2) mesh: the same ValueError
    text as the JAX package, before any work."""
    m = np.zeros((P, G, 16), np.uint8)
    t = np.zeros((P, G), np.int32)
    port_mesh = mesh.Mesh(2, 2, (0, 0), None)
    jmesh = jax_mesh.make_mesh(2, 2)
    args = (m, t) if fn != "rect" else (m, m, t, t)
    name = {"sn": "sharded_fused_sn", "aji": "sharded_fused_aji",
            "rect": "sharded_fused_sn_rect"}[fn]
    with pytest.raises(ValueError) as want:
        getattr(jax_mesh, name)(jmesh, *args)
    with pytest.raises(ValueError) as got:
        getattr(mesh, name)(port_mesh, *args, CPU)
    assert str(got.value) == str(want.value)
    assert "not divisible by mesh {'rows': 2, 'scp': 2}" in str(got.value)


def _pairs(mode, dbs, jax_side: bool):
    """(presence, pairs) of ``mode`` through one package's host modules."""
    qt_db, scp_db = ((JaxQTDatabase, JaxSCPDatabase) if jax_side
                     else (QueryTargetDatabase, SCPDatabase))
    fns = ((jax_query_target, jax_query_subset, jax_all_vs_all) if jax_side
           else (query_target, query_subset, all_vs_all))
    if mode.startswith("qt"):
        db = qt_db(dbs["target"], dbs["query"])
        pairs = fns[0](db.meta, compat_qt_t_swap=mode == "qt")
    else:
        db = scp_db(dbs["target"])
        pairs = fns[1](db.meta, QUERIES) if mode == "qsub" else fns[2](db.meta)
    try:
        return db.load_presence(), pairs
    finally:
        db.close()


@pytest.mark.parametrize("jax_rows", [1, 2, 4])
@pytest.mark.parametrize("mode", ["all", "qsub", "qt", "qt_noswap"])
def test_compute_sharded_matches_jax(mode, jax_rows, dbs):
    """The port's (1, 1) mesh against the JAX package's (rows, 1): a row
    split changes which device computes a cell, not its arithmetic."""
    presence, pairs = _pairs(mode, dbs, jax_side=False)
    j_presence, j_pairs = _pairs(mode, dbs, jax_side=True)
    phases = {}
    got = compute_sharded(presence, pairs, CPU, 1, 1, phases=phases)
    want = jax_compute_sharded(j_presence, j_pairs, jax_rows, 1)
    assert set(phases) == {"H2D", "kernel", "scp all-reduce", "row gather"}
    for field in ("genome_a", "genome_b", "n", "s"):
        np.testing.assert_array_equal(
            getattr(got, field), getattr(want, field))


def test_compute_sharded_default_rows_is_the_world(dbs):
    presence, pairs = _pairs("all", dbs, jax_side=False)
    got = compute_sharded(presence, pairs, CPU)
    want = compute_sharded(presence, pairs, CPU, 1, 1)
    np.testing.assert_array_equal(got.s, want.s)
    with pytest.raises(ValueError, match="Need 2 devices, have 1"):
        compute_sharded(presence, pairs, CPU, None, 2)


# Calls that the port refused before it ran the mesh; each now runs as in
# the JAX package (a mesh under exact or fast is ignored there).
API_CASES = {
    "sharded": ("aji", dict(engine="sharded")),
    "sharded_mesh_1_1": ("aji", dict(engine="sharded", mesh=(1, 1))),
    "mesh": ("aji", dict(engine="fast", mesh=(2, 1))),
    "exact_mesh": ("aji", dict(engine="exact", mesh=(2, 1))),
    "to_csv_sharded": ("aji_to_csv", dict(engine="sharded")),
    "sharded_qt": ("aji", dict(engine="sharded", mesh=(1, 1), qt=True)),
}


@pytest.mark.parametrize("case", sorted(API_CASES))
def test_api_sharded_matches_jax(case, dbs, tmp_path):
    fn, kw = API_CASES[case]
    kw = dict(kw)
    if kw.pop("qt", False):
        kw["query_db"] = dbs["query"]
    out = {}
    for name, module, extra in (("jax", jax_api, {}),
                                ("port", api, {"device": "cpu"})):
        path = tmp_path / f"{name}.csv"
        args = (str(path), dbs["target"]) if fn == "aji_to_csv" else (
            dbs["target"],)
        res = getattr(module, fn)(*args, **extra, **kw)
        out[name] = path.read_bytes() if fn == "aji_to_csv" else res
    if fn == "aji_to_csv":
        assert out["port"] == out["jax"]
        return
    got, want = out["port"], out["jax"]
    assert got.row_names == want.row_names and got.col_names == want.col_names
    np.testing.assert_array_equal(got.matrix, want.matrix)
    for field in ("genome_a", "genome_b", "s", "n"):
        np.testing.assert_array_equal(
            getattr(got.pairs, field), getattr(want.pairs, field))


def test_api_mesh_larger_than_the_world_raises(dbs):
    with pytest.raises(ValueError, match="Need 4 devices, have 1"):
        api.aji(dbs["target"], engine="sharded", mesh=(2, 2), device="cpu")
