"""The port's whole-matrix fused AJI against the JAX package, on the CPU.

The same numpy inputs go through ``parfastaai_tpu_torch.ops.sn_square``
(whose CUDA kernel's plain version runs for CPU tensors) and through the
JAX functions it ports: ``pallas_fused_aji`` and the square Pallas kernels
in TPU interpret mode (as tests/test_fused.py runs them), and the XLA-scan
``ops.fused.fused_aji``.  N must agree exactly and S and AJI within 2e-6
relative, the JAX package's own bound for its fused paths.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from parfastaai_tpu.constants import MAX_K_SINGLE_BLOCK
from parfastaai_tpu.ops import fused as jax_fused
from parfastaai_tpu.ops import pallas_intersect as jpi
from parfastaai_tpu_torch.ops import _build, fused, sn_rect, sn_square

RTOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _presence(P, G, K, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < density).astype(np.uint8)
    return m, m.sum(axis=2, dtype=np.int32)


def _assert_close(got, want):
    """got/want: (aji, s, n) tuples of torch / jax arrays."""
    aji, s, n = (np.asarray(x) for x in got)
    raji, rs, rn = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(n, rn)
    np.testing.assert_allclose(s, rs, rtol=RTOL, atol=0)
    np.testing.assert_allclose(aji, raji, rtol=RTOL, atol=0, equal_nan=True)


@pytest.mark.parametrize(
    "P,G,K,density,kw",
    [
        (3, 12, 256, 0.2, {}),  # G padded to the tile on the JAX side
        (3, 300, 256, 0.2, {"tile": 128}),
        (3, 300, 256, 0.2, {"tile": 128, "symmetric": False}),
        (3, 300, 255, 0.2, {"tile": 128, "packed": True}),
        (3, 300, 254, 0.2, {"tile": 128, "packed": True, "symmetric": False,
                            "precise": True}),
        # the K-blocked route (kb_sym) on the JAX side
        (2, 12, MAX_K_SINGLE_BLOCK + 300, 0.05,
         {"tile": 128, "precise": True}),
    ],
    ids=["pad", "sym", "full", "packed", "packed_full", "kb"],
)
def test_fused_aji_matches_jax(P, G, K, density, kw):
    m, t = _presence(P, G, K, density, seed=G + K)
    with pltpu.force_tpu_interpret_mode():
        want = jpi.pallas_fused_aji(jnp.asarray(m), jnp.asarray(t), **kw)
    want_scan = jax_fused.fused_aji(jnp.asarray(m), jnp.asarray(t))
    port_kw = {k: v for k, v in kw.items() if k != "tile"}
    got = sn_square.fused_aji(
        torch.from_numpy(m), torch.from_numpy(t), **port_kw
    )
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.int32
    assert tuple(got[1].shape) == (G, G)
    _assert_close(got, want)
    _assert_close(got, want_scan)


def test_plain_fused_aji_matches_jax_scan():
    """ops.fused.fused_sn / fused_aji (clamped-denominator transform)
    against the JAX package's XLA scan; NaN where N == 0, self-AJI on the
    diagonal."""
    m, t = _presence(4, 20, 128, 0.1, seed=3)
    m[:, 5] = 0  # a genome sharing nothing: N == 0 on its row and column
    t = m.sum(axis=2, dtype=np.int32)
    got = fused.fused_aji(torch.from_numpy(m), torch.from_numpy(t))
    want = jax_fused.fused_aji(jnp.asarray(m), jnp.asarray(t))
    _assert_close(got, want)
    aji = got[0].numpy()
    assert np.isnan(aji[5]).all() and np.isnan(aji[:, 5]).all()
    assert np.all(np.delete(np.diag(aji), 5) == 1.0)


_PLAN_CASES = [
    # (p, g, k, symmetric, packed)
    (3, 384, 256, True, False),
    (3, 384, 256, False, False),
    (80, 4096, 1280, True, False),
    (80, 4096, 1280, False, False),
    (3, 300, MAX_K_SINGLE_BLOCK // 4, True, False),
    (3, 300, MAX_K_SINGLE_BLOCK // 4 + 1, True, False),
    (3, 384, 256, True, True),
    (3, 384, 255, True, True),
    (4, 100, MAX_K_SINGLE_BLOCK, True, False),
    (4, 100, MAX_K_SINGLE_BLOCK + 1, True, False),
    (4, 100, MAX_K_SINGLE_BLOCK + 128, False, False),
    (4, 100, 2 * MAX_K_SINGLE_BLOCK, True, True),
    (4, 100, 2 * MAX_K_SINGLE_BLOCK + 2, True, True),
    (4, 100, 2 * MAX_K_SINGLE_BLOCK + 2, False, True),
]


@pytest.mark.parametrize("p,g,k,sym,packed", _PLAN_CASES)
def test_plan_mode_matches_jax(p, g, k, sym, packed):
    want = jpi.fused_aji_plan(p, g, k, symmetric=sym, packed=packed)
    plan = sn_square.fused_aji_plan(p, g, k, symmetric=sym, packed=packed)
    assert set(plan) == set(want)
    assert plan["mode"] == want["mode"]
    nt = plan["nt"]
    # every route's tile and K slice: the wgmma kernel's, packed or not
    tile = 128
    assert plan["tile"] == tile
    assert plan["gp"] == tile * nt >= g > plan["gp"] - tile
    assert plan["n_tiles"] == (nt * (nt + 1) // 2 if sym else nt * nt)
    assert plan["pp"] == p  # the wgmma kernel's protein loop has no steps
    kbytes = plan["kp"] // 2 if packed else plan["kp"]
    assert kbytes % tile == 0 and plan["kp"] >= k
    assert plan["kp"] - k < (2 if packed else 1) * tile
    assert plan["mxu_macs"] == (
        plan["n_tiles"] * tile * tile * plan["pp"] * plan["kp"]
    )


def test_plan_rejects_other_tiles():
    """Every route runs 128-row tiles: packed rows and 'f32gram' too."""
    for kw in ({}, {"packed": True}, {"symmetric": False},
               *({"variant": v} for v in ("pipe", "fused", "mxu_outer",
                                          "counts", "f32gram"))):
        assert sn_square.fused_aji_plan(3, 100, 64, tile=128,
                                        **kw)["tile"] == 128
        for tile in (64, 256):
            with pytest.raises(ValueError, match="tile on this route is 128"):
                sn_square.fused_aji_plan(3, 100, 64, tile=tile, **kw)
    with pytest.raises(ValueError, match="unknown variant"):
        sn_square.fused_aji_plan(3, 100, 64, variant="nope")


@pytest.mark.parametrize(
    "p,g,k,kw,want",
    [
        # the bench shape on the default route: 32 row tiles of 128
        (80, 4096, 1280, {},
         dict(mode="2p", tile=128, gp=4096, nt=32, n_tiles=528, pp=80,
              kp=1280, mxu_macs=885837004800)),
        (80, 4096, 1280, {"symmetric": False},
         dict(mode="full", tile=128, nt=32, n_tiles=1024, pp=80,
              mxu_macs=1024 * 128 * 128 * 80 * 1280)),
        # ragged G: one tile and an edge, three tiles
        (3, 129, 256, {}, dict(tile=128, gp=256, nt=2, n_tiles=3, pp=3)),
        (3, 300, 200, {}, dict(tile=128, gp=384, nt=3, n_tiles=6, kp=256)),
        (5, 77, 128, {}, dict(tile=128, gp=128, nt=1, n_tiles=1, pp=5,
                              mxu_macs=128 * 128 * 5 * 128)),
        # packed presence: the same tiles, kp in presence columns (two a
        # byte: 640 bytes a row at the bench shape, 128 at K = 200)
        (80, 4096, 1280, {"packed": True},
         dict(mode="sym", tile=128, gp=4096, nt=32, n_tiles=528, pp=80,
              kp=1280, mxu_macs=885837004800)),
        (80, 4096, 1280, {"packed": True, "symmetric": False},
         dict(mode="full", tile=128, nt=32, n_tiles=1024, pp=80, kp=1280)),
        (3, 300, 200, {"packed": True}, dict(tile=128, nt=3, kp=256)),
        (3, 300, 256, {"packed": True}, dict(tile=128, nt=3, kp=256)),
        # an odd K gains a zero column: 129 bytes, padded to 256
        (3, 300, 257, {"packed": True}, dict(tile=128, nt=3, kp=512)),
        # the K-blocked plans at the kb bench's shape
        (16, 1024, 51200, {},
         dict(mode="kb_sym", tile=128, nt=8, n_tiles=36, pp=16, kp=51200,
              mxu_macs=36 * 128 * 128 * 16 * 51200)),
        (16, 1024, 51200, {"symmetric": False},
         dict(mode="kb_full", tile=128, n_tiles=64,
              mxu_macs=16 * 1024 * 1024 * 51200)),
        # the variant selects a kernel in mode 2p only
        (16, 1024, 51200, {"variant": "fused"},
         dict(mode="kb_sym", tile=128, n_tiles=36)),
        (5, 4096, 1280, {"variant": "base"},
         dict(mode="2p", tile=128, n_tiles=528, pp=5)),
        # every variant runs the wgmma kernel's bodies ('f32gram' lean's):
        # 528 triu tiles of 128 at the bench shape, 8.858e11 MACs at P=80
        *((p, 4096, 1280, {"variant": v},
           dict(mode="2p", tile=128, gp=4096, nt=32, n_tiles=528, pp=p,
                kp=1280, mxu_macs=528 * 128 * 128 * p * 1280))
          for v in ("counts", "fused", "pipe", "mxu_outer", "f32gram")
          for p in (5, 80)),
        (3, 300, 200, {"variant": "mxu_outer"},
         dict(tile=128, nt=3, n_tiles=6, kp=256, pp=3)),
    ],
)
def test_plan_describes_the_route(p, g, k, kw, want):
    """The plan's tile, tile count and MACs are those of the kernel the
    same arguments launch: 128-row tiles on the wgmma kernel, whatever the
    route."""
    plan = sn_square.fused_aji_plan(p, g, k, **kw)
    assert {key: plan[key] for key in want} == want


def _recorded_launches(monkeypatch):
    """Calls that would reach csrc/sn_square_wgmma.cu, recorded instead of
    launched: the wrappers take CPU tensors as if they lay on the card."""
    calls = []

    def launch(m, t, **kw):
        calls.append(kw)
        return "launched", None

    monkeypatch.setattr(sn_square, "_route", lambda *a: True)
    monkeypatch.setattr(sn_square, "_launch_wgmma", launch)
    return calls


@pytest.mark.parametrize(
    "update,packed,code",
    [("lean", False, 0), ("base", False, 0), ("f32gram", False, 0),
     ("pipe", False, 1), ("mxu_outer", False, 2), ("fused", False, 2),
     ("counts", False, 3), ("lean", True, 0)],
)
def test_on_wgmma_routes(update, packed, code, monkeypatch):
    """Every route of ``fused_sn_square`` reaches csrc/sn_square_wgmma.cu
    over the tile list: 'f32gram' with lean's code, packed rows as lean on
    packed bytes; no other kernel is left to reach."""
    calls = _recorded_launches(monkeypatch)
    m, t = _square_inputs(P=2, G=16)
    pairs = 1 if update in ("lean", "base") else 2
    for symmetric in (True, False):
        assert sn_square.fused_sn_square(
            m, t, symmetric=symmetric, pairs_per_step=pairs, update=update,
            packed=packed)[0] == "launched"
    assert [(c["symmetric"], c["packed"]) for c in calls] == [
        (True, packed), (False, packed)]
    assert {sn_square._WGMMA_UPDATES[c["update"]] for c in calls} == {code}
    assert all(c.get("walk", sn_square._WALK_LIST) == sn_square._WALK_LIST
               for c in calls)
    assert not hasattr(sn_square, "LAUNCHES")
    assert not hasattr(sn_square, "MMA_LAUNCHES")


@pytest.mark.parametrize("name,walk,packed", [
    ("sn_sym_diag", 1, False), ("sn_sym_diag", 1, True),
    ("sn_sym_bands", 2, False), ("sn_sym_bands", 2, True),
    ("sn_sym_bands_2p", 2, False)])
def test_walks_route_to_the_wgmma_kernel(name, walk, packed, monkeypatch):
    """The diagonal and band walks reach csrc/sn_square_wgmma.cu with their
    walk code, lean and the mirror, packed or not (``sn_sym_bands_2p``, which
    takes no packed input, is ``sn_sym_bands``' launch: the kernel's protein
    loop has no steps)."""
    calls = _recorded_launches(monkeypatch)
    m, t = _square_inputs(P=2, G=16)
    kw = {"packed": True} if packed else {}
    getattr(sn_square, name)(m, t, **kw)
    (call,) = calls
    assert call["walk"] == walk and call["update"] == "lean"
    assert call["symmetric"] and call.get("packed", False) == packed


def _csrc(name: str) -> str:
    return open(os.path.join(os.path.dirname(_build.__file__), "..", "csrc",
                             name)).read()


def test_wgmma_update_codes_match_the_kernel_sources():
    """The wrapper's update codes are the header's kLean / kPipe / kPair /
    kCounts (the pair body gives the 'fused' and 'mxu_outer' values,
    kLean 'base''s and 'f32gram''s), its walk codes the kernel's kWalkList /
    kWalkDiag / kWalkBand; the packed-N bound is the header's kMaxPackedP,
    which binds the two-set codes."""
    hdr = _csrc("sn_wgmma.cuh")
    square = _csrc("sn_square_wgmma.cu")
    codes = {"lean": "kLean", "base": "kLean", "f32gram": "kLean",
             "pipe": "kPipe", "fused": "kPair", "mxu_outer": "kPair",
             "counts": "kCounts"}
    for name, const in codes.items():
        want = sn_square._WGMMA_UPDATES[name]
        assert f"constexpr int {const} = {want};" in hdr
    assert "constexpr int kCounts = 3;" in hdr
    assert set(sn_square._WGMMA_UPDATES) == set(codes)
    walks = {"kWalkList": sn_square._WALK_LIST,
             "kWalkDiag": sn_square._WALK_DIAG,
             "kWalkBand": sn_square._WALK_BAND}
    for const, want in walks.items():
        assert f"constexpr int {const} = {want};" in square
    assert sorted(walks.values()) == [0, 1, 2]
    assert (f"constexpr int kMaxPackedP = {sn_square.WGMMA_MAX_PACKED_P};"
            in hdr)
    assert sorted(sn_square._TWO_SET_CODES) == sorted(
        {sn_square._WGMMA_UPDATES[u] for u in ("pipe", "fused", "mxu_outer")})
    assert sn_square._VARIANTS == sorted(sn_square._WGMMA_UPDATES)


def test_one_ring_two_count_sets_and_no_dp4a_pipe():
    """One block body: one ring (its refill, its wgmma call and the wait for
    its slices each written once, packed rows or not), one count set for
    'lean' and for 'counts' (each its own loop) and two for the two-set
    updates; the __dp4a and f16 kernels are gone, and no source keeps a
    __dp4a or an mma.sync."""
    hdr = _csrc("sn_wgmma.cuh")
    # the PTX wrapper's definition and its one call
    assert hdr.count("wgmma_m64n128k32(") == 2
    for once in ("cp_async_wait<kSt - 3>();",
                 "load_slice((stage + kSt - 2) % kSt);",
                 "    int ca[4 * kNT], cb[4 * kNT];",
                 "auto mma_slice = ",
                 "auto fill_ring = ",
                 "      unpack_chunks(smem + stage * kTileBytes + lphys,"):
        assert hdr.count(once) == 1, once
    assert hdr.count("    int cnt[4 * kNT];") == 2
    square = _csrc("sn_square_wgmma.cu")
    assert square.count("sn_wgmma_tile<kMode, kUpdate, kPacked != 0>(") == 1
    assert "smem_bytes(kUpdate, kPacked)" in square
    csrc = os.path.dirname(_build._HDRS[0])
    assert sorted(os.listdir(csrc)) == [
        "finish_f64.cu", "sn_rect.cu", "sn_square_wgmma.cu", "sn_wgmma.cuh"]
    for name in os.listdir(csrc):
        for gone in ("__dp4a", "mma.sync", "IDP"):
            assert gone not in _csrc(name), (name, gone)


def test_wgmma_two_set_updates_limit_p():
    """'pipe' and 'mxu_outer' hold N in 16-bit halves: the wgmma wrapper
    raises before any launch for P >= WGMMA_MAX_PACKED_P; 'lean' takes
    any P."""
    P = sn_square.WGMMA_MAX_PACKED_P
    m = torch.zeros((P, 1, 128), dtype=torch.uint8)
    t = torch.ones((P, 1), dtype=torch.float32)
    before = sn_square.WGMMA_LAUNCHES
    for update in ("pipe", "mxu_outer"):
        with pytest.raises(ValueError, match="P < 32768"):
            sn_square._launch_wgmma(m, t, symmetric=True, update=update,
                                    approx=False, precise=False)
    assert sn_square.WGMMA_LAUNCHES == before


def test_wgmma_fused_limits_p():
    """'fused' runs the pair body, which holds N in 16-bit halves: P >=
    WGMMA_MAX_PACKED_P raises before any launch, through the wrapper's
    kernel route as through ``_launch_wgmma``.  The reference has no such
    limit; 'counts' keeps no N and is not bound."""
    P = sn_square.WGMMA_MAX_PACKED_P
    m = torch.zeros((P, 1, 128), dtype=torch.uint8)
    t = torch.ones((P, 1), dtype=torch.float32)
    before = sn_square.WGMMA_LAUNCHES
    with pytest.raises(ValueError, match="'fused' on the wgmma kernel takes "
                                         "P < 32768"):
        sn_square._launch_wgmma(m, t, symmetric=True, update="fused",
                                approx=False, precise=False)
    assert sn_square.WGMMA_LAUNCHES == before
    assert sn_square._WGMMA_UPDATES["counts"] not in sn_square._TWO_SET_CODES


def test_pair_count_sum_is_exact_in_f32():
    """f32(c0) + f32(c1), rounded to nearest, equals f32(c0 + c1) for every
    c0, c1 <= MAX_K_SINGLE_BLOCK // 4 (mode '2p''s K bound): 'counts' on the
    card adds a pair's integer count sum once, converted once, where the
    plain version adds the pair's two f32 counts."""
    k = MAX_K_SINGLE_BLOCK // 4
    assert k == 8192
    c1 = np.arange(k + 1, dtype=np.int32)
    f1 = c1.astype(np.float32)
    for lo in range(0, k + 1, 1024):
        c0 = np.arange(lo, min(lo + 1024, k + 1), dtype=np.int32)[:, None]
        got = c0.astype(np.float32) + f1[None, :]
        want = (c0 + c1[None, :]).astype(np.float32)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _emulate_counts(m: np.ndarray) -> np.ndarray:
    """S of csrc/sn_wgmma.cuh's kCounts update over the whole square, in its
    schedule: the flat (protein, slice) sequence, four k32 products a slice,
    each overwriting the count set where the pair's slice index and the
    step are both 0 (the wgmma scale-d of ``(ks | j) != 0``) and adding to
    it elsewhere, and after the pair's last slice (or an odd last
    protein's) one ``s = rn(s + rn(int32 count))``."""
    P, G, K = m.shape
    slice_bytes, step = 128, 32
    m = np.pad(m, ((0, 0), (0, 0), (0, -K % slice_bytes))).astype(np.int32)
    ks_per_p = m.shape[2] // slice_bytes
    total, per_pair = P * ks_per_p, 2 * ks_per_p
    s = np.zeros((G, G), np.float32)
    cnt = np.full((G, G), -7, np.int32)  # what the set held before
    ks = 0
    for it in range(total):
        p, k = divmod(it, ks_per_p)
        for j in range(slice_bytes // step):
            a = m[p, :, k * slice_bytes + j * step:][:, :step]
            prod = a @ a.T
            cnt = cnt + prod if (ks | j) != 0 else prod
        ks += 1
        if ks == per_pair or it + 1 == total:
            s = s + cnt.astype(np.float32)
            ks = 0
    return s


@pytest.mark.parametrize("P,K", [(4, 256), (5, 256), (3, 128), (1, 200)])
def test_counts_schedule_emulation_equals_plain(P, K):
    """kCounts' per-pair schedule, emulated in numpy, is bit-equal to
    ``fused_sn_square_plain(update='counts')`` for even and odd P, one or
    more slices a protein and a K padded to the slice; N stays 0."""
    m, t = _presence(P, 70, K, 0.5, seed=P * K)
    s_ref, n_ref = sn_square.fused_sn_square_plain(
        torch.from_numpy(m), sn_rect.clamp_t(torch.from_numpy(t)),
        update="counts")
    np.testing.assert_array_equal(_emulate_counts(m), s_ref.numpy())
    assert not n_ref.any()


@pytest.mark.parametrize("nt", [1, 2, 3, 32])
@pytest.mark.parametrize("symmetric", [True, False])
def test_tile_list_over_128_row_tiles(nt, symmetric):
    """Row-major upper triangle (np.triu_indices, as the TPU wrapper's
    scalar-prefetched maps) or the whole square, int32 (n_tiles, 2)."""
    tiles = sn_square._tile_list(nt, symmetric, torch.device("cpu"))
    assert tiles.dtype == torch.int32 and tiles.is_contiguous()
    got = [tuple(x) for x in tiles.tolist()]
    want = [(r, c) for r in range(nt) for c in range(nt)
            if c >= r or not symmetric]
    assert got == want
    plan = sn_square.fused_aji_plan(1, nt * 128, 128, symmetric=symmetric)
    assert len(got) == plan["n_tiles"]


def test_wgmma_loader_covers_each_staged_chunk_once():
    """Both staged sides (the tile's rows, then its columns' rows) take
    sn_rect's loader map: over a block's threads every 16-byte chunk of
    every row once, swizzled to distinct cells of the side's 16 KB."""
    tile, ks = sn_square.WGMMA_TILE, sn_square.WGMMA_K_SLICE
    got = [c for tid in range(sn_square.WGMMA_THREADS)
           for c in sn_rect.loader_chunks(tid)]
    assert sorted(got) == [(r, c) for r in range(tile)
                           for c in range(ks // 16)]
    cells = sorted(sn_rect.staged_offset(r, c) for r, c in got)
    assert cells == list(range(0, tile * ks, 16))
    assert 2 * tile == sn_square.WGMMA_THREADS  # one T value a thread


def test_wgmma_accumulator_cells_cover_the_tile_once():
    """Direct cells of one block: every cell of the 128 x 128 tile once; a
    mirrored block also stores each cell's transpose."""
    tile = sn_square.WGMMA_TILE
    cells = [cell for tid in range(sn_square.WGMMA_THREADS)
             for i in range(tile // 2)
             for cell in sn_square.stored_cells(tid, i, 2, 2, False)]
    assert sorted(cells) == [(r, c) for r in range(2 * tile, 3 * tile)
                             for c in range(2 * tile, 3 * tile)]
    assert sn_square.stored_cells(5, 7, 0, 1, True) == [
        cell := sn_square.stored_cells(5, 7, 0, 1, False)[0], cell[::-1]]


def _store_hits(G: int, launches) -> np.ndarray:
    """How often the kernel stores each cell of the G x G square over
    ``launches``, each the ``walk_tiles`` of one launch (cells past G
    masked)."""
    tile = sn_square.WGMMA_TILE
    hits = np.zeros((G, G), np.int32)
    for tiles in launches:
        for rt, ct, mirrored in tiles:
            for tid in range(sn_square.WGMMA_THREADS):
                for i in range(tile // 2):
                    direct, *mirror = sn_square.stored_cells(
                        tid, i, rt, ct, mirrored)
                    if direct[0] < G and direct[1] < G:
                        hits[direct] += 1
                        for cell in mirror:
                            hits[cell] += 1
    return hits


@pytest.mark.parametrize("G", [77, 128, 129, 300])
@pytest.mark.parametrize("symmetric", [True, False])
def test_wgmma_stored_cells_cover_the_square_once(G, symmetric):
    """Over the tile list, the cells the kernel stores (direct and, off the
    diagonal tiles of the triu walk, mirrored; cells past G masked) are
    every cell of the G x G square exactly once."""
    nt = -(-G // sn_square.WGMMA_TILE)
    tiles = sn_square.walk_tiles(sn_square._WALK_LIST, nt, mirror=symmetric)
    assert [(r, c) for r, c, _ in tiles] == [
        tuple(x) for x in sn_square._tile_list(
            nt, symmetric, torch.device("cpu")).tolist()]
    assert (_store_hits(G, [tiles]) == 1).all()


@pytest.mark.parametrize("G", [256, 300, 512, 640])  # nt = 2, 3, 4, 5
@pytest.mark.parametrize("walk", ["diag", "bands"])
def test_walk_stored_cells_cover_the_square_once(G, walk):
    """The wrapped diagonals (one launch of (nt // 2 + 1) nt tiles; for an
    even nt both orientations of d = nt / 2, neither mirrored) and the band
    rows (nt launches of nt - r tiles) store every cell of the G x G square
    exactly once, at an even and an odd nt."""
    nt = -(-G // sn_square.WGMMA_TILE)
    if walk == "diag":
        launches = [sn_square.walk_tiles(sn_square._WALK_DIAG, nt, nt)]
        assert len(launches[0]) == (nt // 2 + 1) * nt
        unmirrored = [(r, c) for r, c, mirrored in launches[0]
                      if not mirrored and r != c]
        assert len(unmirrored) == (nt if nt % 2 == 0 else 0)
    else:
        launches = [sn_square.walk_tiles(sn_square._WALK_BAND, nt, r)
                    for r in range(nt)]
        assert [len(x) for x in launches] == list(range(nt, 0, -1))
    assert (_store_hits(G, launches) == 1).all()


def test_wgmma_constants_match_the_kernel_source():
    """WGMMA_TILE, WGMMA_THREADS and WGMMA_K_SLICE are the constants of the
    block body in csrc/sn_wgmma.cuh, which csrc/sn_square_wgmma.cu and
    csrc/sn_rect.cu both run, and equal sn_rect's, whose index maps the
    kernel shares; the build compiles the source and hashes its header."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    hdr = open(os.path.join(csrc, "sn_wgmma.cuh")).read()
    for name, want in (("kTile", sn_square.WGMMA_TILE),
                       ("kThreads", sn_square.WGMMA_THREADS),
                       ("kSliceBytes", sn_square.WGMMA_K_SLICE)):
        assert f"constexpr int {name} = {want};" in hdr
    assert (sn_square.WGMMA_TILE, sn_square.WGMMA_THREADS,
            sn_square.WGMMA_K_SLICE) == (sn_rect.TILE, sn_rect.THREADS,
                                         sn_rect.K_SLICE)
    for source, call in (("sn_square_wgmma.cu",
                          "<kMode, kUpdate, kPacked != 0>("),
                         ("sn_rect.cu", "<kMode>(")):
        src = open(os.path.join(csrc, source)).read()
        assert '#include "sn_wgmma.cuh"' in src
        assert src.count("sn_wgmma_tile" + call) == 1
        # one body: no second copy of the ring or of its constants
        assert "wgmma_m64n128k32(" not in src and "cp_async_wait" not in src
        for const in ("kTile", "kThreads", "kSliceBytes", "kStages",
                      "kPackedStages", "kRows", "kTileBytes", "kNT"):
            assert f"constexpr int {const} " not in src, (source, const)
    names = {os.path.basename(path) for path in _build._SRCS + _build._HDRS}
    assert {"sn_square_wgmma.cu", "sn_wgmma.cuh", "sn_rect.cu"} <= names


def test_build_tag_follows_the_shared_header(monkeypatch, tmp_path):
    """A changed header changes the library's name, so it is rebuilt."""
    before = _build._tag()
    hdr = tmp_path / "sn_wgmma.cuh"
    hdr.write_bytes(open(_build._HDRS[0], "rb").read() + b"\n// changed\n")
    monkeypatch.setattr(_build, "_HDRS", [str(hdr)])
    assert _build._tag() != before


@pytest.mark.parametrize("K", [256, 255, 1])
def test_pack_nibbles_matches_jax(K):
    m, _ = _presence(2, 5, K, 0.5, seed=K)
    mj = np.pad(m, ((0, 0), (0, 0), (0, K % 2))).astype(np.int8)
    want = np.asarray(jpi._pack_nibbles(jnp.asarray(mj)))
    got = sn_square.pack_nibbles(torch.from_numpy(m))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int8), want)


def _emulate_packed_counts(mp: np.ndarray) -> np.ndarray:
    """(G, G) int counts of one protein's packed rows mp (G <= 128, packed
    bytes) as csrc/sn_wgmma.cuh's kPacked body forms them: per slice of
    128 packed bytes, both sides staged by the loader's threads at the
    swizzled offsets of ``sn_rect.staged_offset``; each thread splits its
    own chunks, the low nibbles in place and the high ones at the same
    offsets of a second buffer; the eight k32 products read both buffers
    through the 128-byte swizzle (the four of the low nibbles, then the
    four of the high), the first of a protein overwriting the counts."""
    G, kb = mp.shape
    ks_bytes, tile, step = 128, 128, 32
    rows = np.zeros((tile, -(-kb // ks_bytes) * ks_bytes), np.uint8)
    rows[:G, :kb] = mp
    # physical byte of logical (row, k) in a staged side: the swizzle
    r_idx, k_idx = np.meshgrid(np.arange(tile), np.arange(ks_bytes),
                               indexing="ij")
    phys = r_idx * ks_bytes + ((k_idx // 16) ^ (r_idx % 8)) * 16 + k_idx % 16
    cnt = np.full((tile, tile), -5, np.int64)  # what the set held before
    for ks in range(rows.shape[1] // ks_bytes):
        lo = np.zeros(tile * ks_bytes, np.uint8)
        for tid in range(sn_square.WGMMA_THREADS):  # one side's 128 rows
            for r, c in sn_rect.loader_chunks(tid):
                off = sn_rect.staged_offset(r, c)
                lo[off:off + 16] = rows[r, ks * ks_bytes + 16 * c:][:16]
        hi = np.zeros_like(lo)
        for tid in range(sn_square.WGMMA_THREADS):
            for r, c in sn_rect.loader_chunks(tid):
                off = sn_rect.staged_offset(r, c)
                hi[off:off + 16] = (lo[off:off + 16] >> 4) & 0x0F
                lo[off:off + 16] &= 0x0F
        for j in range(2 * ks_bytes // step):
            half = (lo if j < ks_bytes // step else hi)[phys].astype(np.int64)
            k32 = j % (ks_bytes // step)
            a = half[:, step * k32:step * (k32 + 1)]
            cnt = cnt + a @ a.T if (ks | j) != 0 else a @ a.T
    return cnt[:G, :G]


@pytest.mark.parametrize("K", [256, 255, 130, 900])
def test_packed_split_emulation_equals_plain(K):
    """The packed body's split into low and high nibbles at the swizzled
    offsets, its eight k32 products a slice and lean's transform, emulated
    in numpy, are bit-equal to ``fused_sn_square_plain(packed=True)`` and to
    the unpacked plain version, at one and several slices a protein and an
    odd K."""
    m, t = _presence(3, 70, K, 0.4, seed=K)
    mt, tt = torch.from_numpy(m), sn_rect.clamp_t(torch.from_numpy(t))
    mp = sn_square.pack_nibbles(mt)
    s_ref, n_ref = sn_square.fused_sn_square_plain(mp, tt, packed=True)
    s = torch.zeros_like(s_ref)
    n = torch.zeros_like(n_ref)
    for p in range(m.shape[0]):
        cnt = torch.from_numpy(_emulate_packed_counts(mp[p].numpy()))
        np.testing.assert_array_equal(
            cnt.numpy(), m[p].astype(np.int64) @ m[p].T.astype(np.int64))
        cf = cnt.to(torch.float32)
        s += cf / (tt[p][:, None] + tt[p][None, :] - cf)
        n += cnt.clamp(max=1).to(torch.int32)
    assert torch.equal(s, s_ref) and torch.equal(n, n_ref)
    u_s, u_n = sn_square.fused_sn_square_plain(mt, tt)
    assert torch.equal(s, u_s) and torch.equal(n, u_n)


def _square_inputs(P=5, G=70, K=128, seed=5):
    m, t = _presence(P, G, K, 0.25, seed=seed)
    mt = torch.from_numpy(m)
    return mt, sn_rect.clamp_t(torch.from_numpy(t))


def test_plain_square_is_symmetric_and_equals_rect_block():
    m, t = _square_inputs()
    s, n = sn_square.fused_sn_square_plain(m, t)
    assert torch.equal(s, s.T) and torch.equal(n, n.T)
    rs, rn = sn_rect.fused_sn_block_plain(m, m, t, t)
    assert torch.equal(s, rs) and torch.equal(n, rn)
    # packed input counts exactly the same
    ps, pn = sn_square.fused_sn_square_plain(
        sn_square.pack_nibbles(m), t, packed=True
    )
    assert torch.equal(ps, s) and torch.equal(pn, n)


@pytest.mark.parametrize("P", [3, 4])
def test_variants(P):
    """lean == base == one protein per step, bit for bit; 'fused' (pair
    terms summed first) matches the JAX 2p fused variant; 'counts' gives
    S = sum of the counts and N = 0."""
    m, t = _presence(P, 130, 128, 0.25, seed=P)
    mt, tt = torch.from_numpy(m), torch.from_numpy(t)
    ref = sn_square.fused_sn_square(mt, sn_rect.clamp_t(tt), pairs_per_step=1)
    for variant in ("lean", "base"):
        _, s, n = sn_square.fused_aji(mt, tt, variant=variant)
        assert torch.equal(s, ref[0]) and torch.equal(n, ref[1])
    got = sn_square.fused_aji(mt, tt, variant="fused", precise=True)
    with pltpu.force_tpu_interpret_mode():
        want = jpi.pallas_fused_aji(
            jnp.asarray(m), jnp.asarray(t), tile=128, precise=True,
            variant="fused",
        )
    _assert_close(got, want)
    _, s, n = sn_square.fused_aji(mt, tt, variant="counts")
    counts = np.einsum("pik,pjk->ij", m.astype(np.int64), m.astype(np.int64))
    np.testing.assert_array_equal(s.numpy(), counts.astype(np.float32))
    assert not n.any()


def test_unknown_variant_raises():
    m, t = _presence(2, 8, 64, seed=1)
    with pytest.raises(ValueError, match="unknown variant"):
        sn_square.fused_aji(torch.from_numpy(m), torch.from_numpy(t),
                            variant="nope")


_VARIANTS_2P = ("pipe", "fused", "mxu_outer", "counts", "f32gram")


@pytest.mark.parametrize(
    "variant,P,G,K",
    [
        ("pipe", 2, 384, 256),  # one step: nothing carried
        ("pipe", 3, 130, 128),
        ("pipe", 6, 384, 128),
        ("mxu_outer", 3, 130, 256),
        ("mxu_outer", 4, 384, 128),
        ("f32gram", 3, 384, 256),
        ("f32gram", 4, 130, 128),
    ],
)
def test_2p_variant_matches_jax(variant, P, G, K):
    """The three Mosaic-experiment bodies of ``_pallas_sn_sym_2p`` against
    their TPU kernels in interpret mode.  The reference's 'f32gram' raises
    there (see the next test), so the port's is held against 'base', whose
    values its documented intent (exact f32 counts) shares."""
    m, t = _presence(P, G, K, 0.25, seed=P * G + K)
    with pltpu.force_tpu_interpret_mode():
        want = jpi.pallas_fused_aji(
            jnp.asarray(m), jnp.asarray(t), tile=128, precise=True,
            variant="base" if variant == "f32gram" else variant,
        )
    got = sn_square.fused_aji(torch.from_numpy(m), torch.from_numpy(t),
                              precise=True, variant=variant)
    _assert_close(got, want)


def test_jax_f32gram_is_broken_in_interpret_mode():
    """The reference's 'f32gram' adds min(cnt, 1) of f32 counts into its
    int32 N ref and fails (Mosaic rejects the variant on the TPU too).  A
    fix of the reference makes this test fail: then hold the port's
    'f32gram' against it directly."""
    m, t = _presence(3, 130, 128, 0.25, seed=2)
    with pytest.raises(ValueError, match="dtype"):
        with pltpu.force_tpu_interpret_mode():
            jpi.pallas_fused_aji(jnp.asarray(m), jnp.asarray(t), tile=128,
                                 precise=True, variant="f32gram")


@pytest.mark.parametrize("P", [3, 4])
@pytest.mark.parametrize(
    "variant,like",
    [("pipe", "lean"), ("f32gram", "lean"), ("mxu_outer", "fused")],
)
def test_plain_variant_is_bit_equal(variant, like, P):
    """'pipe' and 'f32gram' change no value of 'lean', 'mxu_outer' none of
    'fused': the plain versions agree bit for bit."""
    m, t = _square_inputs(P=P, G=130, K=192, seed=P)
    s, n = sn_square.fused_sn_square_plain(m, t, update=variant)
    ws, wn = sn_square.fused_sn_square_plain(m, t, update=like)
    assert torch.equal(s, ws) and torch.equal(n, wn)


@pytest.mark.parametrize("variant", _VARIANTS_2P)
def test_2p_variant_on_cpu_launches_nothing(variant):
    m, t = _square_inputs(P=3, G=40)
    before = sn_square.WGMMA_LAUNCHES
    s, n = sn_square.fused_sn_square(m, t, pairs_per_step=2, update=variant)
    want = sn_square.fused_sn_square_plain(m, t, update=variant)
    assert torch.equal(s, want[0]) and torch.equal(n, want[1])
    sn_square.fused_aji(m, t, variant=variant)
    assert sn_square.WGMMA_LAUNCHES == before


@pytest.mark.parametrize("variant", _VARIANTS_2P)
def test_2p_variant_needs_two_per_step(variant):
    m, t = _square_inputs(P=2, G=16)
    with pytest.raises(ValueError, match="needs pairs_per_step=2"):
        sn_square.fused_sn_square(m, t, update=variant)


@pytest.mark.parametrize(
    "fn,jax_fn,packed",
    [
        (sn_square.sn_sym_diag, jpi._pallas_sn_sym_diag, False),
        (sn_square.sn_sym_bands, jpi._pallas_sn_sym_bands, False),
        (sn_square.sn_sym_bands_2p, jpi._pallas_sn_sym_bands_2p, False),
        (sn_square.sn_sym_diag, jpi._pallas_sn_sym_diag, True),
        (sn_square.sn_sym_bands, jpi._pallas_sn_sym_bands, True),
    ],
    ids=["diag", "bands", "bands_2p", "diag_packed", "bands_packed"],
)
def test_alternative_walks_match_jax(fn, jax_fn, packed):
    """Kernels 8-10's wrappers against their TPU kernels (interpret mode,
    nt = 3 tiles of 128), unpacked and nibble-packed, on CPU tensors, where
    they launch nothing."""
    m, t = _presence(3, 384, 128, 0.25, seed=8)
    kw = {"packed": True} if packed else {}
    with pltpu.force_tpu_interpret_mode():
        ws, wn = jax_fn(jnp.asarray(m), jnp.asarray(t), tile=128,
                        precise=True, **kw)
    before = sn_square.WGMMA_LAUNCHES
    mt = torch.from_numpy(m)
    s, n = fn(sn_square.pack_nibbles(mt) if packed else mt,
              sn_rect.clamp_t(torch.from_numpy(t)), precise=True, **kw)
    assert sn_square.WGMMA_LAUNCHES == before
    np.testing.assert_array_equal(n.numpy(), np.asarray(wn))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL, atol=0)


def test_wrappers_on_cpu_launch_nothing():
    m, t = _square_inputs(P=3, G=40)
    ref = sn_square.fused_sn_square_plain(m, t)
    mp = sn_square.pack_nibbles(m)
    before = sn_square.WGMMA_LAUNCHES
    for kw in ({}, {"symmetric": False}, {"pairs_per_step": 2},
               {"pairs_per_step": 2, "update": "base"},
               {"approx": True}, {"precise": True}):
        s, n = sn_square.fused_sn_square(m, t, **kw)
        assert torch.equal(s, ref[0]) and torch.equal(n, ref[1])
    for symmetric in (True, False):
        s, n = sn_square.fused_sn_square(mp, t, packed=True,
                                         symmetric=symmetric)
        assert torch.equal(s, ref[0]) and torch.equal(n, ref[1])
    for fn in (sn_square.sn_sym_diag, sn_square.sn_sym_bands,
               sn_square.sn_sym_bands_2p):
        s, n = fn(m, t)
        assert torch.equal(s, ref[0]) and torch.equal(n, ref[1])
    for fn in (sn_square.sn_sym_diag, sn_square.sn_sym_bands):
        s, n = fn(mp, t, packed=True)
        assert torch.equal(s, ref[0]) and torch.equal(n, ref[1])
    sn_square.fused_aji(m, t)
    sn_square.fused_aji(m, t, symmetric=False)
    sn_square.fused_aji(m, t, packed=True)
    assert sn_square.WGMMA_LAUNCHES == before


def test_wrappers_reject_bad_operands():
    m, t = _square_inputs(P=2, G=16)
    sq = sn_square.fused_sn_square
    with pytest.raises(TypeError, match="float32"):
        sq(m, t.to(torch.int32))
    with pytest.raises(TypeError, match="uint8 or int8"):
        sq(m.float(), t)
    with pytest.raises(ValueError, match="does not match"):
        sq(m, t[:, :4])
    with pytest.raises(ValueError, match="contiguous"):
        sq(m.transpose(1, 2).contiguous().transpose(1, 2), t)
    with pytest.raises(ValueError, match="mutually exclusive"):
        sq(m, t, approx=True, precise=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        sn_square.fused_aji(m, t, approx=True, precise=True)
    with pytest.raises(ValueError, match="needs pairs_per_step=2"):
        sq(m, t, update="fused")
    with pytest.raises(ValueError, match="needs pairs_per_step=1"):
        sq(m, t, packed=True, pairs_per_step=2)
    with pytest.raises(ValueError, match="1 or 2"):
        sq(m, t, pairs_per_step=3)
    with pytest.raises(ValueError, match="packed"):
        wide = torch.zeros((1, 8, 2 * MAX_K_SINGLE_BLOCK + 2),
                           dtype=torch.uint8)
        sn_square.fused_aji(wide, torch.zeros((1, 8)), packed=True)
    for fn in (sq, sn_square.sn_sym_diag, sn_square.sn_sym_bands,
               sn_square.sn_sym_bands_2p):
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            fn(m.to("meta"), t.to("meta"))


def _build_argtypes(entry: str) -> list:
    """The argtypes that _build.load gives ``entry``, read from its source
    (load itself needs the built library)."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(_build.load))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Attribute)
                and node.targets[0].attr == "argtypes"
                and isinstance(node.targets[0].value, ast.Attribute)
                and node.targets[0].value.attr == entry):
            return node.value.elts
    raise AssertionError(f"no argtypes for {entry}")


@pytest.mark.parametrize("tool,source", [
    ("sn_rect_ablation", "sn_rect.cu"),
    ("sn_square_ablation", "sn_square_wgmma.cu"),
])
def test_ablation_cuts_match_the_sources(tool, source):
    """Every text that the ablation tools replace stands exactly once in the
    block body that both kernels include (the tools raise on the card
    otherwise), and each tool builds its own kernel's source."""
    import importlib

    from parfastaai_tpu_torch.tools import sn_rect_ablation

    mod = importlib.import_module(f"parfastaai_tpu_torch.tools.{tool}")
    assert mod.build_variants is sn_rect_ablation.build_variants
    if tool == "sn_square_ablation":
        # it binds the C entry with its 5 pointers and 10 ints (update,
        # packed, walk and walk_arg last), as _build does, and times each
        # update of the body and lean on packed rows
        args = len(_build_argtypes("sn_square_wgmma_launch"))
        assert (mod.N_POINTERS, mod.N_INTS) == (5, 10) and args == 5 + 10 + 1
        assert mod.UPDATES == sorted({*sn_square._WGMMA_UPDATES, "packed"})
        with pytest.raises(SystemExit, match="2"):
            mod.main(["--update", "nope"])
    cuts = sn_rect_ablation.CUTS
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    hdr = open(os.path.join(csrc, sn_rect_ablation.HEADER)).read()
    assert f'#include "{sn_rect_ablation.HEADER}"' in open(
        os.path.join(csrc, source)).read()
    assert source in open(mod.__file__).read()
    assert [name for name, _ in cuts] == ["full", "noload", "nomma", "noepi"]
    # noepi cuts every epilogue: kLean's, the two-set updates' and kCounts'
    assert len(dict(cuts)["noepi"]) == 3
    for name, replacements in cuts:
        for old, new in replacements:
            assert hdr.count(old) == 1 and new != old, name


def test_wgmma_ab_reads_ptxas_and_sass():
    """tools/wgmma_ab keys each wgmma instantiation by kernel and template
    arguments (missing ones 0, so that a square kernel from before the
    update argument meets this one's lean), reads ptxas's registers and
    spills, and counts the SASS opcodes (predicated or not) of each; other
    kernels are skipped."""
    import collections

    from parfastaai_tpu_torch.tools import wgmma_ab

    log = "\n".join([
        "ptxas info    : (C7517) warpgroup.wait is injected in function 'x'",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__sn_square"
        "_wgmma_cu_b05e665222sn_square_wgmma_kernelILi0ELi1EEEvPKhPKf' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _ZN51_GLOBAL__N__x",
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 253 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__sn_square"
        "_cu_96f008e916sn_square_kernelILi0ELi2ELb0ELi0EEEvPKh' for 'sm_90a'",
        "ptxas info    : Used 99 registers, used 1 barriers, 8192 bytes smem",
        "ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__sn_rect_cu"
        "_3cd395cf14sn_rect_kernelILi2EEEvPKhS2_' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 248 registers, used 1 barriers",
    ])
    assert wgmma_ab.ptxas_report(log) == {
        ("sn_square_wgmma", 0, 1, 0, 0): (253, 8, 4),
        ("sn_rect", 2, 0, 0, 0): (248, 0, 0)}
    assert wgmma_ab.kernel_key("_ZN51_sn_square_wgmma_kernelILi2EEEvPKh") == (
        "sn_square_wgmma", 2, 0, 0, 0)
    # this checkout's keys: (mode, update, packed, walk)
    assert wgmma_ab.kernel_key(
        "_ZN51_sn_square_wgmma_kernelILi1ELi0ELi1ELi2EEEvPKh") == (
        "sn_square_wgmma", 1, 0, 1, 2)
    sass = "\n".join([
        "\t\tFunction : _ZN43_GLOBAL__N__sn_rect_cu_3cd395cf14sn_rect_kernel"
        "ILi2EEEvPKhS2_",
        "        /*0000*/                   IMAD.MOV.U32 R1, RZ, RZ, "
        "c[0x0][0x28] ;          /* 0x00000a00ff017624 */",
        "                                                                    "
        "                    /* 0x000fe400078e00ff */",
        "        /*0010*/              @!P0 BRA 0x70 ;",
        "        /*0020*/                   IGMMA.64x128x32.S8.S8 R24, "
        "gdesc[UR4], RZ, !UPT ;",
        "        /*0030*/                   IGMMA.64x128x32.S8.S8 R24, "
        "gdesc[UR8], R24 ;",
        "\t\tFunction : _ZN45_GLOBAL__N__sn_square_cu_sn_square_kernelILi0ELi"
        "2ELb0ELi0EEEv",
        "        /*0000*/                   IDP.4A.U8.U8 R1, R2, R3, R1 ;",
    ])
    assert wgmma_ab.sass_mix(sass) == {
        ("sn_rect", 2, 0, 0, 0): collections.Counter(
            {"IMAD.MOV.U32": 1, "BRA": 1, "IGMMA.64x128x32.S8.S8": 2})}
