"""The port's whole-matrix fused AJI against the JAX package, on the CPU.

The same numpy inputs go through ``parfastaai_tpu_torch.ops.sn_square``
(whose CUDA kernel's plain version runs for CPU tensors) and through the
JAX functions it ports: ``pallas_fused_aji`` and the square Pallas kernels
in TPU interpret mode (as tests/test_fused.py runs them), and the XLA-scan
``ops.fused.fused_aji``.  N must agree exactly and S and AJI within 2e-6
relative, the JAX package's own bound for its fused paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from parfastaai_tpu.constants import MAX_K_SINGLE_BLOCK
from parfastaai_tpu.ops import fused as jax_fused
from parfastaai_tpu.ops import pallas_intersect as jpi
from parfastaai_tpu_torch.ops import fused, sn_rect, sn_square

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
        # the K-blocked route (kb_sym) on the JAX side
        (2, 12, MAX_K_SINGLE_BLOCK + 300, 0.05,
         {"tile": 128, "precise": True}),
    ],
    ids=["pad", "sym", "full", "packed", "kb"],
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
    assert plan["tile"] == 64 and plan["gp"] == 64 * nt >= g > plan["gp"] - 64
    assert plan["n_tiles"] == (nt * (nt + 1) // 2 if sym else nt * nt)
    assert plan["pp"] == (p + p % 2 if plan["mode"] == "2p" else p)
    kbytes = plan["kp"] // 2 if packed else plan["kp"]
    assert kbytes % 64 == 0 and plan["kp"] >= k
    assert plan["mxu_macs"] == (
        plan["n_tiles"] * 64 * 64 * plan["pp"] * plan["kp"]
    )


def test_plan_rejects_other_tiles():
    assert sn_square.fused_aji_plan(3, 100, 64, tile=64)["tile"] == 64
    with pytest.raises(ValueError, match="tile is 64"):
        sn_square.fused_aji_plan(3, 100, 64, tile=128)


@pytest.mark.parametrize("K", [256, 255, 1])
def test_pack_nibbles_matches_jax(K):
    m, _ = _presence(2, 5, K, 0.5, seed=K)
    mj = np.pad(m, ((0, 0), (0, 0), (0, K % 2))).astype(np.int8)
    want = np.asarray(jpi._pack_nibbles(jnp.asarray(mj)))
    got = sn_square.pack_nibbles(torch.from_numpy(m))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int8), want)


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


_VARIANTS_2P = ("pipe", "mxu_outer", "f32gram")


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
    before = (sn_square.LAUNCHES, sn_square.MMA_LAUNCHES)
    s, n = sn_square.fused_sn_square(m, t, pairs_per_step=2, update=variant)
    want = sn_square.fused_sn_square_plain(m, t, update=variant)
    assert torch.equal(s, want[0]) and torch.equal(n, want[1])
    sn_square.fused_aji(m, t, variant=variant)
    assert (sn_square.LAUNCHES, sn_square.MMA_LAUNCHES) == before


@pytest.mark.parametrize("variant", _VARIANTS_2P)
def test_2p_variant_needs_two_per_step(variant):
    m, t = _square_inputs(P=2, G=16)
    with pytest.raises(ValueError, match="needs pairs_per_step=2"):
        sn_square.fused_sn_square(m, t, update=variant)


@pytest.mark.parametrize(
    "fn,jax_fn",
    [
        (sn_square.sn_sym_diag, jpi._pallas_sn_sym_diag),
        (sn_square.sn_sym_bands, jpi._pallas_sn_sym_bands),
        (sn_square.sn_sym_bands_2p, jpi._pallas_sn_sym_bands_2p),
    ],
    ids=["diag", "bands", "bands_2p"],
)
def test_alternative_walks_match_jax(fn, jax_fn):
    """Kernels 8-10's wrappers against their TPU kernels (interpret mode,
    nt = 3 tiles of 128), on CPU tensors, where they launch nothing."""
    m, t = _presence(3, 384, 128, 0.25, seed=8)
    with pltpu.force_tpu_interpret_mode():
        ws, wn = jax_fn(jnp.asarray(m), jnp.asarray(t), tile=128, precise=True)
    before = sn_square.LAUNCHES
    s, n = fn(torch.from_numpy(m), sn_rect.clamp_t(torch.from_numpy(t)),
              precise=True)
    assert sn_square.LAUNCHES == before
    np.testing.assert_array_equal(n.numpy(), np.asarray(wn))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=RTOL, atol=0)


def test_wrappers_on_cpu_launch_nothing():
    m, t = _square_inputs(P=3, G=40)
    ref = sn_square.fused_sn_square_plain(m, t)
    before = sn_square.LAUNCHES
    for kw in ({}, {"symmetric": False}, {"pairs_per_step": 2},
               {"approx": True}, {"precise": True}):
        s, n = sn_square.fused_sn_square(m, t, **kw)
        assert torch.equal(s, ref[0]) and torch.equal(n, ref[1])
    for fn in (sn_square.sn_sym_diag, sn_square.sn_sym_bands,
               sn_square.sn_sym_bands_2p):
        s, n = fn(m, t)
        assert torch.equal(s, ref[0]) and torch.equal(n, ref[1])
    sn_square.fused_aji(m, t)
    assert sn_square.LAUNCHES == before


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
