"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``; without a CUDA device each test skips.  On a
machine with a card (and no jax), run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from parfastaai_tpu_torch import engine
from parfastaai_tpu_torch.ops import finish, sn_rect, sn_square
from test_torch_finish import CASES, finish_case, host_finish


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _block(dev, P, A, B, K, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, A + B, K)) < 0.3).astype(np.uint8)
    t = m.sum(axis=2, dtype=np.int32)
    ma = torch.from_numpy(np.ascontiguousarray(m[:, :A])).to(dev)
    mb = torch.from_numpy(np.ascontiguousarray(m[:, A:])).to(dev)
    ta = sn_rect.clamp_t(torch.from_numpy(t[:, :A]).to(dev))
    tb = sn_rect.clamp_t(torch.from_numpy(t[:, A:]).to(dev))
    return ma, mb, ta, tb


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P,A,B,K",
    [
        (3, 70, 130, 256),
        (2, 65, 33, 200),
        (1, 77, 131, 256),  # one protein, A and B off the 128 x 128 block
        (9, 129, 300, 128),  # one slice per protein: the ring wraps at once
        (3, 40, 24, 64),  # half a slice: zero-padded to one
        (5, 128, 256, 896),  # whole blocks, more slices than ring stages
    ],
)
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_rect_kernel_matches_plain(cuda, P, A, B, K, mode):
    """N exact in every mode; S bit-equal under the IEEE divide, within
    2e-6 relative under Newton, AJI within 1e-3 under the raw reciprocal.
    K=200 and K=64 exercise the wrapper's zero-pad to the 128-byte slice."""
    ma, mb, ta, tb = _block(cuda, P, A, B, K, seed=P + A + B + K)
    s_ref, n_ref = sn_rect.fused_sn_block_plain(ma, mb, ta, tb)
    before = sn_rect.LAUNCHES
    s, n = sn_rect.fused_sn_block(
        ma, mb, ta, tb, approx=mode == "approx", precise=mode == "precise"
    )
    torch.cuda.synchronize()
    assert sn_rect.LAUNCHES == before + 1
    assert torch.equal(n, n_ref)
    if mode == "precise":
        assert torch.equal(s, s_ref)
    elif mode == "newton":
        assert bool(((s - s_ref).abs() <= 2e-6 * s_ref.abs()).all())
    else:
        shared = n_ref > 0
        aji, aji_ref = s[shared] / n[shared], s_ref[shared] / n_ref[shared]
        assert bool(((aji - aji_ref).abs() <= 1e-3 * aji_ref.abs()).all())


def _assert_matches_plain(s, n, s_ref, n_ref, mode):
    """N exact; S bit-equal under the IEEE divide, within 2e-6 relative
    under Newton, AJI within 1e-3 under the raw reciprocal."""
    torch.cuda.synchronize()
    assert torch.equal(n, n_ref)
    if mode == "precise":
        assert torch.equal(s, s_ref)
    elif mode == "newton":
        assert bool(((s - s_ref).abs() <= 2e-6 * s_ref.abs()).all())
    else:
        shared = n_ref > 0
        aji, aji_ref = s[shared] / n[shared], s_ref[shared] / n_ref[shared]
        assert bool(((aji - aji_ref).abs() <= 1e-3 * aji_ref.abs()).all())


def _square(dev, P, G, K, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < 0.3).astype(np.uint8)
    t = m.sum(axis=2, dtype=np.int32)
    return (torch.from_numpy(m).to(dev),
            sn_rect.clamp_t(torch.from_numpy(t).to(dev)))


_DIVIDE = {"newton": {}, "approx": {"approx": True},
           "precise": {"precise": True}}


def _launches():
    """Launches of csrc/sn_square_wgmma.cu, the one kernel of every square
    route, and of the rectangular kernel, which no square route may
    launch."""
    return sn_square.WGMMA_LAUNCHES, sn_rect.LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P,G,K,kw",
    [
        (3, 300, 256, {}),  # triu walk, ragged G
        (3, 300, 256, {"symmetric": False}),
        (3, 300, 256, {"pairs_per_step": 2}),  # odd P: masked last pair
        (4, 256, 1280, {"pairs_per_step": 2}),
        (3, 300, 255, {"packed": True}),
        (2, 130, 34816, {}),  # K past the TPU's single-block limit
        (2, 130, 34816, {"symmetric": False}),
        (3, 300, 256, {"pairs_per_step": 2, "update": "fused"}),
    ],
    ids=["sym", "full", "2p_odd", "2p", "packed", "kb_sym", "kb_full",
         "fused"],
)
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_kernel_matches_plain(cuda, P, G, K, kw, mode):
    """Every walk ('lean' and 'fused', packed input too) launches
    csrc/sn_square_wgmma.cu once and no other kernel."""
    m, t = _square(cuda, P, G, K, seed=P + G + K)
    packed = kw.get("packed", False)
    update = kw.get("update", "lean")
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update=update)
    before = _launches()
    s, n = sn_square.fused_sn_square(
        sn_square.pack_nibbles(m) if packed else m, t, **kw, **_DIVIDE[mode]
    )
    assert _launches() == (before[0] + 1, before[1])
    _assert_matches_plain(s, n, s_ref, n_ref, mode)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P,G,K,kw",
    [
        (1, 300, 256, {}),  # one protein
        (5, 300, 256, {"pairs_per_step": 2}),  # odd P: no zero protein here
        (4, 300, 256, {"pairs_per_step": 2, "update": "base"}),
        (3, 77, 256, {}),  # one ragged tile
        (3, 128, 256, {}),  # one whole tile
        (3, 129, 256, {}),  # a diagonal tile and a ragged edge
        (3, 300, 256, {}),  # three row tiles, six triu tiles
        (9, 300, 128, {}),  # one slice a protein: the ring wraps at once
        (3, 130, 200, {}),  # K zero-padded to the 128-byte slice
        (5, 256, 896, {}),  # whole tiles, more slices than ring stages
        (2, 130, 34816, {}),  # K past the TPU's single-block limit
        (3, 300, 256, {"symmetric": False}),
        (3, 77, 200, {"symmetric": False}),
    ],
    ids=["p1", "2p_odd", "2p_base", "g77", "g128", "g129", "g300",
         "one_slice", "k200", "k896", "kb", "full", "full_ragged"],
)
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_wgmma_matches_plain(cuda, P, G, K, kw, mode):
    """csrc/sn_square_wgmma.cu against the plain version: N exact, S
    bit-equal under the IEEE divide and within the other modes'
    tolerances; S and N bit-symmetric; one launch of it and of no other
    kernel."""
    m, t = _square(cuda, P, G, K, seed=P + G + K)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t)
    before = _launches()
    s, n = sn_square.fused_sn_square(m, t, **kw, **_DIVIDE[mode])
    assert _launches() == (before[0] + 1, before[1])
    _assert_matches_plain(s, n, s_ref, n_ref, mode)
    assert torch.equal(s, s.T) and torch.equal(n, n.T)


@pytest.mark.cuda
def test_sn_square_wgmma_empty_protein_axis(cuda):
    """No protein: S and N are zeros and nothing is launched."""
    m = torch.zeros((0, 70, 128), dtype=torch.uint8, device=cuda)
    t = torch.zeros((0, 70), dtype=torch.float32, device=cuda)
    before = _launches()
    s, n = sn_square.fused_sn_square(m, t)
    assert _launches() == before
    assert tuple(s.shape) == (70, 70) and not s.any() and not n.any()


@pytest.mark.cuda
def test_sn_square_counts_variant(cuda):
    """The 'counts' diagnostic: S is the f32 sum of the counts, N stays 0;
    one launch of csrc/sn_square_wgmma.cu and of no other kernel."""
    m, t = _square(cuda, 3, 300, 256, seed=9)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update="counts")
    before = _launches()
    s, n = sn_square.fused_sn_square(m, t, pairs_per_step=2, update="counts")
    assert _launches() == (before[0] + 1, before[1])
    _assert_matches_plain(s, n, s_ref, n_ref, "precise")
    assert not n.any()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "P,G,K",
    [(5, 300, 256), (4, 130, 128), (9, 129, 128), (1, 77, 200),
     (2, 130, 34816)],
    ids=["odd_p_ragged", "even_p_one_slice", "odd_p_one_slice", "p1",
         "wide_k"],
)
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_counts_bit_equal_in_every_mode(cuda, P, G, K, mode):
    """'counts' never divides: in every divide mode its S is bit-equal to
    the plain version's (one count set a pair, converted once: exact for
    counts below 2^24) and N is 0, at a ragged G, an odd P and one slice
    a protein."""
    m, t = _square(cuda, P, G, K, seed=P * G + K)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update="counts")
    before = _launches()
    s, n = sn_square.fused_sn_square(m, t, pairs_per_step=2, update="counts",
                                     **_DIVIDE[mode])
    assert _launches() == (before[0] + 1, before[1])
    _assert_matches_plain(s, n, s_ref, n_ref, "precise")
    assert torch.equal(s, s.T)


# The 2p variants' shapes: the bench shape, a ragged G, an odd P, one slice
# a protein, K past the TPU's single-block limit, one protein.
_VARIANT_SHAPES = [(80, 4096, 1280), (3, 300, 256), (4, 130, 128),
                   (5, 700, 1280), (9, 129, 128), (2, 256, 34816),
                   (1, 300, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,G,K", _VARIANT_SHAPES,
                         ids=[f"{P}-{G}-{K}" for P, G, K in _VARIANT_SHAPES])
@pytest.mark.parametrize(
    "variant,like",
    [("pipe", "lean"), ("f32gram", "lean"), ("mxu_outer", "fused"),
     ("fused", "mxu_outer")],
)
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_2p_variant(cuda, P, G, K, variant, like, mode):
    """'pipe', 'fused' and 'mxu_outer' (csrc/sn_square_wgmma.cu's
    two-count-set bodies) and 'f32gram' (its lean body) against their plain
    versions, and bit-equal to the kernel whose values they keep ('lean',
    or 'fused' and 'mxu_outer' each other's) in every divide mode; one
    launch of csrc/sn_square_wgmma.cu and of no other kernel."""
    m, t = _square(cuda, P, G, K, seed=P + G + K)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update=variant)
    before = _launches()
    s, n = sn_square.fused_sn_square(m, t, pairs_per_step=2, update=variant,
                                     **_DIVIDE[mode])
    assert _launches() == (before[0] + 1, before[1])
    _assert_matches_plain(s, n, s_ref, n_ref, mode)
    ws, wn = sn_square.fused_sn_square(m, t, pairs_per_step=2, update=like,
                                       **_DIVIDE[mode])
    torch.cuda.synchronize()
    assert torch.equal(s, ws) and torch.equal(n, wn)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["pipe", "mxu_outer", "fused", "counts"])
def test_fused_aji_two_set_variants_launch_the_wgmma_kernel(cuda, variant):
    """fused_aji(variant='pipe' | 'mxu_outer' | 'fused' | 'counts') plans
    128-row tiles and launches sn_square_wgmma once and no other kernel."""
    m, t = _square(cuda, 5, 300, 256, seed=11)
    assert sn_square.fused_aji_plan(5, 300, 256, variant=variant)["tile"] == 128
    before = _launches()
    _, s, n = sn_square.fused_aji(m, t, variant=variant, precise=True)
    assert _launches() == (before[0] + 1, before[1])
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update=variant)
    _assert_matches_plain(s, n, s_ref, n_ref, "precise")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["pipe", "mxu_outer", "fused"])
def test_two_set_variants_reject_packed_n_overflow(cuda, variant):
    """N in 16-bit halves: P >= 32768 raises before any launch."""
    P = sn_square.WGMMA_MAX_PACKED_P
    m = torch.zeros((P, 1, 128), dtype=torch.uint8, device=cuda)
    t = torch.ones((P, 1), dtype=torch.float32, device=cuda)
    before = _launches()
    with pytest.raises(ValueError, match="P < 32768"):
        sn_square.fused_sn_square(m, t, pairs_per_step=2, update=variant)
    assert _launches() == before


@pytest.mark.cuda
@pytest.mark.parametrize("G", [256, 300, 512, 640])  # nt = 2, 3, 4, 5
@pytest.mark.parametrize("name,packed", [
    ("sn_sym_diag", False), ("sn_sym_diag", True), ("sn_sym_bands", False),
    ("sn_sym_bands", True), ("sn_sym_bands_2p", False)])
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_alternative_walks(cuda, G, name, packed, mode):
    """The diagonal walk (one launch) and the band walks (one launch per
    band row of 128) on csrc/sn_square_wgmma.cu, packed or not, against the
    plain version, S and N bit-symmetric, at an even and an odd nt."""
    m, t = _square(cuda, 3, G, 256, seed=G)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t)
    kw = {"packed": True} if packed else {}
    before = _launches()
    s, n = getattr(sn_square, name)(
        sn_square.pack_nibbles(m) if packed else m, t, **kw, **_DIVIDE[mode])
    nt = -(-G // 128)
    assert _launches() == (
        before[0] + (1 if name == "sn_sym_diag" else nt), before[1])
    _assert_matches_plain(s, n, s_ref, n_ref, mode)
    assert torch.equal(s, s.T) and torch.equal(n, n.T)


# Packed rows at the small shapes: ragged G, one ragged tile, an odd K, one
# packed slice a protein (the ring wraps at once), K past the TPU's
# single-block limit.
_PACKED_SHAPES = [(3, 300, 256), (3, 77, 256), (3, 129, 255), (9, 129, 256),
                  (2, 130, 34816)]


@pytest.mark.cuda
@pytest.mark.parametrize("P,G,K", _PACKED_SHAPES,
                         ids=[f"{P}-{G}-{K}" for P, G, K in _PACKED_SHAPES])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_packed_matches_plain(cuda, P, G, K, symmetric, mode):
    """Nibble-packed rows on csrc/sn_square_wgmma.cu (split into low and
    high nibbles on chip): one launch, N exact, S bit-equal to the plain
    version under the IEEE divide and bit-symmetric, and bit-equal to the
    unpacked launch in every mode."""
    m, t = _square(cuda, P, G, K, seed=P * G + K)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t)
    before = _launches()
    s, n = sn_square.fused_sn_square(sn_square.pack_nibbles(m), t,
                                     packed=True, symmetric=symmetric,
                                     **_DIVIDE[mode])
    assert _launches() == (before[0] + 1, before[1])
    _assert_matches_plain(s, n, s_ref, n_ref, mode)
    assert torch.equal(s, s.T) and torch.equal(n, n.T)
    us, un = sn_square.fused_sn_square(m, t, symmetric=symmetric,
                                       **_DIVIDE[mode])
    torch.cuda.synchronize()
    assert torch.equal(s, us) and torch.equal(n, un)


@pytest.mark.cuda
def test_fused_aji_packed_launches_the_wgmma_kernel(cuda):
    """fused_aji(packed=True) at an odd K pads one zero column, packs and
    launches csrc/sn_square_wgmma.cu once, with the default plan's
    values."""
    m, t = _square(cuda, 5, 300, 255, seed=3)
    raw = m.sum(dim=2, dtype=torch.int32)
    before = _launches()
    _, s, n = sn_square.fused_aji(m, raw, packed=True, precise=True)
    assert _launches() == (before[0] + 1, before[1])
    _, ws, wn = sn_square.fused_aji(m, raw, precise=True)
    torch.cuda.synchronize()
    assert torch.equal(s, ws) and torch.equal(n, wn)


@pytest.mark.cuda
def test_fused_aji_on_cuda_matches_cpu(cuda):
    """fused_aji's default plan on the card against the same call on the
    CPU (plain version): N exact, S bit-equal under the IEEE divide, NaN
    where N == 0."""
    rng = np.random.default_rng(4)
    m = (rng.random((5, 200, 384)) < 0.1).astype(np.uint8)
    m[:, 7] = 0
    t = torch.from_numpy(m.sum(axis=2, dtype=np.int32))
    want = sn_square.fused_aji(torch.from_numpy(m), t, precise=True)
    got = sn_square.fused_aji(torch.from_numpy(m).to(cuda), t.to(cuda),
                              precise=True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_sn_rect_kernel_rejects_non_contiguous(cuda):
    ma, mb, ta, tb = _block(cuda, 2, 64, 64, 128, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        sn_rect.fused_sn_block(
            ma.transpose(1, 2).contiguous().transpose(1, 2), mb, ta, tb
        )


@pytest.mark.cuda
def test_sn_rect_kernel_rejects_misaligned(cuda):
    """The kernel copies 16 bytes a thread: an operand whose first byte is
    not 16-byte aligned raises."""
    ma, mb, ta, tb = _block(cuda, 2, 64, 64, 128, seed=2)
    flat = torch.zeros(ma.numel() + 16, dtype=torch.uint8, device=cuda)
    shifted = flat[1:1 + ma.numel()].view(ma.shape)
    shifted.copy_(ma)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        sn_rect.fused_sn_block(shifted, mb, ta, tb)


@pytest.mark.cuda
def test_sn_rect_kernel_empty_protein_axis(cuda):
    """No protein: S and N are zeros and nothing is launched."""
    ma = torch.zeros((0, 70, 128), dtype=torch.uint8, device=cuda)
    mb = torch.zeros((0, 30, 128), dtype=torch.uint8, device=cuda)
    ta = torch.zeros((0, 70), dtype=torch.float32, device=cuda)
    tb = torch.zeros((0, 30), dtype=torch.float32, device=cuda)
    before = sn_rect.LAUNCHES
    s, n = sn_rect.fused_sn_block(ma, mb, ta, tb)
    assert sn_rect.LAUNCHES == before
    assert tuple(s.shape) == (70, 30) and not s.any() and not n.any()


@pytest.fixture(scope="module")
def synth_db(tmp_path_factory):
    from parfastaai_tpu_torch.tools.synth_db import generate

    path = str(tmp_path_factory.mktemp("torch_cuda") / "synth.db")
    generate(path, n_genomes=40, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=1)
    return path


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_cli_on_cuda_matches_cpu(cuda, synth_db, tmp_path, fast):
    """The default (exact) CSV is byte-identical between the card and the
    CPU; the --fast CSV agrees within 1e-6 relative and runs the kernel."""
    from parfastaai_tpu_torch.cli import run

    flags = ["--quiet", "--fast"] if fast else ["--quiet"]
    on_cpu, on_cuda = tmp_path / "cpu.csv", tmp_path / "cuda.csv"
    assert run([synth_db, str(on_cpu), "--device", "cpu", *flags]) == 0
    before = sn_rect.LAUNCHES
    assert run([synth_db, str(on_cuda), "--device", "cuda", *flags]) == 0
    if not fast:
        assert on_cuda.read_bytes() == on_cpu.read_bytes()
        return
    assert sn_rect.LAUNCHES > before
    a, b = (
        np.array([[float(v) for v in ln.split(",")[1:]]
                  for ln in p.read_text().splitlines()[1:]])
        for p in (on_cpu, on_cuda)
    )
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mirror", ["on", "off"])
@pytest.mark.parametrize("mode", ["all", "qsub"])
@pytest.mark.parametrize("band", [16, 3])
def test_banded_exact_on_cuda_matches_cpu(
    cuda, synth_db, tmp_path, monkeypatch, mirror, mode, band
):
    """The banded exact engine on the card (Grams on the current stream,
    copies through the page-locked pool on the side stream, many more
    blocks than buffers at band 3) writes the bytes of the same call on the
    CPU and of the dense default call, with the symmetric mirror on and
    off, at 40 genomes: a ragged last band."""
    from parfastaai_tpu_torch.cli import run

    if mirror == "off":
        monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
    extra = []
    if mode == "qsub":
        qfile = tmp_path / "queries.txt"
        qfile.write_text("".join(
            f"synthetic_genome_{i:05d}.fna.gz\n" for i in (30, 2, 17, 39, 8)))
        extra = ["-q", str(qfile)]
    flags = ["--quiet", "--streamed", "--exact", "--band", str(band),
             "--col-chunk", "12", *extra]
    dense, on_cpu, on_cuda = (
        tmp_path / n for n in ("dense.csv", "cpu.csv", "cuda.csv"))
    assert run([synth_db, str(dense), "--device", "cpu", "--quiet", *extra]) == 0
    assert run([synth_db, str(on_cpu), "--device", "cpu", *flags]) == 0
    before = (sn_rect.LAUNCHES, *_launches())
    assert run([synth_db, str(on_cuda), "--device", "cuda", *flags]) == 0
    assert (sn_rect.LAUNCHES, *_launches()) == before  # a library Gram
    assert on_cuda.read_bytes() == on_cpu.read_bytes() == dense.read_bytes()


@pytest.mark.cuda
def test_banded_exact_resume_on_cuda(cuda, synth_db, tmp_path):
    from parfastaai_tpu_torch.cli import run

    flags = ["--quiet", "--device", "cuda", "--streamed", "--exact",
             "--band", "16"]
    full, cut = tmp_path / "full.csv", tmp_path / "cut.csv"
    assert run([synth_db, str(full), *flags]) == 0
    whole = full.read_bytes()
    cut.write_bytes(b"\n".join(whole.split(b"\n")[: 1 + 20]) + b"\nsynth")
    assert run([synth_db, str(cut), *flags, "--resume"]) == 0
    assert cut.read_bytes() == whole


def _bucketed_presence(G=150, seed=5):
    """(meta, presence) of ``G`` genomes whose 5 proteins fall into two
    width buckets; one genome lacks a protein, one has no tetramer."""
    from parfastaai_tpu_torch.etl.database import PresenceData
    from parfastaai_tpu_torch.types import DBMetaData

    rng = np.random.default_rng(seed)
    widths = np.array([300, 20, 280, 10, 290], np.int32)
    m = np.zeros((5, G, 384), np.uint8)
    for p, w in enumerate(widths):
        m[p, :, :w] = rng.random((G, w)) < 0.4
    m[3, 4] = 0
    m[:, 9] = 0
    meta = DBMetaData(protein_set=tuple(f"P{p}" for p in range(5)),
                      genome_set=tuple(f"g{i}" for i in range(G)))
    presence = PresenceData(
        meta=meta, m=m, t=m.sum(2).astype(np.int32), widths=widths,
        tetramer_ids=[np.arange(w, dtype=np.int32) for w in widths])
    return meta, presence


def _run_streamed(presence, names, rows, cols, out, device, **kw) -> bytes:
    from parfastaai_tpu_torch import engine

    engine.compute_streamed(
        presence, rows, cols, str(out), tuple(names[i] for i in rows),
        tuple(names[i] for i in cols), device, **kw)
    return out.read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("mirror", ["on", "off"])
@pytest.mark.parametrize("shape", ["square", "rect"])
@pytest.mark.parametrize("band,col_chunk", [(64, 48), (7, 150), (1024, 4096)])
def test_streamed_on_cuda_equals_cpu_under_precise(
    cuda, tmp_path, monkeypatch, mirror, shape, band, col_chunk
):
    """``compute_streamed`` on the card writes the bytes of its CPU run
    under ``precise`` (the kernel is then bit-equal to its plain version
    and ``_mask_aji`` divides in IEEE f32 on both), with two width buckets,
    ragged bands and chunks, many more blocks than host buffers at band 7,
    the mirror on and off; it launches the kernel once per block and
    bucket."""
    from parfastaai_tpu_torch import engine

    if mirror == "off":
        monkeypatch.setenv("PARFASTAAI_MIRROR_BYTES", "1")
    meta, presence = _bucketed_presence()
    n_buckets = len(engine.to_device_buckets(presence, torch.device("cpu")))
    assert n_buckets == 2
    cols = np.arange(150, dtype=np.int32)
    rows = cols if shape == "square" else np.array([31, 0, 7, 149, 12, 5, 9])
    kw = dict(band=band, col_chunk=col_chunk, precise=True)
    want = _run_streamed(presence, meta.genome_set, rows, cols,
                         tmp_path / "cpu.csv", torch.device("cpu"), **kw)
    before = sn_rect.LAUNCHES
    phases = {}
    got = _run_streamed(presence, meta.genome_set, rows, cols,
                        tmp_path / "cuda.csv", cuda, phases=phases, **kw)
    assert got == want
    b, c = min(band, len(rows)), min(col_chunk, 150)
    sym = shape == "square" and mirror == "on"
    blocks = sum(1 for r0 in range(0, len(rows), b)
                 for c0 in range(0, 150, c) if not (sym and c0 + c <= r0))
    assert sn_rect.LAUNCHES - before == blocks * n_buckets
    assert phases["kernel"] > 0 and phases["D2H"] > 0 and phases["gather"] >= 0


@pytest.mark.cuda
def test_streamed_main_thread_never_waits_for_the_card(cuda, tmp_path, monkeypatch):
    """Between the first and the last block the main thread calls nothing
    that waits for the device: no ``torch.cuda.synchronize``, no stream or
    event ``synchronize``, no ``.cpu()``, ``.item()``, ``.numpy()`` or
    ``.tolist()``.  (The writer thread waits on each copy's event.)"""
    import threading

    from parfastaai_tpu_torch import engine

    meta, presence = _bucketed_presence()
    engine.to_device_buckets(presence, cuda)  # resident before the walk
    log = []

    def spy(owner, name, label=None):
        real = getattr(owner, name)

        def wrapped(*a, **k):
            if threading.current_thread() is threading.main_thread():
                log.append(label or name)
            return real(*a, **k)

        monkeypatch.setattr(owner, name, wrapped)

    spy(torch.cuda, "synchronize")
    spy(torch.cuda.Stream, "synchronize", "stream.synchronize")
    spy(torch.cuda.Event, "synchronize", "event.synchronize")
    for name in ("cpu", "item", "numpy", "tolist"):
        spy(torch.Tensor, name)
    spy(engine, "fused_sn_block", "block")
    ids = np.arange(150, dtype=np.int32)
    _run_streamed(presence, meta.genome_set, ids, ids, tmp_path / "x.csv",
                  cuda, band=16, col_chunk=32)
    first = log.index("block")
    last = len(log) - 1 - log[::-1].index("block")
    assert log.count("block") > 40
    assert set(log[first:last + 1]) == {"block"}
    # after the last block: the pool's close waits for the side stream
    assert "stream.synchronize" in log[last:]


@pytest.mark.cuda
@pytest.mark.parametrize("slab_proteins", [None, 1, 2])
@pytest.mark.parametrize("band,col_chunk", [(64, 48), (7, 150)])
def test_staged_streamed_on_cuda_equals_cpu_under_precise(
    cuda, tmp_path, monkeypatch, slab_proteins, band, col_chunk
):
    """The staged streamed engine on the card, under a budget whose slab
    store holds about two slabs: the bytes of its CPU run under
    ``precise``, whatever the split; with buckets left whole or cut into
    one protein a slab, the bytes of the resident run on the card too; one
    kernel launch per block and chunk."""
    from parfastaai_tpu_torch import engine

    meta, presence = _bucketed_presence()
    G = 150
    ids = np.arange(G, dtype=np.int32)
    kw = dict(band=band, col_chunk=col_chunk, precise=True)
    resident = _run_streamed(presence, meta.genome_set, ids, ids,
                             tmp_path / "resident.csv", cuda, **kw)
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", str(3 * 384 * 2 * 64 * 2))
    if slab_proteins:
        monkeypatch.setenv("PARFASTAAI_SLAB_BYTES",
                           str(slab_proteins * max(band, col_chunk) * 384))
    want = _run_streamed(_bucketed_presence()[1], meta.genome_set, ids, ids,
                         tmp_path / "cpu.csv", torch.device("cpu"),
                         staged=True, **kw)
    _, fresh = _bucketed_presence()
    before = sn_rect.LAUNCHES
    got = _run_streamed(fresh, meta.genome_set, ids, ids,
                        tmp_path / "cuda.csv", cuda, staged=True, **kw)
    assert got == want
    if slab_proteins in (None, 1):
        assert got == resident
    stats = engine.slab_stats(fresh, cuda)
    assert stats["uploaded"] > engine.presence_device_bytes(fresh)
    b, c = min(band, G), min(col_chunk, G)
    chunks = lambda n: len(list(engine._split_plan(  # noqa: E731
        engine._bucket_plan(fresh), n, cuda)))
    launches = sum(chunks(max(min(b, G - r0), min(c, G - c0)))
                   for r0 in range(0, G, b) for c0 in range(0, G, c)
                   if not c0 + c <= r0)
    assert sn_rect.LAUNCHES - before == launches


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["all", "qsub"])
def test_staged_exact_and_fast_on_cuda(cuda, synth_db, tmp_path, monkeypatch,
                                       mode):
    """Staged through the CLI on the card: ``--streamed --exact --staged``
    writes the dense CPU bytes, ``--fast --staged`` and ``--streamed
    --staged`` the resident card run's bytes (no bucket is cut at this
    size)."""
    from parfastaai_tpu_torch.cli import run

    extra = []
    if mode == "qsub":
        qfile = tmp_path / "queries.txt"
        qfile.write_text("".join(
            f"synthetic_genome_{i:05d}.fna.gz\n" for i in (30, 2, 17, 39, 8)))
        extra = ["-q", str(qfile)]
    dense = tmp_path / "dense.csv"
    assert run([synth_db, str(dense), "--device", "cpu", "--quiet", *extra]) == 0
    for flags in (["--streamed", "--exact"], ["--fast"], ["--streamed"]):
        base = ["--device", "cuda", "--quiet", "--band", "16",
                "--col-chunk", "12", *extra, *flags]
        resident, staged = tmp_path / "resident.csv", tmp_path / "staged.csv"
        assert run([synth_db, str(resident), *base]) == 0
        monkeypatch.setenv("PARFASTAAI_HBM_BYTES", "20000")
        assert run([synth_db, str(staged), *base, "--staged"]) == 0
        monkeypatch.delenv("PARFASTAAI_HBM_BYTES")
        assert staged.read_bytes() == resident.read_bytes()
        if "--exact" in flags:
            assert staged.read_bytes() == dense.read_bytes()


@pytest.mark.cuda
def test_staged_main_thread_never_waits_for_the_card(cuda, tmp_path,
                                                     monkeypatch):
    """The staged streamed engine keeps the resident one's rule: between
    the first and the last block the main thread calls nothing that waits
    for the device.  (The slab store takes ``.numpy()`` views of its own
    page-locked host buffers, which wait for nothing, so that call is not
    watched here.)"""
    import threading

    from parfastaai_tpu_torch import engine

    meta, presence = _bucketed_presence()
    monkeypatch.setenv("PARFASTAAI_HBM_BYTES", str(150 * 384 * 5 // 2))
    log = []

    def spy(owner, name, label=None):
        real = getattr(owner, name)

        def wrapped(*a, **k):
            if threading.current_thread() is threading.main_thread():
                log.append(label or name)
            return real(*a, **k)

        monkeypatch.setattr(owner, name, wrapped)

    spy(torch.cuda, "synchronize")
    spy(torch.cuda.Stream, "synchronize", "stream.synchronize")
    spy(torch.cuda.Event, "synchronize", "event.synchronize")
    for name in ("cpu", "item", "tolist"):
        spy(torch.Tensor, name)
    spy(engine, "fused_sn_block", "block")
    ids = np.arange(150, dtype=np.int32)
    _run_streamed(presence, meta.genome_set, ids, ids, tmp_path / "x.csv",
                  cuda, band=16, col_chunk=32)
    assert engine.slab_stats(presence, cuda)["slabs"] > 0
    first = log.index("block")
    last = len(log) - 1 - log[::-1].index("block")
    assert log.count("block") > 40
    assert set(log[first:last + 1]) == {"block"}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["hook", "formatter"])
def test_streamed_writer_fault_returns_every_pinned_buffer(
    cuda, tmp_path, monkeypatch, fault
):
    """A writer that fails (at its start, or in the formatter at the second
    band) reaches the caller, the producer does not hang on the pool, and
    every page-locked buffer is back in it."""
    import threading

    from parfastaai_tpu_torch import engine

    pools = []

    class Pool(engine._BlockDownloads):
        def __init__(self, *a, n_buffers, **k):
            super().__init__(*a, n_buffers=n_buffers, **k)
            pools.append((self, n_buffers))

    monkeypatch.setattr(engine, "_BlockDownloads", Pool)
    if fault == "hook":
        monkeypatch.setenv("PARFASTAAI_TEST_WORKER_FAULT", "1")
        match = "injected csv-writer fault"
    else:
        calls = []
        real = engine.format_matrix

        def boom(mat, sep):
            calls.append(1)
            if len(calls) >= 2:
                raise OSError("disk full (simulated)")
            return real(mat, sep)

        monkeypatch.setattr(engine, "format_matrix", boom)
        match = "disk full"
    meta, presence = _bucketed_presence()
    ids = np.arange(150, dtype=np.int32)
    with pytest.raises((RuntimeError, OSError), match=match):
        _run_streamed(presence, meta.genome_set, ids, ids, tmp_path / "x.csv",
                      cuda, band=8, col_chunk=40)
    (pool, n_buffers), = pools
    assert pool._free.qsize() == n_buffers == 4
    assert all(buf.is_pinned() for buf in list(pool._free.queue))
    assert not [t for t in threading.enumerate() if t.name.startswith("pfaai-")]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "flags", [[], ["--precise"], ["--approx"], ["--fast"]],
    ids=["newton", "precise", "approx", "fast"])
def test_streamed_cli_on_cuda_matches_cpu(cuda, synth_db, tmp_path, flags):
    """``--streamed`` on the card against the CPU run (IEEE divide): the
    text ``0`` in the same cells; bytes equal under --precise, within 1e-6
    under the Newton divide and 1e-3 under --approx (which only the card
    runs); one kernel launch per block."""
    from parfastaai_tpu_torch.cli import run

    base = ["--quiet", "--streamed", "--band", "16", "--col-chunk", "12"]
    on_cpu, on_cuda = tmp_path / "cpu.csv", tmp_path / "cuda.csv"
    assert run([synth_db, str(on_cpu), "--device", "cpu", *base]) == 0
    before = sn_rect.LAUNCHES
    assert run([synth_db, str(on_cuda), "--device", "cuda", *base, *flags]) == 0
    # 40 genomes: bands at 0, 16, 32; chunks of 12 not wholly below them
    assert sn_rect.LAUNCHES - before == 4 + 3 + 2
    if flags == ["--precise"]:
        assert on_cuda.read_bytes() == on_cpu.read_bytes()
        return
    a, b = (
        np.array([ln.split(",")[1:] for ln in p.read_text().splitlines()[1:]],
                 dtype=object)
        for p in (on_cpu, on_cuda)
    )
    np.testing.assert_array_equal(a == "0", b == "0")
    np.testing.assert_allclose(b.astype(float), a.astype(float),
                               rtol=1e-3 if flags == ["--approx"] else 1e-6,
                               atol=0)


@pytest.mark.cuda
def test_streamed_resume_and_api_on_cuda(cuda, synth_db, tmp_path):
    """On the card: --resume restores a cut file, and the library API's
    ``engine="streamed"`` writes the CLI's bytes."""
    import parfastaai_tpu_torch.api as api
    from parfastaai_tpu_torch.cli import run

    flags = ["--quiet", "--device", "cuda", "--streamed", "--band", "16",
             "--col-chunk", "12"]
    full, cut, lib = (tmp_path / n for n in ("full.csv", "cut.csv", "api.csv"))
    assert run([synth_db, str(full), *flags]) == 0
    whole = full.read_bytes()
    cut.write_bytes(b"\n".join(whole.split(b"\n")[: 1 + 20]) + b"\nsynth")
    assert run([synth_db, str(cut), *flags, "--resume"]) == 0
    assert cut.read_bytes() == whole
    api.aji_to_csv(str(lib), synth_db, engine="streamed", band=16,
                   col_chunk=12, device="cuda")
    assert lib.read_bytes() == whole


@pytest.mark.cuda
def test_profile_on_cuda_records_device_events(cuda, synth_db, tmp_path):
    """--profile on the card: the trace holds kernel events, among them
    the rectangular kernel's, and the CSV's bytes do not change."""
    import json

    from parfastaai_tpu_torch.cli import PROFILE_TRACE, run

    base = [synth_db, "--quiet", "--device", "cuda", "--streamed"]
    plain, got = tmp_path / "plain.csv", tmp_path / "profiled.csv"
    assert run([base[0], str(plain), *base[1:]]) == 0
    assert run([base[0], str(got), *base[1:], "--profile",
                str(tmp_path / "trace")]) == 0
    assert got.read_bytes() == plain.read_bytes()
    events = json.loads((tmp_path / "trace" / PROFILE_TRACE).read_text())[
        "traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert any("sn_rect" in e["name"] for e in kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,scp", [(1, 1), (2, 1), (1, 2), (2, 2), (3, 1)])
def test_mesh_cell_body_bit_equal_to_plain(cuda, rows, scp):
    """Every cell of a (rows, scp) mesh, run in turn on the card: its
    program (its shard uploaded, its row band cut, one sn_rect launch)
    under the IEEE divide is bit-equal to ``fused_sn_block_plain`` on the
    same shard and band; the default divide within 2e-6."""
    from parfastaai_tpu_torch.parallel import mesh

    rng = np.random.default_rng(rows * 10 + scp)
    P, G, K = 6, 258, 384  # two row bands of 129: off the 128 x 128 block
    m = (rng.random((P, G, K)) < 0.3).astype(np.uint8)
    m[:, 5] = 0
    t = m.sum(axis=2, dtype=np.int32)
    G_pad = -(-G // rows) * rows
    m = np.pad(m, ((0, 0), (0, G_pad - G), (0, 0)))
    t = np.pad(t, ((0, 0), (0, G_pad - G)))
    band = G_pad // rows
    for r in range(rows):
        for sh in range(scp):
            m_loc, t_loc = mesh.upload_shard(m, t, sh, scp, cuda)
            assert m_loc.device.type == "cuda"
            ma, ta = mesh.row_band(m_loc, r, band), mesh.row_band(t_loc, r, band)
            s_ref, n_ref = sn_rect.fused_sn_block_plain(ma, m_loc, ta, t_loc)
            before = sn_rect.LAUNCHES
            s, n = sn_rect.fused_sn_block(ma, m_loc, ta, t_loc, precise=True)
            assert sn_rect.LAUNCHES == before + 1
            _assert_matches_plain(s, n, s_ref, n_ref, "precise")
            s, n = sn_rect.fused_sn_block(ma, m_loc, ta, t_loc)
            _assert_matches_plain(s, n, s_ref, n_ref, "newton")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["all", "qt"])
def test_compute_sharded_on_cuda_matches_cpu(cuda, synth_db, tmp_path, mode):
    """The one-process mesh on the card: one sn_rect launch, N equal to the
    CPU's and S within 2e-6 (the kernel's Newton divide, as the JAX
    package's mesh bodies); the CLI's --mesh 1,1 CSV within 1e-6."""
    import sqlite3

    from parfastaai_tpu_torch.cli import run
    from parfastaai_tpu_torch.engine import compute_sharded
    from parfastaai_tpu_torch.etl.database import (
        QueryTargetDatabase,
        SCPDatabase,
    )
    from parfastaai_tpu_torch.modes import all_vs_all, query_target
    from parfastaai_tpu_torch.tools.synth_db import generate

    extra = []
    if mode == "qt":
        query = str(tmp_path / "query.db")
        generate(query, n_genomes=17, n_proteins=6, pool_size=300,
                 tetras_per_genome=100, seed=2)
        with sqlite3.connect(query) as conn:
            conn.execute(
                "UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
        db = QueryTargetDatabase(synth_db, query)
        pairs = query_target(db.meta, compat_qt_t_swap=True)
        extra = ["-r", query]
    else:
        db = SCPDatabase(synth_db)
        pairs = all_vs_all(db.meta)
    presence = db.load_presence()
    db.close()
    want = compute_sharded(presence, pairs, torch.device("cpu"))
    before = sn_rect.LAUNCHES
    got = compute_sharded(presence, pairs, cuda, 1, 1)
    assert sn_rect.LAUNCHES == before + 1
    np.testing.assert_array_equal(got.n, want.n)
    np.testing.assert_allclose(got.s, want.s, rtol=2e-6, atol=0)
    on_cpu, on_cuda = tmp_path / "cpu.csv", tmp_path / "cuda.csv"
    for out, dev in ((on_cpu, "cpu"), (on_cuda, "cuda")):
        assert run([synth_db, str(out), "--quiet", "--mesh", "1,1",
                    "--device", dev, *extra]) == 0
    a, b = (
        np.array([[float(v) for v in ln.split(",")[1:]]
                  for ln in p.read_text().splitlines()[1:]])
        for p in (on_cpu, on_cuda)
    )
    np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,scp", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("staged", [False, True], ids=["resident", "staged"])
def test_mesh_rank_blocks_on_cuda(cuda, monkeypatch, rows, scp, staged):
    """Every cell of the streamed engines' mesh, run in turn on the card
    (``_block_sn`` on the ``_MeshResident`` placement, or ``_MeshStaged``
    on slabs of two proteins), two width buckets, a ragged band: under the
    IEEE divide each cell's (S, N) is bit-equal to the same cell on the
    CPU (the kernel's plain version), with one sn_rect launch per bucket
    or chunk; each cell of ``_block_counts`` equals the CPU's."""
    from parfastaai_tpu_torch import engine
    from parfastaai_tpu_torch.parallel.mesh import Mesh

    cpu = torch.device("cpu")
    if staged:
        monkeypatch.setenv("PARFASTAAI_SLAB_BYTES", str(2 * 150 * 384))

    def block(presence, cell, dev):
        place = engine._placement(presence, dev, staged, cell)
        return lambda *ids: engine._block_sn(place, *ids, precise=True)

    def counts(presence, cell, dev):
        place = engine._placement(presence, dev, staged, cell)
        return lambda *ids: engine._block_counts(place, *ids)

    on_cpu, on_cuda = _bucketed_presence()[1], _bucketed_presence()[1]
    rids = np.arange(3, 140, 2)  # 69 rows, padded to the mesh's rows
    cids = np.arange(150)[::-1].copy()
    plan = engine._bucket_plan(on_cuda)
    for r in range(rows):
        for sh in range(scp):
            cell = Mesh(rows, scp, (r, sh), None)
            want = block(on_cpu, cell, cpu)(rids, cids, rids, cids)
            before = sn_rect.LAUNCHES
            got = block(on_cuda, cell, cuda)(rids, cids, rids, cids)
            torch.cuda.synchronize()
            launches = (len(list(engine._split_plan(
                plan, 150, cuda,
                engine._placement(on_cuda, cuda, True, cell)._store.target)))
                if staged else len(plan))
            assert sn_rect.LAUNCHES - before == launches
            assert got[0].device.type == "cuda"
            assert torch.equal(got[0].cpu(), want[0])
            assert torch.equal(got[1].cpu(), want[1])
            c_cpu, layout_cpu = counts(on_cpu, cell, cpu)(rids, cids)
            c_cuda, layout = counts(on_cuda, cell, cuda)(rids, cids)
            np.testing.assert_array_equal(layout, layout_cpu)
            assert torch.equal(c_cuda.cpu(), c_cpu)


FINISH_CASES = [
    *CASES,
    # past the kernel's grid cap of 2^16 blocks of 256: the grid-stride loop
    (9, 2, 100, 2**24 + 37, np.int16, 300),
]


@pytest.mark.cuda
@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("case", FINISH_CASES, ids=lambda c: f"s{c[0]}")
def test_finish_kernel_bit_equal_to_host_finish(cuda, case, native,
                                                monkeypatch):
    """S and N of csrc/finish_f64.cu equal the host's ``jaccard_finish``
    (native and NumPy loop) bit for bit: int16 and int32 counts, an
    all-zero protein, N = 0 pairs, T near 2^15, n off the block size, n = 1
    and n = 0 (no launch)."""
    if not native:
        monkeypatch.setattr(engine, "native_jaccard_finish",
                            lambda *a: None)
    counts, t, da, db = finish_case(*case)
    s_ref, n_ref = host_finish(counts, t, da, db)
    before = finish.LAUNCHES
    s, n = finish.finish_pairs(
        *(torch.from_numpy(x).to(cuda) for x in (counts, t, da, db)))
    torch.cuda.synchronize()
    assert finish.LAUNCHES == before + (len(n_ref) > 0)
    assert s.device.type == "cuda" and s.dtype == torch.float64
    assert n.dtype == torch.int32
    assert np.array_equal(s.cpu().numpy(), s_ref)
    assert np.array_equal(n.cpu().numpy(), n_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("change,error,match", [
    ({"counts": lambda x: x.to(torch.int64)}, TypeError, "int16 or int32"),
    ({"t": lambda x: x.to(torch.float32)}, TypeError, "t must be int32"),
    ({"denom_a": lambda x: x[:-1]}, ValueError, "does not match n_pairs"),
    ({"t": lambda x: x[:1]}, ValueError, "differ in P"),
    ({"t": lambda x: x.cpu()}, ValueError, "different devices"),
    ({"counts": lambda x: x.t().contiguous().t()}, ValueError, "contiguous"),
], ids=["counts_i64", "t_f32", "ids_n", "t_P", "t_on_cpu", "counts_strided"])
def test_finish_kernel_rejects_what_it_does_not_take(cuda, change, error,
                                                     match):
    counts, t, da, db = finish_case(10, 3, 20, 50)
    ops = {"counts": counts, "t": t, "denom_a": da, "denom_b": db}
    ops = {k: torch.from_numpy(v).to(cuda) for k, v in ops.items()}
    for name, fn in change.items():
        ops[name] = fn(ops[name])
    before = finish.LAUNCHES
    with pytest.raises(error, match=match):
        finish.finish_pairs(**ops)
    assert finish.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["all", "qt", "qsub"])
def test_dense_compute_on_cuda_equals_cpu(cuda, synth_db, tmp_path, mode):
    """``engine.compute`` on the card (the finish kernel on the counts
    where they lie) equals the CPU's host finish field by field for the
    all-vs-all, ``-r`` and ``-q`` pair spaces: one finish launch a call,
    ``device_finish_pairs`` its pairs, and the CPU's 0."""
    import sqlite3

    from parfastaai_tpu_torch import modes
    from parfastaai_tpu_torch.etl.database import (
        QueryTargetDatabase,
        SCPDatabase,
    )
    from parfastaai_tpu_torch.tools.synth_db import generate
    from parfastaai_tpu_torch.utils import timing

    if mode == "qt":
        query = str(tmp_path / "query.db")
        generate(query, n_genomes=17, n_proteins=6, pool_size=300,
                 tetras_per_genome=100, seed=2)
        with sqlite3.connect(query) as conn:
            conn.execute(
                "UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
        db = QueryTargetDatabase(synth_db, query)
        pairs = modes.query_target(db.meta)
    else:
        db = SCPDatabase(synth_db)
        pairs = (modes.query_subset(db.meta, db.meta.genome_set[30:2:-3])
                 if mode == "qsub" else modes.all_vs_all(db.meta))
    presence = db.load_presence()
    db.close()
    got = {}
    for dev in (torch.device("cpu"), cuda):
        before = finish.LAUNCHES
        with timing.call(force=True) as c:
            got[dev.type] = engine.compute(presence, pairs, dev)
        (fin,) = [s for s in c.spans if s.name == "engine.finish"]
        on_card = dev.type == "cuda"
        assert finish.LAUNCHES == before + on_card
        assert fin.counters == {
            "device_finish_pairs": pairs.n_pairs if on_card else 0}
    want, res = got["cpu"], got["cuda"]
    assert pairs.n_pairs > 0
    for field in ("genome_a", "genome_b", "s", "n"):
        a, b = getattr(res, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        assert np.array_equal(a, b), field
