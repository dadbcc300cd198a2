"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``; without a CUDA device each test skips.  On a
machine with a card (and no jax), run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from parfastaai_tpu_torch.ops import sn_rect, sn_square


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
    return (sn_square.LAUNCHES, sn_square.MMA_LAUNCHES,
            sn_square.WGMMA_LAUNCHES)


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
    """Unpacked 'lean' walks launch csrc/sn_square_wgmma.cu once, packed
    input and the 'fused' update csrc/sn_square.cu once."""
    m, t = _square(cuda, P, G, K, seed=P + G + K)
    packed = kw.get("packed", False)
    update = kw.get("update", "lean")
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update=update)
    before = _launches()
    s, n = sn_square.fused_sn_square(
        sn_square.pack_nibbles(m) if packed else m, t, **kw, **_DIVIDE[mode]
    )
    wgmma = not packed and update == "lean"
    assert _launches() == (before[0] + (not wgmma), before[1],
                           before[2] + wgmma)
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
    assert _launches() == (before[0], before[1], before[2] + 1)
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
    """The 'counts' diagnostic: S is the f32 sum of the counts, N stays 0."""
    m, t = _square(cuda, 3, 300, 256, seed=9)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update="counts")
    s, n = sn_square.fused_sn_square(m, t, pairs_per_step=2, update="counts")
    _assert_matches_plain(s, n, s_ref, n_ref, "precise")
    assert not n.any()


@pytest.mark.cuda
@pytest.mark.parametrize("P,G,K", [(3, 300, 256), (4, 130, 128)])
@pytest.mark.parametrize(
    "variant,like",
    [("pipe", "lean"), ("f32gram", "lean"), ("mxu_outer", "fused")],
)
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_2p_variant(cuda, P, G, K, variant, like, mode):
    """'pipe', 'f32gram' (csrc/sn_square_mma.cu) and 'mxu_outer' against
    their plain versions, and bit-equal to the kernel whose values they
    keep ('lean', on csrc/sn_square_wgmma.cu, or 'fused') in every divide
    mode."""
    m, t = _square(cuda, P, G, K, seed=P + G + K)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t, update=variant)
    mma = variant == "f32gram"
    before = _launches()
    s, n = sn_square.fused_sn_square(m, t, pairs_per_step=2, update=variant,
                                     **_DIVIDE[mode])
    assert _launches() == (before[0] + (not mma), before[1] + mma, before[2])
    _assert_matches_plain(s, n, s_ref, n_ref, mode)
    ws, wn = sn_square.fused_sn_square(m, t, pairs_per_step=2, update=like,
                                       **_DIVIDE[mode])
    torch.cuda.synchronize()
    assert torch.equal(s, ws) and torch.equal(n, wn)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [256, 300])  # nt = 4 (even), 5 (odd)
@pytest.mark.parametrize(
    "name", ["sn_sym_diag", "sn_sym_bands", "sn_sym_bands_2p"]
)
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_square_alternative_walks(cuda, G, name, mode):
    m, t = _square(cuda, 3, G, 256, seed=G)
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, t)
    before = sn_square.LAUNCHES
    s, n = getattr(sn_square, name)(m, t, **_DIVIDE[mode])
    nt = -(-G // 64)
    assert sn_square.LAUNCHES == before + (1 if name == "sn_sym_diag" else nt)
    _assert_matches_plain(s, n, s_ref, n_ref, mode)


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
