"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked ``cuda``; without a CUDA device each test skips.  On a
machine with a card (and no jax), run them with

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from parfastaai_tpu_torch.ops import sn_rect


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
@pytest.mark.parametrize("P,A,B,K", [(3, 70, 130, 256), (2, 65, 33, 200)])
@pytest.mark.parametrize("mode", ["newton", "approx", "precise"])
def test_sn_rect_kernel_matches_plain(cuda, P, A, B, K, mode):
    """N exact in every mode; S bit-equal under the IEEE divide, within
    2e-6 relative under Newton, AJI within 1e-3 under the raw reciprocal.
    K=200 exercises the wrapper's zero-pad to the 64-byte slice."""
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


@pytest.mark.cuda
def test_sn_rect_kernel_rejects_non_contiguous(cuda):
    ma, mb, ta, tb = _block(cuda, 2, 64, 64, 128, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        sn_rect.fused_sn_block(
            ma.transpose(1, 2).contiguous().transpose(1, 2), mb, ta, tb
        )


@pytest.fixture(scope="module")
def synth_db(tmp_path_factory):
    from parfastaai_tpu.tools.synth_db import generate

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
