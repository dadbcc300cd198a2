"""The port's fused (S, N) block and exact Gram against the JAX package, on
the CPU.

The same numpy inputs go through ``parfastaai_tpu_torch.ops`` and through
the JAX functions they port: the XLA-scan ``ops.fused.fused_sn_block`` and
the Pallas ``pallas_fused_sn_block`` run in TPU interpret mode (as
tests/test_fused.py runs it), which reaches ``_pallas_sn_rect`` and, for
K > MAX_K_SINGLE_BLOCK, ``_pallas_sn_rect_kb``.
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from parfastaai_tpu.constants import MAX_K_SINGLE_BLOCK
from parfastaai_tpu.ops.fused import fused_sn_block as jax_fused_sn_block
from parfastaai_tpu.ops.fused import pair_counts_device as jax_pair_counts
from parfastaai_tpu.ops.pallas_intersect import pallas_fused_sn_block
from parfastaai_tpu_torch.ops import _build, sn_rect
from parfastaai_tpu_torch.ops.fused import int_gram, pair_counts_device


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(P, A, B, K, density, seed):
    rng = np.random.default_rng(seed)
    m = (rng.random((P, A + B, K)) < density).astype(np.uint8)
    t = m.sum(axis=2, dtype=np.int32)
    return m[:, :A], m[:, A:], t[:, :A], t[:, A:]


def _torch_block(ma, mb, ta, tb):
    return (
        torch.from_numpy(np.ascontiguousarray(ma)),
        torch.from_numpy(np.ascontiguousarray(mb)),
        sn_rect.clamp_t(torch.from_numpy(np.ascontiguousarray(ta))),
        sn_rect.clamp_t(torch.from_numpy(np.ascontiguousarray(tb))),
    )


@pytest.mark.parametrize(
    "P,A,B,K,density",
    [
        (5, 70, 130, 256, 0.2),
        # neither A nor B a multiple of the kernel's block, one protein
        (1, 77, 131, 256, 0.3),
        # K of a single kernel slice
        (3, 140, 24, 128, 0.3),
        # K past the single-block limit: the JAX side runs _pallas_sn_rect_kb
        (2, 4, 8, MAX_K_SINGLE_BLOCK + 300, 0.05),
    ],
)
def test_plain_block_matches_jax_and_pallas(P, A, B, K, density):
    """N exact and S within 2e-6 relative (the JAX package's own bound for
    the rectangular block, tests/test_fused.py)."""
    ma, mb, ta, tb = _inputs(P, A, B, K, density, seed=P * 1000 + K)
    js, jn = jax_fused_sn_block(
        jnp.asarray(ma), jnp.asarray(mb), jnp.asarray(ta), jnp.asarray(tb)
    )
    with pltpu.force_tpu_interpret_mode():
        ps, pn = pallas_fused_sn_block(
            jnp.asarray(ma), jnp.asarray(mb), jnp.asarray(ta),
            jnp.asarray(tb), tile=128, precise=True,
        )
    s, n = sn_rect.fused_sn_block_plain(*_torch_block(ma, mb, ta, tb))
    assert s.dtype == torch.float32 and n.dtype == torch.int32
    assert tuple(s.shape) == (A, B)
    for ref_s, ref_n in ((js, jn), (ps, pn)):
        np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))
        np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), rtol=2e-6)


@pytest.mark.parametrize("mode", [{}, {"approx": True}, {"precise": True}])
def test_wrapper_runs_plain_for_cpu_tensors(mode):
    """CPU tensors take the plain version (IEEE divide in every mode) and
    launch nothing."""
    blk = _torch_block(*_inputs(3, 17, 33, 128, 0.3, seed=7))
    before = sn_rect.LAUNCHES
    s, n = sn_rect.fused_sn_block(*blk, **mode)
    ref_s, ref_n = sn_rect.fused_sn_block_plain(*blk)
    assert sn_rect.LAUNCHES == before
    assert torch.equal(s, ref_s) and torch.equal(n, ref_n)


def test_wrapper_rejects_bad_operands():
    ma, mb, ta, tb = _torch_block(*_inputs(2, 8, 16, 128, 0.3, seed=8))
    with pytest.raises(TypeError, match="float32"):
        sn_rect.fused_sn_block(ma, mb, ta.to(torch.int32), tb)
    with pytest.raises(TypeError, match="uint8 or int8"):
        sn_rect.fused_sn_block(ma.float(), mb.float(), ta, tb)
    with pytest.raises(ValueError, match="differ in P or K"):
        sn_rect.fused_sn_block(ma, mb[:, :, :64], ta, tb)
    with pytest.raises(ValueError, match="do not match"):
        sn_rect.fused_sn_block(ma, mb, ta[:, :4], tb)
    with pytest.raises(ValueError, match="contiguous"):
        sn_rect.fused_sn_block(
            ma.transpose(1, 2).contiguous().transpose(1, 2), mb, ta, tb
        )
    with pytest.raises(ValueError, match="mutually exclusive"):
        sn_rect.fused_sn_block(ma, mb, ta, tb, approx=True, precise=True)
    meta = [x.to("meta") for x in (ma, mb, ta, tb)]
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        sn_rect.fused_sn_block(*meta)


def test_kernel_loader_covers_each_staged_chunk_once():
    """Over a block's threads, the loader's (row, chunk) pairs are each
    16-byte chunk of each staged row of one side exactly once, and the
    swizzle sends them to distinct 16-byte cells of the staged tile."""
    got = [c for tid in range(sn_rect.THREADS)
           for c in sn_rect.loader_chunks(tid)]
    assert sorted(got) == [(r, c) for r in range(sn_rect.TILE)
                           for c in range(sn_rect.K_SLICE // 16)]
    cells = sorted(sn_rect.staged_offset(r, c) for r, c in got)
    assert cells == list(range(0, sn_rect.TILE * sn_rect.K_SLICE, 16))
    assert 2 * sn_rect.TILE == sn_rect.THREADS  # one T value a thread


def test_kernel_swizzle_is_the_address_bit_xor():
    """The staged layout is wgmma's 128-byte swizzle: bits 4-6 of the byte
    address XORed with bits 7-9, on tiles that start at a multiple of 1024
    bytes; a row stays within its own 128 bytes."""
    for row in range(sn_rect.TILE):
        for chunk in range(8):
            linear = row * 128 + chunk * 16
            want = linear ^ (((linear >> 7) & 7) << 4)
            assert sn_rect.staged_offset(row, chunk) == want
            assert want // 128 == row


def test_kernel_accumulator_cells_cover_the_warpgroup_piece_once():
    cells = [sn_rect.accumulator_cell(thread, i)
             for thread in range(128) for i in range(sn_rect.TILE // 2)]
    assert sorted(cells) == [(r, c) for r in range(64)
                             for c in range(sn_rect.TILE)]


def test_wrapper_constants_match_the_kernel_source():
    """TILE, THREADS and K_SLICE are the constants of the block body that
    csrc/sn_rect.cu includes (csrc/sn_wgmma.cuh)."""
    csrc = os.path.join(os.path.dirname(_build.__file__), "..", "csrc")
    assert '#include "sn_wgmma.cuh"' in open(
        os.path.join(csrc, "sn_rect.cu")).read()
    hdr = open(os.path.join(csrc, "sn_wgmma.cuh")).read()
    for name, want in (("kTile", sn_rect.TILE),
                       ("kThreads", sn_rect.THREADS),
                       ("kSliceBytes", sn_rect.K_SLICE)):
        assert f"constexpr int {name} = {want};" in hdr


@pytest.mark.parametrize("A,B,K", [(3, 5, 7), (40, 24, 256), (17, 9, 131)])
def test_int_gram_is_exact(A, B, K):
    rng = np.random.default_rng(A * B * K)
    a = (rng.random((A, K)) < 0.5).astype(np.int8)
    b = (rng.random((B, K)) < 0.5).astype(np.int8)
    got = int_gram(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), a.astype(np.int32) @ b.astype(np.int32).T
    )


@pytest.mark.parametrize("out_dtype", [torch.int16, torch.int32])
def test_pair_counts_device_matches_jax(out_dtype):
    rng = np.random.default_rng(11)
    m = (rng.random((4, 30, 256)) < 0.3).astype(np.uint8)
    a, b = np.triu_indices(30, k=1)
    want = np.asarray(
        jax_pair_counts(jnp.asarray(m), jnp.asarray(a), jnp.asarray(b))
    )
    got = pair_counts_device(
        torch.from_numpy(m.view(np.int8)), a, b, out_dtype=out_dtype
    )
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no_nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_raises_with_nvcc_stderr(monkeypatch, tmp_path):
    """A failing compile raises with nvcc's own stderr and leaves no
    library behind."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    fake = bindir / "nvcc"
    fake.write_text("#!/bin/sh\necho 'sn_rect.cu(1): error: boom' >&2\nexit 2\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="(?s)exit 2.*error: boom"):
        _build.build()
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".so")]
