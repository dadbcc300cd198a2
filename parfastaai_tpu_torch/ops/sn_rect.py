"""Rectangular fused (S, N) block: genome band A x genome band B.

Counterpart of parfastaai_tpu/ops/pallas_intersect.py ``pallas_fused_sn_block``
and the two TPU kernels behind it, ``_pallas_sn_rect`` and
``_pallas_sn_rect_kb``.  For each protein p, in ascending order:

    cnt = Ma_p . Mb_p^T                       (exact integer counts)
    S  += cnt / (ta_p[:, None] + tb_p[None, :] - cnt)
    N  += min(cnt, 1)

with T pre-clamped to >= 1 (``clamp_t``), which makes the transform need no
per-cell clamp: cnt == 0 cells divide 0 by at least 2.

``fused_sn_block`` launches the hand-written CUDA kernel (csrc/sn_rect.cu)
for CUDA tensors and runs ``fused_sn_block_plain`` for CPU tensors only; on
any other device it raises.  There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .fused import int_gram

# Kernel launches since the process started (or since a caller reset it).
LAUNCHES = 0

# K bytes the kernel stages per shared-memory slice (one 128-byte swizzled
# row per genome); K is zero-padded to a multiple (exact: zero columns add 0
# to every count).  Width buckets are already multiples of 128
# (etl.database.bucket_bounds), so the main path never pads.
K_SLICE = 128
_MODES = {(False, False): 0, (True, False): 1, (False, True): 2}
# The kernel's block: a TILE x TILE piece of the output, two warpgroups of
# 128 threads with 64 rows of it each, on a 1-D grid.
TILE = 128
THREADS = 256
_MAX_TILES = 2**31 - 1  # CUDA grid.x limit


# The kernel's index maps, as csrc/sn_rect.cu computes them (the tests hold
# them to covering every staged byte and every output cell exactly once).


def loader_chunks(tid: int) -> list[tuple[int, int]]:
    """(row, 16-byte chunk) pairs of one side's TILE staged rows that thread
    ``tid`` of a block copies per slice."""
    return [(tid // 8 + 32 * i, tid % 8) for i in range(TILE // 32)]


def staged_offset(row: int, chunk: int) -> int:
    """Byte offset in a staged tile of 16-byte chunk ``chunk`` of row
    ``row``: 128-byte rows in the 128-byte swizzle of wgmma's K-major
    shared-memory layout (chunk ^ row % 8 within the row)."""
    return row * K_SLICE + ((chunk ^ (row & 7)) << 4)


def accumulator_cell(thread: int, i: int) -> tuple[int, int]:
    """(row, column), in a warpgroup's 64 x TILE piece, of accumulator
    element ``i`` of ``thread`` (0..127) of the warpgroup."""
    warp, g, tig = thread // 32, thread % 32 // 4, thread % 4
    j, e = i // 4, i % 4
    return 16 * warp + g + 8 * (e // 2), 8 * j + 2 * tig + e % 2


def clamp_t(t: torch.Tensor) -> torch.Tensor:
    """T operand of the kernel: f32 (exact, counts < 2^24) and clamped to
    >= 1 (``_clamp_t`` semantics of the JAX package)."""
    return t.clamp_min(1).to(torch.float32)


def _as_int8(m: torch.Tensor) -> torch.Tensor:
    return m.view(torch.int8) if m.dtype == torch.uint8 else m


def fused_sn_block_plain(
    ma: torch.Tensor, mb: torch.Tensor, ta: torch.Tensor, tb: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version on any device: a loop over proteins with exact
    int8 Gram counts and the IEEE f32 transform in the kernel's op order
    (``outer = ta + tb``, ``denom = outer - cf``, ``j = cf / denom``,
    ``s += j``)."""
    P, A, _ = ma.shape
    B = mb.shape[1]
    a8, b8 = _as_int8(ma), _as_int8(mb)
    s = torch.zeros((A, B), dtype=torch.float32, device=ma.device)
    n = torch.zeros((A, B), dtype=torch.int32, device=ma.device)
    for p in range(P):
        cnt = int_gram(a8[p], b8[p])
        cf = cnt.to(torch.float32)
        outer = ta[p][:, None] + tb[p][None, :]
        denom = outer - cf
        s += cf / denom
        n += cnt.clamp(max=1)
    return s, n


def _check(ma, mb, ta, tb) -> None:
    if ma.dim() != 3 or mb.dim() != 3:
        raise ValueError("ma and mb must be (P, A, K) and (P, B, K)")
    P, A, K = ma.shape
    if mb.shape[0] != P or mb.shape[2] != K:
        raise ValueError(
            f"ma {tuple(ma.shape)} and mb {tuple(mb.shape)} differ in P or K"
        )
    if tuple(ta.shape) != (P, A) or tuple(tb.shape) != (P, mb.shape[1]):
        raise ValueError(
            f"ta {tuple(ta.shape)} / tb {tuple(tb.shape)} do not match "
            f"(P, A) = {(P, A)} / (P, B) = {(P, mb.shape[1])}"
        )
    for name, x in (("ma", ma), ("mb", mb)):
        if x.dtype not in (torch.uint8, torch.int8):
            raise TypeError(f"{name} must be uint8 or int8, got {x.dtype}")
    for name, x in (("ta", ta), ("tb", tb)):
        if x.dtype != torch.float32:
            raise TypeError(
                f"{name} must be float32 (see clamp_t), got {x.dtype}"
            )
    devs = {x.device for x in (ma, mb, ta, tb)}
    if len(devs) != 1:
        raise ValueError(f"operands lie on different devices: {devs}")
    for name, x in (("ma", ma), ("mb", mb), ("ta", ta), ("tb", tb)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_sn_block(
    ma: torch.Tensor,
    mb: torch.Tensor,
    ta: torch.Tensor,
    tb: torch.Tensor,
    approx: bool = False,
    precise: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(s f32 (A, B), n int32 (A, B)) for ma (P, A, K), mb (P, B, K) 0/1
    uint8/int8 and ta (P, A), tb (P, B) f32 from ``clamp_t``.

    CUDA tensors go to the kernel; ``approx`` selects the raw approximate
    reciprocal, ``precise`` the IEEE divide (bit-identical to the plain
    version), neither the Newton-refined reciprocal.  CPU tensors go to
    ``fused_sn_block_plain``, which always divides in IEEE f32."""
    global LAUNCHES
    if approx and precise:
        raise ValueError("approx and precise are mutually exclusive")
    _check(ma, mb, ta, tb)
    dev = ma.device
    if dev.type == "cpu":
        return fused_sn_block_plain(ma, mb, ta, tb)
    if dev.type != "cuda":
        raise ValueError(f"fused_sn_block runs on cuda or cpu, not {dev}")
    P, A, K = ma.shape
    B = mb.shape[1]
    if K % K_SLICE:
        pad = K_SLICE - K % K_SLICE
        ma = F.pad(ma, (0, pad))
        mb = F.pad(mb, (0, pad))
        K += pad
    for name, x in (("ma", ma), ("mb", mb)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if A == 0 or B == 0 or P == 0 or K == 0:
        return (torch.zeros((A, B), dtype=torch.float32, device=dev),
                torch.zeros((A, B), dtype=torch.int32, device=dev))
    if -(-A // TILE) * -(-B // TILE) > _MAX_TILES:
        raise ValueError(f"A={A} x B={B} exceeds the kernel's grid limit")
    s = torch.empty((A, B), dtype=torch.float32, device=dev)
    n = torch.empty((A, B), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sn_rect_launch(
            ma.data_ptr(), mb.data_ptr(), ta.data_ptr(), tb.data_ptr(),
            s.data_ptr(), n.data_ptr(), P, A, B, K,
            _MODES[(approx, precise)], stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"sn_rect kernel launch failed: "
            f"{lib.sn_rect_error_string(rc).decode()} (cudaError {rc})"
        )
    LAUNCHES += 1
    return s, n
