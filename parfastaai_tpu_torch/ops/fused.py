"""Exact intersection counts on the device: the int8 presence Gram.

Counterpart of parfastaai_tpu/ops/fused.py.  The Gram is a plain matrix
product outside any hand-written kernel, as the JAX package leaves it to
XLA, so it goes to ``torch._int_mm`` (int8 x int8 -> int32, exact on CUDA
and on the CPU).  The XLA-scan ``fused_sn_block`` of that module has its
counterpart in ``ops.sn_rect.fused_sn_block_plain``; ``fused_sn`` and
``fused_aji`` are the plain whole-matrix versions that the kernels of
``ops.sn_square`` are checked against.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def int_gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact counts ``a @ b.T`` of two 0/1 int8 matrices (A, K) and (B, K),
    as an (A, B) int32 tensor.

    ``torch._int_mm`` on CUDA wants more than 16 rows and K, B multiples of
    8; the operands are zero-padded to that (zero rows and columns add 0 to
    every count) and the result is sliced back."""
    A, K = a.shape
    B = b.shape[0]
    ap, kp, bp = max(24, _round_up(A, 8)), _round_up(K, 8), _round_up(B, 8)
    if (ap, kp) != (A, K):
        a = F.pad(a, (0, kp - K, 0, ap - A))
    if (bp, kp) != (B, K):
        b = F.pad(b, (0, kp - K, 0, bp - B))
    return torch._int_mm(a, b.t())[:A, :B]


def fused_sn(m: torch.Tensor, t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Full G x G fused (S, N) of a (P, G, K) 0/1 uint8/int8 presence tensor
    and its (P, G) integer rowsums T, on the tensors' device.

    Per protein, in ascending order: ``cnt = M_p . M_p^T``,
    ``S += cnt / max(t_a + t_b - cnt, 1)`` in f32 and ``N += cnt > 0``: the
    clamped-denominator transform of the JAX package's ``fused_sn``.
    Returns (s f32 (G, G), n int32 (G, G))."""
    P, G, _ = m.shape
    m8 = m.view(torch.int8) if m.dtype == torch.uint8 else m
    t32 = t.to(torch.int32)
    s = torch.zeros((G, G), dtype=torch.float32, device=m.device)
    n = torch.zeros((G, G), dtype=torch.int32, device=m.device)
    for p in range(P):
        cnt = int_gram(m8[p], m8[p])
        denom = (t32[p][:, None] + t32[p][None, :] - cnt).clamp_min(1)
        s += cnt.to(torch.float32) / denom.to(torch.float32)
        n += (cnt > 0).to(torch.int32)
    return s, n


def fused_aji(
    m: torch.Tensor, t: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(aji f32, s f32, n int32), each (G, G): ``fused_sn`` and
    ``aji = s / n``, NaN where N == 0.  The diagonal is each genome's
    self-AJI (1.0 where it has any tetramer); callers mask as needed."""
    s, n = fused_sn(m, t)
    return s / n.to(torch.float32), s, n


def pair_counts_device(
    m: torch.Tensor,
    db_a: np.ndarray,
    db_b: np.ndarray,
    out_dtype: torch.dtype = torch.int32,
) -> torch.Tensor:
    """Exact counts for an explicit pair list, gathered on the device.

    ``m`` is the (P, G, K) int8 presence tensor on the device.  Returns
    (P, n_pairs) in ``out_dtype`` on the same device: per protein, the
    G x G Gram and a gather of the requested (a, b) entries (int64 flat
    index a * G + b)."""
    P, G, _ = m.shape
    flat = torch.from_numpy(
        np.asarray(db_a, np.int64) * G + np.asarray(db_b, np.int64)
    ).to(m.device)
    out = torch.empty((P, flat.numel()), dtype=out_dtype, device=m.device)
    for p in range(P):
        cnt = int_gram(m[p], m[p]).reshape(-1)
        out[p] = cnt.index_select(0, flat).to(out_dtype)
    return out
