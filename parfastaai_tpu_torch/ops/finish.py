"""The dense exact engine's f64 finish of a pair list, on the device that
holds its counts.

For each pair i, over the proteins p in ascending order:

    c  = counts[p, i]
    S += c / (t[p, denom_a[i]] + t[p, denom_b[i]] - c)   where c > 0  (f64)
    N += 1                                               where c > 0

the arithmetic and order of ``engine.jaccard_finish`` (the native
``jaccard_finish_f64`` and its NumPy loop), so S and N are bit-equal to it.

Replaces no TPU kernel: the JAX package finishes on the host.
``finish_pairs`` launches the hand-written CUDA kernel (csrc/finish_f64.cu)
for CUDA tensors, so that the counts of ``fused.pair_counts_device`` are
never downloaded, and runs ``finish_pairs_plain`` for CPU tensors only; on
any other device it raises.  There is no fallback from the kernel to the
plain version.
"""

from __future__ import annotations

import torch

from . import _build

# Kernel launches since the process started (or since a caller reset it).
LAUNCHES = 0

COUNT_DTYPES = (torch.int16, torch.int32)


def finish_pairs_plain(
    counts: torch.Tensor, t: torch.Tensor, denom_a: torch.Tensor,
    denom_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version on any device: a loop over proteins in
    ascending order, the denominator in int64, f64 divide and add."""
    P, n = counts.shape
    s = torch.zeros(n, dtype=torch.float64, device=counts.device)
    nshared = torch.zeros(n, dtype=torch.int32, device=counts.device)
    for p in range(P):
        c = counts[p].to(torch.int64)
        shared = c > 0
        denom = (t[p].index_select(0, denom_a).to(torch.int64)
                 + t[p].index_select(0, denom_b) - c)
        s = torch.where(shared, s + c.double() / denom.double(), s)
        nshared += shared
    return s, nshared


def _check(counts, t, denom_a, denom_b) -> None:
    if counts.dim() != 2 or t.dim() != 2:
        raise ValueError("counts and t must be (P, n) and (P, G_t)")
    P, n = counts.shape
    if t.shape[0] != P:
        raise ValueError(
            f"t {tuple(t.shape)} and counts {tuple(counts.shape)} differ in P"
        )
    for name, x in (("denom_a", denom_a), ("denom_b", denom_b)):
        if tuple(x.shape) != (n,):
            raise ValueError(
                f"{name} {tuple(x.shape)} does not match n_pairs = {n}"
            )
    if counts.dtype not in COUNT_DTYPES:
        raise TypeError(f"counts must be int16 or int32, got {counts.dtype}")
    for name, x in (("t", t), ("denom_a", denom_a), ("denom_b", denom_b)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
    devs = {x.device for x in (counts, t, denom_a, denom_b)}
    if len(devs) != 1:
        raise ValueError(f"operands lie on different devices: {devs}")
    for name, x in (("counts", counts), ("t", t), ("denom_a", denom_a),
                    ("denom_b", denom_b)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def finish_pairs(
    counts: torch.Tensor, t: torch.Tensor, denom_a: torch.Tensor,
    denom_b: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(s f64 (n,), n int32 (n,)) for counts (P, n) int16 or int32, t
    (P, G_t) int32 and denom_a, denom_b (n,) int32 column ids of t, all on
    one device.  CUDA tensors go to the kernel on the current stream, CPU
    tensors to ``finish_pairs_plain``."""
    global LAUNCHES
    _check(counts, t, denom_a, denom_b)
    dev = counts.device
    if dev.type == "cpu":
        return finish_pairs_plain(counts, t, denom_a, denom_b)
    if dev.type != "cuda":
        raise ValueError(f"finish_pairs runs on cuda or cpu, not {dev}")
    P, n = counts.shape
    s = torch.empty(n, dtype=torch.float64, device=dev)
    nshared = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return s, nshared
    lib = _build.load_finish()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.finish_f64_launch(
            counts.data_ptr(), counts.element_size(), t.data_ptr(),
            denom_a.data_ptr(), denom_b.data_ptr(), P, n, t.shape[1],
            s.data_ptr(), nshared.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"finish_f64 kernel launch failed: "
            f"{lib.finish_f64_error_string(rc).decode()} (cudaError {rc})"
        )
    LAUNCHES += 1
    return s, nshared
