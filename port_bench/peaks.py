"""Peaks of the cards the benchmark runs on, and the count kernels' work.

``INT8_PEAK_MACS``: the dense int8 tensor-core rate in multiply-adds a
second, keyed by a substring of ``torch.cuda.get_device_name()``: NVIDIA's
H100 data sheet lists int8 TOPS with sparsity; halved for dense, halved
again for MACs.  ``HBM_BYTES_PER_S``: the data sheet's memory bandwidth.
Both assume the card's full power limit (700 W on the SXM part).
"""

from __future__ import annotations

import numpy as np

INT8_PEAK_MACS = {
    "H100 80GB HBM3": 989.5e12,  # SXM: 3,958 TOPS sparse, 1,979 dense
}

HBM_BYTES_PER_S = {
    "H100 80GB HBM3": 3.35e12,
}


def lookup(table: dict[str, float], device_name: str) -> float | None:
    for key, value in table.items():
        if key in device_name:
            return value
    return None


def count_macs(widths: np.ndarray, pairs: int) -> int:
    """Multiply-adds of the intersection counts of one call: every output
    pair contracts each protein's compacted width once (K_p before any
    padding), whatever kernel or route computes it."""
    return int(np.sum(np.asarray(widths, dtype=np.int64))) * int(pairs)


def count_bytes(widths: np.ndarray, n_genomes: int, pairs: int) -> int:
    """Bytes the counts of one call need to move at the least: the 0/1
    presence read once (one byte per genome and compacted column) and one
    f64 AJI written per output pair."""
    presence = int(np.sum(np.asarray(widths, dtype=np.int64))) * int(n_genomes)
    return presence + 8 * int(pairs)


def least_seconds(widths: np.ndarray, n_genomes: int, pairs: int,
                  device_name: str) -> float | None:
    """The least time the card could take for one call's counts: the
    larger of its MACs over the int8 peak and its bytes over the memory
    bandwidth.  None for a card without a listed peak."""
    macs = lookup(INT8_PEAK_MACS, device_name)
    bw = lookup(HBM_BYTES_PER_S, device_name)
    if macs is None or bw is None:
        return None
    return max(count_macs(widths, pairs) / macs,
               count_bytes(widths, n_genomes, pairs) / bw)
