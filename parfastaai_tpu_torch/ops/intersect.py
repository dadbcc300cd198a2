"""Intersection counts of explicit genome pairs: the public count ops.

Counterpart of parfastaai_tpu/ops/intersect.py.  With ``M_p`` the {0,1}
genome x tetramer presence matrix of protein p, the counts are the batched
Gram ``cnt_p = M_p @ M_p.T``, an int8 x int8 -> int32 product that is exact
on any device.  As the JAX package leaves this product to XLA outside any
Pallas kernel, it goes to the library int8 product here
(``ops.fused.int_gram``).

Both functions run on ``device`` (default ``"cuda"``; ``"cpu"`` when asked
for) and return host arrays.  Without CUDA the default device raises
PFAAIError, as ``device.resolve_device`` does: nothing moves to the CPU by
itself.  Inputs use the ETL's compacted tetramer axis; zero padding columns
add nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused import int_gram

# The JAX package's DEFAULT_TILE (parfastaai_tpu/constants.py): distinct
# A-side genomes per Gram tile of ``pair_counts``.
DEFAULT_TILE = 128


def _int8_on(m, device: str) -> torch.Tensor:
    """``m`` as an int8 tensor on the named device (resolved here: device.py
    imports the mesh, which imports this package)."""
    from ..device import resolve_device

    t = torch.as_tensor(np.asarray(m)) if not isinstance(m, torch.Tensor) else m
    if t.dtype == torch.uint8:
        t = t.view(torch.int8)
    return t.to(device=resolve_device(device), dtype=torch.int8)


def intersection_counts(m, device: str = "cuda") -> np.ndarray:
    """The full (P, G, G) int32 intersection-count tensor of a (P, G, K)
    0/1 presence tensor, on the host.

    For test-scale problems: the engines never hold G x G per protein."""
    md = _int8_on(m, device)
    P, G, _ = md.shape
    out = np.empty((P, G, G), dtype=np.int32)
    for p in range(P):
        out[p] = int_gram(md[p], md[p]).cpu().numpy()
    return out


def pair_counts(
    m,
    db_a: np.ndarray,
    db_b: np.ndarray,
    tile: int = DEFAULT_TILE,
    device: str = "cuda",
) -> np.ndarray:
    """Intersection counts for an explicit pair list -> int32 (P, n_pairs).

    Tiled over the distinct A-side genomes: each tile of at most ``tile``
    of them is multiplied against every genome on the device, and the
    needed (a, b) entries are gathered on the host.  Device memory stays at
    O(P * tile * G) instead of O(P * G^2)."""
    md = _int8_on(m, device)
    P = md.shape[0]
    db_a = np.asarray(db_a)
    db_b = np.asarray(db_b)
    out = np.empty((P, db_a.shape[0]), dtype=np.int32)
    uniq_a = np.unique(db_a)
    for start in range(0, len(uniq_a), tile):
        rows = uniq_a[start : start + tile]
        ridx = torch.from_numpy(rows.astype(np.int64)).to(md.device)
        counts = torch.stack(
            [int_gram(md[p].index_select(0, ridx), md[p]) for p in range(P)]
        ).cpu().numpy()  # (P, |rows|, G)
        sel = np.isin(db_a, rows)
        local = np.searchsorted(rows, db_a[sel])
        out[:, sel] = counts[:, local, db_b[sel]]
    return out
