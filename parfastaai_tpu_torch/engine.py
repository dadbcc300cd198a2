"""The AJI compute engine on PyTorch.

Counterpart of parfastaai_tpu/engine.py for the paths this package covers:

* ``compute`` (exact, CLI default): integer intersection counts from the
  int8 Gram on the device (ops.fused.pair_counts_device), downloaded as
  int16 when they fit, finished on the host in f64 in ascending protein
  order (the native finish the JAX package uses), so the CSV is
  byte-identical to the JAX package's.
* ``compute_fast`` (``--fast``): the fused f32 pipeline.  Width buckets of
  the presence tensor live on the device (``to_device_buckets``); output
  blocks of band x col_chunk genome pairs run through the hand-written
  rectangular kernel (ops.sn_rect) and are assembled on the host.

Every function computes on the device it is given.  ``phases``, where
accepted, is a dict that collects wall seconds per sub-phase; the device
is synchronised at each phase boundary, which the block loop's host copies
do anyway.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .etl.database import PresenceData, bucket_bounds, bucketize_presence
from .modes import PairSpace
from .native import native_jaccard_finish
from .ops.fused import pair_counts_device
from .ops.sn_rect import clamp_t, fused_sn_block
from .types import ErrorCode, JacResult, PFAAIError


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _add(phases: dict | None, key: str, seconds: float) -> None:
    if phases is not None:
        phases[key] = phases.get(key, 0.0) + seconds


def jaccard_finish(
    counts: np.ndarray,  # integer (P, n_pairs)
    denom_ta: np.ndarray,  # int (P, n_pairs) — T[p, denom_a]
    denom_tb: np.ndarray,  # int (P, n_pairs) — T[p, denom_b]
) -> tuple[np.ndarray, np.ndarray]:
    """Sequential ascending-protein f64 accumulation of (S, N) per pair:
    the native kernel when it loads, else the NumPy loop with the same
    operation order (parfastaai_tpu.engine.jaccard_finish)."""
    res = native_jaccard_finish(counts, denom_ta, denom_tb)
    if res is not None:
        return res
    P, n = counts.shape
    s = np.zeros(n, dtype=np.float64)
    nacc = np.zeros(n, dtype=np.int32)
    for p in range(P):
        c = counts[p]
        mask = c > 0
        if not mask.any():
            continue
        cm = c[mask].astype(np.float64)
        dm = (denom_ta[p][mask] + denom_tb[p][mask] - c[mask]).astype(
            np.float64
        )
        s[mask] += cm / dm
        nacc += mask
    return s, nacc


def _count_wire_dtype(presence: PresenceData) -> torch.dtype:
    """Narrowest dtype that carries every count to the host (counts are
    bounded by max(T))."""
    return torch.int16 if int(presence.t.max()) < 2**15 else torch.int32


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array to ``device``; to a card through page-locked memory, so
    the copy is one DMA at the bus's rate."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def upload_presence(
    presence: PresenceData, device: torch.device, phases: dict | None = None
) -> torch.Tensor:
    """The whole (P, G, K) presence tensor on the device as int8, by a plain
    copy (the JAX package's bit packing served a slow relay)."""
    t0 = time.perf_counter()
    m = _to_device(presence.m.view(np.int8), device)
    _sync(device)
    _add(phases, "H2D", time.perf_counter() - t0)
    return m


def to_device_buckets(
    presence: PresenceData, device: torch.device, phases: dict | None = None
) -> list[tuple[np.ndarray, torch.Tensor, torch.Tensor]]:
    """Width buckets of ``presence`` on ``device``: [(protein_idx, m_b, t_b)]
    with m_b the (Pb, G, Kb) uint8 presence slice and t_b the (Pb, G) f32 T
    clamped to >= 1 (``clamp_t``), in ``bucketize_presence`` order.  Cached
    on the presence object per device, so repeated calls copy nothing."""
    cache = getattr(presence, "_torch_bucket_cache", None)
    if cache is None:
        cache = {}
        presence._torch_bucket_cache = cache
    key = str(device)
    if key not in cache:
        t0 = time.perf_counter()
        host = bucketize_presence(presence)
        t1 = time.perf_counter()
        cache[key] = [
            (
                idx,
                _to_device(np.ascontiguousarray(m_b), device),
                clamp_t(_to_device(t_b, device)),
            )
            for idx, m_b, t_b in host
        ]
        _sync(device)
        _add(phases, "host bucketize", t1 - t0)
        _add(phases, "H2D", time.perf_counter() - t1)
    return cache[key]


def presence_device_bytes(presence: PresenceData) -> int:
    """Device bytes of the width-bucketed presence (sum of Pb * G * Kb)."""
    _, bounds = bucket_bounds(presence.widths)
    g = presence.m.shape[1]
    return sum((i - k) * g * kb for k, i, kb in bounds)


def _device_budget(device: torch.device) -> int | None:
    """Device-memory budget for the presence buckets: PARFASTAAI_HBM_BYTES,
    else 75% of the card's memory; None on the CPU."""
    env = os.environ.get("PARFASTAAI_HBM_BYTES")
    if env:
        return int(float(env))
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory * 0.75)
    return None


def _bucket_block_engine(
    presence: PresenceData,
    approx: bool,
    precise: bool,
    device: torch.device,
    phases: dict | None = None,
):
    """``block_sn(rids, cids, drids, dcids) -> (s, n)`` device tensors for
    one output block, summed over the width buckets in bucket order.  The
    index arguments are int64 host arrays: genome ids of the rows and
    columns and the T columns of their denominators.  Raises
    PFAAIError(CONSTRUCT_ERROR) when the buckets exceed the device budget
    and so need the staged slab engine, which this package does not run
    yet."""
    budget = _device_budget(device)
    if budget is not None and presence_device_bytes(presence) > budget:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            f"the width-bucketed presence ({presence_device_bytes(presence)} "
            f"bytes) exceeds the device budget ({budget} bytes) and needs "
            "the staged slab engine, which the PyTorch port does not run "
            "yet (PARFASTAAI_HBM_BYTES sets the budget)",
        )
    buckets = to_device_buckets(presence, device, phases)
    everyone = np.arange(presence.m.shape[1], dtype=np.int64)

    def selector(ids: np.ndarray) -> torch.Tensor | None:
        """None when ``ids`` is every genome in order (no gather needed),
        else the ids on the device."""
        if np.array_equal(ids, everyone):
            return None
        return torch.from_numpy(ids).to(device)

    def take(x: torch.Tensor, sel: torch.Tensor | None) -> torch.Tensor:
        return x if sel is None else x.index_select(1, sel)

    def block_sn(rids, cids, drids, dcids):
        t0 = time.perf_counter()
        rsel, csel, drsel, dcsel = map(selector, (rids, cids, drids, dcids))
        _add(phases, "gather", time.perf_counter() - t0)
        s = n = None
        for _, md, td in buckets:
            t0 = time.perf_counter()
            ma, mb = take(md, rsel), take(md, csel)
            ta, tb = take(td, drsel), take(td, dcsel)
            _sync(device)
            t1 = time.perf_counter()
            s_b, n_b = fused_sn_block(
                ma, mb, ta, tb, approx=approx, precise=precise
            )
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
            _sync(device)
            _add(phases, "gather", t1 - t0)
            _add(phases, "kernel", time.perf_counter() - t1)
        return s, n

    return block_sn


def _banded_sn(
    presence: PresenceData,
    row_ids: np.ndarray,
    col_ids: np.ndarray,
    row_denom_ids: np.ndarray,
    col_denom_ids: np.ndarray,
    device: torch.device,
    approx: bool = False,
    precise: bool = False,
    band: int = 1024,
    col_chunk: int = 4096,
    phases: dict | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full (len(row_ids), len(col_ids)) S/N matrices on the host, computed
    in band x col_chunk device blocks.

    Short last bands and chunks are padded with genome 0 and sliced off.
    Symmetric problems (rows == cols with the same denominators) skip the
    blocks wholly below the diagonal and fill them from the transpose:
    counts and the denominator sums are symmetric, so each cell is the
    same f32 value."""
    row_ids = np.asarray(row_ids, np.int64)
    col_ids = np.asarray(col_ids, np.int64)
    row_denom_ids = np.asarray(row_denom_ids, np.int64)
    col_denom_ids = np.asarray(col_denom_ids, np.int64)
    s = np.zeros((len(row_ids), len(col_ids)), dtype=np.float32)
    n = np.zeros((len(row_ids), len(col_ids)), dtype=np.int32)
    if len(row_ids) == 0 or len(col_ids) == 0:
        return s, n
    block_sn = _bucket_block_engine(presence, approx, precise, device, phases)
    band = min(band, len(row_ids))
    col_chunk = min(col_chunk, len(col_ids))
    symmetric = (
        len(row_ids) == len(col_ids)
        and np.array_equal(row_ids, col_ids)
        and np.array_equal(row_denom_ids, col_denom_ids)
    )

    def padded(ids: np.ndarray, start: int, width: int) -> np.ndarray:
        part = ids[start : start + width]
        return np.pad(part, (0, width - len(part)))

    for r0 in range(0, len(row_ids), band):
        nr = min(band, len(row_ids) - r0)
        rids = padded(row_ids, r0, band)
        drids = padded(row_denom_ids, r0, band)
        for c0 in range(0, len(col_ids), col_chunk):
            if symmetric and c0 + col_chunk <= r0:
                continue  # wholly below the diagonal: transpose fill
            nc = min(col_chunk, len(col_ids) - c0)
            s_b, n_b = block_sn(
                rids,
                padded(col_ids, c0, col_chunk),
                drids,
                padded(col_denom_ids, c0, col_chunk),
            )
            t0 = time.perf_counter()
            s[r0 : r0 + nr, c0 : c0 + nc] = s_b[:nr, :nc].cpu().numpy()
            n[r0 : r0 + nr, c0 : c0 + nc] = n_b[:nr, :nc].cpu().numpy()
            _add(phases, "D2H", time.perf_counter() - t0)
    if symmetric:
        t0 = time.perf_counter()
        for r0 in range(0, len(row_ids), band):
            r1 = min(r0 + band, len(row_ids))
            s[r0:r1, :r0] = s[:r0, r0:r1].T
            n[r0:r1, :r0] = n[:r0, r0:r1].T
        _add(phases, "host assembly", time.perf_counter() - t0)
    return s, n


def _is_rect_pairs(pairs: PairSpace) -> bool:
    """True when the pair slots are the full row-major rows x cols product of
    the CSV axes (the two-database layout) with per-axis denominators."""
    nr, nc = len(pairs.row_db_ids), len(pairs.col_db_ids)
    if pairs.n_pairs != nr * nc or pairs.n_pairs == 0:
        return False
    return (
        np.array_equal(pairs.db_a, np.repeat(pairs.row_db_ids, nc))
        and np.array_equal(pairs.db_b, np.tile(pairs.col_db_ids, nr))
        and np.array_equal(pairs.denom_a, np.repeat(pairs.row_denom_ids, nc))
        and np.array_equal(pairs.denom_b, np.tile(pairs.col_denom_ids, nr))
    )


def _result(pairs: PairSpace, s: np.ndarray, n: np.ndarray) -> JacResult:
    return JacResult(
        genome_a=pairs.jac_a.astype(np.int32),
        genome_b=pairs.jac_b.astype(np.int32),
        s=np.asarray(s, dtype=np.float64),
        n=np.asarray(n, dtype=np.int32),
    )


def compute(
    presence: PresenceData,
    pairs: PairSpace,
    device: torch.device,
    phases: dict | None = None,
) -> JacResult:
    """Exact path: integer counts on the device, f64 finish on the host
    (bit-parity with the reference and the JAX package)."""
    out_dtype = _count_wire_dtype(presence)
    m = upload_presence(presence, device, phases)
    t0 = time.perf_counter()
    counts_d = pair_counts_device(m, pairs.db_a, pairs.db_b, out_dtype)
    _sync(device)
    t1 = time.perf_counter()
    counts = counts_d.cpu().numpy()
    t2 = time.perf_counter()
    del m, counts_d
    t = presence.t
    s, n = jaccard_finish(counts, t[:, pairs.denom_a], t[:, pairs.denom_b])
    _add(phases, "Gram", t1 - t0)
    _add(phases, "D2H", t2 - t1)
    _add(phases, "host finish", time.perf_counter() - t2)
    return _result(pairs, s, n)


def compute_fast(
    presence: PresenceData,
    pairs: PairSpace,
    device: torch.device,
    approx: bool = False,
    precise: bool = False,
    phases: dict | None = None,
) -> JacResult:
    """Fused f32 path through the rectangular kernel.

    ``approx`` / ``precise`` select the kernel's divide (raw approximate
    reciprocal / IEEE divide; default the Newton-refined reciprocal).

    All-vs-all runs the symmetric G x G band walk; query-subset runs the
    |Q| x G rectangle, which covers both of its slot parts; two-database
    mode runs the |Q| x |T| rectangle with the denominators gathered
    through PairSpace.row_denom_ids / col_denom_ids.  Any other pair space
    takes exact counts and the f64 finish."""
    G = presence.m.shape[1]
    fast = dict(approx=approx, precise=precise, phases=phases)
    if np.array_equal(pairs.denom_a, pairs.db_a) and np.array_equal(
        pairs.denom_b, pairs.db_b
    ):
        rows = np.asarray(pairs.row_db_ids, np.int32)
        qsub_rect = (
            0 < len(rows) < G
            and np.array_equal(pairs.col_db_ids, np.arange(G, dtype=np.int32))
            and bool(np.isin(pairs.db_a, rows).all())
        )
        if qsub_rect:
            qidx_of = np.full(G, -1, np.int32)
            qidx_of[rows] = np.arange(len(rows), dtype=np.int32)
            cols = np.arange(G, dtype=np.int32)
            s_mat, n_mat = _banded_sn(
                presence, rows, cols, rows, cols, device, **fast
            )
            t0 = time.perf_counter()
            s = s_mat[qidx_of[pairs.db_a], pairs.db_b]
            n = n_mat[qidx_of[pairs.db_a], pairs.db_b]
            _add(phases, "pair gather", time.perf_counter() - t0)
        else:
            ids = np.arange(G, dtype=np.int32)
            s_mat, n_mat = _banded_sn(
                presence, ids, ids, ids, ids, device, **fast
            )
            t0 = time.perf_counter()
            s = s_mat[pairs.db_a, pairs.db_b]
            n = n_mat[pairs.db_a, pairs.db_b]
            _add(phases, "pair gather", time.perf_counter() - t0)
    elif _is_rect_pairs(pairs):
        s_mat, n_mat = _banded_sn(
            presence,
            pairs.row_db_ids,
            pairs.col_db_ids,
            pairs.row_denom_ids,
            pairs.col_denom_ids,
            device,
            **fast,
        )
        # Pair slots are row-major rows x cols: a flatten matches.
        s = s_mat.reshape(-1)
        n = n_mat.reshape(-1)
    else:
        return compute(presence, pairs, device, phases)
    return _result(pairs, s, n)
