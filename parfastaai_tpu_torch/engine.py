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
* ``compute_streamed_exact`` (``--streamed --exact``, and the default call
  above the host budget): the banded exact engine.  Integer count blocks
  of band x col_chunk genome pairs from the same resident width buckets
  (``_bucket_count_engine``), copied to page-locked host memory on a side
  stream while a worker thread finishes earlier blocks in f64 and appends
  whole bands to the CSV; the bytes of ``compute`` + ``write_aji_csv`` in
  memory that does not grow with the genome count.
* ``compute_streamed`` (``--streamed``): the f32 streamed engine.  Masked
  AJI blocks of band x col_chunk genome pairs from the rectangular kernel
  (``_bucket_block_engine`` + ``_mask_aji``), copied to page-locked host
  memory on a side stream while a writer thread assembles earlier bands
  and appends them to the CSV; memory that does not grow with the square
  of the genome count.
* ``compute_sharded`` (``--mesh``, the API's ``engine="sharded"``): the
  fused f32 path over a (rows, scp) mesh of ranks, one device each
  (parallel/mesh.py): each rank runs the rectangular kernel on its row
  band and protein shard of the whole presence tensor; the shards' sums
  meet in an all-reduce, the bands in a gather on every rank.
* ``compute_streamed`` and ``compute_streamed_exact`` with ``mesh``
  (``--streamed [--exact] --mesh``): each block cut into the mesh's cells,
  one rank each (``_mesh_block_engine``, ``_mesh_count_engine``), the
  cells gathered to process 0, which alone writes the CSV.

Above the device budget (``_use_staged``: PARFASTAAI_HBM_BYTES, else 75% of
the card's memory), or where ``staged`` / PARFASTAAI_STAGED asks for it,
the banded engines take their blocks from staged slabs instead of resident
buckets: an LRU of (proteins x genomes x K) slabs on the device
(``_slab_store``), gathered on the host and uploaded on demand
(``_staged_block_engine``, ``_staged_count_engine``); over a mesh, each
rank's shard of each slab (``_MeshSlabStore``, ``_use_staged_mesh``,
``_staged_mesh_block_engine``, ``_staged_mesh_count_engine``), shipped
from process 0 where only it holds the presence tensor.

Every function computes on the device it is given.  ``phases``, where
accepted, is a dict that collects seconds per sub-phase.  ``compute`` and
``compute_fast`` synchronise the device at each phase boundary, which
their host copies do anyway; the two banded CSV engines never do, and read
their device phases from CUDA events after the last block.
"""

from __future__ import annotations

import itertools
import os
import queue
import sys
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .etl.database import PresenceData, bucket_bounds, bucketize_presence
from .io.csv_writer import format_matrix
from .modes import PairSpace
from .native import native_jaccard_finish, native_jaccard_finish_block
from .ops.fused import int_gram, pair_counts_device
from .ops.sn_rect import clamp_t, fused_sn_block
from .types import ErrorCode, JacResult, PFAAIError


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _add(phases: dict | None, key: str, seconds: float) -> None:
    if phases is not None:
        phases[key] = phases.get(key, 0.0) + seconds


class _StageClock:
    """Seconds per named stage of the work one thread enqueues on a device.

    ``sync=True``: each lap synchronises the device and reads the host's
    clock, and ``phases`` fills as the work goes (``compute_fast``'s
    split).  ``sync=False``: nothing waits.  On a card each lap records a
    CUDA event on the current stream and ``close`` sums the event pairs
    into ``phases`` once the work is done; on the CPU, where each call
    returns with its work done, a lap reads the host's clock."""

    def __init__(self, device: torch.device, phases: dict | None, sync: bool):
        self._device, self._phases, self._sync = device, phases, sync
        self._events = device.type == "cuda" and not sync
        self._pairs: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._last = None

    def _now(self):
        if self._events:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        if self._sync:
            _sync(self._device)
        return time.perf_counter()

    def start(self) -> None:
        self._last = self._now()

    def lap(self, key: str) -> None:
        """Ends the stage ``key`` that began at ``start`` or the last lap."""
        now = self._now()
        if self._events:
            self._pairs.append((key, self._last, now))
        else:
            _add(self._phases, key, now - self._last)
        self._last = now

    def close(self) -> None:
        """Sums the event pairs; every recorded event must have fired."""
        for key, begin, end in self._pairs:
            _add(self._phases, key, begin.elapsed_time(end) / 1e3)
        self._pairs.clear()


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


def jaccard_finish_block(
    counts: np.ndarray,  # integer (P, A, B)
    ta: np.ndarray,  # int (P, A) — T[p, row_denom_ids]
    tb: np.ndarray,  # int (P, B) — T[p, col_denom_ids]
) -> tuple[np.ndarray, np.ndarray]:
    """Block twin of ``jaccard_finish``: (S, N) of an (A, B) output block
    with the denominator columns given per axis, so no (P, A * B) gather
    exists.  The same ascending-protein f64 accumulation per cell, so
    bit-for-bit the per-pair finish (parfastaai_tpu.engine
    .jaccard_finish_block)."""
    res = native_jaccard_finish_block(counts, ta, tb)
    if res is not None:
        return res
    P, A, B = counts.shape
    s = np.zeros((A, B), dtype=np.float64)
    n = np.zeros((A, B), dtype=np.int32)
    ta64 = ta.astype(np.float64)
    tb64 = tb.astype(np.float64)
    for p in range(P):
        mask = counts[p] > 0
        if not mask.any():
            continue
        c = counts[p].astype(np.float64)
        denom = ta64[p][:, None] + tb64[p][None, :] - c
        with np.errstate(divide="ignore", invalid="ignore"):
            s += np.where(mask, c / denom, 0.0)
        n += mask
    return s, n


def _resume_point(out_path: str, header: str, band: int) -> int:
    """Rows already complete in a partial banded CSV, rounded down to a
    band boundary; truncates the file to exactly those rows.  Returns 0 (and
    leaves rewriting to the caller) when the file is absent or its header
    does not match this run's column set."""
    if not os.path.exists(out_path):
        return 0
    rows = 0
    keep_bytes = 0
    with open(out_path, "rb") as fp:
        first = fp.readline()
        if not first.endswith(b"\n") or first.decode() != header:
            return 0
        offset = len(first)
        for line in fp:
            if not line.endswith(b"\n"):
                break  # trailing partial write of the interrupted run
            offset += len(line)
            rows += 1
            if rows % band == 0:
                keep_bytes = offset  # only band-aligned prefixes resume
    rows -= rows % band
    if rows == 0:
        return 0
    with open(out_path, "r+b") as fp:
        fp.truncate(keep_bytes)
    return rows


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


def staged_override(staged: bool | None) -> bool | None:
    """The reference's tri-state resolution of staged slabs
    (``_staged_override``): an explicit ``staged`` wins; else
    PARFASTAAI_STAGED, where "0", "false", "no" (any case) ask for a
    resident run and any other non-empty value for staging; else None
    (decide from the device budget)."""
    if staged is not None:
        return staged
    env = os.environ.get("PARFASTAAI_STAGED")
    if env:
        return env.lower() not in ("0", "false", "no")
    return None


def _device_budget(device: torch.device) -> int | None:
    """Device-memory budget for the presence buckets: PARFASTAAI_HBM_BYTES,
    else 75% of the card's memory; None on the CPU."""
    env = os.environ.get("PARFASTAAI_HBM_BYTES")
    if env:
        return int(float(env))
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory * 0.75)
    return None


def _use_staged(
    presence: PresenceData, device: torch.device, staged: bool | None = None
) -> bool:
    """Staged slabs or resident buckets (parfastaai_tpu.engine._use_staged):
    ``staged`` or PARFASTAAI_STAGED when either decides
    (``staged_override``), else staged exactly when the width-bucketed
    presence exceeds the device budget.  The CPU reports no budget, so a
    CPU run stages only when asked or under PARFASTAAI_HBM_BYTES."""
    override = staged_override(staged)
    if override is not None:
        return override
    budget = _device_budget(device)
    return budget is not None and presence_device_bytes(presence) > budget


def _slab_target_bytes(device: torch.device) -> int:
    """Upper bound on one staged slab's bytes: PARFASTAAI_SLAB_BYTES, else
    a sixth of the device budget within [256 MiB, 2 GiB], 2 GiB without a
    budget (parfastaai_tpu.engine._slab_target_bytes).  A block's row and
    column slab sets then fit the store's cap together with the slabs of
    the block before, which the card may still be reading."""
    env = os.environ.get("PARFASTAAI_SLAB_BYTES")
    if env:
        return int(float(env))
    budget = _device_budget(device)
    if budget is None:
        return 2 << 30
    return min(2 << 30, max(256 << 20, budget // 6))


def _split_plan(plan, n_ids: int, device: torch.device,
                target: int | None = None):
    """Each width bucket's proteins cut into chunks whose slab of ``n_ids``
    genomes stays under ``target`` bytes (default ``_slab_target_bytes``):
    yields (bucket_i, p_chunk_i, protein_idx, kb) in bucket order, chunks in
    protein order (parfastaai_tpu.engine._split_plan).  The chunk length is
    a floor, so no chunk of ``np.array_split`` overshoots the target."""
    if target is None:
        target = _slab_target_bytes(device)
    for bi, (idx, kb) in enumerate(plan):
        chunk_len = max(1, target // max(1, n_ids * kb))
        n_pc = max(1, -(-len(idx) // chunk_len))
        for pci, idx_c in enumerate(np.array_split(idx, n_pc)):
            if len(idx_c):
                yield bi, pci, idx_c, kb


def _bucket_plan(presence: PresenceData) -> list[tuple[np.ndarray, int]]:
    """[(protein_idx, kb)] of the width buckets, in bucket order, without
    copying any presence (``etl.database.bucket_bounds``)."""
    order, bounds = bucket_bounds(presence.widths)
    return [(order[k:i], kb) for k, i, kb in bounds]


class _SlabStore:
    """LRU of presence slabs on one device, shared by the staged block and
    count engines (parfastaai_tpu.engine._slab_store).

    ``fetch(idx, kb, ids)`` returns the (len(idx), len(ids), kb) int8 slab
    of proteins ``idx`` and genomes ``ids``, zero-padded from the tensor's
    width to ``kb``.  A slab is keyed by what it holds, (kb, idx, ids): the
    reference keys it by (bucket, protein chunk, ids), and since the
    chunks depend on the block width, a second call on the same presence
    with another width is served slabs of the first call's proteins there.

    On a miss the store evicts least recently used slabs until the new one
    fits 0.75 of the device budget (4 GiB without one), but never the most
    recent slab, which is the other live slab of the current block, and
    only then uploads: the rows and the bucket's own K columns are
    gathered straight into page-locked memory (no full-width or full-G
    copy) and copied on the current stream, the stream of the kernels, so
    a dropped slab's memory is reused only by work queued after the
    kernels that read it.

    ``uploaded`` counts the bytes copied to the device, ``peak`` the most
    bytes the store held, ``slabs`` the uploads and ``hits`` the fetches
    served from the store."""

    def __init__(self, presence: PresenceData, device: torch.device):
        self._m = presence.m
        self._device = device
        self._slabs: OrderedDict = OrderedDict()
        self.held = self.peak = self.uploaded = self.slabs = self.hits = 0

    def cap(self) -> int:
        """0.75 of the device budget as it stands (4 GiB without one)."""
        budget = _device_budget(self._device)
        return int((budget if budget is not None else 4 << 30) * 0.75)

    def fetch(self, idx: np.ndarray, kb: int, ids: np.ndarray) -> torch.Tensor:
        idx = np.asarray(idx, np.int64)
        ids = np.asarray(ids, np.int64)
        return self._fetch(
            (kb, idx.tobytes(), ids.tobytes()), len(idx) * len(ids) * kb,
            lambda: self._to_device(self._host_slab(idx, kb, ids)))

    def _fetch(self, key, nb: int, upload):
        """The slab under ``key`` (``nb`` bytes in the store): from the
        store, or made by ``upload()`` after the evictions it needs."""
        if key in self._slabs:
            self._slabs.move_to_end(key)
            self.hits += 1
            return self._slabs[key][0]
        cap = self.cap()
        while self.held + nb > cap and len(self._slabs) > 1:
            _, (_, old_nb) = self._slabs.popitem(last=False)
            self.held -= old_nb
        slab = upload()
        self._slabs[key] = (slab, nb)
        self.held += nb
        self.peak = max(self.peak, self.held)
        self.uploaded += nb
        self.slabs += 1
        return slab

    def _host_slab(
        self, idx: np.ndarray, kb: int, ids: np.ndarray, pinned: bool = True
    ) -> torch.Tensor:
        """The (len(idx), len(ids), kb) int8 slab gathered on the host, into
        page-locked memory for a card where ``pinned``; a protein -1 gives
        a zero row."""
        cuda = pinned and self._device.type == "cuda"
        host = torch.empty((len(idx), len(ids), kb), dtype=torch.int8,
                           pin_memory=cuda)
        out = host.numpy().view(np.uint8)
        kw = min(kb, self._m.shape[2])
        for j, p in enumerate(idx):
            if p < 0:
                out[j] = 0
                continue
            out[j, :, :kw] = self._m[p][ids, :kw]
            out[j, :, kw:] = 0
        return host

    def _to_device(self, host: torch.Tensor) -> torch.Tensor:
        if self._device.type != "cuda":
            return host.to(self._device)
        return host.to(self._device, non_blocking=True)

    def stats(self) -> dict:
        return {"uploaded": self.uploaded, "peak": self.peak,
                "held": self.held, "cap": self.cap(), "slabs": self.slabs,
                "hits": self.hits}


def _slab_store(presence: PresenceData, device: torch.device) -> _SlabStore:
    """The presence's slab store on ``device``, made at first use and kept
    on the presence object, so later calls reuse its slabs."""
    stores = getattr(presence, "_torch_slab_stores", None)
    if stores is None:
        stores = {}
        presence._torch_slab_stores = stores
    key = str(device)
    if key not in stores:
        stores[key] = _SlabStore(presence, device)
    return stores[key]


class _MeshSlabStore(_SlabStore):
    """This rank's shard of each staged slab over a (rows, scp) mesh
    (parfastaai_tpu.engine._mesh_slab_store), on the LRU of ``_SlabStore``.

    ``fetch(kind, idx, kb, ids)`` returns this cell's shard of the
    (len(idx), len(ids), kb) slab: the proteins ``idx`` padded with empty
    proteins to a multiple of scp and cut into the cell's protein shard
    (``mesh.shard_proteins``); for a ``row`` slab the cell's band of the
    genomes ``ids``, a multiple of the mesh's rows (``mesh.cell_rows``),
    for a ``col`` slab every genome of ``ids``.  Device memory per rank is
    1 / (rows x scp) of a row slab and 1 / scp of a column slab, so the
    genome capacity grows with the mesh.  A rank past the mesh keeps the
    books of cell (0, 0) and uploads nothing (``fetch`` gives None).

    A slab is keyed by what the whole slab holds, (kind, kb, proteins,
    genomes), which fixes every rank's shard of it.  A key of the shard
    alone could hit on one rank and miss on another (two protein chunks
    can share one shard), and the broadcasts below would stop lining up.
    Every rank fetches the same keys in the same order, holds shards of
    equal bytes (P and the band are padded to the mesh) and has the cap
    and slab target of process 0 (broadcast when the store is made), so
    every rank misses and evicts at the same fetches.

    Meta-only runs (``presence.slab_broadcast``, set by
    ``distributed.broadcast_presence(meta_only=True)``): only process 0
    holds the presence tensor, so on a miss it gathers the whole slab,
    packs its bits and broadcasts them; each rank unpacks its own shard.
    A rank's host memory stays at one packed slab."""

    def __init__(self, presence: PresenceData, device: torch.device, mesh):
        from .parallel import distributed

        super().__init__(presence, device)
        self._mesh = mesh
        self._cell = mesh.coords if mesh.coords is not None else (0, 0)
        multiproc = distributed.world_size() > 1
        self._broadcast = multiproc and bool(
            getattr(presence, "slab_broadcast", False))
        budget = _device_budget(device)
        limits = (int((budget if budget is not None else 4 << 30) * 0.75),
                  _slab_target_bytes(device))
        if multiproc:
            limits = distributed.broadcast_pyobj(limits)
        self._cap, self.target = limits

    def cap(self) -> int:
        return self._cap

    def fetch(self, kind: str, idx: np.ndarray, kb: int, ids: np.ndarray):
        from .parallel.mesh import cell_rows, shard_proteins

        idx = np.asarray(idx, np.int64)
        ids = np.asarray(ids, np.int64)
        prot = shard_proteins(idx, self._cell[1], self._mesh.n_scp)
        genomes = cell_rows(self._mesh, ids) if kind == "row" else ids
        return self._fetch(
            (kind, kb, idx.tobytes(), ids.tobytes()),
            len(prot) * len(genomes) * kb,
            lambda: self._upload_shard(kind, idx, kb, ids, prot, genomes))

    def _upload_shard(self, kind, idx, kb, ids, prot, genomes):
        from .parallel import distributed
        from .parallel.mesh import shard_proteins

        idle = self._mesh.coords is None
        if not self._broadcast:
            return None if idle else self._to_device(
                self._host_slab(prot, kb, genomes))
        n_scp = self._mesh.n_scp
        whole = np.concatenate(
            [shard_proteins(idx, s, n_scp) for s in range(n_scp)])
        shape = (len(whole), len(ids), -(-kb // 8))
        packed = None
        if distributed.is_primary():
            host = self._host_slab(whole, kb, ids, pinned=False)
            host = host.numpy().view(np.uint8)
            packed = np.packbits(host, axis=-1)
        packed = distributed.broadcast_bytes(packed, shape)
        if idle:
            return None
        p = len(prot)
        rows = slice(None)
        if kind == "row":
            band = len(genomes)
            rows = slice(self._cell[0] * band, (self._cell[0] + 1) * band)
        part = packed[self._cell[1] * p : (self._cell[1] + 1) * p, rows]
        cuda = self._device.type == "cuda"
        out = torch.empty((p, len(genomes), kb), dtype=torch.int8,
                          pin_memory=cuda)
        out.numpy().view(np.uint8)[:] = np.unpackbits(part, axis=-1, count=kb)
        return self._to_device(out)


def _mesh_slab_store(presence: PresenceData, mesh,
                     device: torch.device) -> _MeshSlabStore:
    """The presence's mesh slab store for ``mesh`` on ``device``, made at
    first use and kept on the presence object under the mesh's identity
    (``mesh.mesh_key``: device, shape, world and rank)."""
    from .parallel.mesh import mesh_key

    stores = getattr(presence, "_torch_mesh_slab_stores", None)
    if stores is None:
        stores = {}
        presence._torch_mesh_slab_stores = stores
    key = mesh_key(mesh, device)
    if key not in stores:
        stores[key] = _MeshSlabStore(presence, device, mesh)
    return stores[key]


def slab_stats(
    presence: PresenceData, device: torch.device, mesh=None
) -> dict | None:
    """The counters of the presence's slab store on ``device`` (bytes
    uploaded, peak and held bytes, the cap, uploads and hits; with
    ``mesh``, this rank's store of that mesh, its bytes a rank's), or None
    where nothing was staged."""
    if mesh is None:
        store = getattr(presence, "_torch_slab_stores", {}).get(str(device))
    else:
        from .parallel.mesh import mesh_key

        store = getattr(presence, "_torch_mesh_slab_stores", {}).get(
            mesh_key(mesh, device))
    return None if store is None else store.stats()


def _selector(
    ids: np.ndarray, n_genomes: int, device: torch.device
) -> torch.Tensor | None:
    """None when ``ids`` is every genome in order (no gather needed), else
    the ids as an int64 tensor on the device."""
    ids = np.asarray(ids, np.int64)
    if np.array_equal(ids, np.arange(n_genomes, dtype=np.int64)):
        return None
    return _to_device(ids, device)


def _take(x: torch.Tensor, sel: torch.Tensor | None) -> torch.Tensor:
    """Genomes ``sel`` of a (Pb, G, ...) bucket tensor; the tensor itself
    for ``sel`` None."""
    return x if sel is None else x.index_select(1, sel)


def _bucket_block_engine(
    presence: PresenceData,
    approx: bool,
    precise: bool,
    device: torch.device,
    phases: dict | None = None,
    clock: _StageClock | None = None,
):
    """``block_sn(rids, cids, drids, dcids) -> (s, n)`` device tensors for
    one output block, summed over the width buckets in bucket order.  The
    index arguments are host arrays: genome ids of the rows and columns and
    the T columns of their denominators.  Every width bucket stays on the
    device (``to_device_buckets``); ``_staged_block_engine`` is its twin
    for presence above the device budget.

    ``clock`` times the block's ``gather`` and ``kernel`` stages.  The
    default synchronises the device at each stage boundary and fills
    ``phases`` (``compute_fast``'s split); a caller that pipelines blocks
    passes its own ``_StageClock(..., sync=False)``, with which ``block_sn``
    enqueues its work and returns without waiting for the device.  The
    values are the same either way."""
    buckets = to_device_buckets(presence, device, phases)
    G = presence.m.shape[1]
    if clock is None:
        clock = _StageClock(device, phases, sync=True)

    def block_sn(rids, cids, drids, dcids):
        clock.start()
        rsel, csel, drsel, dcsel = (
            _selector(ids, G, device) for ids in (rids, cids, drids, dcids)
        )
        s = n = None
        for _, md, td in buckets:
            ma, mb = _take(md, rsel), _take(md, csel)
            ta, tb = _take(td, drsel), _take(td, dcsel)
            clock.lap("gather")
            s_b, n_b = fused_sn_block(
                ma, mb, ta, tb, approx=approx, precise=precise
            )
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
            clock.lap("kernel")
        return s, n

    return block_sn


def _staged_block_engine(
    presence: PresenceData,
    approx: bool,
    precise: bool,
    device: torch.device,
    phases: dict | None = None,
    clock: _StageClock | None = None,
):
    """``_bucket_block_engine``'s contract for presence above the device
    budget (parfastaai_tpu.engine._staged_block_engine): no bucket is
    uploaded whole.  Per block, each chunk of ``_split_plan`` (at the
    block's larger side) fetches its row and column slabs from the
    ``_slab_store``, uploads its T columns clamped (``clamp_t``) and runs
    the rectangular kernel.  The chunks of a bucket are summed in chunk
    order and the bucket sums in bucket order: a bucket cut into one
    chunk, or into chunks of one protein each, gives the resident
    engine's values bit for bit; other cuts change the f32 order of S
    within a bucket (~1e-7), and N not at all.

    ``clock`` laps ``slab upload`` (the host gather, page-locking and the
    copies of a chunk's slabs and T) and ``kernel``, as the resident
    engine laps its stages."""
    fetch = _slab_store(presence, device).fetch
    plan = _bucket_plan(presence)
    t = presence.t
    if clock is None:
        clock = _StageClock(device, phases, sync=True)

    def block_sn(rids, cids, drids, dcids):
        rids, cids = np.asarray(rids), np.asarray(cids)
        drids, dcids = np.asarray(drids), np.asarray(dcids)
        clock.start()
        s = n = None
        chunks = _split_plan(plan, max(len(rids), len(cids)), device)
        for _, bucket in itertools.groupby(chunks, key=lambda c: c[0]):
            s_b = n_b = None
            for _, _, idx, kb in bucket:
                ma, mb = fetch(idx, kb, rids), fetch(idx, kb, cids)
                ta = clamp_t(_to_device(t[np.ix_(idx, drids)], device))
                tb = clamp_t(_to_device(t[np.ix_(idx, dcids)], device))
                clock.lap("slab upload")
                s_c, n_c = fused_sn_block(
                    ma, mb, ta, tb, approx=approx, precise=precise
                )
                s_b = s_c if s_b is None else s_b + s_c
                n_b = n_c if n_b is None else n_b + n_c
                clock.lap("kernel")
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
        return s, n

    return block_sn


def _choose_block_engine(
    presence: PresenceData,
    approx: bool,
    precise: bool,
    device: torch.device,
    phases: dict | None = None,
    clock: _StageClock | None = None,
    staged: bool | None = None,
):
    """The resident block engine, or the staged one where ``_use_staged``
    says so (parfastaai_tpu.engine._choose_block_engine); both keep one
    ``block_sn`` contract."""
    engine = (
        _staged_block_engine
        if _use_staged(presence, device, staged)
        else _bucket_block_engine
    )
    return engine(presence, approx, precise, device, phases, clock)


def _mask_aji(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """One streamed block finished on its device: AJI = S / N in f32 (an
    IEEE divide on the card and on the CPU alike; N to f32 is exact) with
    the cells that share no protein (N == 0) set to 0, as the reference
    leaves them in the CSV.  One f32 array per block crosses to the host
    (parfastaai_tpu.engine._mask_aji)."""
    return torch.where(n == 0, s.new_zeros(()), s / n.to(torch.float32))


def _bucket_count_engine(
    presence: PresenceData, device: torch.device, phases: dict | None = None
):
    """``block_counts(rids, cids) -> (P, len(rids), len(cids))`` device
    tensor of exact intersection counts for one output block, in the wire
    dtype (int16 when max(T) < 2^15, which halves the copy to the host).

    Each width bucket's per-protein int8 Grams (``ops.fused.int_gram``) are
    written straight into the rows of the block that its proteins own, so
    the block is in ascending protein order, the order of the f64 finish
    that byte parity rides on, and one copy carries it to the host.  Blocks
    have their exact shape: nothing is padded here.  Every width bucket
    stays on the device; ``_staged_count_engine`` is its twin for presence
    above the device budget."""
    buckets = to_device_buckets(presence, device, phases)
    out_dtype = _count_wire_dtype(presence)
    P, G = presence.t.shape

    def block_counts(rids: np.ndarray, cids: np.ndarray) -> torch.Tensor:
        rsel, csel = _selector(rids, G, device), _selector(cids, G, device)
        out = torch.empty(
            (P, len(rids), len(cids)), dtype=out_dtype, device=device
        )
        for idx, md, _ in buckets:
            m8 = md.view(torch.int8)
            ma, mb = _take(m8, rsel), _take(m8, csel)
            for j, p in enumerate(idx):
                out[int(p)] = int_gram(ma[j], mb[j])
        return out

    return block_counts


def _staged_count_engine(presence: PresenceData, device: torch.device):
    """``_bucket_count_engine``'s contract from the ``_slab_store``
    (parfastaai_tpu.engine._staged_count_engine): per chunk of
    ``_split_plan`` (at the block's larger side), the row and column slabs
    are fetched and each protein's Gram is written into the block's row of
    that protein.  Counts are integers, so the block does not depend on
    the split."""
    fetch = _slab_store(presence, device).fetch
    plan = _bucket_plan(presence)
    out_dtype = _count_wire_dtype(presence)
    P = presence.t.shape[0]

    def block_counts(rids: np.ndarray, cids: np.ndarray) -> torch.Tensor:
        out = torch.empty(
            (P, len(rids), len(cids)), dtype=out_dtype, device=device
        )
        for _, _, idx, kb in _split_plan(
            plan, max(len(rids), len(cids)), device
        ):
            ma, mb = fetch(idx, kb, rids), fetch(idx, kb, cids)
            for j, p in enumerate(idx):
                out[int(p)] = int_gram(ma[j], mb[j])
        return out

    return block_counts


def _use_staged_mesh(
    presence: PresenceData,
    n_scp: int,
    device: torch.device,
    staged: bool | None = None,
) -> bool:
    """Staged slabs or resident shards over a mesh
    (parfastaai_tpu.engine._use_staged_mesh): ``staged`` or
    PARFASTAAI_STAGED where either decides (``staged_override``), else
    staged exactly when a rank's share of the width-bucketed presence, its
    protein shard of every genome (1 / ``n_scp``), exceeds the rank's
    device budget.  In a run of several processes only process 0's answer
    counts: the callers broadcast it."""
    override = staged_override(staged)
    if override is not None:
        return override
    budget = _device_budget(device)
    return (budget is not None
            and presence_device_bytes(presence) // n_scp > budget)


def _zero_block(a: int, b: int, device: torch.device):
    """The (S, N) a rank past the mesh brings to a block's gather."""
    return (torch.zeros((a, b), dtype=torch.float32, device=device),
            torch.zeros((a, b), dtype=torch.int32, device=device))


def _t_rows(t: np.ndarray, prot: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """T[prot, ids] with a zero row for every protein -1 (padding)."""
    out = np.zeros((len(prot), len(ids)), t.dtype)
    valid = prot >= 0
    out[valid] = t[np.ix_(prot[valid], ids)]
    return out


def _mesh_buckets(presence: PresenceData, mesh, device: torch.device,
                  phases: dict | None = None):
    """This rank's protein shard of every width bucket on ``device``:
    [(layout, m, t)] in bucket order, ``layout`` the (scp, Pb/scp) proteins
    of every shard (-1 for the padding of Pb to a multiple of scp), ``m``
    the (Pb/scp, G, Kb) uint8 presence of this rank's shard and ``t`` its
    clamped T (``clamp_t``), both None past the mesh.  With scp = 1 the
    tensors of ``to_device_buckets``.  Cached on the presence object under
    the mesh's identity."""
    from .parallel.mesh import mesh_key, shard_proteins

    cache = getattr(presence, "_torch_mesh_bucket_cache", None)
    if cache is None:
        cache = {}
        presence._torch_mesh_bucket_cache = cache
    key = mesh_key(mesh, device)
    if key in cache:
        return cache[key]
    n_scp = mesh.n_scp
    G, K = presence.m.shape[1], presence.m.shape[2]
    out = []
    gather_s = h2d_s = 0.0
    for idx, kb in _bucket_plan(presence):
        layout = np.stack(
            [shard_proteins(idx, s, n_scp) for s in range(n_scp)])
        if mesh.coords is None:
            out.append((layout, None, None))
            continue
        t0 = time.perf_counter()
        prot = layout[mesh.coords[1]]
        valid = prot >= 0
        kw = min(kb, K)
        m_host = np.zeros((len(prot), G, kb), np.uint8)
        m_host[valid, :, :kw] = presence.m[prot[valid], :, :kw]
        t_host = _t_rows(presence.t, prot, np.arange(G))
        t1 = time.perf_counter()
        out.append((layout, _to_device(m_host, device),
                    clamp_t(_to_device(t_host, device))))
        _sync(device)
        gather_s += t1 - t0
        h2d_s += time.perf_counter() - t1
    _add(phases, "host bucketize", gather_s)
    _add(phases, "H2D", h2d_s)
    cache[key] = out
    return out


def _mesh_block_engine(
    presence: PresenceData,
    mesh,
    approx: bool,
    precise: bool,
    device: torch.device,
    phases: dict | None = None,
    clock: _StageClock | None = None,
):
    """``block_sn(rids, cids, drids, dcids) -> (s, n)`` of this rank's cell
    of one output block over a (rows, scp) mesh: the resident mesh branch
    of parfastaai_tpu.engine.compute_streamed.

    Every rank holds its protein shard of every width bucket
    (``_mesh_buckets``).  The block's rows are padded with genome 0 to a
    multiple of the mesh's rows; cell (r, s) takes band r of them against
    every column of the block and runs the rectangular kernel on its shard
    of each bucket, sums the buckets in bucket order, and then adds its
    row's scp partials (``mesh._reduce``, an all-reduce over the row's scp
    group).  Returns this cell's (S, N), on the collectives' device; zeros
    past the mesh.  ``mesh.gather_rows`` puts the bands together.  With scp
    = 1 each cell is ``_bucket_block_engine``'s arithmetic on its rows, so
    a row split changes no value; with scp > 1 the shards' sums meet at the
    end (~1e-7 against one device).

    ``clock`` laps ``gather``, ``kernel`` and ``scp all-reduce``."""
    from .parallel.mesh import _reduce, cell_rows, pad_rows

    buckets = _mesh_buckets(presence, mesh, device, phases)
    G = presence.m.shape[1]
    if clock is None:
        clock = _StageClock(device, phases, sync=True)

    def block_sn(rids, cids, drids, dcids):
        clock.start()
        rl = cell_rows(mesh, pad_rows(np.asarray(rids), mesh.n_rows))
        drl = cell_rows(mesh, pad_rows(np.asarray(drids), mesh.n_rows))
        if mesh.coords is None:
            return _zero_block(len(rl), len(cids), device)
        rsel, csel, drsel, dcsel = (
            _selector(ids, G, device) for ids in (rl, cids, drl, dcids)
        )
        s = n = None
        for _, md, td in buckets:
            ma, mb = _take(md, rsel), _take(md, csel)
            ta, tb = _take(td, drsel), _take(td, dcsel)
            clock.lap("gather")
            s_b, n_b = fused_sn_block(
                ma, mb, ta, tb, approx=approx, precise=precise
            )
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
            clock.lap("kernel")
        s, n = _reduce(mesh, s, n)
        clock.lap("scp all-reduce")
        return s, n

    return block_sn


def _staged_mesh_block_engine(
    presence: PresenceData,
    mesh,
    approx: bool,
    precise: bool,
    device: torch.device,
    phases: dict | None = None,
    clock: _StageClock | None = None,
):
    """``_mesh_block_engine``'s contract from staged slabs
    (parfastaai_tpu.engine._staged_mesh_block_engine): per block, each
    chunk of ``_split_plan`` (at the block's larger side, with the store's
    slab target) fetches this cell's shard of its row and column slabs
    from the ``_MeshSlabStore``, uploads the matching T (clamped, zeros for
    padding proteins) and runs the rectangular kernel.  Chunks are summed
    in chunk order within a bucket and the buckets in bucket order, as
    ``_staged_block_engine`` sums them, so a one-row mesh gives that
    engine's values; then the scp all-reduce.  A rank past the mesh joins
    the slab broadcasts of a meta-only run and computes nothing.

    ``clock`` laps ``slab upload``, ``kernel`` and ``scp all-reduce``."""
    from .parallel.mesh import _reduce, cell_rows, pad_rows, shard_proteins

    store = _mesh_slab_store(presence, mesh, device)
    plan = _bucket_plan(presence)
    t = presence.t
    if clock is None:
        clock = _StageClock(device, phases, sync=True)

    def block_sn(rids, cids, drids, dcids):
        n_ids = max(len(rids), len(cids))
        rids = pad_rows(np.asarray(rids), mesh.n_rows)
        drl = cell_rows(mesh, pad_rows(np.asarray(drids), mesh.n_rows))
        cids, dcids = np.asarray(cids), np.asarray(dcids)
        clock.start()
        s = n = None
        chunks = _split_plan(plan, n_ids, device, store.target)
        for _, bucket in itertools.groupby(chunks, key=lambda c: c[0]):
            s_b = n_b = None
            for _, _, idx, kb in bucket:
                ma = store.fetch("row", idx, kb, rids)
                mb = store.fetch("col", idx, kb, cids)
                if mesh.coords is None:
                    continue
                prot = shard_proteins(idx, mesh.coords[1], mesh.n_scp)
                ta = clamp_t(_to_device(_t_rows(t, prot, drl), device))
                tb = clamp_t(_to_device(_t_rows(t, prot, dcids), device))
                clock.lap("slab upload")
                s_c, n_c = fused_sn_block(
                    ma, mb, ta, tb, approx=approx, precise=precise
                )
                s_b = s_c if s_b is None else s_b + s_c
                n_b = n_c if n_b is None else n_b + n_c
                clock.lap("kernel")
            if s_b is not None:
                s = s_b if s is None else s + s_b
                n = n_b if n is None else n + n_b
        if mesh.coords is None:
            return _zero_block(len(drl), len(cids), device)
        s, n = _reduce(mesh, s, n)
        clock.lap("scp all-reduce")
        return s, n

    return block_sn


def _mesh_count_engine(
    presence: PresenceData, mesh, device: torch.device,
    phases: dict | None = None,
):
    """``block_counts(rids, cids) -> (counts, layout)``: this rank's cell of
    one exact count block over a (rows, scp) mesh
    (parfastaai_tpu.engine._mesh_count_engine).

    The block's rows are padded with genome 0 to a multiple of the mesh's
    rows.  Cell (r, s) takes its protein shard of every width bucket
    (``_mesh_buckets``) and band r of the rows against every column, and
    writes each protein's int8 Gram (``ops.fused.int_gram``, as
    ``_bucket_count_engine``) into the row of ``counts`` that ``layout``
    gives it: ``counts`` is (rows of layout, band / rows, len(cids)) in the
    wire dtype, ``layout`` the (scp, rows) proteins of every shard's rows,
    -1 for padding (whose rows are 0).  No collective: process 0 gathers
    the cells and puts every row in its place (``mesh.gather_cells``,
    ``mesh.assemble_counts``).  Counts are integers, so the split changes
    no value.  Zeros past the mesh."""
    from .parallel.mesh import cell_rows, pad_rows

    buckets = _mesh_buckets(presence, mesh, device, phases)
    layout = np.concatenate([b[0] for b in buckets], axis=1)
    out_dtype = _count_wire_dtype(presence)
    G = presence.m.shape[1]

    def block_counts(rids: np.ndarray, cids: np.ndarray):
        rl = cell_rows(mesh, pad_rows(np.asarray(rids), mesh.n_rows))
        out = torch.zeros((layout.shape[1], len(rl), len(cids)),
                          dtype=out_dtype, device=device)
        if mesh.coords is None:
            return out, layout
        rsel, csel = _selector(rl, G, device), _selector(cids, G, device)
        row = 0
        for b_layout, md, _ in buckets:
            m8 = md.view(torch.int8)
            ma, mb = _take(m8, rsel), _take(m8, csel)
            for j, p in enumerate(b_layout[mesh.coords[1]]):
                if p >= 0:
                    out[row + j] = int_gram(ma[j], mb[j])
            row += b_layout.shape[1]
        return out, layout

    return block_counts


def _staged_mesh_count_engine(
    presence: PresenceData, mesh, device: torch.device
):
    """``_mesh_count_engine``'s contract from staged slabs
    (parfastaai_tpu.engine._staged_mesh_count_engine): per chunk of
    ``_split_plan`` (at the block's larger side, with the store's slab
    target), this cell's shard of the row and column slabs from the
    ``_MeshSlabStore``; ``layout`` lists the chunks' shards in turn."""
    from .parallel.mesh import pad_rows, protein_layout

    store = _mesh_slab_store(presence, mesh, device)
    plan = _bucket_plan(presence)
    out_dtype = _count_wire_dtype(presence)

    def block_counts(rids: np.ndarray, cids: np.ndarray):
        chunks = list(_split_plan(
            plan, max(len(rids), len(cids)), device, store.target))
        rids = pad_rows(np.asarray(rids), mesh.n_rows)
        cids = np.asarray(cids)
        layout = protein_layout([c[2] for c in chunks], mesh.n_scp)
        out = torch.zeros(
            (layout.shape[1], len(rids) // mesh.n_rows, len(cids)),
            dtype=out_dtype, device=device)
        row = 0
        for _, _, idx, kb in chunks:
            ma = store.fetch("row", idx, kb, rids)
            mb = store.fetch("col", idx, kb, cids)
            n_p = -(-len(idx) // mesh.n_scp)
            if mesh.coords is not None:
                for j in range(n_p):
                    if layout[mesh.coords[1], row + j] >= 0:
                        out[row + j] = int_gram(ma[j], mb[j])
            row += n_p
        return out, layout

    return block_counts


def _staged_col_group(
    presence: PresenceData,
    device: torch.device,
    band: int,
    col_chunk: int,
    n_chunks: int,
    staged: bool | None,
) -> int:
    """Column chunks per group of ``_banded_sn``'s column-group-major walk
    (parfastaai_tpu.engine._staged_col_group): as many as fit, with one
    row band's slabs, into 0.8 of the slab store's cap (0.75 of the
    budget).  Resident runs get ``n_chunks``: one group, the row-major
    walk."""
    if n_chunks <= 1 or not _use_staged(presence, device, staged):
        return max(1, n_chunks)
    g = max(1, presence.m.shape[1])
    per_genome = presence_device_bytes(presence) / g
    budget = _device_budget(device)
    cap = (budget if budget is not None else 4 << 30) * 0.75
    avail = cap - band * per_genome
    if avail <= 0 or per_genome <= 0:
        return 1
    return max(1, min(n_chunks, int(avail * 0.8 / (per_genome * col_chunk))))


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
    staged: bool | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Full (len(row_ids), len(col_ids)) S/N matrices on the host, computed
    in band x col_chunk device blocks (``_choose_block_engine``).

    Short last bands and chunks are padded with genome 0 and sliced off.
    Symmetric problems (rows == cols with the same denominators) skip the
    blocks wholly below the diagonal and fill them from the transpose:
    counts and the denominator sums are symmetric, so each cell is the
    same f32 value.

    Staged runs walk column-group-major (parfastaai_tpu.engine._banded_sn):
    every row band of a group of column chunks (``_staged_col_group``)
    before the next group, so a column slab is uploaded once per group,
    not once per band.  Blocks land at their (r0, c0), so the order
    changes no value."""
    row_ids = np.asarray(row_ids, np.int64)
    col_ids = np.asarray(col_ids, np.int64)
    row_denom_ids = np.asarray(row_denom_ids, np.int64)
    col_denom_ids = np.asarray(col_denom_ids, np.int64)
    s = np.zeros((len(row_ids), len(col_ids)), dtype=np.float32)
    n = np.zeros((len(row_ids), len(col_ids)), dtype=np.int32)
    if len(row_ids) == 0 or len(col_ids) == 0:
        return s, n
    block_sn = _choose_block_engine(
        presence, approx, precise, device, phases, staged=staged
    )
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

    col_starts = list(range(0, len(col_ids), col_chunk))
    group_n = _staged_col_group(
        presence, device, band, col_chunk, len(col_starts), staged
    )
    for g0 in range(0, len(col_starts), group_n):
        group = col_starts[g0 : g0 + group_n]
        for r0 in range(0, len(row_ids), band):
            nr = min(band, len(row_ids) - r0)
            rids = padded(row_ids, r0, band)
            drids = padded(row_denom_ids, r0, band)
            for c0 in group:
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
    staged: bool | None = None,
) -> JacResult:
    """Fused f32 path through the rectangular kernel.

    ``approx`` / ``precise`` select the kernel's divide (raw approximate
    reciprocal / IEEE divide; default the Newton-refined reciprocal).

    All-vs-all runs the symmetric G x G band walk; query-subset runs the
    |Q| x G rectangle, which covers both of its slot parts; two-database
    mode runs the |Q| x |T| rectangle with the denominators gathered
    through PairSpace.row_denom_ids / col_denom_ids.  Any other pair space
    takes exact counts and the f64 finish.  ``staged``: the three block
    walks' slab staging (``_use_staged``)."""
    G = presence.m.shape[1]
    fast = dict(approx=approx, precise=precise, phases=phases, staged=staged)
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


def compute_sharded(
    presence: PresenceData,
    pairs: PairSpace,
    device: torch.device,
    n_rows: int | None = None,
    n_scp: int = 1,
    phases: dict | None = None,
) -> JacResult:
    """Fused f32 path over an (n_rows, n_scp) mesh of ranks
    (parallel/mesh.py; parfastaai_tpu.engine.compute_sharded).

    Genome row bands go to the mesh's rows, contiguous protein shards to
    its scp axis, summed by an all-reduce.  G and P are padded to mesh
    multiples with zero genomes and empty proteins (inert: a zero row's
    counts are 0).  Two-database pair spaces (either compat setting) and
    any rows x cols product run the rectangular program with the
    denominator T columns gathered through PairSpace.row_denom_ids /
    col_denom_ids, so the compat T-swap holds here too; the rest gathers
    its pairs from the G x G square.  No width buckets: the full presence
    tensor, proteins ascending within each shard.  ``n_rows`` None: the
    world size over ``n_scp``.  Every rank of the process group calls it
    and gets the whole result.  ``phases`` collects ``H2D``, ``kernel``,
    ``scp all-reduce`` and ``row gather`` seconds."""
    from .parallel import distributed
    from .parallel.mesh import (
        gather_rows,
        make_mesh,
        sharded_fused_sn,
        sharded_fused_sn_rect,
    )

    if n_rows is None:
        n_rows = max(1, distributed.world_size() // n_scp)
    mesh = make_mesh(n_rows, n_scp)

    def gathered(s_b, n_b, rows: int):
        t0 = time.perf_counter()
        s_mat = gather_rows(mesh, s_b)[:rows]
        n_mat = gather_rows(mesh, n_b)[:rows]
        _add(phases, "row gather", time.perf_counter() - t0)
        return s_mat, n_mat

    if not (
        np.array_equal(pairs.denom_a, pairs.db_a)
        and np.array_equal(pairs.denom_b, pairs.db_b)
    ) or _is_rect_pairs(pairs):
        if not _is_rect_pairs(pairs):
            raise ValueError(
                "compute_sharded: pair space is neither a single-id-space "
                "layout nor a rows x cols product"
            )
        ma = np.ascontiguousarray(presence.m[:, pairs.row_db_ids])
        mb = np.ascontiguousarray(presence.m[:, pairs.col_db_ids])
        ta = np.ascontiguousarray(presence.t[:, pairs.row_denom_ids])
        tb = np.ascontiguousarray(presence.t[:, pairs.col_denom_ids])
        P, A = ta.shape
        pp = -(-P // n_scp) * n_scp
        ap = -(-A // n_rows) * n_rows
        if (pp, ap) != (P, A):
            ma = np.pad(ma, ((0, pp - P), (0, ap - A), (0, 0)))
            ta = np.pad(ta, ((0, pp - P), (0, ap - A)))
            mb = np.pad(mb, ((0, pp - P), (0, 0), (0, 0)))
            tb = np.pad(tb, ((0, pp - P), (0, 0)))
        s_mat, n_mat = gathered(
            *sharded_fused_sn_rect(mesh, ma, mb, ta, tb, device, phases), A
        )
        return _result(pairs, s_mat.reshape(-1), n_mat.reshape(-1))

    P, G, _ = presence.m.shape
    pp = -(-P // n_scp) * n_scp
    gp = -(-G // n_rows) * n_rows
    m, t = presence.m, presence.t
    if (pp, gp) != (P, G):
        m = np.pad(m, ((0, pp - P), (0, gp - G), (0, 0)))
        t = np.pad(t, ((0, pp - P), (0, gp - G)))
    s_mat, n_mat = gathered(*sharded_fused_sn(mesh, m, t, device, phases), G)
    return _result(
        pairs, s_mat[pairs.db_a, pairs.db_b], n_mat[pairs.db_a, pairs.db_b]
    )


class _Download:
    """One device block on its way to the host (see ``_BlockDownloads``)."""

    __slots__ = ("_block", "_buf", "_done", "_free")

    def __init__(self, block, buf=None, done=None, free=None):
        self._block, self._buf, self._done, self._free = block, buf, done, free

    def wait(self) -> np.ndarray:
        """The block as a C-contiguous host array of its shape, once its copy
        has landed.  Waiting on the event releases the GIL and starts no
        CUDA work.  The array is valid until ``release``."""
        if self._buf is None:
            return self._block.numpy()
        self._done.synchronize()
        shape = self._block.shape
        self._block = None  # the copy has read it: the device may reuse it
        return self._buf[: shape.numel()].view(shape).numpy()

    def release(self) -> None:
        """Hands the host buffer back to the pool; the reader is done."""
        if self._buf is not None:
            self._free.put(self._buf)
            self._buf = None


class _BlockDownloads:
    """Device blocks (the exact engine's integer counts, the streamed
    engine's f32 AJI) to the host without stalling the producer.

    On a card: a pool of page-locked host buffers, one side stream and one
    event per block in flight.  ``fetch`` enqueues a block's work on the
    current stream and its copy on the side stream, which first waits for
    that work, and returns at once; the ``_Download`` keeps the device
    block alive until the copy's event has fired, and its buffer returns to
    the pool only when the reader releases it.  On the CPU ``fetch``
    computes the block and hands its memory over as it is: no stream, no
    buffer.

    ``compute_s`` / ``d2h_s`` are the blocks' device seconds, from CUDA
    event pairs read after the last block (``close``); on the CPU
    ``compute_s`` is host seconds and ``d2h_s`` stays 0.  ``wait_s``:
    seconds ``fetch`` waited for a free buffer."""

    def __init__(
        self,
        device: torch.device,
        max_numel: int,
        dtype: torch.dtype,
        n_buffers: int,
    ):
        self.compute_s = self.d2h_s = self.wait_s = 0.0
        self._cuda = device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(device)
            self._free: queue.Queue = queue.Queue()
            for _ in range(n_buffers):
                self._free.put(
                    torch.empty(max_numel, dtype=dtype, pin_memory=True)
                )
            self._timed: list[tuple[torch.cuda.Event, ...]] = []

    def fetch(self, compute_block) -> _Download:
        """Runs ``compute_block() -> device tensor`` and starts its copy."""
        if not self._cuda:
            t0 = time.perf_counter()
            block = compute_block()
            self.compute_s += time.perf_counter() - t0
            return _Download(block)
        t0 = time.perf_counter()
        buf = self._free.get()
        self.wait_s += time.perf_counter() - t0
        g0, g1, c0, c1 = (
            torch.cuda.Event(enable_timing=True) for _ in range(4)
        )
        main = torch.cuda.current_stream()
        g0.record(main)
        block = compute_block()
        g1.record(main)
        self._stream.wait_event(g1)
        with torch.cuda.stream(self._stream):
            c0.record()
            buf[: block.numel()].view(block.shape).copy_(
                block, non_blocking=True
            )
            c1.record()
        self._timed.append((g0, g1, c0, c1))
        return _Download(block, buf, c1, self._free)

    def close(self) -> None:
        """Sums the blocks' event pairs, after every copy has landed."""
        if self._cuda:
            self._stream.synchronize()
            for g0, g1, c0, c1 in self._timed:
                self.compute_s += g0.elapsed_time(g1) / 1e3
                self.d2h_s += c0.elapsed_time(c1) / 1e3
            self._timed.clear()


def mirror_budget() -> int:
    """Host bytes the banded engines' symmetric mirror may hold:
    PARFASTAAI_MIRROR_BYTES, default 4 GiB."""
    return int(float(os.environ.get("PARFASTAAI_MIRROR_BYTES", 4 << 30)))


def _primary_decides(decide, multiproc: bool):
    """``decide()`` on process 0 alone in a run of several processes, and
    its answer on every rank.  A failure there travels in the answer's
    place, so every rank raises it instead of waiting in a collective that
    process 0 never joins.  One process: ``decide()``."""
    if not multiproc:
        return decide()
    from .parallel import distributed

    value = err = None
    if distributed.is_primary():
        try:
            value = decide()
        except Exception as exc:  # noqa: BLE001 — every failure must reach
            # the other ranks
            err = distributed.picklable(exc)
    value, err = distributed.broadcast_pyobj((value, err))
    if err is not None:
        raise err
    return value


def _stop_everywhere(werr: list, multiproc: bool) -> bool:
    """Whether the run stops here because process 0's writer or worker
    thread failed (``werr``).  In a run of several processes, one flag from
    process 0 and, where it is set, its error, which every rank then holds
    in ``werr``: every rank stops at the same step and raises the same
    error.  One process: ``werr`` alone."""
    if not multiproc:
        return bool(werr)
    from .parallel import distributed

    if not distributed.broadcast_from_primary(1 if werr else 0):
        return False
    err = distributed.broadcast_pyobj(
        distributed.picklable(werr[0]) if werr else None)
    if not distributed.is_primary():
        werr.append(err)
    return True


def _primary_only(engine: str, world: int, hint: str) -> None:
    """The reference's WARNING where an engine without a mesh runs on
    process 0 alone in a run of several processes."""
    print(
        f"WARNING: the {engine} engine without --mesh computes on the "
        f"primary process only; the other {world - 1} process(es) idle "
        f"through this phase (pass --mesh R,S to {hint})",
        file=sys.stderr,
    )


def _open_csv(out_path: str, rows_done: int, header: str):
    """The CSV for appending after ``rows_done`` resumed rows, else anew
    with its header."""
    fp = open(out_path, "a" if rows_done else "w")
    try:
        if not rows_done:
            fp.write(header)
    except BaseException:
        fp.close()
        raise
    return fp


def compute_streamed_exact(
    presence: PresenceData,
    row_ids: np.ndarray,
    col_ids: np.ndarray,
    out_path: str,
    row_names: tuple[str, ...],
    col_names: tuple[str, ...],
    device: torch.device,
    separator: str = ",",
    band: int = 512,
    col_chunk: int = 2048,
    resume: bool = False,
    row_denom_ids: np.ndarray | None = None,
    col_denom_ids: np.ndarray | None = None,
    phases: dict | None = None,
    staged: bool | None = None,
    mesh=None,
) -> None:
    """Banded exact engine: bit-parity f64 AJI straight to the CSV
    (parfastaai_tpu.engine.compute_streamed_exact).

    ``compute`` downloads the whole (P, n_pairs) count matrix, which grows
    with G^2.  This engine keeps its exactness (integer intersections, f64
    S accumulated in ascending protein order) at any G: per band x
    col_chunk output block it takes the integer counts from the device
    (``_bucket_count_engine``), runs the banded f64 finish
    (``jaccard_finish_block``, the operation order of ``compute``'s finish)
    and appends the CSV rows of each completed band.  Memory is
    O(P * band * col_chunk) on the host and on the device beside the
    resident presence, whatever G is.  Where ``_use_staged`` says so
    (``staged``, PARFASTAAI_STAGED, or presence above the device budget)
    the counts come from staged slabs (``_staged_count_engine``) instead
    of resident buckets, with the same bytes out.

    The CSV is byte-identical to ``compute`` + ``write_aji_csv`` in every
    mode: the same f64 values and formatter; pairs that share no protein
    print ``nan`` (0/0) and same-genome cells print ``0``.

    ``resume``: complete band-aligned rows already in ``out_path`` are kept
    and the run restarts at the first missing row (the CSV is the
    checkpoint).

    Two-stage pipeline: the main thread enqueues each block's Grams and its
    copy to page-locked host memory (``_BlockDownloads``) and never waits
    for the device; one worker thread, up to two blocks behind, waits for a
    block's copy, runs the native f64 finish and, at a band's end, formats
    and writes the band (both release the GIL).  Device compute, the copy,
    the host's f64 math and file IO overlap; the order of the rows holds
    because the queue is FIFO and one worker consumes it.  A band is
    written only when all its chunks arrived, so an interrupted run leaves
    whole bands only.

    Symmetric (all-vs-all) runs compute only the blocks on and above the
    diagonal: counts are symmetric, so each block below it is the transpose
    of a finished f64 tile that the worker holds in a mirror store and pops
    at its one use.  That halves the Grams and the copied bytes with
    identical bytes out.  It engages when rows == cols (ids and
    denominators), no rows were resumed and the peak mirror footprint fits
    PARFASTAAI_MIRROR_BYTES (default 4 GiB); blocks are then band x band.

    ``mesh`` (``parallel.mesh.make_mesh``): the count blocks come from the
    mesh's ranks (``_mesh_count_engine``, or ``_staged_mesh_count_engine``
    where ``_use_staged_mesh`` says so or the presence is meta-only), the
    band rounded up to a multiple of the mesh's rows; every rank runs the
    block walk and joins one gather per block, and process 0 puts the cells
    together and runs the worker, the mirror store and the CSV alone.
    Counts are integers, so the bytes are those of one device.  In a run
    of several processes process 0 decides (staged, the resume point, the
    mirror) after opening the CSV, and its decisions or its failure reach
    every rank in one broadcast; one flag per block then says whether its
    worker failed, so every rank stops and raises the same error.  Without
    a mesh, the other processes return at once and process 0 computes
    alone, with the reference's WARNING.

    ``phases`` collects seconds under ``host bucketize`` and ``H2D`` (the
    presence upload), ``Gram`` and ``D2H`` (device seconds from CUDA event
    pairs; staged: the slabs' uploads too), ``host finish`` and ``CSV
    write`` (the worker's busy seconds), ``producer wait`` (main thread
    blocked on a full queue or on a host buffer) and ``worker wait``
    (worker blocked on a copy or on an empty queue).  The stages overlap,
    so they do not sum to the wall.  With a mesh, ``Gram`` is host seconds
    up to the end of the block's Grams and ``count gather`` the gather and
    the assembly on process 0.
    """
    from .parallel import distributed
    from .parallel.mesh import assemble_counts, gather_cells

    primary = distributed.is_primary()
    multiproc = distributed.world_size() > 1
    if multiproc and mesh is None:
        if not primary:
            return  # no collective here: process 0 computes and writes
        _primary_only("banded exact", distributed.world_size(),
                      "shard the exact count production")
        multiproc = False
    row_ids = np.asarray(row_ids, dtype=np.int32)
    col_ids = np.asarray(col_ids, dtype=np.int32)
    row_denom_ids = (
        row_ids
        if row_denom_ids is None
        else np.asarray(row_denom_ids, dtype=np.int32)
    )
    col_denom_ids = (
        col_ids
        if col_denom_ids is None
        else np.asarray(col_denom_ids, dtype=np.int32)
    )
    band = max(1, min(band, len(row_ids)))
    col_chunk = max(1, min(col_chunk, len(col_ids)))
    if mesh is not None:
        band = -(-band // mesh.n_rows) * mesh.n_rows  # cells of equal bands
    t = presence.t
    P = t.shape[0]
    header = separator + separator.join(col_names) + "\n"
    # Symmetric reuse (see docstring): square blocks, so that each block
    # below the diagonal is exactly the transpose of a stored tile.
    sym_layout = (
        len(row_ids) == len(col_ids)
        and np.array_equal(row_ids, col_ids)
        and np.array_equal(row_denom_ids, col_denom_ids)
    )
    opened = []

    def decide():
        if mesh is None:
            staged_active = _use_staged(presence, device, staged)
        else:
            staged_active = getattr(presence, "slab_broadcast", False) or (
                _use_staged_mesh(presence, mesh.n_scp, device, staged))
        rows_done = _resume_point(out_path, header, band) if resume else 0
        if sym_layout and rows_done:
            print(
                "NOTE: symmetric mirror disabled on --resume (mirrors need "
                "every earlier band from this run); the remaining bands "
                "compute the full square",
                file=sys.stderr,
            )
        sym = sym_layout and rows_done == 0
        if sym:
            # The budget is checked before the square col_chunk is
            # adopted, so a run without the mirror keeps the caller's chunk.
            n_ch = -(-len(col_ids) // band)
            # Peak live mirror tiles = max_i (i+1)(n-1-i) ~ n^2/4 f64 tiles.
            peak = ((n_ch * n_ch) // 4 + 1) * band * band * 8
            budget = mirror_budget()
            if peak > budget:
                sym = False
                print(
                    "NOTE: symmetric mirror disabled — peak mirror bytes "
                    f"{peak} exceed PARFASTAAI_MIRROR_BYTES={budget}; "
                    "computing the full square",
                    file=sys.stderr,
                )
        opened.append(_open_csv(out_path, rows_done, header))
        return staged_active, rows_done, sym

    # Process 0 opens the CSV before the first collective; its failure
    # (a missing directory, an unwritable file) stops every rank.
    staged_active, rows_done, sym = _primary_decides(decide, multiproc)
    fp = opened[0] if opened else None
    if sym:
        col_chunk = band  # square blocks so mirrors transpose exactly
    n_chunks_per_band = max(1, -(-len(col_ids) // col_chunk))

    # Worker (stage 2).  The queue's depth of 2 bounds the blocks in flight;
    # the host buffers are one being filled, two queued, one being read.
    work_q: queue.Queue = queue.Queue(maxsize=2)
    downloads = None
    werr: list[BaseException] = []
    # Seconds by stage: the worker adds to its three keys, the main thread
    # to "producer wait" alone.
    busy = {"host finish": 0.0, "CSV write": 0.0, "producer wait": 0.0,
            "worker wait": 0.0}

    def _worker() -> None:
        download = None
        try:
            if os.environ.get("PARFASTAAI_TEST_WORKER_FAULT"):
                # Fault-injection hook (tests only): a failure of the finish
                # worker must stop the producer and reach the caller.
                raise RuntimeError("injected finish-worker fault")
            cur_r0 = -1
            cur_rids: np.ndarray | None = None
            rows_aji: np.ndarray | None = None
            chunks_done = 0
            mirror: dict[tuple[int, int], np.ndarray] = {}

            def flush() -> None:
                nonlocal rows_aji
                if rows_aji is None:
                    return
                if chunks_done < n_chunks_per_band:
                    # The producer stopped mid-band (device error,
                    # interrupt): the unfilled chunks are np.empty garbage.
                    # Writing them would bake a complete-looking band into
                    # the CSV that --resume would keep as a checkpoint.
                    rows_aji = None
                    return
                t0 = time.perf_counter()
                # Same-genome cells are untouched in the reference => 0.
                rows_aji[cur_rids[:, None] == col_ids[None, :]] = 0.0
                for i, row in enumerate(format_matrix(rows_aji, separator)):
                    fp.write(row_names[cur_r0 + i] + separator + row + "\n")
                rows_aji = None
                busy["CSV write"] += time.perf_counter() - t0

            while True:
                t0 = time.perf_counter()
                item = work_q.get()
                busy["worker wait"] += time.perf_counter() - t0
                if item is None:
                    flush()
                    return
                r0, rids, drids, c0, nc, dcids, kind, data = item
                if r0 != cur_r0:
                    flush()
                    cur_r0, cur_rids = r0, rids
                    chunks_done = 0
                    rows_aji = np.empty(
                        (len(rids), len(col_ids)), dtype=np.float64
                    )
                chunks_done += 1
                if kind == "mirror":
                    # Transpose of a tile above the diagonal that was
                    # finished earlier (the FIFO guarantees it is there);
                    # each tile mirrors once.
                    t0 = time.perf_counter()
                    rows_aji[:, c0 : c0 + nc] = mirror.pop(data).T
                    busy["host finish"] += time.perf_counter() - t0
                    continue
                download, store_key = data
                t0 = time.perf_counter()
                counts = download.wait()
                t1 = time.perf_counter()
                s, n = jaccard_finish_block(counts, t[:, drids], t[:, dcids])
                del counts
                download.release()
                download = None
                with np.errstate(divide="ignore", invalid="ignore"):
                    blk = s / n  # 0/0 -> nan (parity)
                rows_aji[:, c0 : c0 + nc] = blk
                if store_key is not None:
                    mirror[store_key] = blk
                busy["worker wait"] += t1 - t0
                busy["host finish"] += time.perf_counter() - t1
        except BaseException as exc:  # handed to the caller after the join
            werr.append(exc)
            if download is not None:
                download.release()
            # Keep the producer unblocked: empty the queue and hand every
            # host buffer back until the producer's end mark arrives.
            while (item := work_q.get()) is not None:
                if item[6] == "counts":
                    item[7][0].release()

    def put(item) -> None:
        t0 = time.perf_counter()
        work_q.put(item)
        busy["producer wait"] += time.perf_counter() - t0

    worker = None
    try:
        if mesh is not None:
            block_counts = (
                _staged_mesh_count_engine(presence, mesh, device)
                if staged_active
                else _mesh_count_engine(presence, mesh, device, phases)
            )
        elif staged_active:
            block_counts = _staged_count_engine(presence, device)
        else:
            block_counts = _bucket_count_engine(presence, device, phases)
        if mesh is None:
            downloads = _BlockDownloads(
                device, P * band * col_chunk, _count_wire_dtype(presence),
                n_buffers=work_q.maxsize + 2,
            )

        def counts_of(rids, cids):
            """The block's counts on their way to process 0's worker."""
            if mesh is None:
                return downloads.fetch(lambda: block_counts(rids, cids))
            t0 = time.perf_counter()
            counts, layout = block_counts(rids, cids)
            _sync(device)
            t1 = time.perf_counter()
            cells = gather_cells(mesh, counts)  # every rank joins
            host = (assemble_counts(mesh, cells, layout, P, len(rids))
                    if primary else None)
            _add(phases, "Gram", t1 - t0)
            _add(phases, "count gather", time.perf_counter() - t1)
            return _Download(torch.from_numpy(host)) if primary else None

        if primary:
            worker = threading.Thread(
                target=_worker, name="pfaai-exact-finish", daemon=True
            )
            worker.start()
        stop = False
        for bi, r0 in enumerate(range(rows_done, len(row_ids), band)):
            rids = row_ids[r0 : r0 + band]
            drids = row_denom_ids[r0 : r0 + band]
            for ci, c0 in enumerate(range(0, len(col_ids), col_chunk)):
                cids = col_ids[c0 : c0 + col_chunk]
                dcids = col_denom_ids[c0 : c0 + col_chunk]
                if sym and ci < bi:
                    # Below the diagonal: no device work and no copy; the
                    # worker mirrors the stored (ci, bi) tile.
                    data = (ci, bi)
                    kind = "mirror"
                else:
                    data = (counts_of(rids, cids),
                            (bi, ci) if sym and ci > bi else None)
                    kind = "counts"
                if primary:
                    put((r0, rids, drids, c0, len(cids), dcids, kind, data))
                # One flag a block (the reference's protocol): every rank
                # makes this call once per block.
                stop = _stop_everywhere(werr, multiproc)
                if stop:
                    break
            if stop:
                break
    finally:
        if worker is not None and worker.is_alive():
            work_q.put(None)
            worker.join()
        if fp is not None:
            fp.close()
    if downloads is not None:
        downloads.close()
        busy["producer wait"] += downloads.wait_s
        _add(phases, "Gram", downloads.compute_s)
        _add(phases, "D2H", downloads.d2h_s)
    if primary:
        for key, seconds in busy.items():
            _add(phases, key, seconds)
    if werr:
        raise werr[0]


# Bytes of the f64 slab that the streamed engine's writer formats at a time:
# half of the 32 MiB above which glibc maps every allocation afresh.
_FORMAT_SLAB_BYTES = 16 << 20


def compute_streamed(
    presence: PresenceData,
    row_ids: np.ndarray,
    col_ids: np.ndarray,
    out_path: str,
    row_names: tuple[str, ...],
    col_names: tuple[str, ...],
    device: torch.device,
    separator: str = ",",
    band: int = 1024,
    col_chunk: int = 4096,
    resume: bool = False,
    approx: bool = False,
    precise: bool = False,
    row_denom_ids: np.ndarray | None = None,
    col_denom_ids: np.ndarray | None = None,
    phases: dict | None = None,
    staged: bool | None = None,
    mesh=None,
) -> None:
    """The f32 streamed engine: AJI straight to the CSV in row bands
    (parfastaai_tpu.engine.compute_streamed).

    The output is walked in band x col_chunk blocks.  Each block is one
    pass of the rectangular kernel per width bucket
    (``_bucket_block_engine``), summed in bucket order, finished on the
    device by ``_mask_aji`` and copied to the host as one f32 array.  Host
    memory is O(band x G) beside the presence tensor (plus the mirror
    store below) and the CSV grows in row order: a header of column names,
    one row per row genome, same-genome cells and cells that share no
    protein ``0``.  f32 on the device (~1e-7 relative, like
    ``compute_fast``).

    ``row_denom_ids`` / ``col_denom_ids``: T columns of the denominators
    per row / column (default: the id columns), so that the two-database
    T swap is honoured.  ``resume``: complete band-aligned rows already in
    ``out_path`` are kept and the run restarts at the first missing row.
    ``approx`` / ``precise`` select the kernel's divide.  ``precise`` is
    honoured on every device (the plain version divides in IEEE f32);
    ``approx`` exists only in the CUDA kernel, so on another device it
    raises PFAAIError(CONSTRUCT_ERROR) before anything is uploaded.

    Blocks have their exact shape.  The reference pads short bands and
    chunks with genome 0 to keep one compiled shape and slices the padding
    off; the kernel here masks ragged edges, and a cell's value does not
    depend on the block it is computed in (per cell: ascending proteins
    within a bucket, buckets summed in bucket order), so the bytes do not
    depend on ``band`` or ``col_chunk``.

    Two-stage pipeline.  The main thread enqueues each block's gather,
    kernel, bucket sum and mask on the current stream and its copy to
    page-locked host memory on a side stream (``_BlockDownloads``), and
    never waits for the device.  One writer thread, up to two blocks
    behind, waits for a block's copy, assembles the band in an array of
    its own, and at the band's end formats and writes it (in slabs of rows
    of ``_FORMAT_SLAB_BYTES`` as f64).  Device work,
    copies, assembly and file IO overlap; the rows keep their order
    because the queue is FIFO and one thread consumes it.  A band is
    written only once the producer has marked its end, so an interrupted
    run leaves whole bands only.

    Symmetric (all-vs-all) runs skip the column chunks wholly below the
    diagonal (``c0 + col_chunk <= r0``) and fill that region from the
    transposes of the assembled bands written before (the same f32 value
    per cell: counts and the denominator sums are symmetric).  Device work
    and copied bytes approach half, at the cost of keeping every assembled
    band (rows x cols x 4 bytes) on the host; it engages when rows == cols
    (ids and denominators), no rows were resumed and that store fits
    PARFASTAAI_MIRROR_BYTES (default 4 GiB), and says so on stderr when a
    symmetric run goes without it.

    ``phases`` collects seconds under ``host bucketize`` and ``H2D`` (the
    presence upload), ``gather`` (staged: ``slab upload``), ``kernel``,
    ``AJI mask`` and ``D2H`` (device seconds from CUDA event pairs, read
    after the last block),
    ``host assembly`` and ``CSV write`` (the writer's busy seconds),
    ``producer wait`` (main thread blocked on a full queue or on a host
    buffer) and ``writer wait`` (writer blocked on a copy or on an empty
    queue).  The stages overlap, so they do not sum to the wall.

    Staged slabs (``staged``, PARFASTAAI_STAGED, or presence above the
    device budget: ``_use_staged``): blocks come from the staged block
    engine, and the column walk runs right to left in every other band
    (the reference's snake order), so the column slabs of a band's last
    chunks, still in the slab store, open the next band.  The writer
    places each chunk at its c0, so the bytes do not depend on the order.

    ``mesh`` (``parallel.mesh.make_mesh``): each block is cut into the
    mesh's cells (``_mesh_block_engine``, or ``_staged_mesh_block_engine``
    where ``_use_staged_mesh`` says so or the presence is meta-only), the
    band rounded up to a multiple of the mesh's rows.  Every rank runs the
    block walk and joins one gather of the masked cells per block; process
    0 runs the writer, the mirror store and the CSV alone.  A one-row mesh
    writes the bytes of one device; protein shards add their sums at the
    end (~1e-7).  In a run of several processes process 0 decides (staged,
    the resume point, the mirror) after opening the CSV, its decisions or
    its failure reach every rank in one broadcast, and one flag per band
    says whether its writer failed, so every rank stops and raises the
    same error.  Without a mesh the other processes return at once and
    process 0 computes alone, with a WARNING (the reference runs the whole
    walk on every process and gathers each block).  The mesh's ``phases``
    are host seconds around syncs: ``gather`` (staged: ``slab upload``),
    ``kernel``, ``scp all-reduce``, ``AJI mask`` and ``row gather``.

    Not here: the host numpy block for small problems (``_take_host``:
    relay dispatch model, not ported).
    """
    from .parallel import distributed
    from .parallel.mesh import gather_rows

    if approx and device.type != "cuda":
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "--approx requires the CUDA streamed kernel, but the device is "
            f"{device.type!r}, not cuda",
        )
    primary = distributed.is_primary()
    multiproc = distributed.world_size() > 1
    if multiproc and mesh is None:
        if not primary:
            return  # no collective here: process 0 computes and writes
        _primary_only("f32 streamed", distributed.world_size(),
                      "cut its blocks into the mesh's cells")
        multiproc = False
    row_ids = np.asarray(row_ids, dtype=np.int32)
    col_ids = np.asarray(col_ids, dtype=np.int32)
    row_denom_ids = (
        row_ids
        if row_denom_ids is None
        else np.asarray(row_denom_ids, dtype=np.int32)
    )
    col_denom_ids = (
        col_ids
        if col_denom_ids is None
        else np.asarray(col_denom_ids, dtype=np.int32)
    )
    # Clamped to >= 1: an empty axis gives a header-only CSV.
    band = max(1, min(band, len(row_ids)))
    col_chunk = max(1, min(col_chunk, len(col_ids)))
    if mesh is not None:
        band = -(-band // mesh.n_rows) * mesh.n_rows  # cells of equal bands
    header = separator + separator.join(col_names) + "\n"
    sym_layout = (
        len(row_ids) == len(col_ids)
        and np.array_equal(row_ids, col_ids)
        and np.array_equal(row_denom_ids, col_denom_ids)
    )
    opened = []

    def decide():
        if mesh is None:
            staged_active = _use_staged(presence, device, staged)
        else:
            staged_active = getattr(presence, "slab_broadcast", False) or (
                _use_staged_mesh(presence, mesh.n_scp, device, staged))
        rows_done = _resume_point(out_path, header, band) if resume else 0
        store_bytes = len(row_ids) * len(col_ids) * 4
        budget = mirror_budget()
        sym = sym_layout and rows_done == 0 and store_bytes <= budget
        if sym_layout and not sym:
            why = (
                "--resume keeps earlier bands this run never produced"
                if rows_done
                else f"assembled-band store {store_bytes} B exceeds "
                f"PARFASTAAI_MIRROR_BYTES={budget}"
            )
            print(
                f"NOTE: symmetric mirror disabled ({why}); computing the "
                "full square",
                file=sys.stderr,
            )
        opened.append(_open_csv(out_path, rows_done, header))
        return staged_active, rows_done, sym

    # Process 0 opens the CSV before the first collective; its failure
    # (a missing directory, an unwritable file) stops every rank.
    staged_active, rows_done, sym = _primary_decides(decide, multiproc)
    fp = opened[0] if opened else None

    # Writer (stage 2).  The queue's depth of 2 bounds the blocks in flight;
    # the host buffers are one being filled, two queued, one being read.
    work_q: queue.Queue = queue.Queue(maxsize=2)
    downloads = None
    werr: list[BaseException] = []
    # The writer converts and formats a band in slabs of rows whose f64 copy
    # stays at _FORMAT_SLAB_BYTES: an array the allocator hands out again
    # and again, where a whole 1024 x 4096 band (33.5 MB as f64) is mapped
    # and page-faulted anew for every band.
    slab_rows = max(1, _FORMAT_SLAB_BYTES // (8 * max(1, len(col_ids))))
    # Seconds by stage: the writer adds to its three keys, the main thread
    # to "producer wait" alone.
    busy = {"host assembly": 0.0, "CSV write": 0.0, "producer wait": 0.0,
            "writer wait": 0.0}

    def _writer() -> None:
        download = None
        try:
            if os.environ.get("PARFASTAAI_TEST_WORKER_FAULT"):
                # Fault-injection hook (tests only): a failure of the writer
                # must stop the producer and reach the caller.
                raise RuntimeError("injected csv-writer fault")
            rows_aji: np.ndarray | None = None
            # Assembled bands by first row, kept for the mirror: each its
            # own array, never a view of a pooled host buffer.
            band_store: dict[int, np.ndarray] = {}
            while True:
                t0 = time.perf_counter()
                item = work_q.get()
                busy["writer wait"] += time.perf_counter() - t0
                if item is None:
                    return  # a band without its end mark is not written
                r0, rids, chunk = item
                if rows_aji is None:
                    rows_aji = np.empty(
                        (len(rids), len(col_ids)), dtype=np.float32
                    )
                if chunk is not None:
                    c0, nc, download = chunk
                    t0 = time.perf_counter()
                    block = download.wait()
                    t1 = time.perf_counter()
                    rows_aji[:, c0 : c0 + nc] = block
                    del block
                    download.release()
                    download = None
                    busy["writer wait"] += t1 - t0
                    busy["host assembly"] += time.perf_counter() - t1
                    continue
                # The band's end: every computed chunk is in place.
                t0 = time.perf_counter()
                if sym:
                    # The skipped region [0, fill_end): transposed slices of
                    # the earlier bands (all complete: only the last band
                    # can be short, and nothing mirrors from it).
                    fill_end = (r0 // col_chunk) * col_chunk
                    for bs in range(0, fill_end, band):
                        width = min(band, fill_end - bs)
                        rows_aji[:, bs : bs + width] = band_store[bs][
                            :width, r0 : r0 + len(rids)
                        ].T
                # Same-genome cells are untouched in the reference => 0.
                rows_aji[rids[:, None] == col_ids[None, :]] = 0.0
                if sym:
                    band_store[r0] = rows_aji
                t1 = time.perf_counter()
                for i0 in range(0, len(rids), slab_rows):
                    slab = rows_aji[i0 : i0 + slab_rows].astype(np.float64)
                    for i, row in enumerate(format_matrix(slab, separator)):
                        fp.write(
                            row_names[r0 + i0 + i] + separator + row + "\n"
                        )
                rows_aji = None
                busy["host assembly"] += t1 - t0
                busy["CSV write"] += time.perf_counter() - t1
        except BaseException as exc:  # handed to the caller after the join
            werr.append(exc)
            if download is not None:
                download.release()
            # Keep the producer unblocked: empty the queue and hand every
            # host buffer back until the producer's end mark arrives.
            while (item := work_q.get()) is not None:
                if item[2] is not None:
                    item[2][2].release()

    def put(item) -> None:
        t0 = time.perf_counter()
        work_q.put(item)
        busy["producer wait"] += time.perf_counter() - t0

    writer = None
    # The mesh's blocks meet in a gather that waits for the device anyway:
    # its stages are host seconds around syncs.
    clock = _StageClock(device, phases, sync=mesh is not None)
    try:
        if mesh is None:
            block_sn = _choose_block_engine(
                presence, approx, precise, device, phases, clock,
                staged_active
            )
            downloads = _BlockDownloads(
                device, band * col_chunk, torch.float32,
                n_buffers=work_q.maxsize + 2
            )
        else:
            block_sn = (
                _staged_mesh_block_engine if staged_active
                else _mesh_block_engine
            )(presence, mesh, approx, precise, device, phases, clock)

        def block_aji(rids, cids, drids, dcids) -> torch.Tensor:
            aji = _mask_aji(*block_sn(rids, cids, drids, dcids))
            clock.lap("AJI mask")
            return aji

        def aji_of(rids, cids, drids, dcids):
            """The block's AJI on its way to process 0's writer."""
            if mesh is None:
                return downloads.fetch(
                    lambda: block_aji(rids, cids, drids, dcids))
            cell = block_aji(rids, cids, drids, dcids)
            t0 = time.perf_counter()
            rows = gather_rows(mesh, cell)  # every rank joins
            _add(phases, "row gather", time.perf_counter() - t0)
            if not primary:
                return None
            return _Download(
                torch.from_numpy(np.ascontiguousarray(rows[: len(rids)])))

        if primary:
            writer = threading.Thread(
                target=_writer, name="pfaai-csv-writer", daemon=True
            )
            writer.start()
        c0s = list(range(0, len(col_ids), col_chunk))
        for bi, r0 in enumerate(range(rows_done, len(row_ids), band)):
            rids = row_ids[r0 : r0 + band]
            drids = row_denom_ids[r0 : r0 + band]
            snake = staged_active and bi % 2 == 1
            for c0 in reversed(c0s) if snake else c0s:
                if sym and c0 + col_chunk <= r0:
                    continue  # below the diagonal: the writer mirrors it
                cids = col_ids[c0 : c0 + col_chunk]
                dcids = col_denom_ids[c0 : c0 + col_chunk]
                download = aji_of(rids, cids, drids, dcids)
                if primary:
                    put((r0, rids, (c0, len(cids), download)))
                if werr and not multiproc:
                    break
            if primary:
                put((r0, rids, None))  # the band's end mark
            # One flag a band (the reference's protocol): every rank makes
            # this call once per band.
            if _stop_everywhere(werr, multiproc):
                break
    finally:
        if writer is not None and writer.is_alive():
            work_q.put(None)
            writer.join()
        if fp is not None:
            fp.close()
    if downloads is not None:
        downloads.close()
        busy["producer wait"] += downloads.wait_s
        _add(phases, "D2H", downloads.d2h_s)
    clock.close()
    if primary:
        for key, seconds in busy.items():
            _add(phases, key, seconds)
    if werr:
        raise werr[0]
