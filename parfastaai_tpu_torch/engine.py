"""The AJI compute engine on PyTorch.

Counterpart of parfastaai_tpu/engine.py for the paths this package covers:

* ``compute`` (exact, CLI default): integer intersection counts from the
  int8 Gram on the device (ops.fused.pair_counts_device), int16 when they
  fit, finished in f64 in ascending protein order, so the CSV is
  byte-identical to the JAX package's: on a card by the finish kernel
  (ops.finish) where the counts lie, only S and N downloaded; on the CPU
  by the host's native finish, which the JAX package uses.
* ``compute_fast`` (``--fast``): the fused f32 pipeline.  Width buckets of
  the presence tensor live on the device (``to_device_buckets``); output
  blocks of band x col_chunk genome pairs run through the hand-written
  rectangular kernel (ops.sn_rect) and are assembled on the host.
* ``compute_streamed_exact`` (``--streamed --exact``, and the default call
  above the host budget): the banded exact engine.  Integer count blocks
  of band x col_chunk genome pairs (``_block_counts``), copied to
  page-locked host memory on a side stream while a worker thread finishes
  earlier blocks in f64 and appends whole bands to the CSV; the bytes of
  ``compute`` + ``write_aji_csv`` in memory that does not grow with the
  genome count.
* ``compute_streamed`` (``--streamed``): the f32 streamed engine.  Masked
  AJI blocks of band x col_chunk genome pairs from the rectangular kernel
  (``_block_sn`` + ``_mask_aji``), copied to page-locked host memory on a
  side stream while a writer thread assembles earlier bands and appends
  them to the CSV; memory that does not grow with the square of the
  genome count.
* ``compute_sharded`` (``--mesh``, the API's ``engine="sharded"``): the
  fused f32 path over a (rows, scp) mesh of ranks, one device each
  (parallel/mesh.py): each rank runs the rectangular kernel on its row
  band and protein shard of the whole presence tensor; the shards' sums
  meet in an all-reduce, the bands in a gather on every rank.
* ``compute_streamed`` and ``compute_streamed_exact`` with ``mesh``
  (``--streamed [--exact] --mesh``): each block cut into the mesh's cells,
  one rank each, the cells gathered to process 0, which alone writes the
  CSV.

The banded engines (the two above and ``compute_fast``'s ``_banded_sn``)
compute a block with one of two bodies, ``_block_sn`` (f32 S and N) and
``_block_counts`` (exact counts), over one of four placements of the
presence (``_placement``): width buckets resident on the device
(``_Resident``, ``to_device_buckets``), or above the device budget
(``_use_staged``: PARFASTAAI_HBM_BYTES, else 75% of the card's memory),
or where ``staged`` / PARFASTAAI_STAGED asks for it, staged slabs: an LRU
of (proteins x genomes x K) slabs on the device (``_Staged``,
``_SlabStore``), gathered on the host and uploaded on demand; over a
mesh, each rank's shard of either (``_MeshResident``, ``_MeshStaged`` on
``_MeshSlabStore``), a staged slab shipped from process 0 where only it
holds the presence tensor.

Every function computes on the device it is given.  ``phases``, where
accepted, is a dict that collects seconds per sub-phase.  Each host-timed
sub-phase is a span of the recorded call too (``utils.timing``; its name
beside its key: ``engine.bucketize`` for ``host bucketize``,
``engine.upload`` for ``H2D``, ...), and the two banded CSV engines' worker
and writer threads record into the call that started them.  ``compute``
and ``compute_fast`` synchronise the device at each phase boundary, which
their host copies do anyway, where a caller reads the split (``phases``
or a recorded call); the two banded CSV engines never do, and read their
device phases from CUDA events after the last block.
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
from .ops.finish import finish_pairs
from .ops.fused import int_gram, pair_counts_device
from .ops.sn_rect import clamp_t, fused_sn_block
from .parallel import distributed
from .parallel.mesh import (
    _reduce,
    assemble_counts,
    cell_rows,
    gather_cells,
    gather_rows,
    make_mesh,
    mesh_key,
    pad_rows,
    protein_layout,
    shard_proteins,
    sharded_fused_sn,
    sharded_fused_sn_rect,
)
from .types import ErrorCode, JacResult, PFAAIError
from .utils import timing
from .utils.timing import span as _span


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
    returns with its work done, a lap reads the host's clock.  A host lap
    is also span ``engine.<stage>`` of the recorded call.  Where nothing
    reads a lap (no ``phases``, and for a host lap no recorded call), the
    clock does nothing and never waits."""

    def __init__(self, device: torch.device, phases: dict | None, sync: bool):
        self._device, self._phases = device, phases
        self._events = device.type == "cuda" and not sync
        self._on = phases is not None or (
            timing.active() and not self._events)
        self._sync = sync and self._on
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
        if self._on:
            self._last = self._now()

    def lap(self, key: str) -> None:
        """Ends the stage ``key`` that began at ``start`` or the last lap."""
        if not self._on:
            return
        now = self._now()
        if self._events:
            self._pairs.append((key, self._last, now))
        else:
            timing.record(_stage_span(key), self._last, now, self._phases,
                          key)
        self._last = now

    def close(self) -> None:
        """Sums the event pairs; every recorded event must have fired."""
        for key, begin, end in self._pairs:
            _add(self._phases, key, begin.elapsed_time(end) / 1e3)
        self._pairs.clear()


def _stage_span(key: str) -> str:
    """The span name of a ``_StageClock`` stage."""
    name = "upload" if key == "H2D" else key.lower()
    return "engine." + name.replace(" ", "_").replace("-", "_")


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
    with _span("engine.upload", phases, "H2D"):
        m = _to_device(presence.m.view(np.int8), device)
        _sync(device)
    return m


def _cached(presence: PresenceData, kind: str, device: torch.device,
            mesh=None, make=None):
    """What ``presence`` keeps of ``kind`` ("buckets" or "slabs") for
    ``device``, and with ``mesh`` for that mesh's rank (``mesh.mesh_key``:
    device, shape, world and rank): made by ``make()`` at first use, so
    later calls reuse it; None where it was never made and ``make`` is
    None."""
    cache = vars(presence).setdefault("_torch_cache", {})
    key = (kind, str(device) if mesh is None else mesh_key(mesh, device))
    if key not in cache and make is not None:
        cache[key] = make()
    return cache.get(key)


def to_device_buckets(
    presence: PresenceData, device: torch.device, phases: dict | None = None
) -> list[tuple[np.ndarray, torch.Tensor, torch.Tensor]]:
    """Width buckets of ``presence`` on ``device``: [(protein_idx, m_b, t_b)]
    with m_b the (Pb, G, Kb) uint8 presence slice and t_b the (Pb, G) f32 T
    clamped to >= 1 (``clamp_t``), in ``bucketize_presence`` order.  Cached
    on the presence object per device, so repeated calls copy nothing."""

    def upload():
        with _span("engine.bucketize", phases, "host bucketize"):
            host = bucketize_presence(presence)
        with _span("engine.upload", phases, "H2D"):
            buckets = [
                (
                    idx,
                    _to_device(np.ascontiguousarray(m_b), device),
                    clamp_t(_to_device(t_b, device)),
                )
                for idx, m_b, t_b in host
            ]
            _sync(device)
            del host  # the host copy's pages go back inside the span
        return buckets

    return _cached(presence, "buckets", device, make=upload)


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
    presence: PresenceData,
    device: torch.device,
    staged: bool | None = None,
    mesh=None,
) -> bool:
    """Staged slabs or resident buckets, the one decision of the banded
    engines, with or without a mesh (the JAX package's two staged
    decisions, parfastaai_tpu.engine._use_staged and its mesh twin): a
    meta-only presence on a mesh (``presence.slab_broadcast``) is staged;
    else ``staged`` or PARFASTAAI_STAGED when either decides
    (``staged_override``); else staged exactly when a rank's share of the
    width-bucketed presence (over a mesh its protein shard of every
    genome, 1 / ``n_scp``) exceeds the device budget.  The CPU reports no
    budget, so a CPU run stages only when asked or under
    PARFASTAAI_HBM_BYTES.  In a run of several processes only process 0's
    answer counts: the callers broadcast it."""
    if mesh is not None and getattr(presence, "slab_broadcast", False):
        return True
    override = staged_override(staged)
    if override is not None:
        return override
    budget = _device_budget(device)
    n_scp = 1 if mesh is None else mesh.n_scp
    return (budget is not None
            and presence_device_bytes(presence) // n_scp > budget)


def _store_cap(device: torch.device) -> int:
    """A slab store's cap: 0.75 of the device budget (4 GiB without one)."""
    budget = _device_budget(device)
    return int((budget if budget is not None else 4 << 30) * 0.75)


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
    """LRU of presence slabs on one device, the staged placement's
    (parfastaai_tpu.engine._slab_store).

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
        """``_store_cap`` of the device budget as it stands."""
        return _store_cap(self._device)

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
        super().__init__(presence, device)
        self._mesh = mesh
        self._cell = mesh.coords if mesh.coords is not None else (0, 0)
        multiproc = distributed.world_size() > 1
        self._broadcast = multiproc and bool(
            getattr(presence, "slab_broadcast", False))
        limits = (_store_cap(device), _slab_target_bytes(device))
        if multiproc:
            limits = distributed.broadcast_pyobj(limits)
        self._cap, self.target = limits

    def cap(self) -> int:
        return self._cap

    def fetch(self, kind: str, idx: np.ndarray, kb: int, ids: np.ndarray):
        idx = np.asarray(idx, np.int64)
        ids = np.asarray(ids, np.int64)
        prot = shard_proteins(idx, self._cell[1], self._mesh.n_scp)
        genomes = cell_rows(self._mesh, ids) if kind == "row" else ids
        return self._fetch(
            (kind, kb, idx.tobytes(), ids.tobytes()),
            len(prot) * len(genomes) * kb,
            lambda: self._upload_shard(kind, idx, kb, ids, prot, genomes))

    def _upload_shard(self, kind, idx, kb, ids, prot, genomes):
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


def slab_stats(
    presence: PresenceData, device: torch.device, mesh=None
) -> dict | None:
    """The counters of the presence's slab store on ``device`` (bytes
    uploaded, peak and held bytes, the cap, uploads and hits; with
    ``mesh``, this rank's store of that mesh, its bytes a rank's), or None
    where nothing was staged."""
    store = _cached(presence, "slabs", device, mesh)
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


def _mask_aji(s: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """One streamed block finished on its device: AJI = S / N in f32 (an
    IEEE divide on the card and on the CPU alike; N to f32 is exact) with
    the cells that share no protein (N == 0) set to 0, as the reference
    leaves them in the CSV.  One f32 array per block crosses to the host
    (parfastaai_tpu.engine._mask_aji)."""
    return torch.where(n == 0, s.new_zeros(()), s / n.to(torch.float32))


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

    def upload():
        n_scp = mesh.n_scp
        G, K = presence.m.shape[1], presence.m.shape[2]
        out = []
        for idx, kb in _bucket_plan(presence):
            layout = np.stack(
                [shard_proteins(idx, s, n_scp) for s in range(n_scp)])
            if mesh.coords is None:
                out.append((layout, None, None))
                continue
            with _span("engine.bucketize", phases, "host bucketize"):
                prot = layout[mesh.coords[1]]
                valid = prot >= 0
                kw = min(kb, K)
                m_host = np.zeros((len(prot), G, kb), np.uint8)
                m_host[valid, :, :kw] = presence.m[prot[valid], :, :kw]
                t_host = _t_rows(presence.t, prot, np.arange(G))
            with _span("engine.upload", phases, "H2D"):
                out.append((layout, _to_device(m_host, device),
                            clamp_t(_to_device(t_host, device))))
                _sync(device)
        return out

    return _cached(presence, "buckets", device, mesh, upload)


class _Placement:
    """Where a banded engine's presence lives on the device, and how one
    output block's protein groups come out of it: the seam between the
    block walks and the two bodies, ``_block_sn`` and ``_block_counts``.

    ``block(rids, cids, drids=None, dcids=None) -> (layout, n_rows,
    groups)``: the index arguments are host arrays, genome ids of the
    block's rows and columns and, where the body asks for denominators,
    the T columns of both.  ``groups`` yields one iterator a width bucket,
    in bucket order, of its groups in protein order: (rows, ma, mb, ta,
    tb), ``ma`` and ``mb`` the group's int8 presence of the rows and the
    columns, ``ta`` and ``tb`` its clamped T (``clamp_t``) of the
    denominators or None, and ``rows`` each protein's row of the count
    block (-1: padding, no row).  Nothing is gathered or uploaded before
    the body asks for the group.  ``layout`` and ``n_rows``: the count
    block's protein layout (None without a mesh: the rows are the proteins
    themselves) and this cell's rows of the block.

    Four placements: ``_Resident`` (width buckets on the device) and
    ``_Staged`` (slabs uploaded on demand), and over a (rows, scp) mesh
    ``_MeshResident`` and ``_MeshStaged``, this rank's cell of them: band r
    of the block's rows, padded with genome 0 to a multiple of the mesh's
    rows, against every column, over protein shard s.  ``upload_lap`` names
    the clock's stage up to a group's arrival, ``end`` the cell's end."""

    staged, upload_lap = False, "gather"

    def __init__(self, presence: PresenceData, device: torch.device,
                 mesh=None):
        self.presence, self.device, self.mesh = presence, device, mesh
        self.wire_dtype = _count_wire_dtype(presence)

    def _cell(self, ids):
        """This cell's band of a block's rows ``ids`` (None: None)."""
        if ids is None:
            return None
        return cell_rows(self.mesh, pad_rows(np.asarray(ids),
                                             self.mesh.n_rows))

    def end(self, s, n, shape: tuple[int, int], clock: _StageClock):
        """The cell's (S, N) once its groups are summed: as they are
        without a mesh; over one, summed over the row's scp group
        (``mesh._reduce``), and zeros of ``shape`` past the mesh."""
        if self.mesh is None:
            return s, n
        if self.mesh.coords is None:
            return _zero_block(*shape, self.device)
        s, n = _reduce(self.mesh, s, n)
        clock.lap("scp all-reduce")
        return s, n


class _Resident(_Placement):
    """Every width bucket on the device (``to_device_buckets``), one group
    a bucket: its rows and columns of the block and their T (``_take``; an
    axis of every genome in order is the bucket itself, ungathered)."""

    def __init__(self, presence, device, mesh=None, phases=None):
        super().__init__(presence, device)
        self._buckets = [(idx, m.view(torch.int8), t) for idx, m, t
                         in to_device_buckets(presence, device, phases)]

    def block(self, rids, cids, drids=None, dcids=None):
        return None, len(rids), self._gather(rids, cids, drids, dcids)

    def _gather(self, *axes):
        g = self.presence.m.shape[1]
        sel = [_selector(ids, g, self.device) for ids in axes
               if ids is not None]

        def group(rows, m, t):
            ma, mb = _take(m, sel[0]), _take(m, sel[1])
            ta, tb = [_take(t, s) for s in sel[2:]] or (None, None)
            yield rows, ma, mb, ta, tb

        return (group(*bucket) for bucket in self._buckets)


class _MeshResident(_Resident):
    """This rank's protein shard of every width bucket (``_mesh_buckets``),
    gathered as ``_Resident`` gathers; the count block's rows are the
    layout's, the buckets' layouts side by side.  Past the mesh: no
    group and no upload."""

    def __init__(self, presence, device, mesh, phases=None):
        _Placement.__init__(self, presence, device, mesh)
        buckets = _mesh_buckets(presence, mesh, device, phases)
        self.layout = np.concatenate([lay for lay, _, _ in buckets], axis=1)
        shard = self.layout[mesh.coords[1] if mesh.coords else 0]
        rows = np.where(shard >= 0, np.arange(len(shard)), -1)
        starts = np.cumsum([0] + [lay.shape[1] for lay, _, _ in buckets])
        self._buckets = [] if mesh.coords is None else [
            (rows[a : a + lay.shape[1]], m.view(torch.int8), t)
            for a, (lay, m, t) in zip(starts, buckets)]

    def block(self, rids, cids, drids=None, dcids=None):
        rl = self._cell(rids)
        groups = () if self.mesh.coords is None else self._gather(
            rl, cids, self._cell(drids), dcids)
        return self.layout, len(rl), groups


class _Staged(_Placement):
    """Slabs from the presence's ``_SlabStore``, one group a chunk of
    ``_split_plan`` at the block's larger side: its row and column slabs
    and its T columns, uploaded clamped."""

    staged, upload_lap = True, "slab upload"

    def __init__(self, presence, device, mesh=None, phases=None):
        super().__init__(presence, device)
        self._store = _cached(presence, "slabs", device,
                              make=lambda: _SlabStore(presence, device))
        self._plan = _bucket_plan(presence)

    def block(self, rids, cids, drids=None, dcids=None):
        rids, cids = np.asarray(rids), np.asarray(cids)
        fetch, t, dev = self._store.fetch, self.presence.t, self.device
        chunks = _split_plan(self._plan, max(len(rids), len(cids)), dev)

        def group(bucket):
            for _, _, idx, kb in bucket:
                ma, mb = fetch(idx, kb, rids), fetch(idx, kb, cids)
                ta = tb = None
                if drids is not None:
                    ta = clamp_t(_to_device(t[np.ix_(idx, drids)], dev))
                    tb = clamp_t(_to_device(t[np.ix_(idx, dcids)], dev))
                yield idx, ma, mb, ta, tb

        return None, len(rids), (
            group(bucket)
            for _, bucket in itertools.groupby(chunks, key=lambda c: c[0]))


class _MeshStaged(_Placement):
    """This cell's shard of each staged slab (``_MeshSlabStore``), one group
    a chunk of ``_split_plan`` (with the store's slab target) and its T
    (clamped, zeros for padding proteins); the count block's rows are the
    chunks' shards in turn (``mesh.protein_layout``).  Every rank fetches
    every chunk, so a rank past the mesh joins a meta-only run's slab
    broadcasts, and then yields no group."""

    staged, upload_lap = True, "slab upload"

    def __init__(self, presence, device, mesh, phases=None):
        super().__init__(presence, device, mesh)
        self._store = _cached(presence, "slabs", device, mesh,
                              lambda: _MeshSlabStore(presence, device, mesh))
        self._plan = _bucket_plan(presence)

    def block(self, rids, cids, drids=None, dcids=None):
        mesh, store, t = self.mesh, self._store, self.presence.t
        dev = self.device
        chunks = list(_split_plan(
            self._plan, max(len(rids), len(cids)), dev, store.target))
        layout = protein_layout([c[2] for c in chunks], mesh.n_scp)
        shard = layout[mesh.coords[1] if mesh.coords else 0]
        starts = np.cumsum([0] + [-(-len(c[2]) // mesh.n_scp)
                                  for c in chunks])
        rids, cids = pad_rows(np.asarray(rids), mesh.n_rows), np.asarray(cids)
        drl = self._cell(drids)

        def group(bucket):
            for a, b, (_, _, idx, kb) in bucket:
                ma = store.fetch("row", idx, kb, rids)
                mb = store.fetch("col", idx, kb, cids)
                if mesh.coords is None:
                    continue
                prot = shard[a:b]
                ta = tb = None
                if drl is not None:
                    ta = clamp_t(_to_device(_t_rows(t, prot, drl), dev))
                    tb = clamp_t(_to_device(
                        _t_rows(t, prot, np.asarray(dcids)), dev))
                yield (np.where(prot >= 0, np.arange(a, b), -1), ma, mb,
                       ta, tb)

        spans = zip(starts, starts[1:], chunks)
        return layout, len(rids) // mesh.n_rows, (
            group(bucket)
            for _, bucket in itertools.groupby(spans, key=lambda c: c[2][0]))


def _placement(presence: PresenceData, device: torch.device, staged: bool,
               mesh=None, phases: dict | None = None) -> _Placement:
    """The presence placed for a banded engine: staged slabs where
    ``staged`` (``_use_staged``'s answer), else resident buckets; over
    ``mesh``, this rank's cell of them.  ``phases`` collects a resident
    upload's ``host bucketize`` and ``H2D`` seconds."""
    kinds = (_Resident, _Staged) if mesh is None else (_MeshResident,
                                                       _MeshStaged)
    return kinds[bool(staged)](presence, device, mesh, phases)


def _block_sn(place: _Placement, rids, cids, drids, dcids,
              approx: bool = False, precise: bool = False,
              clock: _StageClock | None = None):
    """(S, N) device tensors of one output block from ``place``: the
    rectangular kernel on each group, a bucket's chunks summed in chunk
    order and the buckets in bucket order, then the placement's end of the
    cell (over a mesh, the scp all-reduce: a one-row mesh gives one
    device's values, protein shards add their sums at the end, ~1e-7).  A
    staged bucket cut into one chunk, or into chunks of one protein each,
    gives the resident values bit for bit; other cuts change the f32 order
    of S within a bucket (~1e-7), and N not at all.

    ``clock`` laps the placement's ``upload_lap`` (``gather``, or ``slab
    upload``: the host gather, page-locking and the copies of a chunk's
    slabs and T), ``kernel`` and, over a mesh, ``scp all-reduce``.  The
    default synchronises the device at each stage boundary; a caller that
    pipelines blocks passes its own ``_StageClock(..., sync=False)``, with
    which the call enqueues its work and returns without waiting for the
    device.  The values are the same either way."""
    if clock is None:
        clock = _StageClock(place.device, None, sync=True)
    clock.start()
    _, n_rows, groups = place.block(rids, cids, drids, dcids)
    s = n = None
    for bucket in groups:
        s_b = n_b = None
        for _, ma, mb, ta, tb in bucket:
            clock.lap(place.upload_lap)
            s_c, n_c = fused_sn_block(
                ma, mb, ta, tb, approx=approx, precise=precise
            )
            s_b = s_c if s_b is None else s_b + s_c
            n_b = n_c if n_b is None else n_b + n_c
            clock.lap("kernel")
        if s_b is not None:
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
    return place.end(s, n, (n_rows, len(cids)), clock)


def _block_counts(place: _Placement, rids, cids):
    """Exact intersection counts of one output block from ``place``, on the
    device in the wire dtype (int16 when max(T) < 2^15, which halves the
    copy to the host).

    Each group's per-protein int8 Grams (``ops.fused.int_gram``) are
    written straight into their rows of the block, so the block is in
    ascending protein order, the order of the f64 finish that byte parity
    rides on, and one copy carries it to the host.  Without a mesh the
    block is (P, len(rids), len(cids)), every row written, nothing padded.
    Over a mesh it is this cell's (rows of layout, band / rows,
    len(cids)), padding rows 0, returned as ``(counts, layout)``: no
    collective, process 0 gathers the cells and puts every row in its
    place (``mesh.gather_cells``, ``mesh.assemble_counts``).  Counts are
    integers, so no placement changes a value."""
    layout, n_rows, groups = place.block(rids, cids)
    shape = (len(place.presence.t) if layout is None else layout.shape[1],
             n_rows, len(cids))
    new = torch.empty if layout is None else torch.zeros
    out = new(shape, dtype=place.wire_dtype, device=place.device)
    for bucket in groups:
        for rows, ma, mb, _, _ in bucket:
            for j, r in enumerate(rows):
                if r >= 0:
                    out[int(r)] = int_gram(ma[j], mb[j])
    return out if layout is None else (out, layout)


def _staged_col_group(place: _Placement, band: int, col_chunk: int,
                      n_chunks: int) -> int:
    """Column chunks per group of ``_banded_sn``'s column-group-major walk
    (parfastaai_tpu.engine._staged_col_group): as many as fit, with one
    row band's slabs, into 0.8 of the slab store's cap (``_store_cap``).
    Resident placements get ``n_chunks``: one group, the row-major
    walk."""
    if n_chunks <= 1 or not place.staged:
        return max(1, n_chunks)
    presence = place.presence
    g = max(1, presence.m.shape[1])
    per_genome = presence_device_bytes(presence) / g
    avail = _store_cap(place.device) - band * per_genome
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
    in band x col_chunk device blocks (``_block_sn`` on the placement that
    ``_use_staged`` picks).

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
    place = _placement(presence, device,
                       _use_staged(presence, device, staged), phases=phases)
    clock = _StageClock(device, phases, sync=True)
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
    group_n = _staged_col_group(place, band, col_chunk, len(col_starts))
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
                s_b, n_b = _block_sn(
                    place, rids, padded(col_ids, c0, col_chunk), drids,
                    padded(col_denom_ids, c0, col_chunk), approx, precise,
                    clock,
                )
                with _span("engine.d2h", phases, "D2H"):
                    s[r0 : r0 + nr, c0 : c0 + nc] = (
                        s_b[:nr, :nc].cpu().numpy())
                    n[r0 : r0 + nr, c0 : c0 + nc] = (
                        n_b[:nr, :nc].cpu().numpy())
    if symmetric:
        with _span("engine.assembly", phases, "host assembly"):
            for r0 in range(0, len(row_ids), band):
                r1 = min(r0 + band, len(row_ids))
                s[r0:r1, :r0] = s[:r0, r0:r1].T
                n[r0:r1, :r0] = n[:r0, r0:r1].T
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
    """Exact path: integer counts on the device, then the f64 finish in
    ascending protein order (bit-parity with the reference and the JAX
    package).  On a card the finish runs there (ops.finish, its kernel) on
    the counts where they lie, and only S and N are downloaded; on the CPU
    it is the host's ``jaccard_finish``.  Span ``engine.finish`` counts the
    pairs the card finished (``device_finish_pairs``: n_pairs or 0)."""
    out_dtype = _count_wire_dtype(presence)
    m = upload_presence(presence, device, phases)
    with _span("engine.gram", phases, "Gram"):
        counts_d = pair_counts_device(m, pairs.db_a, pairs.db_b, out_dtype)
        _sync(device)
        n_prot, n_genomes = m.shape[:2]
        # Entries the per-protein G x G Grams compute, and those the pairs
        # keep of them.
        timing.count(gram_cells=n_prot * n_genomes * n_genomes,
                     gathered=n_prot * pairs.n_pairs)
    del m
    if device.type == "cuda":
        with _span("engine.finish", phases, "host finish"):
            timing.count(device_finish_pairs=pairs.n_pairs)
            with _span("engine.finish.gather"):
                # Pageable copies: a few MB, kept out of the pinned cache.
                t_d, ids_a, ids_b = (
                    torch.from_numpy(np.ascontiguousarray(x, np.int32))
                    .to(device)
                    for x in (presence.t, pairs.denom_a, pairs.denom_b)
                )
                _sync(device)
            with _span("engine.finish.sum"):
                s_d, n_d = finish_pairs(counts_d, t_d, ids_a, ids_b)
                _sync(device)
            del counts_d, t_d, ids_a, ids_b
        with _span("engine.d2h", phases, "D2H"):
            s, n = s_d.cpu().numpy(), n_d.cpu().numpy()
        return _result(pairs, s, n)
    with _span("engine.d2h", phases, "D2H"):
        counts = counts_d.cpu().numpy()
    with _span("engine.finish", phases, "host finish"):
        timing.count(device_finish_pairs=0)
        del counts_d
        t = presence.t
        with _span("engine.finish.gather"):
            ta, tb = t[:, pairs.denom_a], t[:, pairs.denom_b]
        with _span("engine.finish.sum"):
            s, n = jaccard_finish(counts, ta, tb)
        del ta, tb
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
            with _span("engine.pair_gather", phases, "pair gather"):
                s = s_mat[qidx_of[pairs.db_a], pairs.db_b]
                n = n_mat[qidx_of[pairs.db_a], pairs.db_b]
        else:
            ids = np.arange(G, dtype=np.int32)
            s_mat, n_mat = _banded_sn(
                presence, ids, ids, ids, ids, device, **fast
            )
            with _span("engine.pair_gather", phases, "pair gather"):
                s = s_mat[pairs.db_a, pairs.db_b]
                n = n_mat[pairs.db_a, pairs.db_b]
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
    if n_rows is None:
        n_rows = max(1, distributed.world_size() // n_scp)
    mesh = make_mesh(n_rows, n_scp)

    def gathered(s_b, n_b, rows: int):
        with _span("engine.row_gather", phases, "row gather"):
            s_mat = gather_rows(mesh, s_b)[:rows]
            n_mat = gather_rows(mesh, n_b)[:rows]
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
    event pairs read after the last block (``close``); on the CPU both stay
    0, and with ``phases`` each block's compute is span ``engine.gram``,
    its host seconds in ``phases["Gram"]``.  ``wait_s``: seconds ``fetch``
    waited for a free buffer (spans ``engine.producer_wait``)."""

    def __init__(
        self,
        device: torch.device,
        max_numel: int,
        dtype: torch.dtype,
        n_buffers: int,
        phases: dict | None = None,
    ):
        self.compute_s = self.d2h_s = 0.0
        self._phases = phases
        self._waited: dict[str, float] = {}
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
            if self._phases is None:
                return _Download(compute_block())
            with _span("engine.gram", self._phases, "Gram"):
                return _Download(compute_block())
        with _span("engine.producer_wait", self._waited, "producer wait"):
            buf = self._free.get()
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

    @property
    def wait_s(self) -> float:
        return self._waited.get("producer wait", 0.0)

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


def _in_call_thread(target, name: str) -> threading.Thread:
    """A daemon thread running ``target`` inside the recorded call of the
    thread that makes it (under its innermost open span)."""
    handed = timing.handoff()

    def run() -> None:
        with timing.attached(handed):
            target()

    return threading.Thread(target=run, name=name, daemon=True)


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
    (``_block_counts``), runs the banded f64 finish
    (``jaccard_finish_block``, the operation order of ``compute``'s finish)
    and appends the CSV rows of each completed band.  Memory is
    O(P * band * col_chunk) on the host and on the device beside the
    resident presence, whatever G is.  Where ``_use_staged`` says so
    (``staged``, PARFASTAAI_STAGED, or presence above the device budget)
    the counts come from staged slabs instead of resident buckets
    (``_placement``), with the same bytes out.

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
    mesh's ranks (resident shards, or staged ones where ``_use_staged``
    says so or the presence is meta-only), the band rounded up to a
    multiple of the mesh's rows; every rank runs the block walk and joins
    one gather per block, and process 0 puts the cells together and runs
    the worker, the mirror store and the CSV alone.
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
    the assembly on process 0.  In a recorded call (``utils.timing``) the
    main thread's spans are ``engine.open``, ``engine.block`` (one block's
    enqueue), ``engine.producer_wait`` and ``engine.tail`` (the end mark
    to the worker's join), the worker's ``worker.wait``, ``worker.finish``
    and ``worker.csv`` (one a band, counter ``rows``); the caller's open
    span gets counters ``blocks`` and ``mirrored``.
    """
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
        staged_active = _use_staged(presence, device, staged, mesh)
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
    with _span("engine.open"):
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
                with _span("worker.csv", busy, "CSV write"):
                    # Same-genome cells are untouched in the reference => 0.
                    rows_aji[cur_rids[:, None] == col_ids[None, :]] = 0.0
                    for i, row in enumerate(
                            format_matrix(rows_aji, separator)):
                        fp.write(
                            row_names[cur_r0 + i] + separator + row + "\n")
                    timing.count(rows=len(rows_aji))
                    rows_aji = None

            while True:
                with _span("worker.wait", busy, "worker wait"):
                    item = work_q.get()
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
                    with _span("worker.finish", busy, "host finish"):
                        rows_aji[:, c0 : c0 + nc] = mirror.pop(data).T
                    continue
                download, store_key = data
                with _span("worker.wait", busy, "worker wait"):
                    counts = download.wait()
                with _span("worker.finish", busy, "host finish"):
                    s, n = jaccard_finish_block(
                        counts, t[:, drids], t[:, dcids])
                    del counts
                    download.release()
                    download = None
                    with np.errstate(divide="ignore", invalid="ignore"):
                        blk = s / n  # 0/0 -> nan (parity)
                    rows_aji[:, c0 : c0 + nc] = blk
                    if store_key is not None:
                        mirror[store_key] = blk
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
        with _span("engine.producer_wait", busy, "producer wait"):
            work_q.put(item)

    worker = None
    n_blocks = n_mirrored = 0
    try:
        place = _placement(presence, device, staged_active, mesh, phases)
        if mesh is None:
            downloads = _BlockDownloads(
                device, P * band * col_chunk, _count_wire_dtype(presence),
                n_buffers=work_q.maxsize + 2, phases=phases,
            )

        def counts_of(rids, cids):
            """The block's counts on their way to process 0's worker."""
            if mesh is None:
                return downloads.fetch(
                    lambda: _block_counts(place, rids, cids))
            with _span("engine.gram", phases, "Gram"):
                counts, layout = _block_counts(place, rids, cids)
                _sync(device)
            with _span("engine.count_gather", phases, "count gather"):
                cells = gather_cells(mesh, counts)  # every rank joins
                host = (assemble_counts(mesh, cells, layout, P, len(rids))
                        if primary else None)
            return _Download(torch.from_numpy(host)) if primary else None

        if primary:
            worker = _in_call_thread(_worker, "pfaai-exact-finish")
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
                    n_mirrored += 1
                else:
                    with _span("engine.block"):
                        download = counts_of(rids, cids)
                    data = (download, (bi, ci) if sym and ci > bi else None)
                    kind = "counts"
                    n_blocks += 1
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
            with _span("engine.tail"):
                work_q.put(None)
                worker.join()
        if fp is not None:
            fp.close()
    timing.count(blocks=n_blocks, mirrored=n_mirrored)
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
    pass of the rectangular kernel per width bucket (``_block_sn``),
    summed in bucket order, finished on the device by ``_mask_aji`` and
    copied to the host as one f32 array.  Host memory is O(band x G)
    beside the presence tensor (plus the mirror store below) and the CSV
    grows in row order: a header of column names, one row per row genome,
    same-genome cells and cells that share no protein ``0``.  f32 on the
    device (~1e-7 relative, like ``compute_fast``).

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
    queue).  The stages overlap, so they do not sum to the wall.  In a
    recorded call (``utils.timing``) the main thread's spans are those of
    ``compute_streamed_exact``, and the writer's ``writer.wait``,
    ``writer.assembly`` and ``writer.csv`` (one a band, counter ``rows``).

    Staged slabs (``staged``, PARFASTAAI_STAGED, or presence above the
    device budget: ``_use_staged``): blocks come from staged slabs
    (``_placement``), and the column walk runs right to left in every
    other band (the reference's snake order), so the column slabs of a
    band's last chunks, still in the slab store, open the next band.  The
    writer places each chunk at its c0, so the bytes do not depend on the
    order.

    ``mesh`` (``parallel.mesh.make_mesh``): each block is cut into the
    mesh's cells (resident shards, or staged ones where ``_use_staged``
    says so or the presence is meta-only), the band rounded up to a
    multiple of the mesh's rows.  Every rank runs the block walk and joins
    one gather of the masked cells per block; process 0 runs the writer,
    the mirror store and the CSV alone.  A one-row mesh
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
        staged_active = _use_staged(presence, device, staged, mesh)
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
    with _span("engine.open"):
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
                with _span("writer.wait", busy, "writer wait"):
                    item = work_q.get()
                if item is None:
                    return  # a band without its end mark is not written
                r0, rids, chunk = item
                if rows_aji is None:
                    rows_aji = np.empty(
                        (len(rids), len(col_ids)), dtype=np.float32
                    )
                if chunk is not None:
                    c0, nc, download = chunk
                    with _span("writer.wait", busy, "writer wait"):
                        block = download.wait()
                    with _span("writer.assembly", busy, "host assembly"):
                        rows_aji[:, c0 : c0 + nc] = block
                        del block
                        download.release()
                        download = None
                    continue
                # The band's end: every computed chunk is in place.
                with _span("writer.assembly", busy, "host assembly"):
                    if sym:
                        # The skipped region [0, fill_end): transposed
                        # slices of the earlier bands (all complete: only
                        # the last band can be short, and nothing mirrors
                        # from it).
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
                with _span("writer.csv", busy, "CSV write"):
                    for i0 in range(0, len(rids), slab_rows):
                        slab = rows_aji[i0 : i0 + slab_rows].astype(
                            np.float64)
                        for i, row in enumerate(
                                format_matrix(slab, separator)):
                            fp.write(row_names[r0 + i0 + i] + separator
                                     + row + "\n")
                    timing.count(rows=len(rids))
                    rows_aji = None
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
        with _span("engine.producer_wait", busy, "producer wait"):
            work_q.put(item)

    writer = None
    n_blocks = n_mirrored = 0
    # The mesh's blocks meet in a gather that waits for the device anyway:
    # its stages are host seconds around syncs.
    clock = _StageClock(device, phases, sync=mesh is not None)
    try:
        place = _placement(presence, device, staged_active, mesh, phases)
        if mesh is None:
            downloads = _BlockDownloads(
                device, band * col_chunk, torch.float32,
                n_buffers=work_q.maxsize + 2,
            )

        def block_aji(rids, cids, drids, dcids) -> torch.Tensor:
            aji = _mask_aji(*_block_sn(place, rids, cids, drids, dcids,
                                       approx, precise, clock))
            clock.lap("AJI mask")
            return aji

        def aji_of(rids, cids, drids, dcids):
            """The block's AJI on its way to process 0's writer."""
            if mesh is None:
                return downloads.fetch(
                    lambda: block_aji(rids, cids, drids, dcids))
            cell = block_aji(rids, cids, drids, dcids)
            with _span("engine.row_gather", phases, "row gather"):
                rows = gather_rows(mesh, cell)  # every rank joins
            if not primary:
                return None
            return _Download(
                torch.from_numpy(np.ascontiguousarray(rows[: len(rids)])))

        if primary:
            writer = _in_call_thread(_writer, "pfaai-csv-writer")
            writer.start()
        c0s = list(range(0, len(col_ids), col_chunk))
        for bi, r0 in enumerate(range(rows_done, len(row_ids), band)):
            rids = row_ids[r0 : r0 + band]
            drids = row_denom_ids[r0 : r0 + band]
            snake = staged_active and bi % 2 == 1
            for c0 in reversed(c0s) if snake else c0s:
                if sym and c0 + col_chunk <= r0:
                    n_mirrored += 1
                    continue  # below the diagonal: the writer mirrors it
                cids = col_ids[c0 : c0 + col_chunk]
                dcids = col_denom_ids[c0 : c0 + col_chunk]
                with _span("engine.block"):
                    download = aji_of(rids, cids, drids, dcids)
                n_blocks += 1
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
            with _span("engine.tail"):
                work_q.put(None)
                writer.join()
        if fp is not None:
            fp.close()
    timing.count(blocks=n_blocks, mirrored=n_mirrored)
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
