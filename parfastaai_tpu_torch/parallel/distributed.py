"""Multi-process runs of the port: one process (rank) per mesh device.

Counterpart of parfastaai_tpu/parallel/distributed.py on
``torch.distributed``.  The JAX package runs one process per host with
every local chip in it; here every process drives one device, so the
port's device count is the world size, and a one-host run on four GPUs is
four processes.

Launch (every process runs the same command):

* ``PARFASTAAI_COORDINATOR=host:port``, ``PARFASTAAI_NUM_PROCESSES=N`` and
  ``PARFASTAAI_PROCESS_ID=i``, as for the JAX package: the process group
  meets at ``tcp://host:port`` (process 0 listens there);
* or torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
  ``WORLD_SIZE`` (``env://``).

Device of a rank: ``cuda:LOCAL_RANK`` where the launcher sets it, else
``cuda:(rank % device_count)``; ``--device cpu`` puts every rank on the
CPU.  Backend: NCCL where the run is on CUDA and every rank of the node
has a card of its own (``LOCAL_WORLD_SIZE``, else the world size, at most
``torch.cuda.device_count()``); gloo where ranks share a card (NCCL
refuses two ranks on one device) or run on the CPU.  Under gloo every
collective here takes host tensors (``wire``): the kernels still run on
the card, only the transport moves to the host.

Nothing falls back: a failed ``init_process_group`` raises, and a rank
never goes on as a one-process run.  With one process every function is
the identity and makes no collective.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

# Default chunk of packed presence bits per broadcast (PARFASTAAI_BCAST_
# CHUNK_BYTES overrides), as in the JAX package.
BCAST_CHUNK_BYTES = 256 * 1024**2


def _backend(device: str, world: int) -> str:
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    nccl = (device == "cuda" and dist.is_nccl_available()
            and torch.cuda.is_available()
            and torch.cuda.device_count() >= local)
    return "nccl" if nccl else "gloo"


def init_distributed(device: str = "cuda") -> bool:
    """Join the process group when launched as several processes.

    Returns True when a process group is up (this call's or an earlier
    one's), False for a plain one-process run (no launch environment).
    Runs before anything touches a device: under NCCL it makes the rank's
    card the current one first.  ``device`` is the run's device name
    (``"cuda"`` or ``"cpu"``), which picks the backend."""
    if dist.is_initialized():
        return True
    coord = os.environ.get("PARFASTAAI_COORDINATOR")
    torchrun = all(
        k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")
    )
    if coord is None and not torchrun:
        return False
    if coord is not None:
        world = int(os.environ["PARFASTAAI_NUM_PROCESSES"])
        rank_ = int(os.environ["PARFASTAAI_PROCESS_ID"])
        kw = dict(init_method=f"tcp://{coord}", world_size=world, rank=rank_)
    else:
        world, rank_ = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        kw = dict(init_method="env://")
    backend = _backend(device, world)
    if backend == "nccl":
        torch.cuda.set_device(rank_device_index(rank_))
    dist.init_process_group(backend, **kw)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns the output files (one writer, as the
    reference's single process: src/main.cpp:133-175)."""
    return rank() == 0


def backend() -> str | None:
    """The process group's backend (``"nccl"`` or ``"gloo"``), None in a
    one-process run."""
    return dist.get_backend() if dist.is_initialized() else None


def rank_device_index(rank_: int | None = None) -> int:
    """The CUDA device index of rank ``rank_`` (default: this one):
    LOCAL_RANK, else the rank, modulo the card count."""
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else (
        rank() if rank_ is None else rank_)
    return idx % max(1, torch.cuda.device_count())


def wire() -> torch.device:
    """Where collective tensors live: the rank's card under NCCL, the host
    under gloo (and in a one-process run)."""
    if backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def close() -> None:
    """Leave the process group (the end of a multi-process run)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def gather_to_host(x) -> np.ndarray:
    """Every rank's ``x`` (same shape and dtype on each), concatenated
    along axis 0 in rank order, as a numpy array on every rank."""
    if world_size() <= 1:
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    t = t.contiguous().to(wire())
    parts = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def _bcast(t: torch.Tensor) -> torch.Tensor:
    """Process 0's ``t`` (a host tensor of the same shape on every rank)
    on every rank, as a host tensor."""
    w = t.to(wire())
    dist.broadcast(w, src=0)
    return w.cpu()


def broadcast_from_primary(value: int) -> int:
    """Process 0's integer on every rank."""
    if world_size() <= 1:
        return value
    return int(_bcast(torch.tensor([value], dtype=torch.int64))[0])


def broadcast_pyobj(obj):
    """One picklable object from process 0 on every rank (the others'
    ``obj`` is ignored): its length, then its pickled bytes."""
    if world_size() <= 1:
        return obj
    if is_primary():
        data = np.frombuffer(
            pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL), np.uint8
        )
    else:
        data = np.zeros(0, np.uint8)
    n = broadcast_from_primary(len(data))
    buf = torch.zeros(n, dtype=torch.uint8)
    if is_primary():
        buf.copy_(torch.from_numpy(data.copy()))
    return pickle.loads(_bcast(buf).numpy().tobytes())


def broadcast_bytes(data: np.ndarray | None, shape) -> np.ndarray:
    """Process 0's uint8 array ``data`` of ``shape`` on every rank (the
    others pass None), as a host array."""
    if world_size() <= 1:
        return data
    if is_primary():
        t = torch.from_numpy(np.ascontiguousarray(data, np.uint8))
    else:
        t = torch.zeros(tuple(shape), dtype=torch.uint8)
    return _bcast(t).numpy()


def picklable(exc: BaseException) -> BaseException:
    """``exc`` where it survives pickling (so that ``broadcast_pyobj`` can
    carry it to every rank), else a RuntimeError that names it."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:  # noqa: BLE001 — any failure to pickle
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def broadcast_presence(presence, error=None, meta_only: bool = False):
    """Single-reader ETL: only process 0 opened the database; its
    PresenceData, or its failure, reaches every rank.

    ``error``: process 0's exception, if any.  It travels in the header's
    place, so every rank raises it instead of waiting in a collective that
    process 0 never joins.  ``meta_only`` (process 0's decision, carried
    by the header): no tensor is sent; the other ranks get a PresenceData
    whose ``m`` is a ``MetaOnlyM`` shape stub, and every rank's presence
    is marked ``slab_broadcast = True`` (the staged-mesh engines ship
    slabs on demand).  Otherwise the 0/1 presence travels bit-packed
    (``np.packbits``) in chunks along P of at most
    PARFASTAAI_BCAST_CHUNK_BYTES packed bytes (default 256 MiB); T,
    widths and tetramer ids travel pickled.  Process 0 keeps its own
    object.  With one process: ``presence``, or ``error`` raised."""
    if world_size() <= 1:
        if error is not None:
            raise error
        return presence
    from ..etl.database import MetaOnlyM, PresenceData

    primary = is_primary()
    header = None
    if primary:
        header = error if error is not None else {
            "meta": presence.meta,
            "shape": tuple(presence.m.shape),
            "t": presence.t,
            "widths": presence.widths,
            "tetramer_ids": presence.tetramer_ids,
            "meta_only": bool(meta_only),
        }
    header = broadcast_pyobj(header)
    if isinstance(header, BaseException):
        raise header
    if header["meta_only"]:
        out = presence if primary else PresenceData(
            meta=header["meta"],
            m=MetaOnlyM(header["shape"]),
            t=header["t"],
            widths=header["widths"],
            tetramer_ids=header["tetramer_ids"],
        )
        out.slab_broadcast = True
        return out
    P, G, K = header["shape"]
    kb = (K + 7) // 8
    chunk_bytes = int(float(
        os.environ.get("PARFASTAAI_BCAST_CHUNK_BYTES", BCAST_CHUNK_BYTES)
    ))
    p_step = max(1, min(P, chunk_bytes // max(1, G * kb)))
    packed = None if primary else np.empty((P, G, kb), np.uint8)
    for p0 in range(0, P, p_step):
        p1 = min(P, p0 + p_step)
        if primary:
            chunk = torch.from_numpy(
                np.packbits(np.ascontiguousarray(presence.m[p0:p1]), axis=-1)
            )
        else:
            chunk = torch.zeros((p1 - p0, G, kb), dtype=torch.uint8)
        got = _bcast(chunk)
        if not primary:
            packed[p0:p1] = got.numpy()
    if primary:
        return presence
    return PresenceData(
        meta=header["meta"],
        m=np.unpackbits(packed, axis=-1, count=K),
        t=header["t"],
        widths=header["widths"],
        tetramer_ids=header["tetramer_ids"],
    )
