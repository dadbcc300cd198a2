"""The (rows, scp) mesh of ranks over the rectangular kernel.

Counterpart of parfastaai_tpu/parallel/mesh.py.  Two axes, as there:

* ``rows``: data parallelism over genome row bands; each mesh cell owns a
  band of output rows against every column genome.
* ``scp``: the protein axis in contiguous shards; each cell holds P/scp
  proteins of every genome, and the partial (S, N) of a row's cells are
  summed by an all-reduce over that row's scp group (the JAX package's
  ``psum`` over ``scp``).

One process (rank) per mesh cell: rank ``r * scp + s`` holds cell (r, s),
row-major as ``make_mesh`` lays the JAX package's devices out.  Ranks past
``rows * scp`` compute nothing, as the JAX package's devices past
``devices[:n]`` do, but join the row gather, so every rank ends with the
whole result.

Each rank's program (the JAX package's ``_body`` / ``_body_rect``) is
plain code on its own shard: it uploads only its protein shard
(``upload_shard``), cuts its row band once (``row_band``), and calls
``ops.sn_rect.fused_sn_block`` on the rank's device, which launches
csrc/sn_rect.cu on a card and runs ``fused_sn_block_plain`` on the CPU;
the all-reduce over scp (``_reduce``) comes after.  The collectives stay
apart from the program, so a test can run every cell of a mesh in one
process and add the scp partials itself.  Under gloo the collectives take
host copies made here (``distributed.wire``).

Not ported: ``use_pallas_on_mesh`` and the XLA-scan body; the kernel or
its plain version is picked by the device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.sn_rect import clamp_t, fused_sn_block
from . import distributed


class Mesh:
    """A (rows, scp) mesh over the ranks of the process group.

    ``coords``: this rank's (r, s), or None past the mesh.  ``scp_group``:
    the process group of this rank's row (its scp cells), None where there
    is nothing to reduce (scp == 1, one process, or a rank past the
    mesh)."""

    def __init__(self, n_rows: int, n_scp: int, coords, scp_group):
        self.n_rows, self.n_scp = n_rows, n_scp
        self.coords = coords
        self.scp_group = scp_group

    @property
    def shape(self) -> dict:
        return {"rows": self.n_rows, "scp": self.n_scp}


def make_mesh(n_rows: int, n_scp: int = 1) -> Mesh:
    """The mesh of the first ``n_rows * n_scp`` ranks.  Every rank creates
    every row's scp group, in row order, as ``dist.new_group`` needs."""
    world = distributed.world_size()
    n = n_rows * n_scp
    if world < n:
        raise ValueError(f"Need {n} devices, have {world}")
    rank = distributed.rank()
    scp_group = None
    if world > 1 and n_scp > 1:
        for r in range(n_rows):
            ranks = list(range(r * n_scp, (r + 1) * n_scp))
            group = dist.new_group(ranks)
            if rank in ranks:
                scp_group = group
    coords = divmod(rank, n_scp) if rank < n else None
    return Mesh(n_rows, n_scp, coords, scp_group)


def _check(mesh: Mesh, m_shape, a: int) -> int:
    """The row band of a mesh over (P, a, K) inputs; the JAX package's
    ValueError where a or P does not divide by the mesh."""
    if a % mesh.n_rows or m_shape[0] % mesh.n_scp:
        raise ValueError(
            f"shape {tuple(m_shape)} not divisible by mesh {mesh.shape}"
        )
    return a // mesh.n_rows


def upload_shard(
    m: np.ndarray, t: np.ndarray, s: int, n_scp: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """Protein shard ``s`` of ``n_scp`` (contiguous P/scp proteins, every
    genome) on ``device``: the int8 presence by a page-locked copy, T
    through ``clamp_t``."""
    from ..engine import _to_device

    p = m.shape[0] // n_scp
    m_loc = _to_device(np.ascontiguousarray(m[s * p : (s + 1) * p]), device)
    t_loc = _to_device(np.ascontiguousarray(t[s * p : (s + 1) * p]), device)
    return m_loc.view(torch.int8), clamp_t(t_loc)


def row_band(x: torch.Tensor, r: int, band: int) -> torch.Tensor:
    """Row band ``r`` of a shard ((P/scp, G, K) presence or (P/scp, G) T),
    contiguous for the kernel: a device copy, made once per run (none for
    a one-row mesh)."""
    return x[:, r * band : (r + 1) * band].contiguous()


def _reduce(mesh: Mesh, s: torch.Tensor, n: torch.Tensor):
    """The cell's partial summed over its row's scp group (on the wire's
    device: the card under NCCL, the host under gloo)."""
    if mesh.scp_group is None:
        return s, n
    s, n = s.to(distributed.wire()), n.to(distributed.wire())
    dist.all_reduce(s, group=mesh.scp_group)
    dist.all_reduce(n, group=mesh.scp_group)
    return s, n


def _clock(device: torch.device, phases: dict | None):
    from ..engine import _StageClock

    clock = _StageClock(device, phases, sync=True)
    clock.start()
    return clock


def sharded_fused_sn_rect(mesh: Mesh, ma, mb, ta, tb, device: torch.device,
                          phases: dict | None = None):
    """Rectangular fused (S, N) over the mesh: the A side banded over
    ``rows``, the protein axis sharded over ``scp`` and summed, the B side
    whole on every cell.

    ma (P, A, K) / mb (P, B, K) 0/1 uint8 and ta (P, A) / tb (P, B) int32
    denominator T, on the host, the same on every rank; A divisible by
    ``rows`` and P by ``scp`` (zero genomes and empty proteins are inert
    padding).  Returns this rank's row band (S f32 (A/rows, B), N int32),
    summed over scp; zeros past the mesh.  ``gather_rows`` assembles the
    bands.  ``phases`` collects ``H2D``, ``kernel`` and ``scp
    all-reduce`` seconds."""
    band = _check(mesh, ma.shape, ma.shape[1])
    if mesh.coords is None:
        return _idle(band, mb.shape[1])
    r, s = mesh.coords
    clock = _clock(device, phases)
    ma_loc, ta_loc = upload_shard(ma, ta, s, mesh.n_scp, device)
    mb_loc, tb_loc = upload_shard(mb, tb, s, mesh.n_scp, device)
    ma_band, ta_band = row_band(ma_loc, r, band), row_band(ta_loc, r, band)
    clock.lap("H2D")
    s_b, n_b = fused_sn_block(ma_band, mb_loc, ta_band, tb_loc)
    clock.lap("kernel")
    out = _reduce(mesh, s_b, n_b)
    clock.lap("scp all-reduce")
    return out


def _idle(band: int, b: int):
    """The (S, N) a rank past the mesh brings to the row gather."""
    dev = distributed.wire()
    return (torch.zeros((band, b), dtype=torch.float32, device=dev),
            torch.zeros((band, b), dtype=torch.int32, device=dev))


def sharded_fused_sn(mesh: Mesh, m, t, device: torch.device,
                     phases: dict | None = None):
    """Fused (S, N) of the G x G square over the mesh: m (P, G, K) 0/1
    uint8 and t (P, G) int32 on the host, G divisible by ``rows`` and P by
    ``scp``.  Returns this rank's row band, as ``sharded_fused_sn_rect``."""
    band = _check(mesh, m.shape, m.shape[1])
    if mesh.coords is None:
        return _idle(band, m.shape[1])
    r, s = mesh.coords
    clock = _clock(device, phases)
    m_loc, t_loc = upload_shard(m, t, s, mesh.n_scp, device)
    ma_band, ta_band = row_band(m_loc, r, band), row_band(t_loc, r, band)
    clock.lap("H2D")
    s_b, n_b = fused_sn_block(ma_band, m_loc, ta_band, t_loc)
    clock.lap("kernel")
    out = _reduce(mesh, s_b, n_b)
    clock.lap("scp all-reduce")
    return out


def sharded_fused_aji(mesh: Mesh, m, t, device: torch.device,
                      phases: dict | None = None):
    """``sharded_fused_sn`` with the band's AJI = S / N beside it:
    (aji, s, n), each this rank's row band."""
    s, n = sharded_fused_sn(mesh, m, t, device, phases)
    return s / n.to(torch.float32), s, n


def gather_rows(mesh: Mesh, x: torch.Tensor) -> np.ndarray:
    """The whole (rows * band, ...) matrix, on every rank, from each mesh
    row's band (taken from its scp cell 0); every rank joins."""
    full = distributed.gather_to_host(x)
    world = distributed.world_size()
    if world == 1:
        return full
    per_rank = full.reshape(world, *x.shape)
    cells = per_rank[: mesh.n_rows * mesh.n_scp : mesh.n_scp]
    return cells.reshape(-1, *x.shape[1:])


def mesh_key(mesh: Mesh, device: torch.device) -> tuple:
    """What a mesh is to the caches kept on a presence object: the device,
    the mesh's shape, the world, this rank and its cell.  Another shape,
    world, rank or cell holds other shards (a test runs every cell in one
    process)."""
    return (str(device), mesh.n_rows, mesh.n_scp, distributed.world_size(),
            distributed.rank(), mesh.coords)


def pad_rows(ids: np.ndarray, n_rows: int) -> np.ndarray:
    """``ids`` padded with genome 0 to a multiple of ``n_rows``, so that a
    block's rows split into equal cell bands (the padded rows are computed
    and dropped)."""
    return np.pad(ids, (0, -len(ids) % n_rows))


def cell_rows(mesh: Mesh, ids: np.ndarray) -> np.ndarray:
    """This cell's band of a block's rows ``ids`` (a multiple of the mesh's
    rows); a rank past the mesh takes row 0's shape."""
    r = mesh.coords[0] if mesh.coords is not None else 0
    band = len(ids) // mesh.n_rows
    return ids[r * band : (r + 1) * band]


def shard_proteins(idx: np.ndarray, s: int, n_scp: int) -> np.ndarray:
    """Shard ``s`` of ``n_scp`` of the proteins ``idx``: padded with -1 (an
    empty protein: its counts are 0, so it adds nothing to S or N) to a
    multiple of ``n_scp``, then cut into contiguous equal shards, as
    ``upload_shard`` cuts a (P, ...) tensor."""
    idx = np.asarray(idx, np.int64)
    pp = -(-len(idx) // n_scp) * n_scp
    padded = np.concatenate([idx, np.full(pp - len(idx), -1, np.int64)])
    p = pp // n_scp
    return padded[s * p : (s + 1) * p]


def protein_layout(chunks, n_scp: int) -> np.ndarray:
    """(n_scp, rows) int64: the protein of each row of every shard's count
    block (-1 for padding), chunk after chunk of ``chunks`` (each a protein
    list), so that process 0 can put every cell's rows in their place."""
    return np.stack([
        np.concatenate([shard_proteins(idx, s, n_scp) for idx in chunks]
                       or [np.zeros(0, np.int64)])
        for s in range(n_scp)
    ])


def gather_cells(mesh: Mesh, x: torch.Tensor) -> np.ndarray:
    """Every rank's ``x`` (the same shape and dtype on each) as one
    (world, ...) host array, on every rank; every rank joins.  The cells
    travel as their bytes: neither gloo nor NCCL gathers int16."""
    dtype = torch.empty(0, dtype=x.dtype).numpy().dtype
    full = distributed.gather_to_host(x.contiguous().view(torch.uint8))
    return full.view(dtype).reshape(distributed.world_size(), *x.shape)


def assemble_counts(mesh: Mesh, cells: np.ndarray, layout: np.ndarray,
                    n_proteins: int, n_rows: int) -> np.ndarray:
    """The (n_proteins, n_rows, B) count block, proteins in their own order,
    from the cells' (world, rows_of_layout, band, B) count blocks
    (``gather_cells``): cell (r, s) holds the proteins ``layout[s]`` of
    band r.  Rows past ``n_rows`` (the band's padding) are dropped; every
    protein lies in exactly one shard."""
    band, b = cells.shape[2], cells.shape[3]
    out = np.empty((n_proteins, n_rows, b), cells.dtype)
    for r in range(mesh.n_rows):
        lo, hi = r * band, min((r + 1) * band, n_rows)
        if lo >= hi:
            break
        for s in range(mesh.n_scp):
            valid = layout[s] >= 0
            out[layout[s][valid], lo:hi] = (
                cells[r * mesh.n_scp + s][valid, : hi - lo])
    return out
