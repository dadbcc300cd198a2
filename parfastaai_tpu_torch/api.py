"""Public library API of the PyTorch port: one-call AJI computation.

Counterpart of ``parfastaai_tpu.api`` with its names, argument order and
error texts, plus a keyword ``device`` (``"cuda"`` by default; a call never
moves to another device)::

    import parfastaai_tpu_torch.api as pfa

    res = pfa.aji("genomes.db")                          # all-vs-all
    res = pfa.aji("genomes.db", query_subset=["name1"])  # query-subset
    res = pfa.aji("targets.db", query_db="queries.db")   # two-database

    res.matrix                  # (|Q|, |T|) float64, exactly the CSV values
    res.row_names, res.col_names
    res.pairs                   # per-pair JacResult (genome ids, S, N, AJI)
    res.to_csv("out.csv")       # byte-identical to the CLI's output

    pfa.aji_to_csv("out.csv", "genomes.db", engine="streamed")  # large G

Engines: ``exact`` (default: bit-for-bit f64 parity with the reference),
``fast`` (fused f32 on the device, ~1e-7), and through :func:`aji_to_csv`
alone ``streamed`` (f32 row bands straight to the CSV) and
``streamed-exact`` (the banded exact engine).  ``staged`` stages the
presence slabs of the last three (``True`` forces it, ``False`` forbids
it, ``None`` leaves it to PARFASTAAI_STAGED and the device budget), as in
the JAX package.  ``engine="sharded"`` is the fused f32 path over a
(rows, scp) mesh of processes, one device each (``mesh``; default: every
process of the group on one row each, ``(world size, 1)``), and ``mesh``
cuts the streamed engines' blocks into that mesh's cells: in a
multi-process run (``parallel.distributed.init_distributed`` first) every
process makes the same call; ``aji`` returns the whole result on each,
``aji_to_csv`` writes from process 0.  As in the JAX package, ``mesh`` is
ignored by ``exact`` and ``fast``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .device import resolve_device
from .engine import (
    compute,
    compute_fast,
    compute_sharded,
    compute_streamed,
    compute_streamed_exact,
)
from .etl.database import PresenceData, QueryTargetDatabase, SCPDatabase
from .io.csv_writer import aji_matrix, write_aji_csv
from .modes import (
    PairSpace,
    all_vs_all,
    all_vs_all_axes,
    query_subset,
    query_subset_axes,
    query_target,
    query_target_axes,
)
from .types import ErrorCode, JacResult, PFAAIError


@dataclass(frozen=True)
class AJIResult:
    """An AJI matrix with its axis labels and the per-pair tuples behind it."""

    matrix: np.ndarray  # (|rows|, |cols|) float64; untouched cells are 0.0
    row_names: tuple[str, ...]
    col_names: tuple[str, ...]
    pairs: JacResult  # reference JAC order (getJAC, algorithm_impl.hpp:346)
    pair_space: PairSpace

    def to_csv(self, path: str, separator: str = ",") -> None:
        """Write the matrix as the reference-format CSV (byte-identical to
        the CLI: header of column names, one row per row genome,
        shortest-round-trip doubles, 0 for untouched cells)."""
        write_aji_csv(path, self.pair_space, self.pairs.aji, separator)


def _open(
    db_path: str,
    query_db: str | None,
    query_subset_names: list[str] | None,
    compat_qt_t_swap: bool,
    axes_only: bool = False,
):
    """(db, PairSpace | StreamAxes) for the mode implied by the arguments,
    by the CLI's dispatch rule (-q wins; -r with the same path degenerates
    to all-vs-all).  ``axes_only`` builds the O(G) StreamAxes instead of the
    O(n_pairs) PairSpace, which the banded engines' memory contract needs."""
    if query_db and query_subset_names:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "query_db and query_subset are mutually exclusive",
        )
    if query_db and query_db != db_path:
        db = QueryTargetDatabase(db_path, query_db)
        fn = query_target_axes if axes_only else query_target
        return db, fn(db.meta, compat_qt_t_swap=compat_qt_t_swap)
    db = SCPDatabase(db_path)
    if query_subset_names:
        fn = query_subset_axes if axes_only else query_subset
        return db, fn(db.meta, list(query_subset_names))
    return db, (all_vs_all_axes if axes_only else all_vs_all)(db.meta)


def _compute(
    presence: PresenceData,
    pairs: PairSpace,
    engine: str,
    mesh: tuple[int, int] | None,
    approx: bool,
    precise: bool,
    device: torch.device,
    staged: bool | None = None,
) -> JacResult:
    if engine == "exact":
        return compute(presence, pairs, device)
    if engine == "fast":
        return compute_fast(
            presence, pairs, device, approx=approx, precise=precise,
            staged=staged,
        )
    if engine == "sharded":
        n_rows, n_scp = mesh if mesh else (None, 1)
        return compute_sharded(presence, pairs, device, n_rows, n_scp)
    raise PFAAIError(
        ErrorCode.CONSTRUCT_ERROR,
        f"Unknown engine {engine!r} (expected exact | fast | sharded)",
    )


def aji(
    db_path: str,
    *,
    query_db: str | None = None,
    query_subset: list[str] | None = None,
    engine: str = "exact",
    mesh: tuple[int, int] | None = None,
    approx: bool = False,
    precise: bool = False,
    staged: bool | None = None,
    compat_qt_t_swap: bool = True,
    device: str = "cuda",
) -> AJIResult:
    """Compute the AJI matrix for a FastAAI database.

    Args:
      db_path: main/target SQLite database.
      query_db: two-database mode: disjoint query database (CLI ``-r``).
      query_subset: query-subset mode: genome names that must exist in the
        database (CLI ``-q``); mutually exclusive with ``query_db``.
      engine: ``exact`` (bit-parity f64, default) | ``fast`` (fused device
        f32) | ``sharded`` (fused f32 over a mesh of processes).  At genome
        counts where holding per-pair results in memory is
        itself the problem, use :func:`aji_to_csv` with
        ``engine="streamed"`` / ``"streamed-exact"`` instead.
      mesh: (rows, scp) mesh shape for ``engine="sharded"``; one process
        per mesh device (the ``exact`` and ``fast`` engines ignore it).
      approx / precise: fused-kernel divide selection (CLI ``--approx`` /
        ``--precise``); only meaningful with ``engine="fast"``.
      staged: presence-slab staging for presence larger than the device
        budget (CLI ``--staged``); only meaningful with ``engine="fast"``:
        ``True`` forces it, ``False`` keeps the buckets resident, ``None``
        reads PARFASTAAI_STAGED as the reference does ("0", "false", "no"
        or unset: decide from the budget; any other value: stage).
      compat_qt_t_swap: replicate the reference's swapped T-column read in
        two-database mode (modes.query_target; default True = reference
        parity).
      device: ``"cuda"`` (default) or ``"cpu"`` (CLI ``--device``).

    Returns an :class:`AJIResult`.  Raises :class:`PFAAIError` on invalid
    databases, unknown query genomes, or overlapping two-DB genome sets:
    the same error taxonomy (and error codes) as the CLI.
    """
    dev = resolve_device(device)
    db, pairs = _open(db_path, query_db, query_subset, compat_qt_t_swap)
    try:
        presence = db.load_presence()
    finally:
        db.close()
    result = _compute(
        presence, pairs, engine, mesh, approx, precise, dev, staged
    )
    return AJIResult(
        matrix=aji_matrix(pairs, result.aji),
        row_names=pairs.query_names,
        col_names=pairs.target_names,
        pairs=result,
        pair_space=pairs,
    )


def aji_to_csv(
    out_path: str,
    db_path: str,
    *,
    query_db: str | None = None,
    query_subset: list[str] | None = None,
    engine: str = "exact",
    mesh: tuple[int, int] | None = None,
    separator: str = ",",
    band: int = 1024,
    col_chunk: int = 4096,
    resume: bool = False,
    approx: bool = False,
    precise: bool = False,
    staged: bool | None = None,
    compat_qt_t_swap: bool = True,
    device: str = "cuda",
) -> None:
    """Compute AJI and write the reference-format CSV in one call.

    Adds two engines over :func:`aji`: ``"streamed"``, the f32 row-band
    engine that writes the CSV incrementally with O(band x G) memory (CLI
    ``--streamed``), and ``"streamed-exact"``, the banded f64 engine (CLI
    ``--streamed --exact``), byte-identical to ``engine="exact"`` output at
    any genome count.  Both support resume-from-partial-file
    (``resume=True``), ``staged`` as :func:`aji` reads it, and ``mesh``:
    (rows, scp), their blocks over that mesh of processes, one device
    each; every process makes the call and process 0 writes."""
    if engine == "streamed-exact" and (approx or precise):
        # The CLI's --exact guard: the banded exact engine is f64 by
        # definition; a quiet plain f64 pass would misreport what was
        # asked for.
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "engine='streamed-exact' is f64 by definition; it cannot "
            "combine with approx/precise",
        )
    if engine not in ("streamed", "streamed-exact"):
        res = aji(
            db_path,
            query_db=query_db,
            query_subset=query_subset,
            engine=engine,
            mesh=mesh,
            approx=approx,
            precise=precise,
            staged=staged,
            compat_qt_t_swap=compat_qt_t_swap,
            device=device,
        )
        res.to_csv(out_path, separator)
        return
    dev = resolve_device(device)
    cells = None
    if mesh:
        from .parallel.mesh import make_mesh

        cells = make_mesh(mesh[0], mesh[1] if len(mesh) > 1 else 1)
    db, pairs = _open(
        db_path, query_db, query_subset, compat_qt_t_swap, axes_only=True
    )
    try:
        presence = db.load_presence()
    finally:
        db.close()
    axes = dict(
        separator=separator,
        resume=resume,
        row_denom_ids=pairs.row_denom_ids,
        col_denom_ids=pairs.col_denom_ids,
        staged=staged,
        mesh=cells,
    )
    args = (
        presence,
        pairs.row_db_ids,
        pairs.col_db_ids,
        out_path,
        pairs.query_names,
        pairs.target_names,
        dev,
    )
    if engine == "streamed-exact":
        compute_streamed_exact(
            *args, band=min(band, 512), col_chunk=min(col_chunk, 2048), **axes
        )
    else:
        compute_streamed(
            *args,
            band=band,
            col_chunk=col_chunk,
            approx=approx,
            precise=precise,
            **axes,
        )
