"""Command-line entry point of the PyTorch port.

``python -m parfastaai_tpu_torch <db> <out.csv> [flags]`` takes the parser
and flags of ``parfastaai_tpu.cli`` plus ``--device {cuda,cpu}`` (default
cuda).  It runs the three modes (all-vs-all, ``-q`` query-subset, ``-r``
two-database) on the exact default path, on ``--fast``, on the f32
streamed engine (``--streamed``) and on the banded exact engine
(``--streamed --exact``), the last two with ``--resume``, with the same
validation, error codes and phase timers.  Above the host budget of the
dense exact path (PARFASTAAI_EXACT_HOST_BYTES, default 4 GiB) the default
call routes itself through the banded exact engine and writes the same
bytes.  ``--staged`` (with ``--fast`` or ``--streamed``) and
PARFASTAAI_STAGED stage presence slabs instead of keeping the width
buckets on the device, as does presence above the device budget
(PARFASTAAI_HBM_BYTES, else 75% of the card's memory); a staged run
prints what its slab store uploaded.  ``--profile DIR`` writes a Chrome
trace of the compute phase (a ``torch.profiler`` run) into DIR.

``--mesh ROWS[,SCP]`` runs over a mesh of processes, one device each
(parallel/): launch ROWS x SCP processes with PARFASTAAI_COORDINATOR /
PARFASTAAI_NUM_PROCESSES / PARFASTAAI_PROCESS_ID or torchrun; ``--mesh 1``
runs in one process.  Plain ``--mesh`` is ``engine.compute_sharded`` (the
JAX CLI's f32 route); with ``--streamed`` (``--exact``, ``--staged``) the
streamed engines cut their blocks into the mesh's cells.  In a
multi-process run process 0 alone opens the database, reads the query
list and writes every output file (the CSV, ``--dump-jac``, ``--dump-e``,
the ``--profile`` trace); metadata, queries and presence reach the other
ranks by broadcast, and a failure there reaches them in their place.  A
staged ``--streamed --mesh`` run broadcasts only the metadata and T, and
its slabs ship from process 0 on demand.  The streamed engines without
``--mesh`` (the auto-routed default call too) run on process 0 alone in a
multi-process run.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from . import __version__
from .device import resolve_device
from .engine import (
    compute,
    compute_fast,
    compute_sharded,
    compute_streamed,
    compute_streamed_exact,
    _use_staged_mesh,
    presence_device_bytes,
    slab_stats,
)
from .etl.database import QueryTargetDatabase, SCPDatabase
from .etl.derive import derive_qsub, derive_qt, derive_single
from .io.csv_writer import write_aji_csv
from .io.fmtfloat import format_double
from .modes import (
    all_vs_all,
    all_vs_all_axes,
    query_subset,
    query_subset_axes,
    query_target,
    query_target_axes,
)
from .parallel import distributed
from .parallel.mesh import make_mesh, parse_mesh
from .types import ErrorCode, PFAAIError
from .utils.timing import phase_timer

# The one file ``--profile DIR`` writes into DIR.
PROFILE_TRACE = "parfastaai_trace.json"


def _as_pfaai_error(e: Exception) -> PFAAIError:
    """The error code ``parfastaai_tpu.cli`` gives a failure while reading
    the databases or the query list."""
    if isinstance(e, PFAAIError):
        return e
    code = (
        ErrorCode.SQLITE_MEM_ALLOC_ERROR
        if isinstance(e, MemoryError)
        else ErrorCode.SQLITE_DB_ERROR
    )
    return PFAAIError(code, f"{type(e).__name__}: {e}")


def _exact_host_budget() -> int:
    """Host-memory budget of the default exact path's dense machinery
    (PARFASTAAI_EXACT_HOST_BYTES overrides; default 4 GiB)."""
    env = os.environ.get("PARFASTAAI_EXACT_HOST_BYTES")
    return int(float(env)) if env else 4 << 30


def _route_banded_exact(n_pairs_est: int, n_proteins: int) -> bool:
    """True where ``parfastaai_tpu.cli`` routes the default exact path to
    the banded exact engine: the dense (P, n_pairs) counts plus two int32
    denominator gathers would exceed the host budget."""
    return n_pairs_est * n_proteins * (2 + 2 * 4) > _exact_host_budget()


def load_query_genomes(path: str) -> list[str]:
    """Whitespace-split genome names (reference AppParams::load_query_genomes,
    src/main.cpp:114-124)."""
    with open(path) as fp:
        return fp.read().split()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parfastaai-tpu-torch",
        description="Average Jaccard Index (AJI) engine on PyTorch / CUDA",
    )
    p.add_argument("path_to_input_db", help="Path to the main/target SQLite database")
    p.add_argument("path_to_output_file", help="Path to the output CSV")
    p.add_argument(
        "-r", "--query_db", default="", help="Query database (two-database mode)"
    )
    p.add_argument(
        "-q",
        "--query_subset",
        default="",
        help="File listing query genome names (query-subset mode)",
    )
    p.add_argument("-s", "--separator", default=",", help="Output field separator")
    p.add_argument(
        "--no-compat-qt-t-swap",
        action="store_true",
        help=(
            "Disable replication of the reference's swapped T-column read in "
            "two-database mode (see parfastaai_tpu.modes.query_target)"
        ),
    )
    p.add_argument(
        "--fast",
        action="store_true",
        help=(
            "Fused on-device f32 pipeline through the rectangular CUDA "
            "kernel: ~1e-7 relative error vs the default exact path"
        ),
    )
    divide = p.add_mutually_exclusive_group()
    divide.add_argument(
        "--approx",
        action="store_true",
        help=(
            "With --fast or --streamed: raw approximate-reciprocal divide "
            "in the kernel (--streamed: on cuda only)"
        ),
    )
    divide.add_argument(
        "--precise",
        action="store_true",
        help="With --fast or --streamed: IEEE f32 divide in the kernel",
    )
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help=(
            "Device to compute on (default cuda; a run never moves to "
            "another device)"
        ),
    )
    for flag, help_ in (
        (
            "--streamed",
            "Streaming row-band engine: f32 AJI blocks from the rectangular "
            "CUDA kernel straight to the CSV in row bands, in memory that "
            "does not grow with the square of the genome count; with "
            "--exact the banded exact engine",
        ),
        (
            "--exact",
            "With --streamed: banded exact engine, bit-parity f64 CSV in "
            "memory that does not grow with the genome count",
        ),
        (
            "--staged",
            "With --fast or --streamed: stage presence slabs through an "
            "LRU on the device instead of keeping the width buckets "
            "resident (automatic above the device budget, "
            "PARFASTAAI_HBM_BYTES)",
        ),
        (
            "--resume",
            "With --streamed (and on the auto-routed banded exact engine): "
            "keep the complete band-aligned rows already in the output "
            "file and continue after them",
        ),
    ):
        p.add_argument(flag, action="store_true", help=help_)
    p.add_argument(
        "--band", type=int, default=1024, help="Streamed mode: rows per band"
    )
    p.add_argument(
        "--col-chunk",
        type=int,
        default=4096,
        help="Streamed mode: columns per device block",
    )
    p.add_argument(
        "--mesh", default="", metavar="ROWS[,SCP]",
        help=(
            "Fused f32 path over a mesh of ROWS x SCP processes, one "
            "device each: ROWS-way genome-band data parallelism x SCP-way "
            "protein sharding; with --streamed the streamed engines' "
            "blocks over that mesh"
        ),
    )
    p.add_argument(
        "--profile", default="", metavar="DIR",
        help=(
            "Write a Chrome trace of the compute phase (torch.profiler: "
            f"host and, on a card, device activity) to DIR/{PROFILE_TRACE}"
        ),
    )
    p.add_argument(
        "--dump-jac",
        default="",
        metavar="PATH",
        help="Also write the per-pair JAC tuples (genomeA, genomeB, S, N, AJI)",
    )
    p.add_argument(
        "--dump-e",
        default="",
        metavar="PATH",
        help="Also write the sorted E array (proteinIndex, genomeA, genomeB)",
    )
    p.add_argument("--quiet", action="store_true", help="Suppress phase timing output")
    p.add_argument("--version", action="version", version=__version__)
    return p


def _print_args_box(args) -> None:
    """Run-configuration box, as ``parfastaai_tpu.cli`` prints it."""
    rows = [
        f" Input Database  : {args.path_to_input_db} ",
        f" Query Database  : {args.query_db} ",
        f" Query Subset    : {args.query_subset} ",
        f" Output File     : {args.path_to_output_file} ",
        f" Field Separator : {args.separator} ",
    ]
    w = max(len(r) for r in rows)
    print(" ┌" + "─" * w + "┐")
    for r in rows:
        print(" │" + r.ljust(w) + "│")
    print(" └" + "─" * w + "┘")


def _validate(args) -> tuple[int, int] | None:
    """The flag checks of ``parfastaai_tpu.cli.run``, in its order, on
    every rank before any collective; then a mesh larger than the process
    group, which the port refuses before any collective.  Returns
    ``--mesh``'s (rows, scp), or None without it."""
    if args.exact and not args.streamed:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "--exact selects the banded exact engine and requires "
            "--streamed (the default path is already exact)",
        )
    if args.exact and (args.approx or args.precise):
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "--exact is f64 by definition; it cannot combine with "
            "--approx/--precise",
        )
    if args.staged and not (args.fast or args.streamed):
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "--staged stages the presence slabs of the banded device "
            "engines and requires --fast or --streamed",
        )
    if args.staged and args.mesh and not args.streamed:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "--staged with --mesh requires --streamed (the staged-mesh "
            "slab engine is a streamed-path engine)",
        )
    mesh = None
    if args.mesh:
        try:
            mesh = parse_mesh(args.mesh)
        except ValueError as e:
            raise PFAAIError(ErrorCode.CONSTRUCT_ERROR, f"--mesh {e}") from None
    if (args.approx or args.precise) and not (args.fast or args.streamed):
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "--approx/--precise select the fused kernel's divide and "
            "require --fast or --streamed",
        )
    world = distributed.world_size()
    if mesh and mesh[0] * mesh[1] > world:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            f"--mesh {args.mesh}: Need {mesh[0] * mesh[1]} devices, have "
            f"{world} (one process per mesh device)",
        )
    return mesh


def _from_primary(read):
    """``read()`` on process 0 alone (the database and the query list may
    exist only on its disk), and its result on every rank.  A failure
    there travels in the result's place, so every rank raises the same
    PFAAIError instead of waiting in a collective that process 0 never
    joins.  One process: ``read()``, its failure as the JAX CLI's code."""
    value = err = None
    if distributed.is_primary():
        try:
            value = read()
        except Exception as e:  # noqa: BLE001 — every failure must reach
            # the other ranks (a raw sqlite3 error too)
            err = _as_pfaai_error(e)
    value = distributed.broadcast_pyobj(err if err is not None else value)
    if isinstance(value, PFAAIError):
        raise value
    return value


def _pair_space(args, meta, two_db: bool, queries):
    """(pairs, banded_auto) of the run's mode, decided from the metadata
    and the query names (``-q``) alone as ``parfastaai_tpu.cli.run``
    decides it.

    ``banded_auto``: the default exact path's dense host footprint would
    exceed the budget, so the run goes through the banded exact engine
    (the same f64 values and CSV bytes in bounded memory).  ``--dump-jac``
    needs the per-pair result and pins the dense path.  For the banded
    engine (``--streamed --exact`` or ``banded_auto``) ``pairs`` is the
    mode's O(rows + cols) StreamAxes, with the validation of its PairSpace
    and no O(n_pairs) table; otherwise it is the PairSpace."""
    exact_default = not (args.fast or args.streamed or args.mesh)
    n_prot = len(meta.protein_set)
    n_tgt = len(meta.genome_set)
    compat = not args.no_compat_qt_t_swap
    if two_db:
        n_pairs_est = len(meta.query_genome_set) * n_tgt
    elif queries is not None:
        nq = len(queries)
        n_pairs_est = nq * (n_tgt - nq) + nq * (nq - 1) // 2
    else:
        n_pairs_est = n_tgt * (n_tgt - 1) // 2
    banded_auto = (
        exact_default
        and not args.dump_jac
        and _route_banded_exact(n_pairs_est, n_prot)
    )
    use_axes = args.streamed or banded_auto
    if two_db:
        mode_fn = query_target_axes if use_axes else query_target
        pairs = mode_fn(meta, compat_qt_t_swap=compat)
    elif queries is not None:
        mode_fn = query_subset_axes if use_axes else query_subset
        pairs = mode_fn(meta, queries)
    else:
        pairs = all_vs_all_axes(meta) if use_axes else all_vs_all(meta)
    return pairs, banded_auto


def _dump_e(args, db, two_db: bool, queries, verbose: bool) -> None:
    """--dump-e: the sorted E array, re-derived on the host per mode."""
    with phase_timer("E derivation       ", enabled=verbose):
        if two_db:
            _, _, _, e = derive_qt(db)
        elif queries is not None:
            _, _, _, e = derive_qsub(db, queries)
        else:
            _, _, _, e = derive_single(db)
        with open(args.dump_e, "w") as fp:
            fp.write("proteinIndex,genomeA,genomeB\n")
            for row in e:
                fp.write(f"{row[0]},{row[1]},{row[2]}\n")


def _print_phases(phases: dict, verbose: bool) -> None:
    if verbose:
        for label, seconds in phases.items():
            print(f"  {label:<17}: {seconds * 1e3:.1f} ms")


def _print_slabs(presence, device, verbose: bool, mesh=None) -> None:
    """What a staged run's slab store moved and held (with ``mesh``,
    process 0's store of that mesh: its shard of each slab); nothing for a
    resident run."""
    stats = slab_stats(presence, device, mesh)
    if verbose and stats is not None:
        ratio = stats["uploaded"] / max(1, presence_device_bytes(presence))
        print(
            f"  staged slabs     : {stats['slabs']} uploads, "
            f"{stats['hits']} hits, uploaded {stats['uploaded']} B "
            f"({ratio:.3f} x the bucketed presence), peak held "
            f"{stats['peak']} B of a {stats['cap']} B cap"
        )


def _banded_exact_run(
    args, presence, pairs, device, verbose: bool, mesh=None
) -> None:
    """The banded exact engine's one call, for ``--streamed --exact`` and
    for the auto-routed default path alike (``pairs`` is the StreamAxes),
    over ``mesh`` where given."""
    phases: dict[str, float] = {}
    with phase_timer("Banded exact + CSV ", enabled=verbose):
        compute_streamed_exact(
            presence,
            pairs.row_db_ids,
            pairs.col_db_ids,
            args.path_to_output_file,
            pairs.query_names,
            pairs.target_names,
            device,
            separator=args.separator,
            band=min(args.band, 512),
            col_chunk=min(args.col_chunk, 2048),
            resume=args.resume,
            row_denom_ids=pairs.row_denom_ids,
            col_denom_ids=pairs.col_denom_ids,
            phases=phases,
            staged=args.staged or None,
            mesh=mesh,
        )
    _print_phases(phases, verbose)
    _print_slabs(presence, device, verbose, mesh)
    if verbose:
        print(
            "  (the stages above overlap: they do not sum to the phase's "
            "wall)"
        )
        print(
            f"Wrote {len(pairs.query_names)} x "
            f"{len(pairs.target_names)} AJI matrix to "
            f"{args.path_to_output_file} (banded exact) on {device}"
        )


def _streamed_run(
    args, presence, pairs, device, verbose: bool, mesh=None
) -> None:
    """The f32 streamed engine's one call (``pairs`` is the StreamAxes),
    over ``mesh`` where given."""
    phases: dict[str, float] = {}
    with phase_timer("Streamed AJI + CSV ", enabled=verbose):
        compute_streamed(
            presence,
            pairs.row_db_ids,
            pairs.col_db_ids,
            args.path_to_output_file,
            pairs.query_names,
            pairs.target_names,
            device,
            separator=args.separator,
            band=args.band,
            col_chunk=args.col_chunk,
            resume=args.resume,
            approx=args.approx,
            precise=args.precise,
            row_denom_ids=pairs.row_denom_ids,
            col_denom_ids=pairs.col_denom_ids,
            phases=phases,
            staged=args.staged or None,
            mesh=mesh,
        )
    _print_phases(phases, verbose)
    _print_slabs(presence, device, verbose, mesh)
    if verbose:
        print(
            "  (the stages above overlap: they do not sum to the phase's "
            "wall)"
        )
        print(
            f"Wrote {len(pairs.query_names)} x "
            f"{len(pairs.target_names)} AJI matrix to "
            f"{args.path_to_output_file} (streamed) on {device}"
        )


@contextlib.contextmanager
def _profiled(trace_dir: str, device):
    """``--profile DIR``: the body under ``torch.profiler`` (host activity
    and, on a card, device activity), its Chrome trace written to
    DIR/PROFILE_TRACE when the body ends without an error.  The profiler is
    closed either way.  Without DIR the body runs as it is."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, PROFILE_TRACE))


def run(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    owns_group = distributed.backend() is None
    # Before any device is touched; every rank of a multi-process launch
    # runs this same command.
    distributed.init_distributed(args.device)
    try:
        return _run(args, distributed.world_size() > 1)
    finally:
        if owns_group:
            distributed.close()


def _run(args, multiproc: bool) -> int:
    primary = distributed.is_primary()
    # One writer, one reporter: the other ranks compute and join the
    # collectives, and never touch the output files.
    verbose = not args.quiet and primary
    if verbose:
        _print_args_box(args)
    try:
        mesh = _validate(args)
        device = resolve_device(args.device)
        if verbose and multiproc:
            print(
                f"distributed: {distributed.world_size()} processes, backend "
                f"{distributed.backend()}, rank 0 on {device}"
            )
        two_db = bool(args.query_db) and args.query_db != args.path_to_input_db
        db = None

        def open_db():
            nonlocal db
            with phase_timer("DB open + metadata ", enabled=verbose):
                if two_db:
                    db = QueryTargetDatabase(
                        args.path_to_input_db, args.query_db
                    )
                else:
                    db = SCPDatabase(args.path_to_input_db)
                return db.meta

        try:
            meta = _from_primary(open_db)
            queries = None
            if args.query_subset and not two_db:
                queries = _from_primary(
                    lambda: load_query_genomes(args.query_subset)
                )
            pairs, banded_auto = _pair_space(args, meta, two_db, queries)
            presence = err = None
            meta_only = False
            if primary:
                try:
                    with phase_timer("Presence ETL       ", enabled=verbose):
                        presence = db.load_presence(verbose=verbose)
                    # A staged streamed mesh ships its slabs from process 0
                    # on demand: the others need the metadata and T alone.
                    meta_only = bool(
                        multiproc and args.streamed and mesh
                        and _use_staged_mesh(presence, mesh[1], device,
                                             args.staged or None))
                except Exception as e:  # noqa: BLE001 — see _from_primary
                    err = _as_pfaai_error(e)
            with phase_timer(
                "Presence broadcast ", enabled=verbose and multiproc
            ):
                presence = distributed.broadcast_presence(
                    presence, error=err, meta_only=meta_only)
            if verbose and getattr(presence, "slab_broadcast", False):
                print(
                    "Presence broadcast: metadata + T only (staged-mesh "
                    "slabs ship on demand; host capacity scales with the "
                    "mesh)"
                )
            if args.dump_e and primary:
                _dump_e(args, db, two_db, queries, verbose)
        finally:
            if db is not None:
                db.close()
        if banded_auto and verbose:
            # Dense exact would exceed the host budget: the same f64
            # values and CSV bytes through the banded exact engine.
            print(
                "exact path: host footprint exceeds "
                f"{_exact_host_budget() >> 30} GiB — routing through the "
                "banded exact engine (identical CSV bytes; "
                "PARFASTAAI_EXACT_HOST_BYTES overrides)"
            )
        phases: dict[str, float] = {}
        # --profile covers the compute phase of whichever route runs, on
        # process 0 alone (one writer of the trace, as of the CSV).
        # The streamed engines' mesh (every rank makes its groups).
        cells = make_mesh(*mesh) if mesh and args.streamed else None
        with _profiled(args.profile if primary else "", device):
            if args.streamed and not args.exact:
                _streamed_run(args, presence, pairs, device, verbose, cells)
                return 0
            if args.streamed or banded_auto:
                _banded_exact_run(
                    args, presence, pairs, device, verbose, cells)
                return 0
            with phase_timer("JAC + AJI          ", enabled=verbose):
                if mesh:
                    # the reference's f32 mesh route: --fast's divide
                    # flags do not reach it
                    result = compute_sharded(
                        presence, pairs, device, *mesh, phases=phases
                    )
                elif args.fast:
                    result = compute_fast(
                        presence, pairs, device, approx=args.approx,
                        precise=args.precise, phases=phases,
                        staged=args.staged or None,
                    )
                else:
                    result = compute(presence, pairs, device, phases=phases)
        _print_phases(phases, verbose)
        _print_slabs(presence, device, verbose)
        if not primary:
            return 0
        with phase_timer("CSV write          ", enabled=verbose):
            write_aji_csv(
                args.path_to_output_file, pairs, result.aji, args.separator
            )
        if args.dump_jac:
            with open(args.dump_jac, "w") as fp:
                fp.write("genomeA,genomeB,S,N,AJI\n")
                for i in range(result.n_pairs):
                    fp.write(
                        f"{result.genome_a[i]},{result.genome_b[i]},"
                        f"{format_double(result.s[i])},{result.n[i]},"
                        f"{format_double(result.aji[i])}\n"
                    )
        if verbose:
            print(
                f"Wrote {result.n_pairs} genome-pair AJI values "
                f"({len(pairs.query_names)} x {len(pairs.target_names)} "
                f"matrix) to {args.path_to_output_file} on {device}"
            )
        return 0
    except PFAAIError as e:
        print(f"ERROR ({e.code.name}): {e}", file=sys.stderr)
        return int(e.code)


def main() -> None:
    raise SystemExit(run())


if __name__ == "__main__":
    main()
