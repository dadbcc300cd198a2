"""Host-side ETL: FastAAI SQLite databases -> dense TPU-ready tensors.

TPU-first redesign of the reference's DB layer (include/pfaai/scp_db.hpp,
include/pfaai/db_helper.hpp).  The reference streams SQLite rows into sparse
CSR-style arrays (Lc/Lp/F) plus an explicit pair list E; on TPU none of those
exist in the production path.  Instead we build, per single-copy protein (SCP),
a dense genome x tetramer presence matrix over a *compacted* tetramer axis —
only the tetramers that actually occur for that protein get a column (the
Lc > 0 columns).  Dropping all-zero columns cannot change M @ M.T, and it
shrinks the MXU contraction axis by ~100x (160,000 -> a few thousand).

Schema (verified live against data/xdb_subset1.db):
  genome_metadata(genome_name TEXT, genome_id INTEGER PRIMARY KEY, ...)
  scp_data(genome_id, SCP_acc TEXT, SCP_score REAL, tetra_count INTEGER)
  '{SCP}_tetras'(tetramer INTEGER PRIMARY KEY, genomes BLOB)   -- int32[] LE
  '{SCP}_genomes'(genome_id INTEGER PRIMARY KEY, tetramers BLOB) -- int32[] LE

Protein order is the SQLite emission order of
``SELECT DISTINCT SCP_acc FROM scp_data`` and genome order that of
``SELECT genome_name FROM genome_metadata`` — identical queries to the
reference (db_helper.hpp:86,195), run through the same SQLite library, so the
orders match by construction.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sqlite3
from dataclasses import dataclass

import numpy as np

from ..constants import K_BLOCK, LANE, MAX_K_SINGLE_BLOCK, NTETRAMERS
from ..types import DBMetaData, ErrorCode, PFAAIError


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class MetaOnlyM:
    """Shape/dtype stand-in for a presence tensor whose DATA was never
    shipped to this process (meta-only broadcast, parallel/distributed
    .broadcast_presence(meta_only=True)): non-primary processes of a
    staged-mesh run hold metadata + T only, and slab bytes arrive on demand
    through the mesh slab store (engine._MeshSlabStore) — that is what
    makes "genome capacity scales with host RAM x pod size" true on the
    HOST side too.

    Any data access raises: a code path that needs tensor bytes on a
    non-primary process is a routing bug, and a loud error beats a silent
    zero tensor."""

    def __init__(self, shape: tuple[int, ...]):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(np.uint8)

    @property
    def nbytes(self) -> int:  # advisory (what the data WOULD occupy)
        n = 1
        for s in self.shape:
            n *= s
        return n

    def _no_data(self, *_a, **_k):
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "presence tensor bytes are not on this process (meta-only "
            "broadcast): only the staged-mesh slab path may run here — "
            "this code path needs the full tensor and must run on the "
            "primary or under a full presence broadcast",
        )

    __getitem__ = _no_data
    __array__ = _no_data

    def astype(self, *a, **k):
        self._no_data()

    def sum(self, *a, **k):
        self._no_data()


@dataclass
class PresenceData:
    """Dense per-SCP presence tensors, ready for device upload.

    ``m`` is the (P, G, K) uint8 presence tensor over the compacted tetramer
    axis (K = padded max per-protein distinct-tetramer count); column j of
    protein p corresponds to tetramer ``tetramer_ids[p][j]`` (ascending), and
    columns >= ``widths[p]`` are zero padding.  ``t`` is the (P, G) int32
    tetramer-count matrix, the reference's T (scp_db.hpp:219-262: blob bytes /
    4 of the '{SCP}_genomes' rows).
    """

    meta: DBMetaData
    m: np.ndarray  # uint8 (P, G, K)
    t: np.ndarray  # int32 (P, G)
    widths: np.ndarray  # int32 (P,) valid column count per protein
    tetramer_ids: list[np.ndarray]  # per protein: int32 (widths[p],) ascending

    @property
    def n_proteins(self) -> int:
        return self.m.shape[0]

    @property
    def n_genomes(self) -> int:
        return self.m.shape[1]


def _connect(path: str) -> sqlite3.Connection:
    if not os.path.isfile(path):
        raise PFAAIError(
            ErrorCode.SQLITE_DB_ERROR, f"Database file not found: {path}"
        )
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    return conn


def _genome_set(cur: sqlite3.Cursor, table: str = "genome_metadata") -> tuple[str, ...]:
    # Same query as reference db_helper.hpp:86 ("SELECT genome_name FROM ...").
    rows = cur.execute(f"SELECT genome_name FROM {table}").fetchall()
    return tuple(r[0] for r in rows)


def _protein_set(cur: sqlite3.Cursor, table: str = "scp_data") -> tuple[str, ...]:
    # Same query as reference db_helper.hpp:195 ("SELECT DISTINCT SCP_acc ...").
    rows = cur.execute(f"SELECT DISTINCT SCP_acc FROM {table}").fetchall()
    return tuple(r[0] for r in rows)


# The reference's shared-protein query (db_helper.hpp:140-143).
_SCP_JOIN = (
    "SELECT DISTINCT target_table.SCP_acc"
    "  FROM scp_data as target_table, QueryDB.scp_data as query_table"
    "  WHERE target_table.SCP_acc = query_table.SCP_acc"
)
# The same names as a semi-join: each target row is tested once against the
# query's names, where the join meets every query row of its SCP.
_SCP_SEMI_JOIN = (
    "SELECT DISTINCT SCP_acc FROM main.scp_data"
    "  WHERE SCP_acc IN (SELECT SCP_acc FROM QueryDB.scp_data)"
)


def _planner_may_reorder(cur: sqlite3.Cursor) -> bool:
    """True where either attached database holds an index on ``scp_data``
    or planner statistics (``sqlite_stat*``, written by ANALYZE)."""
    for schema in ("main", "QueryDB"):
        if cur.execute(
            f"SELECT 1 FROM {schema}.sqlite_master WHERE (type = 'index'"
            "  AND tbl_name = 'scp_data' COLLATE NOCASE)"
            "  OR name LIKE 'sqlite_stat%' LIMIT 1"
        ).fetchone():
            return True
    return False


def _shared_scps(cur: sqlite3.Cursor) -> tuple[str, ...]:
    """The SCP accessions of ``main.scp_data`` that ``QueryDB.scp_data``
    also has, in the emission order of the reference's join.

    On unindexed tables without statistics SQLite runs that join as a scan
    of the target that probes the query, so it emits each name at its first
    target row; the semi-join scans the target the same way and gives the
    same tuple, without the join's |T| x |Q| rows a protein behind its
    DISTINCT.  An index or statistics let the planner pick another order
    for either statement, so there the join itself runs.
    """
    sql = _SCP_JOIN if _planner_may_reorder(cur) else _SCP_SEMI_JOIN
    return tuple(r[0] for r in cur.execute(sql))


def _blob_to_ids(blob: bytes) -> np.ndarray:
    return np.frombuffer(blob, dtype="<i4")


def _scatter_presence(
    m_p: np.ndarray,
    blobs: list[np.ndarray],
    n_genomes: int,
    col_map: np.ndarray | None = None,
    row0: int = 0,
) -> None:
    """Scatter one protein's genome-id blobs into its (G, K) presence slice:
    column ``col_map[j]`` (j without a map) gets a 1 at row ``row0 + g`` for
    each id g in blobs[j].  Native C++/OpenMP when available (the
    reference's constructF analogue, ds_helper.hpp:126-162), NumPy otherwise.

    Genome ids are bounds-checked first, against the database's own
    ``n_genomes``: the native kernel writes at
    ``(row0 + id) * K + col`` unguarded, so a corrupt database must be
    rejected here, not discovered as memory corruption or as a 1 in another
    database's rows."""
    from ..native import native_unpack_presence

    if blobs:
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        gids = np.concatenate(blobs) if offsets[-1] else np.empty(0, np.int32)
        if len(gids) and (int(gids.min()) < 0 or int(gids.max()) >= n_genomes):
            raise PFAAIError(
                ErrorCode.CONSTRUCT_ERROR,
                f"Corrupt database: genome id outside [0, {n_genomes}) "
                "in a tetramer blob",
            )
        if native_unpack_presence(gids, offsets, m_p, col_map, row0):
            return
    for j, gids in enumerate(blobs):
        m_p[row0 + gids, j if col_map is None else col_map[j]] = 1


def _read_t_matrix(
    cur,
    protein_set: tuple[str, ...],
    t_out: np.ndarray,
    qualifier: str = "",
    col_offset: int = 0,
) -> None:
    """Fill T rows from '{SCP}_genomes' blob lengths (reference
    scp_db.hpp:219-262: blob bytes / 4) — the single Python implementation
    behind every accessor (the native loader is its C++ twin, parity pinned
    by tests/test_native.py)."""
    for p, prot in enumerate(protein_set):
        for gid, nbytes in cur.execute(
            f"SELECT genome_id, length(tetramers) FROM {qualifier}'{prot}_genomes'"
        ):
            t_out[p, col_offset + gid] = nbytes // 4


def _etl_threads(n_threads: int | None) -> int:
    """Worker count for the row-streaming ETL; PARFASTAAI_ETL_THREADS mirrors
    the reference's OMP_NUM_THREADS control (README.md:97-102)."""
    if n_threads is not None:
        return n_threads
    env = os.environ.get("PARFASTAAI_ETL_THREADS")
    return int(env) if env else max(1, min(8, os.cpu_count() or 1))


def _padded_width(widths: np.ndarray) -> int:
    """The presence's K: the widest protein, rounded up to a lane."""
    return max(LANE, _round_up(int(widths.max()) if len(widths) else LANE,
                               LANE))


def _union_columns(
    ids_by_db: list[list[np.ndarray]],
) -> tuple[list[np.ndarray], np.ndarray, list[np.ndarray | None]]:
    """The presence's columns from each database's per-protein ascending
    tetramer ids: ``(tetramer_ids, widths, col_maps)``.

    One database: its own ids, and no map.  Several: per protein the union
    of their ids (``np.union1d``), and per database an int32 (P, max(1,
    its widest protein)) map whose row p holds the union column of each of
    its ids of protein p (``np.searchsorted``)."""
    if len(ids_by_db) == 1:
        (ids,) = ids_by_db
        return ids, np.asarray([len(i) for i in ids], np.int32), [None]
    union = [functools.reduce(np.union1d, per_protein)
             for per_protein in zip(*ids_by_db)]
    col_maps = []
    for ids in ids_by_db:
        col_map = np.zeros((len(ids), max([1] + [len(i) for i in ids])),
                           np.int32)
        for p, (side, cols) in enumerate(zip(ids, union)):
            col_map[p, : len(side)] = np.searchsorted(cols, side)
        col_maps.append(col_map)
    return union, np.asarray([len(u) for u in union], np.int32), col_maps


def _merge_timer(n_dbs: int, verbose: bool):
    """The ``-r`` union and column maps' span and line; nothing for one
    database."""
    from ..utils.timing import phase_timer

    if n_dbs == 1:
        return contextlib.nullcontext()
    return phase_timer("  Column merge     ", enabled=verbose,
                       name="etl.merge")


def _load_tensors(
    dbs: list[tuple[str, int]],
    protein_set: tuple[str, ...],
    n_threads: int | None = None,
    verbose: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[np.ndarray]]:
    """(m, t, widths, tetramer_ids) of one presence over the databases
    ``dbs`` = [(path, n_genomes)] and one protein list: genome g of a
    database is row g plus the genome counts of the databases before it.

    One database keeps its own compacted columns.  Several share, per
    protein, the union of their tetramer ids: each one's ids are read first
    (``_union_columns``, span ``etl.merge``), then its rows are scattered
    through its column map straight into the one zeroed presence (span
    ``etl.fill`` each, counter ``mapped_columns``).

    Native C++ loader (native/pfaai_sqlite.cpp: read + scatter + T fused,
    OpenMP over proteins — measured 2.25x over the Python path at G=4096)
    with the stdlib-sqlite3 path as fallback and error-reporting surface:
    any native failure re-runs everything in Python on a fresh presence,
    which builds identical tensors (same queries through the same C
    library) and raises the proper PFAAIError for genuinely corrupt
    databases."""
    from ..utils.timing import phase_timer

    n_threads = _etl_threads(n_threads)
    rows = np.cumsum([0] + [n for _, n in dbs]).tolist()
    with phase_timer("  Native ETL       ", enabled=verbose):
        res = _native_tensors(dbs, rows, protein_set, n_threads, verbose)
    if res is not None:
        return res
    return _python_tensors(dbs, rows, protein_set, n_threads, verbose)


def _native_tensors(dbs, rows, protein_set, n_threads, verbose):
    """``_load_tensors`` by the native loader; None on any failure."""
    from ..native import native_fill, native_tetramer_ids, native_widths
    from ..utils.timing import count, span

    P = len(protein_set)
    mapped = len(dbs) > 1
    read = []  # per database: (widths, tetramer-id buffer or None)
    with span("etl.widths"):
        for path, _ in dbs:
            widths = native_widths(path, protein_set, n_threads)
            if widths is None:
                return None
            tets = None
            if mapped:
                tets = native_tetramer_ids(path, protein_set, widths,
                                           n_threads)
                if tets is None:
                    return None
            read.append((widths, tets))
    with _merge_timer(len(dbs), verbose):
        if mapped:
            tetramer_ids, widths, col_maps = _union_columns(
                [[tets[p, :w] for p, w in enumerate(widths)]
                 for widths, tets in read])
        else:
            widths, col_maps = read[0][0], [None]
    K = _padded_width(widths)
    with span("etl.alloc"):
        m = np.zeros((P, rows[-1], K), dtype=np.uint8)
        t = np.zeros((P, rows[-1]), dtype=np.int32)
        if not mapped:  # the fill writes the lone database's ids here
            read = [(widths, np.zeros((P, K), dtype=np.int32))]
    # The fill first touches the zeroed pages of m: their faults are here.
    for (path, n), (w, tets), col_map, row0 in zip(dbs, read, col_maps,
                                                   rows):
        with span("etl.fill"):
            if not native_fill(path, protein_set, n, w, m, t, tets,
                               n_threads, col_map, row0):
                return None
            if mapped:
                count(mapped_columns=int(w.sum()))
    if not mapped:
        tetramer_ids = [read[0][1][p, :w].copy() for p, w in enumerate(widths)]
    return m, t, widths, tetramer_ids


def _python_tensors(dbs, rows, protein_set, n_threads, verbose):
    """``_load_tensors`` by threaded stdlib sqlite3 (one read-only
    connection per worker; the C library releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..utils.timing import count, phase_timer, span

    P = len(protein_set)

    def read_protein(path: str, prot: str):
        conn = _connect(path)
        try:
            tets: list[int] = []
            blobs: list[np.ndarray] = []
            for tet, blob in conn.execute(
                f"SELECT tetramer, genomes FROM '{prot}_tetras' ORDER BY tetramer"
            ):
                tets.append(tet)
                blobs.append(_blob_to_ids(blob))
            return np.asarray(tets, dtype=np.int32), blobs
        except (sqlite3.Error, ValueError) as e:
            # Missing '{SCP}_tetras' table, malformed blob length, etc.
            raise PFAAIError(
                ErrorCode.SQLITE_DB_ERROR,
                f"Failed reading protein {prot!r} from {path}: {e}",
            )
        finally:
            conn.close()

    read = []  # per database, per protein: (tetramer ids, blobs)
    with phase_timer("  Tetras read      ", enabled=verbose,
                     name="etl.widths"):
        for path, _ in dbs:
            read_one = functools.partial(read_protein, path)
            if n_threads > 1:
                with ThreadPoolExecutor(n_threads) as ex:
                    read.append(list(ex.map(read_one, protein_set)))
            else:
                read.append([read_one(prot) for prot in protein_set])
    with _merge_timer(len(dbs), verbose):
        tetramer_ids, widths, col_maps = _union_columns(
            [[tets for tets, _ in per_protein] for per_protein in read])

    with phase_timer("  Presence scatter ", enabled=verbose):
        with span("etl.alloc"):
            m = np.zeros((P, rows[-1], _padded_width(widths)), dtype=np.uint8)
        for (_, n), per_protein, col_map, row0 in zip(dbs, read, col_maps,
                                                      rows):
            with span("etl.fill"):
                for p, (tets, blobs) in enumerate(per_protein):
                    _scatter_presence(
                        m[p], blobs, n,
                        None if col_map is None else col_map[p], row0)
                if col_map is not None:
                    count(mapped_columns=sum(len(tets)
                                             for tets, _ in per_protein))

    with phase_timer("  T matrix         ", enabled=verbose, name="etl.t"):
        t = np.zeros((P, rows[-1]), dtype=np.int32)
        for (path, n), row0 in zip(dbs, rows):
            conn = _connect(path)
            try:
                # each database's own columns: an id past its genomes
                # raises, as on a T of its own
                _read_t_matrix(conn.cursor(), protein_set,
                               t[:, row0 : row0 + n])
            except (sqlite3.Error, ValueError) as e:
                raise PFAAIError(
                    ErrorCode.SQLITE_DB_ERROR,
                    f"Failed reading '_genomes' tables from {path}: {e}",
                )
            finally:
                conn.close()
    return m, t, widths, tetramer_ids


class SCPDatabase:
    """Single FastAAI SQLite database accessor (reference SQLiteSCPDataBase,
    scp_db.hpp:57-263)."""

    def __init__(self, path: str):
        self.path = path
        self.conn = _connect(path)
        cur = self.conn.cursor()
        try:
            proteins = _protein_set(cur)
            genomes = _genome_set(cur)
        except sqlite3.Error as e:
            raise PFAAIError(
                ErrorCode.SQLITE_DB_ERROR, f"Failed to read metadata from {path}: {e}"
            )
        if not proteins or not genomes:
            raise PFAAIError(
                ErrorCode.SQLITE_DB_ERROR,
                f"Database {path} has no proteins or no genomes",
            )
        self.meta = DBMetaData(protein_set=proteins, genome_set=genomes)

    def close(self):
        self.conn.close()

    # -- tensor extraction ---------------------------------------------------

    def load_t_matrix(self) -> np.ndarray:
        """T[p, g] = number of distinct tetramers of protein p in genome g
        (reference scp_db.hpp:219-262: length(tetramers) / 4)."""
        cur = self.conn.cursor()
        P = len(self.meta.protein_set)
        G = len(self.meta.genome_set)
        t = np.zeros((P, G), dtype=np.int32)
        _read_t_matrix(cur, self.meta.protein_set, t)
        return t

    def load_presence(
        self, n_threads: int | None = None, verbose: bool = False
    ) -> PresenceData:
        """Build the compacted presence tensor from the '{SCP}_tetras' tables.

        Proteins are read in parallel — native C++ one-pass loader when
        available, threaded stdlib-sqlite3 otherwise (one read-only
        connection per worker; SQLite supports concurrent readers and the C
        library releases the GIL) — the host-side analogue of the
        reference's per-thread row streaming (ds_helper.hpp:126-162).

        ``verbose`` prints one timing line per construction step, mirroring
        the reference's per-phase timers (interface.hpp:306-327: Lc/Lp, F,
        T; E has no production equivalent — it never materializes)."""
        m, t, widths, tetramer_ids = _load_tensors(
            [(self.path, len(self.meta.genome_set))],
            self.meta.protein_set,
            n_threads,
            verbose,
        )
        return PresenceData(
            meta=self.meta,
            m=m,
            t=t,
            widths=widths,
            tetramer_ids=tetramer_ids,
        )


class QueryTargetDatabase:
    """Two-database accessor: query DB ATTACHed to the target (main) DB
    (reference QTSQLiteSCPDataBase, scp_db.hpp:267-590).

    The shared genome id space places target genomes at ``[0, |T|)`` and query
    genomes at ``[|T|, |T|+|Q|)`` (reference scp_db.hpp:353, 519).  The protein
    set is the inner join of the two DBs' SCP accessions in SQLite DISTINCT
    emission order (reference db_helper.hpp:110-166; ``_shared_scps``).  In
    a recorded call span ``cli.attach`` times the open, the ATTACH and both
    genome reads, and ``cli.join`` the protein set (counter ``shared_scps``).
    """

    def __init__(self, target_path: str, query_path: str):
        from ..utils.timing import count, span

        self.target_path = target_path
        self.query_path = query_path
        with span("cli.attach"):
            self.conn = _connect(target_path)
            if not os.path.isfile(query_path):
                raise PFAAIError(
                    ErrorCode.SQLITE_DB_ERROR,
                    f"Database file not found: {query_path}",
                )
            self.conn.execute("ATTACH DATABASE ? AS QueryDB", (query_path,))
            cur = self.conn.cursor()
            tgt_genomes = _genome_set(cur, "main.genome_metadata")
            qry_genomes = _genome_set(cur, "QueryDB.genome_metadata")
        with span("cli.join"):
            shared = _shared_scps(cur)
            count(shared_scps=len(shared))
        self.meta = DBMetaData(
            protein_set=shared,
            genome_set=tgt_genomes,
            query_genome_set=qry_genomes,
        )

    def close(self):
        self.conn.close()

    def load_t_matrix(self) -> np.ndarray:
        """T over the union id space: columns [0,|T|) target, [|T|,...) query
        (reference scp_db.hpp:531-589)."""
        cur = self.conn.cursor()
        P = len(self.meta.protein_set)
        nt = len(self.meta.genome_set)
        nq = len(self.meta.query_genome_set)
        t = np.zeros((P, nt + nq), dtype=np.int32)
        _read_t_matrix(cur, self.meta.protein_set, t, qualifier="main.")
        _read_t_matrix(
            cur, self.meta.protein_set, t, qualifier="QueryDB.", col_offset=nt
        )
        return t

    def load_presence(
        self, n_threads: int | None = None, verbose: bool = False
    ) -> PresenceData:
        """Presence over the union id space and the union of both DBs'
        tetramers per shared protein.

        The reference joins the two '_tetras' tables on tetramer so only
        tetramers present in *both* DBs enter F/E (scp_db.hpp:402-448); for the
        query x target intersection counts this is equivalent to taking the
        column union here, because a tetramer present in only one DB
        contributes zero to every query x target product.

        The union is built first and filled once (``_load_tensors``): both
        databases' tetramer ids are read without their blobs, the union per
        protein is ``np.union1d`` of the two and each database's column map
        one ``np.searchsorted`` into it (span ``etl.merge``); then the target
        is scattered into rows [0, |T|) and the query into [|T|, |T|+|Q|) of
        the one zeroed (P, |T|+|Q|, K) presence through their maps, each
        database's genome ids checked against its own genome count.  No
        per-database presence exists and nothing is copied between
        presences.
        """
        m, t, widths, tetramer_ids = _load_tensors(
            [(self.target_path, len(self.meta.genome_set)),
             (self.query_path, len(self.meta.query_genome_set))],
            self.meta.protein_set,
            n_threads,
            verbose,
        )
        return PresenceData(
            meta=self.meta,
            m=m,
            t=t,
            widths=widths,
            tetramer_ids=tetramer_ids,
        )


def bucket_bounds(
    widths: np.ndarray, max_buckets: int = 4, lane: int = LANE
) -> tuple[np.ndarray, list[tuple[int, int, int]]]:
    """The bucket *plan* of bucketize_presence without materializing slices.

    Returns ``(order, [(start, end, kb)])``: ``order`` is the width-sorted
    protein permutation and each bucket covers ``order[start:end]`` with a
    padded contraction width ``kb``.  Split points come from an exact DP
    minimizing total padded work sum(|group| * roundup(max_width, lane)).
    Shared by bucketize_presence (which slices copies) and the staged
    placements (engine._Staged: slab-sized gathers only — at the
    genome counts staging targets, a full-G bucket copy would double host
    RAM)."""
    P = len(widths)
    order = np.argsort(widths, kind="stable").astype(np.int32)
    w = np.asarray(widths)[order]

    def padded(width: int) -> int:
        w = max(lane, _round_up(int(width), lane))
        if w > MAX_K_SINGLE_BLOCK:
            # K-blocked kernel territory: pre-align to the kernel's K_BLOCK
            # here, HOST-side, so the jitted _pad_k is a no-op — a
            # device-side pad of a multi-GB bucket/slab materializes a full
            # HLO-temp copy (measured: 2 x 4.06 GiB temps OOMing a 16 GB
            # HBM on the G=4096 K=51200 staged workload).
            w = _round_up(w, K_BLOCK)
        return w

    B = min(max_buckets, P)
    # cost[i][j]: minimal padded work for proteins [0, i) using j buckets.
    INF = float("inf")
    cost = [[INF] * (B + 1) for _ in range(P + 1)]
    split = [[0] * (B + 1) for _ in range(P + 1)]
    cost[0][0] = 0
    for i in range(1, P + 1):
        for j in range(1, B + 1):
            for k in range(j - 1, i):
                # group = sorted proteins [k, i); its K = padded(w[i-1])
                c = cost[k][j - 1] + (i - k) * padded(w[i - 1])
                if c < cost[i][j]:
                    cost[i][j] = c
                    split[i][j] = k
    j = min(B, P)
    while cost[P][j - 1] <= cost[P][j] and j > 1:
        j -= 1
    bounds = []
    i = P
    while j > 0:
        k = split[i][j]
        bounds.append((k, i, padded(int(w[i - 1]))))
        i, j = k, j - 1
    bounds.reverse()
    return order, bounds


def bucketize_presence(
    presence: PresenceData, max_buckets: int = 4, lane: int = LANE
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Group proteins into width buckets to cut MXU padding waste.

    The compacted per-protein widths vary ~10x in real databases (e.g.
    58..558 across xdb_subset1's 79 SCPs), so a single K = max(width) pads
    ~69% of the contraction axis with zeros.  Sorting proteins by width and
    partitioning them into <= max_buckets contiguous groups (bucket_bounds)
    lets each group contract at its own K.

    Returns [(protein_idx, m_b, t_b)] with m_b = (Pb, G, Kb) uint8 slices;
    every protein appears in exactly one bucket.  Union of the buckets'
    Gram counts equals the unbucketed counts exactly (integer math), so only
    the f32 S accumulation order changes (~1e-7, same as any fused path).
    """
    order, bounds = bucket_bounds(presence.widths, max_buckets, lane)
    out = []
    for k, i, kb in bounds:
        idx = order[k:i]
        m_b = presence.m[idx, :, : min(kb, presence.m.shape[2])]
        if m_b.shape[2] < kb:
            # Wide buckets are K_BLOCK-aligned past the tensor's own width
            # (bucket_bounds.padded); zero columns add 0 to every count.
            m_b = np.pad(m_b, ((0, 0), (0, 0), (0, kb - m_b.shape[2])))
        else:
            m_b = np.ascontiguousarray(m_b)
        out.append((idx, m_b, np.ascontiguousarray(presence.t[idx])))
    return out


def validate_tetramer_range(tetramer_ids: list[np.ndarray]) -> None:
    """Sanity check: every tetramer id must lie in [0, NTETRAMERS)."""
    for p, tets in enumerate(tetramer_ids):
        if len(tets) and (tets[0] < 0 or tets[-1] >= NTETRAMERS):
            raise PFAAIError(
                ErrorCode.CONSTRUCT_ERROR,
                f"Protein {p} has tetramer ids outside [0, {NTETRAMERS})",
            )
