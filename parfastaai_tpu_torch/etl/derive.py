"""Host-side derivation of the reference's Lc/Lp/F/E arrays — parity tests only.

The TPU production path never materializes these (intersection counts come
from the presence-matrix Gram matmul), but the reference's golden archives pin
them down (tests/pfaai_tests.cpp construct_* cases), so we re-derive them
directly from the SQLite fixtures to prove the ETL reads the same data:

* ``Lc[t]`` = total genome-blob entries for tetramer t across all proteins
  (reference ds_helper.hpp:82-109 via scp_db.hpp:121-158).
* ``Lp``    = exclusive prefix sum of Lc (ds_helper.hpp:112-122).
* ``F``     = (proteinIndex, genomeId) pairs ordered by (tetramer, protein),
  blob order within (scp_db.hpp:161-216: UNION ALL ... ORDER BY tetramer,
  source_table).
* ``E``     = (proteinIndex, genomeA, genomeB) for every valid genome pair in
  each (tetramer, protein) block of F, sorted by (genomeA, genomeB, protein)
  (ds_helper.hpp:270-357, psort.hpp:27-53, interface.hpp:103-111).

Two-database variants join the '_tetras' tables on tetramer so only tetramers
present in both DBs contribute, with target rows first and query genome ids
offset by |target genomes| (scp_db.hpp:402-528).
"""

from __future__ import annotations

import numpy as np

from ..constants import NTETRAMERS
from .database import QueryTargetDatabase, SCPDatabase, _blob_to_ids


def _f_rows_single(db: SCPDatabase) -> tuple[np.ndarray, np.ndarray, list[np.ndarray]]:
    """Per (tetramer, protein) block: tetramer ids, protein ids, genome blobs,
    ordered by (tetramer, protein)."""
    cur = db.conn.cursor()
    tets, prots, blobs = [], [], []
    for p, prot in enumerate(db.meta.protein_set):
        for tet, blob in cur.execute(
            f"SELECT tetramer, genomes FROM '{prot}_tetras'"
        ):
            tets.append(tet)
            prots.append(p)
            blobs.append(_blob_to_ids(blob))
    tets = np.asarray(tets, dtype=np.int64)
    prots = np.asarray(prots, dtype=np.int64)
    order = np.lexsort((prots, tets))  # by tetramer, then protein; stable
    return tets[order], prots[order], [blobs[i] for i in order]


def _derive_single_arrays(db: SCPDatabase, pair_fn):
    """(Lc, Lp, F, E) over one database with mode-specific E pair emission.

    ``pair_fn(gids_sorted)`` returns the (n, 2) valid (genomeA, genomeB)
    pairs of one (tetramer, protein) block — the mode's ``isValidPair``
    filter (reference constructTetramerTuples, ds_helper.hpp:270-357) —
    or None when the block yields no pairs."""
    tets, prots, blobs = _f_rows_single(db)
    sizes = np.asarray([len(b) for b in blobs], dtype=np.int64)

    lc = np.zeros(NTETRAMERS, dtype=np.int32)
    np.add.at(lc, tets, sizes.astype(np.int32))
    lp = np.zeros(NTETRAMERS, dtype=np.int32)
    np.cumsum(lc[:-1], out=lp[1:])

    f = np.empty((int(sizes.sum()), 2), dtype=np.int32)
    e_parts = []
    off = 0
    for tet, p, gids in zip(tets, prots, blobs):
        n = len(gids)
        f[off : off + n, 0] = p
        f[off : off + n, 1] = gids
        off += n
        # Blobs are genome-id sorted, so index order == id order.
        pairs = pair_fn(np.sort(gids).astype(np.int32))
        if pairs is not None and len(pairs):
            block = np.empty((len(pairs), 3), dtype=np.int32)
            block[:, 0] = p
            block[:, 1:] = pairs
            e_parts.append(block)
    e = (
        np.concatenate(e_parts)
        if e_parts
        else np.empty((0, 3), dtype=np.int32)
    )
    order = np.lexsort((e[:, 0], e[:, 2], e[:, 1]))  # (genomeA, genomeB, protein)
    return lc, lp, f, e[order]


def derive_single(db: SCPDatabase):
    """(Lc, Lp, F, E) for a single database, all-vs-all pair semantics:
    every (a, b) with a < b (ds_impl.hpp:38-151 isValidPair)."""

    def pair_fn(g: np.ndarray):
        if len(g) < 2:
            return None
        a, b = np.triu_indices(len(g), k=1)
        return np.stack([g[a], g[b]], axis=1)

    return _derive_single_arrays(db, pair_fn)


def derive_qsub(db: SCPDatabase, query_names: list[str]):
    """(Lc, Lp, F, E) for query-subset semantics: valid pairs are
    (both query and a < b) or (a query, b target) — reference isValidPair,
    ds_impl.hpp:270-273; genomeA must be a query genome
    (constructTetramerTuples's isQryGenome guard, ds_helper.hpp:314-316).
    Lc/Lp/F are identical to all-vs-all (the DB layer is mode-blind)."""
    name_to_id = {n: i for i, n in enumerate(db.meta.genome_set)}
    missing = [q for q in query_names if q not in name_to_id]
    if missing:
        raise ValueError(f"Query genome(s) not in database: {missing}")
    is_query = np.zeros(len(db.meta.genome_set), dtype=bool)
    is_query[[name_to_id[q] for q in query_names]] = True

    def pair_fn(g: np.ndarray):
        qm = is_query[g]
        q, t = g[qm], g[~qm]
        parts = []
        if len(q) >= 2:
            a, b = np.triu_indices(len(q), k=1)
            parts.append(np.stack([q[a], q[b]], axis=1))
        if len(q) and len(t):
            parts.append(
                np.stack(
                    [np.repeat(q, len(t)), np.tile(t, len(q))], axis=1
                )
            )
        return np.concatenate(parts) if parts else None

    return _derive_single_arrays(db, pair_fn)


def derive_pair_extents(
    e: np.ndarray, n_pairs: int, pair_slot
) -> tuple[np.ndarray, np.ndarray]:
    """Per-genome-pair INCLUSIVE [start, end] extents in the sorted E array
    (reference findEBlockExtents, algorithm_impl.hpp:123-219; goldens
    xanthodb_gpe_starts/ends.bin).

    ``pair_slot(genome_a, genome_b)`` maps pair labels to JAC slot indices
    (the reference's genomePairToIndex).  Pairs with no E block keep -1.
    """
    starts = np.full(n_pairs, -1, dtype=np.int32)
    ends = np.full(n_pairs, -1, dtype=np.int32)
    if len(e) == 0:
        return starts, ends
    change = np.flatnonzero((np.diff(e[:, 1]) != 0) | (np.diff(e[:, 2]) != 0))
    bs = np.concatenate(([0], change + 1)).astype(np.int32)
    be = np.concatenate((change, [len(e) - 1])).astype(np.int32)
    slots = pair_slot(e[bs, 1], e[bs, 2])
    starts[slots] = bs
    ends[slots] = be
    return starts, ends


def distribute_bags_of_tasks(
    nproc: int, ntasks: int, bag_sizes: np.ndarray, slack: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Greedy contiguous weighted partition of bags over nproc workers —
    exact replica of the reference scheduler (utils.hpp:66-95 /
    ds_helper.hpp:167-201), including its float32 per-worker quota.  Returns
    (bag_starts, bag_ends), inclusive, -1 for workers given no bags."""
    quota = int(
        np.float32(np.float32(ntasks) / np.float32(nproc))
        * np.float32(1.0 + slack)
    )
    starts = np.full(nproc, -1, dtype=np.int64)
    ends = np.full(nproc, -1, dtype=np.int64)
    filled = np.zeros(nproc, dtype=np.int64)
    pid = 0
    for bag_id, size in enumerate(bag_sizes):
        if filled[pid] + size <= quota or pid == nproc - 1:
            filled[pid] += size
            if starts[pid] == -1:
                starts[pid] = bag_id
            ends[pid] = bag_id
        else:
            pid += 1
            filled[pid] += size
            starts[pid] = bag_id
            ends[pid] = bag_id
    return starts, ends


def derive_thread_slabs(
    lc: np.ndarray, f: np.ndarray, n_threads: int, slack: float = 0.0
) -> tuple[np.ndarray, np.ndarray]:
    """Per-thread E-slab (starts, sizes) for all-vs-all semantics — the
    layout recorded in xanthodb_e_starts/e_size.bin (reference constructE,
    ds_helper.hpp:362-421: tetramers partitioned by Lc weight with |F| as the
    task total, then countTetramerTuples per range with
    countGenomePairs(n) = n(n-1)/2)."""
    occ = np.flatnonzero(lc)
    tet_of_row = np.repeat(occ.astype(np.int64), lc[occ])
    prots = f[:, 0].astype(np.int64)
    change = np.flatnonzero((np.diff(tet_of_row) != 0) | (np.diff(prots) != 0))
    run_start = np.concatenate(([0], change + 1))
    run_end = np.concatenate((change + 1, [len(f)]))
    n = run_end - run_start
    tuples_per_tet = np.zeros(len(lc), dtype=np.int64)
    np.add.at(tuples_per_tet, tet_of_row[run_start], n * (n - 1) // 2)

    bag_starts, bag_ends = distribute_bags_of_tasks(
        n_threads, int(lc.sum()), lc, slack
    )
    cum = np.concatenate(([0], np.cumsum(tuples_per_tet)))
    sizes = np.zeros(n_threads, dtype=np.int32)
    for tid in range(n_threads):
        if bag_starts[tid] >= 0:
            sizes[tid] = cum[bag_ends[tid] + 1] - cum[bag_starts[tid]]
    starts = np.zeros(n_threads, dtype=np.int32)
    np.cumsum(sizes[:-1], out=starts[1:])
    return starts, sizes


def derive_qt(db: QueryTargetDatabase):
    """(Lc, Lp, F, E) for the two-database mode.

    F rows exist only for tetramers present in both DBs for a protein; each
    row lists target genome ids then query ids offset by |targets|
    (scp_db.hpp:450-528).  E pairs are (query, target) only
    (ds_impl.hpp:421-423).
    """
    cur = db.conn.cursor()
    nt = len(db.meta.genome_set)
    rows = []  # (tet, p, tgt_ids, qry_ids)
    for p, prot in enumerate(db.meta.protein_set):
        tgt = dict(
            cur.execute(f"SELECT tetramer, genomes FROM main.'{prot}_tetras'")
        )
        qry = dict(
            cur.execute(f"SELECT tetramer, genomes FROM QueryDB.'{prot}_tetras'")
        )
        for tet in set(tgt) & set(qry):
            rows.append((tet, p, _blob_to_ids(tgt[tet]), _blob_to_ids(qry[tet])))
    rows.sort(key=lambda r: (r[0], r[1]))

    lc = np.zeros(NTETRAMERS, dtype=np.int32)
    f_parts, e_parts = [], []
    for tet, p, tgids, qgids in rows:
        lc[tet] += len(tgids) + len(qgids)
        fb = np.empty((len(tgids) + len(qgids), 2), dtype=np.int32)
        fb[:, 0] = p
        fb[: len(tgids), 1] = tgids
        fb[len(tgids) :, 1] = nt + qgids
        f_parts.append(fb)
        # E: genomeA = query (offset id), genomeB = target.
        qq = np.repeat(nt + qgids, len(tgids))
        tt = np.tile(tgids, len(qgids))
        eb = np.empty((len(qq), 3), dtype=np.int32)
        eb[:, 0] = p
        eb[:, 1] = qq
        eb[:, 2] = tt
        e_parts.append(eb)

    lp = np.zeros(NTETRAMERS, dtype=np.int32)
    np.cumsum(lc[:-1], out=lp[1:])
    f = np.concatenate(f_parts) if f_parts else np.empty((0, 2), dtype=np.int32)
    e = np.concatenate(e_parts) if e_parts else np.empty((0, 3), dtype=np.int32)
    order = np.lexsort((e[:, 0], e[:, 2], e[:, 1]))
    return lc, lp, f, e[order]
