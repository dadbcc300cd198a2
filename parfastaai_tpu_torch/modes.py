"""Run-mode semantics: pair spaces, id maps, and output scatter rules.

TPU-native re-expression of the reference's mode data classes
(include/pfaai/ds_impl.hpp: ParFAAIData :38, ParFAAIQSubData :158,
ParFAAIQryTgtData :343).  Each mode is a *pair space*: an ordered list of
genome-pair slots (the JAC vector order of the reference), in columnar form.

Per slot we carry two id conventions:

* ``db_a`` / ``db_b`` — indices into the presence tensor / intersection-count
  matrix (the DB id space: all-vs-all & query-subset use DB genome ids; the
  two-DB mode uses targets at [0,|T|) and queries at [|T|,...)).
* ``jac_a`` / ``jac_b`` — the labels the reference stores in its JACTuples.
  For all-vs-all and query-subset these equal the DB ids; the two-DB mode
  labels queries 0..|Q|-1 and targets |Q|.. (ds_impl.hpp:428-439) — the
  *opposite* of the DB layer's convention.

The reference indexes its T matrix with the JAC labels
(algorithm_impl.hpp:250-253: ``c_T(proteinID, genomeA/B)``), which in two-DB
mode reads *swapped* T columns: for pair (query q, target t) the denominator
becomes ``T[p, label q] + T[p, |Q|+label t]`` in DB column space.  Verified
bit-for-bit against data/xdb_qt_aji.bin during the survey; the corrected
formula differs by up to 9.8e-3 AJI.  We replicate it behind
``compat_qt_t_swap`` (default True) so the quirk is explicit, testable, and
removable — see QueryTargetMode.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .types import DBMetaData, ErrorCode, PFAAIError


@dataclass(frozen=True)
class PairSpace:
    """Columnar pair-slot table in reference JAC order plus CSV scatter rules."""

    # Pair slots (length n_pairs each):
    db_a: np.ndarray  # int32 — presence/count index of genome A
    db_b: np.ndarray  # int32 — presence/count index of genome B
    jac_a: np.ndarray  # int32 — JACTuple genomeA label
    jac_b: np.ndarray  # int32 — JACTuple genomeB label
    denom_a: np.ndarray  # int32 — T column used for T[p, A] in the denominator
    denom_b: np.ndarray  # int32 — T column used for T[p, B]
    # Output scatter (reference printOutput, src/main.cpp:133-175):
    out_row: np.ndarray  # int32 — row in the query x target AJI matrix
    out_col: np.ndarray  # int32 — column
    mirror_row: np.ndarray  # int32 — second scatter target, -1 when none
    mirror_col: np.ndarray  # int32
    # CSV axes:
    query_names: tuple[str, ...]  # row labels, in row order
    target_names: tuple[str, ...]  # column labels, in column order
    # Presence-tensor genome index of each CSV row / column, in output order
    # (drives the streaming engine, engine.compute_streamed):
    row_db_ids: np.ndarray  # int32 (len(query_names),)
    col_db_ids: np.ndarray  # int32 (len(target_names),)
    # T column used in the denominator for each CSV row / column.  denom_a /
    # denom_b factor by construction into per-row x per-column vectors in
    # every mode (the two-DB compat swap substitutes one whole column set for
    # the other, never mixing within a pair), which is what lets the fused /
    # sharded / streamed block engines honor the swap with two small gathers.
    # Default (None) means "same as the db ids".
    row_denom_ids: np.ndarray = None  # int32 (len(query_names),)
    col_denom_ids: np.ndarray = None  # int32 (len(target_names),)

    def __post_init__(self):
        if self.row_denom_ids is None:
            object.__setattr__(self, "row_denom_ids", self.row_db_ids)
        if self.col_denom_ids is None:
            object.__setattr__(self, "col_denom_ids", self.col_db_ids)

    @property
    def n_pairs(self) -> int:
        return int(self.db_a.shape[0])


@dataclass(frozen=True)
class StreamAxes:
    """CSV axes + per-axis denominator columns ONLY — everything the
    streaming engine (engine.compute_streamed) consumes, in O(rows + cols)
    memory.

    The streamed path exists for genome counts where O(G^2) anything is
    fatal (engine.compute_streamed docstring: G ~ 1e5), so its mode
    constructors must not materialize the per-pair PairSpace columns: at
    G=16384 those are ~5.4 GB of host int32; at G=1e5, ~500 GB.  Validation
    (unknown/duplicate query genomes, overlapping QT genome sets) is shared
    with the PairSpace constructors, so error behavior is identical."""

    query_names: tuple[str, ...]  # CSV row labels, in row order
    target_names: tuple[str, ...]  # CSV column labels, in column order
    row_db_ids: np.ndarray  # int32 — presence index of each CSV row
    col_db_ids: np.ndarray  # int32 — presence index of each CSV column
    row_denom_ids: np.ndarray  # int32 — denominator T column per row
    col_denom_ids: np.ndarray  # int32 — denominator T column per column


def all_vs_all(meta: DBMetaData) -> PairSpace:
    """All-vs-all over one DB: upper-triangle pairs (a < b), row-major slot
    order ``idx(a,b) = G*a + b - (a+2)(a+1)/2`` (reference ds_impl.hpp:83-114).
    Every value is mirrored across the diagonal in the CSV (main.cpp:150-153
    with isSubset=true and isQryGenome always true, ds_impl.hpp:89)."""
    g = len(meta.genome_set)
    a, b = np.triu_indices(g, k=1)
    a = a.astype(np.int32)
    b = b.astype(np.int32)
    ids = np.arange(g, dtype=np.int32)
    return PairSpace(
        db_a=a, db_b=b, jac_a=a, jac_b=b, denom_a=a, denom_b=b,
        out_row=a, out_col=b, mirror_row=b, mirror_col=a,
        query_names=meta.genome_set, target_names=meta.genome_set,
        row_db_ids=ids, col_db_ids=ids,
        row_denom_ids=ids, col_denom_ids=ids,
    )


def all_vs_all_axes(meta: DBMetaData) -> StreamAxes:
    """O(G) axes for streamed all-vs-all (same CSV layout as all_vs_all)."""
    ids = np.arange(len(meta.genome_set), dtype=np.int32)
    return StreamAxes(
        query_names=meta.genome_set, target_names=meta.genome_set,
        row_db_ids=ids, col_db_ids=ids,
        row_denom_ids=ids, col_denom_ids=ids,
    )


def _validate_query_lookup(
    meta: DBMetaData, query_names: list[str]
) -> np.ndarray:
    """Query-name validation shared by query_subset / query_subset_axes:
    every name must exist (reference validate_subset, src/main.cpp:204-232)
    and be unique (documented divergence, PARITY.md).  Returns the DB genome
    id of each query in file order."""
    name_to_id = {n: i for i, n in enumerate(meta.genome_set)}
    missing = [q for q in query_names if q not in name_to_id]
    if missing:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "Query genome(s) not present in the database: " + ", ".join(missing),
        )
    if len(set(query_names)) != len(query_names):
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR, "Duplicate genome names in query list"
        )
    return np.asarray([name_to_id[q] for q in query_names], dtype=np.int32)


def query_subset_axes(
    meta: DBMetaData, query_names: list[str]
) -> StreamAxes:
    """O(Q + G) axes for streamed query-subset (same CSV layout as
    query_subset: rows = queries in file order, columns = all DB genomes)."""
    qry_lookup = _validate_query_lookup(meta, query_names)
    g = len(meta.genome_set)
    all_ids = np.arange(g, dtype=np.int32)
    return StreamAxes(
        query_names=tuple(query_names), target_names=meta.genome_set,
        row_db_ids=qry_lookup, col_db_ids=all_ids,
        row_denom_ids=qry_lookup, col_denom_ids=all_ids,
    )


def _validate_query_target(meta: DBMetaData) -> tuple[int, int]:
    """Two-DB validation shared by query_target / query_target_axes
    (reference validate_qry2tgt, src/main.cpp:268-300).  Returns (|T|, |Q|)."""
    nt = len(meta.genome_set)
    nq = len(meta.query_genome_set)
    if nq == 0:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR, "Two-database mode requires query genomes"
        )
    overlap = set(meta.genome_set) & set(meta.query_genome_set)
    if overlap:
        raise PFAAIError(
            ErrorCode.CONSTRUCT_ERROR,
            "Query and target databases share genomes: "
            + ", ".join(sorted(overlap)),
        )
    return nt, nq


def query_target_axes(
    meta: DBMetaData, compat_qt_t_swap: bool = True
) -> StreamAxes:
    """O(Q + T) axes for streamed two-database mode (same CSV layout and
    denominator convention — including the compat T-swap — as query_target)."""
    nt, nq = _validate_query_target(meta)
    row_db = nt + np.arange(nq, dtype=np.int32)
    col_db = np.arange(nt, dtype=np.int32)
    if compat_qt_t_swap:
        row_denom = np.arange(nq, dtype=np.int32)
        col_denom = nq + np.arange(nt, dtype=np.int32)
    else:
        row_denom, col_denom = row_db, col_db
    return StreamAxes(
        query_names=meta.query_genome_set, target_names=meta.genome_set,
        row_db_ids=row_db, col_db_ids=col_db,
        row_denom_ids=row_denom, col_denom_ids=col_denom,
    )


def query_subset(meta: DBMetaData, query_names: list[str]) -> PairSpace:
    """Query-subset mode: query genomes are a subset of the DB's genomes
    (reference ParFAAIQSubData, ds_impl.hpp:158-337).

    Slot layout is two-part (ds_impl.hpp:251-263, 278-305): first the full
    |Q| x |T'| query x non-query block row-major (query order = query-file
    order, target order = DB order of non-query genomes), then the |Q| x |Q|
    upper triangle in query-file order.  CSV rows are the query genomes in
    file order, columns are *all* DB genomes; query-query cells are mirrored
    (main.cpp:150-153 with isSubset=true).
    """
    g = len(meta.genome_set)
    qry_lookup = _validate_query_lookup(meta, query_names)
    is_query = np.zeros(g, dtype=bool)
    is_query[qry_lookup] = True
    tgt_lookup = np.flatnonzero(~is_query).astype(np.int32)  # DB order
    # genomeIndexMap: query genome -> query-file index (ds_impl.hpp:210-223)
    qidx_of = np.full(g, -1, dtype=np.int32)
    qidx_of[qry_lookup] = np.arange(len(qry_lookup), dtype=np.int32)

    nq, ntp = len(qry_lookup), len(tgt_lookup)
    # Part 1: |Q| x |T'| row-major.
    qi = np.repeat(np.arange(nq, dtype=np.int32), ntp)
    tj = np.tile(np.arange(ntp, dtype=np.int32), nq)
    a1 = qry_lookup[qi]
    b1 = tgt_lookup[tj]
    # Part 2: |Q| x |Q| upper triangle in query-file index order.
    ia, ib = np.triu_indices(nq, k=1)
    a2 = qry_lookup[ia.astype(np.int32)]
    b2 = qry_lookup[ib.astype(np.int32)]

    a = np.concatenate([a1, a2])
    b = np.concatenate([b1, b2])
    out_row = qidx_of[a]
    out_col = b
    # Mirror only when genome B is itself a query genome (main.cpp:150-153).
    mirror_row = np.where(is_query[b], qidx_of[b], -1).astype(np.int32)
    mirror_col = np.where(is_query[b], a, -1).astype(np.int32)

    return PairSpace(
        db_a=a, db_b=b, jac_a=a, jac_b=b, denom_a=a, denom_b=b,
        out_row=out_row, out_col=out_col,
        mirror_row=mirror_row, mirror_col=mirror_col,
        query_names=tuple(query_names), target_names=meta.genome_set,
        row_db_ids=qry_lookup, col_db_ids=np.arange(g, dtype=np.int32),
        row_denom_ids=qry_lookup, col_denom_ids=np.arange(g, dtype=np.int32),
    )


def query_target(meta: DBMetaData, compat_qt_t_swap: bool = True) -> PairSpace:
    """Two-database mode: every (query, target) pair, |Q| x |T| row-major
    (reference ParFAAIQryTgtData, ds_impl.hpp:343-490).

    DB id space: targets [0,|T|), queries [|T|,...) (scp_db.hpp:353).  JAC
    labels: queries 0..|Q|-1, targets |Q|.. (ds_impl.hpp:428-439).  With
    ``compat_qt_t_swap`` (default) the denominator T columns are the JAC
    labels, replicating the reference's swapped-column read (module
    docstring); with it disabled the semantically correct DB ids are used.
    """
    nt, nq = _validate_query_target(meta)
    qi = np.repeat(np.arange(nq, dtype=np.int32), nt)
    ti = np.tile(np.arange(nt, dtype=np.int32), nq)
    db_a = nt + qi
    db_b = ti
    jac_a = qi
    jac_b = nq + ti
    if compat_qt_t_swap:
        denom_a, denom_b = jac_a, jac_b
        row_denom = np.arange(nq, dtype=np.int32)
        col_denom = nq + np.arange(nt, dtype=np.int32)
    else:
        denom_a, denom_b = db_a, db_b
        row_denom = nt + np.arange(nq, dtype=np.int32)
        col_denom = np.arange(nt, dtype=np.int32)
    none = np.full(qi.shape, -1, dtype=np.int32)
    return PairSpace(
        db_a=db_a, db_b=db_b, jac_a=jac_a, jac_b=jac_b,
        denom_a=denom_a, denom_b=denom_b,
        out_row=qi, out_col=ti, mirror_row=none, mirror_col=none,
        query_names=meta.query_genome_set, target_names=meta.genome_set,
        row_db_ids=nt + np.arange(nq, dtype=np.int32),
        col_db_ids=np.arange(nt, dtype=np.int32),
        row_denom_ids=row_denom, col_denom_ids=col_denom,
    )
