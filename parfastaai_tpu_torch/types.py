"""Core typed records and the error taxonomy.

TPU-native re-expression of the reference's core types
(include/pfaai/interface.hpp:39-120): instead of per-element structs we keep
columnar NumPy arrays (struct-of-arrays) — the natural layout for both XLA and
vectorized host code — and provide record views only at test/serialization
boundaries.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class ErrorCode(enum.IntEnum):
    """Mirrors PFAAI_ERROR_CODE (reference include/pfaai/interface.hpp:39-44)."""

    OK = 0
    SQLITE_DB_ERROR = 1
    SQLITE_MEM_ALLOC_ERROR = 2
    CONSTRUCT_ERROR = 3


class PFAAIError(RuntimeError):
    """Raised where the reference returns a non-OK PFAAI_ERROR_CODE."""

    def __init__(self, code: ErrorCode, message: str):
        super().__init__(message)
        self.code = code

    def __reduce__(self):
        # Default Exception pickling replays self.args (message only) into
        # __init__ and loses ``code``; errors cross process boundaries in the
        # multi-host single-reader ETL (parallel/distributed.broadcast_pyobj).
        return (PFAAIError, (self.code, str(self)))


@dataclass(frozen=True)
class DBMetaData:
    """Protein / genome name sets of a database.

    Mirrors DBMetaData (reference include/pfaai/interface.hpp), where
    ``protein_set`` preserves the SQLite ``SELECT DISTINCT`` emission order and
    ``genome_set`` the ``genome_metadata`` row order.  For two-database runs
    ``query_genome_set`` holds the query DB's genomes (ids offset by
    ``len(genome_set)`` in the shared id space, reference scp_db.hpp:353).
    """

    protein_set: tuple[str, ...]
    genome_set: tuple[str, ...]
    query_genome_set: tuple[str, ...] = ()


@dataclass
class JacResult:
    """Columnar JAC/AJI result, one entry per genome-pair slot.

    Equivalent to the reference's ``std::vector<JACTuple>`` + AJI vector
    (include/pfaai/interface.hpp:56-75, algorithm_impl.hpp:309-322) in
    struct-of-arrays form.  ``genome_a``/``genome_b`` carry the *JAC label*
    convention of each mode (see modes.py), ``s`` the f64 Jaccard sum in
    ascending-protein accumulation order, ``n`` the count of proteins with a
    non-empty tetramer intersection, and ``aji = s / n`` (NaN when n == 0,
    matching the reference's 0.0/0 division).
    """

    genome_a: np.ndarray  # int32 (n_pairs,)
    genome_b: np.ndarray  # int32 (n_pairs,)
    s: np.ndarray  # float64 (n_pairs,)
    n: np.ndarray  # int32 (n_pairs,)
    aji: np.ndarray = field(default=None)  # float64 (n_pairs,)

    def __post_init__(self):
        if self.aji is None:
            with np.errstate(divide="ignore", invalid="ignore"):
                self.aji = self.s / self.n

    @property
    def n_pairs(self) -> int:
        return int(self.s.shape[0])
