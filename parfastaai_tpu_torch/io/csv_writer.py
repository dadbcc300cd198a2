"""AJI CSV writer, byte-compatible with the reference's printOutput
(src/main.cpp:133-175).

Builds the dense |Q| x |T| matrix initialized to 0.0, scatters each pair's AJI
to (row, col) — and to the mirror cell when the mode defines one — then writes
a header row of target names and one row per query genome, all values
formatted with fmt-compatible shortest-round-trip doubles (io/fmtfloat.py).
Untouched cells (including the diagonal) print ``0``.
"""

from __future__ import annotations

import numpy as np

from ..constants import DEFAULT_SEPARATOR
from ..modes import PairSpace
from .fmtfloat import format_double


def aji_matrix(pairs: PairSpace, aji: np.ndarray) -> np.ndarray:
    mat = np.zeros((len(pairs.query_names), len(pairs.target_names)), dtype=np.float64)
    mat[pairs.out_row, pairs.out_col] = aji
    has_mirror = pairs.mirror_row >= 0
    mat[pairs.mirror_row[has_mirror], pairs.mirror_col[has_mirror]] = aji[has_mirror]
    return mat


def write_aji_csv(
    path: str,
    pairs: PairSpace,
    aji: np.ndarray,
    separator: str = DEFAULT_SEPARATOR,
    row_chunk: int = 256,
) -> None:
    """Format and write in ``row_chunk`` slices so transient formatted strings
    stay O(row_chunk * cols) — a G=4096 all-vs-all matrix fully materialized
    would be several hundred MB of short-lived strings.  Span ``csv`` of a
    recorded call (``utils.timing``), counters ``rows`` and ``mirrored``
    (the pairs scattered to a mirror cell too)."""
    from ..utils import timing

    with timing.span("csv"):
        mat = aji_matrix(pairs, aji)
        if timing.active():
            timing.count(mirrored=np.count_nonzero(pairs.mirror_row >= 0))
        with open(path, "w") as fp:
            fp.write(separator + separator.join(pairs.target_names) + "\n")
            for r0 in range(0, mat.shape[0], row_chunk):
                rows = format_matrix(mat[r0 : r0 + row_chunk], separator)
                for name, row in zip(
                    pairs.query_names[r0 : r0 + row_chunk], rows
                ):
                    fp.write(name + separator + row + "\n")
        timing.count(rows=mat.shape[0])


def format_matrix(mat: np.ndarray, separator: str) -> list[str]:
    """All rows of a matrix as CSV strings; OpenMP-parallel native formatter
    when available (validated byte-identical at first use), row-at-a-time
    otherwise."""
    if len(separator) == 1:
        from ..native import native_format_matrix

        rows = native_format_matrix(mat, separator)
        if rows is not None:
            return [r.decode("ascii") for r in rows]
    return [format_row(mat[i], separator) for i in range(mat.shape[0])]


def format_row(values: np.ndarray, separator: str) -> str:
    """One row of doubles, shortest-round-trip; native C++ formatter when
    available (validated byte-identical at first use), Python otherwise."""
    if len(separator) == 1:
        from ..native import native_format_row

        row = native_format_row(values, separator)
        if row is not None:
            return row.decode("ascii")
    return separator.join(format_double(v) for v in values)
