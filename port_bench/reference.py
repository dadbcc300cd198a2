"""The plain reference: the AJI matrix worked out again from the tetramer
sets of the SQLite files, and the comparison of a CSV with it.

It reads each genome's set of each single-copy protein from the
``'{SCP}_genomes'`` tables (the port's ETL reads the ``'{SCP}_tetras'``
tables instead), counts every intersection with one dense matmul per
protein, and accumulates the Jaccard indices in ascending protein order,
as ParFastAAI defines the AJI:

    J_p(a, b) = |A_p & B_p| / (T_p(a) + T_p(b) - |A_p & B_p|)
    AJI(a, b) = sum of J_p over the proteins p with a non-empty
                intersection, divided by their number N

with T_p(g) the size of genome g's set.  All-vs-all output is the full
genome x genome matrix with 0 on the diagonal.  Two-database output has the
query genomes as rows and the target genomes as columns; its denominators
read T as ParFastAAI does (``algorithm_impl.hpp:250-253``): with the targets
at ids [0, nt) and the queries at [nt, nt + nq), row i (query i) reads T at
id i and column j (target j) at id nq + j.  Query-subset output has the
listed genomes as rows, in list order, and every genome of the database as
columns: the all-vs-all matrix's rows of those genomes, with 0 at each
query's own cell.  A cell with N = 0 is NaN in the f64 output and 0 in the
f32 output.

Plain PyTorch and NumPy; nothing of the program under test.
"""

from __future__ import annotations

import math
import sqlite3
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Database:
    genome_names: list[str]  # in genome_metadata order
    proteins: list[str]  # SELECT DISTINCT SCP_acc order
    # per protein: the sets of every genome, as (genome index, tetramer)
    # pairs, and each genome's set size
    members: dict[str, tuple[np.ndarray, np.ndarray]]
    sizes: dict[str, np.ndarray]


def read_database(path: str) -> Database:
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True)
    try:
        rows = conn.execute(
            "SELECT genome_id, genome_name FROM genome_metadata").fetchall()
        names = [name for _, name in rows]
        index = {gid: i for i, (gid, _) in enumerate(rows)}
        proteins = [r[0] for r in conn.execute(
            "SELECT DISTINCT SCP_acc FROM scp_data")]
        members, sizes = {}, {}
        for prot in proteins:
            rows = conn.execute(
                f"SELECT genome_id, tetramers FROM '{prot}_genomes'"
            ).fetchall()
            genome = np.array([index[gid] for gid, _ in rows], dtype=np.int64)
            length = np.array([len(blob) // 4 for _, blob in rows],
                              dtype=np.int64)
            tets = np.frombuffer(b"".join(blob for _, blob in rows),
                                 dtype="<i4").astype(np.int64)
            members[prot] = (np.repeat(genome, length), tets)
            sizes[prot] = np.zeros(len(names), dtype=np.int64)
            sizes[prot][genome] = length
    finally:
        conn.close()
    return Database(names, proteins, members, sizes)


@dataclass
class Matrix:
    row_names: list[str]
    col_names: list[str]
    aji: np.ndarray  # (rows, cols)


def _presence(dbs: list[Database], prot: str, device: torch.device):
    """(G_total, K) 0/1 float64 presence of one protein over the genomes of
    ``dbs`` in order, over the tetramers that occur."""
    gids, tets, offset = [], [], 0
    for db in dbs:
        g, t = db.members[prot]
        gids.append(g + offset)
        tets.append(t)
        offset += len(db.genome_names)
    gids, tets = np.concatenate(gids), np.concatenate(tets)
    cols, col_of = np.unique(tets, return_inverse=True)
    m = torch.zeros((offset, max(1, len(cols))), dtype=torch.float64,
                    device=device)
    m[torch.from_numpy(gids).to(device),
      torch.from_numpy(col_of.reshape(-1)).to(device)] = 1.0
    return m


def read_names(path: str) -> list[str]:
    """The genome names of a query list, whitespace-separated, in order."""
    with open(path) as fp:
        return fp.read().split()


def aji(target: str | Database, query: str | Database | None = None, *,
        queries: list[str] | None = None, device="cpu",
        dtype: torch.dtype = torch.float64, empty_is_zero: bool = False,
        row_block: int = 1024) -> Matrix:
    """The AJI matrix of one database (all-vs-all), of the genomes named
    in ``queries`` against all of it (query subset), or of ``query``
    against ``target`` (paths, or databases read before).  Counts are
    exact; the finish (each J_p, their sum, the divide) runs in ``dtype``.
    ``empty_is_zero``: cells with N = 0 are 0 (the f32 output), else NaN."""
    device = torch.device(device)
    tdb = read_database(target) if isinstance(target, str) else target
    qdb = read_database(query) if isinstance(query, str) else query
    if qdb is not None and queries is not None:
        raise ValueError("a query database or a query list, not both")
    if qdb is None:
        dbs, proteins = [tdb], tdb.proteins
        rows = cols = np.arange(len(tdb.genome_names))
        row_names = col_names = tdb.genome_names
        if queries is not None:
            index = {name: g for g, name in enumerate(tdb.genome_names)}
            unknown = [q for q in queries if q not in index]
            if unknown or len(set(queries)) != len(queries):
                raise ValueError(f"query list: unknown {unknown[:3]} or "
                                 "repeated names")
            rows = np.array([index[q] for q in queries], dtype=np.int64)
            row_names = queries
        row_t, col_t = rows, cols
    else:
        dbs = [tdb, qdb]
        shared = set(qdb.proteins)
        proteins = [p for p in tdb.proteins if p in shared]
        nt, nq = len(tdb.genome_names), len(qdb.genome_names)
        rows, cols = nt + np.arange(nq), np.arange(nt)
        row_t, col_t = np.arange(nq), nq + np.arange(nt)
        row_names, col_names = qdb.genome_names, tdb.genome_names
    n_rows, n_cols = len(rows), len(cols)
    s = torch.zeros((n_rows, n_cols), dtype=dtype, device=device)
    n = torch.zeros((n_rows, n_cols), dtype=torch.int32, device=device)
    rows_d = torch.from_numpy(rows).to(device)
    cols_d = torch.from_numpy(cols).to(device)
    for prot in proteins:
        m = _presence(dbs, prot, device)
        t = torch.from_numpy(np.concatenate(
            [db.sizes[prot] for db in dbs])).to(device=device,
                                                dtype=torch.float64)
        tb = t[torch.from_numpy(col_t).to(device)]
        mc = m[cols_d]
        for r0 in range(0, n_rows, row_block):
            r1 = min(n_rows, r0 + row_block)
            c = m[rows_d[r0:r1]] @ mc.T
            ta = t[torch.from_numpy(row_t[r0:r1]).to(device)]
            hit = c > 0
            denom = (ta[:, None] + tb[None, :] - c).to(dtype)
            j = torch.where(hit, c.to(dtype) / denom, torch.zeros((), dtype=dtype,
                                                                  device=device))
            s[r0:r1] += j
            n[r0:r1] += hit
        del m, mc
    out = s / n.to(dtype)
    if empty_is_zero:
        out = torch.where(n == 0, torch.zeros((), dtype=dtype, device=device),
                          out)
    if qdb is None:
        out[torch.arange(n_rows, device=device), rows_d] = 0
    return Matrix(list(row_names), list(col_names),
                  out.to(torch.float64).cpu().numpy())


def format_double(x: float) -> str:
    """A double as ParFastAAI's CSV writes it (fmt's ``{}``): the shortest
    text that reads back to it, without a trailing ``.0``."""
    if math.isnan(x):
        return "nan"
    if math.isinf(x):
        return "inf" if x > 0 else "-inf"
    text = repr(float(x))
    return text[:-2] if text.endswith(".0") else text


# The CLI's default field separator, which every cell uses.
SEP = ","


@dataclass
class Csv:
    header: list[str]
    row_names: list[str]
    values: np.ndarray  # (rows, cols) float64; NaN where a row is short
    lines: list[bytes]  # the data lines as written
    malformed: int  # rows whose value count is not the header's


def read_csv(path: str) -> Csv:
    with open(path, "rb") as fp:
        lines = fp.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    sep = SEP.encode()
    header = lines[0].decode().split(SEP)[1:] if lines else []
    data = lines[1:]
    values = np.full((len(data), len(header)), np.nan)
    names, malformed = [], 0
    for i, line in enumerate(data):
        name, _, rest = line.partition(sep)
        names.append(name.decode(errors="replace"))
        try:
            row = np.array(rest.split(sep), dtype=np.float64)
        except ValueError:
            malformed += 1
            continue
        if len(row) != len(header):
            malformed += 1
            continue
        values[i] = row
    return Csv(header, names, values, data, malformed)


def compare(csv: Csv, ref: Matrix, kind: str,
            sample_rows: np.ndarray) -> dict[str, float]:
    """The numbers that decide ``correct``.

    Every kind: ``labels_differing``, the header and row labels that are
    not the reference's, plus rows missing, extra or malformed.  ``exact``
    (an f64 output): ``values_differing``, the cells whose value is not the
    reference's double (NaN equals NaN), and ``text_rows_differing``, the
    rows of ``sample_rows`` whose bytes are not the reference's formatted
    row.  ``f32``: ``max_abs_gap``, the widest gap between a cell and the
    reference's f64 value (a NaN where the reference has a number, or a
    missing cell, is an infinite gap)."""
    n_rows, n_cols = len(ref.row_names), len(ref.col_names)
    labels = sum(a != b for a, b in zip(csv.header, ref.col_names))
    labels += sum(a != b for a, b in zip(csv.row_names, ref.row_names))
    labels += abs(len(csv.header) - n_cols) + abs(len(csv.row_names) - n_rows)
    labels += csv.malformed
    out: dict[str, float] = {"labels_differing": int(labels)}
    got = np.full((n_rows, n_cols), np.nan)
    r, c = min(n_rows, csv.values.shape[0]), min(n_cols, csv.values.shape[1])
    got[:r, :c] = csv.values[:r, :c]
    present = np.zeros((n_rows, n_cols), dtype=bool)
    present[:r, :c] = True
    if kind == "exact":
        same = (got == ref.aji) | (np.isnan(got) & np.isnan(ref.aji))
        out["values_differing"] = int((~(same & present)).sum())
        text = 0
        for i in sample_rows:
            want = (ref.row_names[i] + SEP + SEP.join(
                format_double(v) for v in ref.aji[i])).encode()
            text += i >= len(csv.lines) or csv.lines[i] != want
        out["text_rows_differing"] = int(text)
    elif kind == "f32":
        gap = np.abs(got - ref.aji)
        gap[np.isnan(gap) | ~present] = np.inf
        out["max_abs_gap"] = float(gap.max()) if gap.size else 0.0
    else:
        raise ValueError(f"unknown comparison {kind!r}")
    return out
