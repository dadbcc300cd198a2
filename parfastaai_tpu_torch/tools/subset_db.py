"""Subset-database tool: derive a smaller FastAAI SQLite DB from a master.

Equivalent of the reference's data tooling (data/subset_db.py:13-275),
reimplemented on stdlib sqlite3 + numpy.  Given a master database and an
ordered list of genome names, writes a new database in which:

* new genome ids are the index of each name in the given list
  (subset_db.py:20),
* ``genome_metadata`` and ``scp_data`` rows are filtered to the subset and
  id-remapped, preserving source row order (subset_db.py:174-221),
* ``index_protein`` / ``protein_index`` are copied verbatim
  (subset_db.py:223-260),
* every ``{SCP}_tetras`` table has its genome blobs filtered to subset
  members, remapped, re-sorted ascending by new id, with now-empty rows
  dropped, plus the ``(tetramer)`` index (subset_db.py:79-121),
* every ``{SCP}_genomes`` table is filtered and id-remapped; the tetramer
  blobs themselves are unchanged (subset_db.py:162-170).

Unlike the reference tool, SCP tables are processed in ``scp_data`` DISTINCT
emission order (the engine's canonical protein order) rather than Python set
order — table order in the file does not affect any reader.

The port's own copy of ``parfastaai_tpu/tools/subset_db.py`` (the same
tables, row for row):

    python -m parfastaai_tpu_torch.tools.subset_db master.db subset.db -g names.txt
"""

from __future__ import annotations

import argparse
import os
import sqlite3

import numpy as np


def load_genome_list(path: str) -> list[str]:
    with open(path) as fp:
        return fp.read().split()


def build_subset_db(src_path: str, dst_path: str, genome_names: list[str]) -> None:
    """Write ``dst_path`` as the subset of ``src_path`` over ``genome_names``
    (new genome id = position in the list)."""
    if os.path.exists(dst_path):
        raise FileExistsError(f"Refusing to overwrite existing {dst_path}")
    src = sqlite3.connect(f"file:{src_path}?mode=ro", uri=True)
    dst = sqlite3.connect(dst_path)
    try:
        _build(src, dst, genome_names)
    finally:
        src.close()
        dst.close()


def _build(src: sqlite3.Connection, dst: sqlite3.Connection, names: list[str]) -> None:
    new_id = {g: i for i, g in enumerate(names)}
    meta_rows = src.execute(
        "SELECT genome_name, genome_id, genome_length, genome_class, SCP_count"
        " FROM genome_metadata"
    ).fetchall()
    have = {r[0] for r in meta_rows}
    missing = [g for g in names if g not in have]
    if missing:
        raise ValueError(f"Genome(s) not in source database: {', '.join(missing)}")
    old_to_new = {r[1]: new_id[r[0]] for r in meta_rows if r[0] in new_id}

    dst.execute(
        "CREATE TABLE 'genome_metadata' (genome_name TEXT, genome_id INTEGER "
        "PRIMARY KEY, genome_length INTEGER, genome_class INTEGER, SCP_count INTEGER)"
    )
    dst.executemany(
        "INSERT INTO genome_metadata VALUES (?,?,?,?,?)",
        [
            (r[0], old_to_new[r[1]], r[2], r[3], r[4])
            for r in meta_rows
            if r[1] in old_to_new
        ],
    )

    dst.execute(
        "CREATE TABLE 'scp_data' (genome_id INTEGER, SCP_acc TEXT, "
        "SCP_score REAL, tetra_count INTEGER)"
    )
    dst.executemany(
        "INSERT INTO scp_data VALUES (?,?,?,?)",
        [
            (old_to_new[gid], acc, score, cnt)
            for gid, acc, score, cnt in src.execute(
                "SELECT genome_id, SCP_acc, SCP_score, tetra_count FROM scp_data"
            )
            if gid in old_to_new
        ],
    )

    dst.execute(
        "CREATE TABLE index_protein (protein_number INTEGER PRIMARY KEY, "
        "protein_string VARCHAR(255) NOT NULL)"
    )
    dst.executemany(
        "INSERT INTO index_protein VALUES (?,?)",
        src.execute("SELECT protein_number, protein_string FROM index_protein"),
    )
    dst.execute(
        "CREATE TABLE protein_index (protein_string VARCHAR(255) NOT NULL "
        "PRIMARY KEY, protein_number INTEGER)"
    )
    dst.executemany(
        "INSERT INTO protein_index VALUES (?,?)",
        src.execute("SELECT protein_string, protein_number FROM protein_index"),
    )

    proteins = [
        r[0] for r in src.execute("SELECT DISTINCT SCP_acc FROM scp_data")
    ]
    max_src_id = max(r[1] for r in meta_rows)
    keep = np.zeros(max_src_id + 1, dtype=bool)
    remap = np.zeros(max_src_id + 1, dtype=np.int32)
    for old, new in old_to_new.items():
        keep[old] = True
        remap[old] = new
    for prot in proteins:
        dst.execute(
            f"CREATE TABLE '{prot}_tetras' "
            "(tetramer INTEGER PRIMARY KEY, genomes BLOB)"
        )
        rows = []
        for tet, blob in src.execute(
            f"SELECT tetramer, genomes FROM '{prot}_tetras'"
        ):
            gids = np.frombuffer(blob, dtype="<i4")
            sel = gids[keep[gids]]
            if len(sel):
                mapped = np.sort(remap[sel]).astype("<i4")
                rows.append((tet, mapped.tobytes()))
        dst.executemany(f"INSERT INTO '{prot}_tetras' VALUES (?,?)", rows)
        dst.execute(
            f"CREATE INDEX `{prot}_tetras_index` ON `{prot}_tetras` (tetramer)"
        )

        dst.execute(
            f"CREATE TABLE '{prot}_genomes' "
            "(genome_id INTEGER PRIMARY KEY, tetramers BLOB)"
        )
        dst.executemany(
            f"INSERT INTO '{prot}_genomes' VALUES (?,?)",
            [
                (old_to_new[gid], blob)
                for gid, blob in src.execute(
                    f"SELECT genome_id, tetramers FROM '{prot}_genomes'"
                )
                if gid in old_to_new
            ],
        )
    dst.commit()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m parfastaai_tpu_torch.tools.subset_db",
        description="Derive a subset FastAAI SQLite database from a master",
    )
    p.add_argument("src_db", help="Master database path")
    p.add_argument("dst_db", help="Output subset database path (must not exist)")
    p.add_argument(
        "-g",
        "--genome-list",
        required=True,
        help="File of genome names (whitespace-separated); order defines new ids",
    )
    args = p.parse_args(argv)
    names = load_genome_list(args.genome_list)
    build_subset_db(args.src_db, args.dst_db, names)
    print(f"Wrote {args.dst_db}: {len(names)} genomes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
