"""Synthetic FastAAI-format SQLite database generator.

Fixture/benchmark tooling (the counterpart of the reference's
data/subset_db.py): produces databases with the exact schema of the bundled
fixtures (verified live against data/xdb_subset1.db; see etl/database.py) at
arbitrary scale, so the OpenMP reference binary and this framework can be
benchmarked on identical inputs.

The statistical shape mimics xanthodb: each protein has a pool of plausible
tetramers; each genome draws ~``tetras_per_genome`` of them, giving related
genomes the high pairwise overlap (J ~ pool sharing) seen in real SCP data.

Usage:
    python -m parfastaai_tpu_torch.tools.synth_db out.db --genomes 256 --proteins 80
"""

from __future__ import annotations

import argparse
import sqlite3

import numpy as np

from ..constants import NTETRAMERS


def generate(
    path: str,
    n_genomes: int = 256,
    n_proteins: int = 80,
    pool_size: int = 1200,
    tetras_per_genome: int = 400,
    seed: int = 0,
) -> None:
    rng = np.random.default_rng(seed)
    conn = sqlite3.connect(path)
    cur = conn.cursor()
    cur.execute("PRAGMA journal_mode=OFF")
    cur.execute("PRAGMA synchronous=OFF")

    genome_names = [f"synthetic_genome_{i:05d}.fna.gz" for i in range(n_genomes)]
    protein_names = [f"PF{90000 + i}.1" for i in range(n_proteins)]

    cur.execute(
        "CREATE TABLE 'genome_metadata' (genome_name TEXT, genome_id INTEGER "
        "PRIMARY KEY, genome_length INTEGER, genome_class INTEGER, SCP_count INTEGER)"
    )
    cur.executemany(
        "INSERT INTO genome_metadata VALUES (?, ?, ?, 0, ?)",
        [
            (name, gid, 3_500_000 + gid, n_proteins)
            for gid, name in enumerate(genome_names)
        ],
    )
    cur.execute(
        "CREATE TABLE 'scp_data' (genome_id INTEGER, SCP_acc TEXT, "
        "SCP_score REAL, tetra_count INTEGER)"
    )
    cur.execute(
        "CREATE TABLE index_protein (protein_number INTEGER PRIMARY KEY, "
        "protein_string VARCHAR(255) NOT NULL)"
    )
    cur.execute(
        "CREATE TABLE protein_index (protein_string VARCHAR(255) NOT NULL "
        "PRIMARY KEY, protein_number INTEGER)"
    )
    cur.executemany(
        "INSERT INTO index_protein VALUES (?, ?)",
        list(enumerate(protein_names, start=1)),
    )
    cur.executemany(
        "INSERT INTO protein_index VALUES (?, ?)",
        [(n, i) for i, n in enumerate(protein_names, start=1)],
    )

    scp_rows = []
    for p, prot in enumerate(protein_names):
        pool = rng.choice(NTETRAMERS, size=pool_size, replace=False).astype(np.int32)
        # genome -> sorted tetramer set drawn from the pool
        sets = []
        for g in range(n_genomes):
            k = int(
                np.clip(rng.normal(tetras_per_genome, tetras_per_genome * 0.05), 8, pool_size)
            )
            sets.append(np.sort(rng.choice(pool, size=k, replace=False)))
            scp_rows.append((g, prot, float(rng.uniform(100, 500)), k))

        cur.execute(
            f"CREATE TABLE '{prot}_genomes' (genome_id INTEGER PRIMARY KEY, "
            "tetramers BLOB)"
        )
        cur.executemany(
            f"INSERT INTO '{prot}_genomes' VALUES (?, ?)",
            [(g, sets[g].astype("<i4").tobytes()) for g in range(n_genomes)],
        )

        # Invert: tetramer -> sorted genome-id blob.
        all_tets = np.concatenate(sets)
        all_gids = np.concatenate(
            [np.full(len(s), g, dtype=np.int32) for g, s in enumerate(sets)]
        )
        order = np.lexsort((all_gids, all_tets))
        all_tets, all_gids = all_tets[order], all_gids[order]
        bounds = np.flatnonzero(np.diff(all_tets)) + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [len(all_tets)]])
        cur.execute(
            f"CREATE TABLE '{prot}_tetras' (tetramer INTEGER PRIMARY KEY, "
            "genomes BLOB)"
        )
        cur.executemany(
            f"INSERT INTO '{prot}_tetras' VALUES (?, ?)",
            [
                (int(all_tets[s]), all_gids[s:e].astype("<i4").tobytes())
                for s, e in zip(starts, ends)
            ],
        )

    cur.executemany("INSERT INTO scp_data VALUES (?, ?, ?, ?)", scp_rows)
    conn.commit()
    conn.close()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("output")
    ap.add_argument("--genomes", type=int, default=256)
    ap.add_argument("--proteins", type=int, default=80)
    ap.add_argument("--pool-size", type=int, default=1200)
    ap.add_argument("--tetras-per-genome", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    generate(
        a.output, a.genomes, a.proteins, a.pool_size, a.tetras_per_genome, a.seed
    )


if __name__ == "__main__":
    main()
