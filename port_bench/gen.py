"""FastAAI SQLite databases from a seed, in bulk.

The sets are calibrated to the upstream's bundled Xanthomonas data, the
only FastAAI data whose statistics the repository records:

- a protein's set holds ``tetramers_mean`` = 194 tetramers on average
  (``modified_xantho_fastaai2.db``: |F| = 310,451 over 20 genomes x 80
  SCPs; BASELINE.md:17);
- the proteins' set sizes spread about tenfold (58..558 over
  ``xdb_subset1``'s 79 SCPs; ``parfastaai_tpu_torch/etl/database.py``):
  log-normal with ``size_log_sd``, the same quantiles for every seed, in
  an order drawn from the seed;
- related genomes share nearly all of a protein's set (``xdb_subset1``:
  |E| = 91,830 shared tetramers over 6 pairs x 80 SCPs, 191 of 194 a pair
  and protein; AJI(g0, g1) = 0.947 in ``xanthodb``; BASELINE.md:18-19).

So each protein has one ancestral set, drawn from the seed, and each
genome keeps each ancestral tetramer with probability ``1 - change_rate``
and the G genomes of a run gain ``round(G * size * change_rate)``
tetramers in all, drawn without replacement from the 20**4 that the
ancestral set lacks and spread over the genomes at random.  Two genomes
then share ``size * (1 - change_rate)**2`` tetramers of a protein, and the
protein's compacted width is ``size + round(G * size * change_rate)`` for
every seed: the seed moves which tetramers and which genomes, never how
much work a call has.

The tables are the ones FastAAI writes and the port's ETL reads:
``genome_metadata``, ``scp_data``, ``index_protein``, ``protein_index``,
``'{SCP}_genomes'`` (genome -> sorted tetramer ids, int32 LE) and
``'{SCP}_tetras'`` (tetramer -> sorted genome ids, int32 LE).  Every
protein has its own random stream, spawned from the seed, so the proteins
draw in parallel and the result depends on the seed alone.  Two databases
from one seed (query and target) share the ancestral sets and the protein
order, and their genome names are disjoint.

The configuration's ``mode`` says what a seed makes: ``all_vs_all`` one
database of ``n_genomes``; ``query_target`` that database and a query
database of ``n_query_genomes``; ``query_subset`` the all-vs-all database,
byte for byte, and ``queries.txt``, ``n_query_genomes`` of its genome names
drawn from the seed, one a line, in the seed's order (which sets the rows
of the CSV).
"""

from __future__ import annotations

import os
import sqlite3
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

# 20 amino acids, 4 positions.
NTETRAMERS = 20**4
MODES = ("all_vs_all", "query_target", "query_subset")


@dataclass
class Collection:
    """One database's genomes: per protein the sorted keys
    ``genome * NTETRAMERS + tetramer`` of every genome's set."""

    genome_names: list[str]
    sets: list[np.ndarray]  # per protein: int64, ascending


def _seq(seed: int, *key: int) -> np.random.SeedSequence:
    """The random stream of ``seed`` for one purpose, named by ``key``."""
    return np.random.SeedSequence([int(seed) % (1 << 64), *key])


def _streams(seed: int, n: int, *key: int) -> list[np.random.Generator]:
    return [np.random.default_rng(s) for s in _seq(seed, *key).spawn(n)]


def _threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def set_sizes(n_proteins: int, mean: float, log_sd: float) -> np.ndarray:
    """The ancestral set sizes: the log-normal's quantiles at
    ``(p + 0.5) / n_proteins``, scaled to ``mean``, ascending."""
    z = np.array([NormalDist().inv_cdf((p + 0.5) / n_proteins)
                  for p in range(n_proteins)])
    raw = np.exp(log_sd * z)
    return np.maximum(1, np.rint(raw * mean / raw.mean())).astype(np.int64)


def ancestors(seed: int, config: dict) -> list[np.ndarray]:
    """Per protein its ancestral set of tetramer ids, ascending; the sizes
    of ``set_sizes`` in an order drawn from the seed."""
    n_prot = config["n_proteins"]
    sizes = set_sizes(n_prot, config["tetramers_mean"], config["size_log_sd"])
    order = np.random.default_rng(_seq(seed, 0)).permutation(n_prot)
    return [np.sort(rng.choice(NTETRAMERS, size=int(k), replace=False))
            for rng, k in zip(_streams(seed, n_prot, 1), sizes[order])]


def _genomes(rng: np.random.Generator, n_genomes: int, ancestor: np.ndarray,
             rate: float) -> np.ndarray:
    """One protein's sets of ``n_genomes`` genomes, as sorted keys.  The
    genomes gain ``round(n_genomes * size * rate)`` tetramers in all, each
    new to the protein, so its width is the same for every seed."""
    size = len(ancestor)
    kept = rng.random((n_genomes, size)) >= rate
    g, i = np.nonzero(kept)
    total = round(n_genomes * size * rate)
    gained = rng.multinomial(total, np.full(n_genomes, 1.0 / n_genomes))
    others = np.setdiff1d(np.arange(NTETRAMERS), ancestor)
    keys = np.concatenate([
        g * NTETRAMERS + ancestor[i],
        np.repeat(np.arange(n_genomes), gained) * NTETRAMERS
        + others[rng.choice(len(others), size=total, replace=False)]])
    return np.sort(keys)


def collections(seed: int, names: list[list[str]],
                ancestral: list[np.ndarray], rate: float) -> list[Collection]:
    """One collection per list of genome names, all derived from the
    ancestral sets and drawn together, so that no tetramer is gained twice
    over the databases of one seed."""
    n = sum(len(x) for x in names)
    with ThreadPoolExecutor(_threads()) as ex:
        sets = list(ex.map(lambda r, a: _genomes(r, n, a, rate),
                           _streams(seed, len(ancestral), 2), ancestral))
    out, lo = [], 0
    for part in names:
        hi = lo + len(part)
        per = []
        for keys in sets:
            a, b = np.searchsorted(keys, [lo * NTETRAMERS, hi * NTETRAMERS])
            per.append(keys[a:b] - lo * NTETRAMERS)
        out.append(Collection(genome_names=list(part), sets=per))
        lo = hi
    return out


def protein_names(n_proteins: int) -> list[str]:
    return [f"PF{90000 + i}.1" for i in range(n_proteins)]


def genome_names(prefix: str, n: int) -> list[str]:
    return [f"{prefix}genome_{i:05d}.fna.gz" for i in range(n)]


def _blobs(keys: np.ndarray, values: np.ndarray, n_keys: int) -> list:
    """``(key, int32 LE blob of its values)`` for each key that has values;
    ``keys`` ascending, ``values`` ascending within a key."""
    per = np.bincount(keys, minlength=n_keys)
    data = values.astype("<i4").tobytes()
    ends = np.cumsum(per) * 4
    return [(k, data[e - 4 * n:e]) for k, (n, e) in
            enumerate(zip(per.tolist(), ends.tolist())) if n]


def _rows(keys: np.ndarray, n_genomes: int):
    """One protein's rows: the tetramer count of each genome, the
    ``_genomes`` rows (genome -> its tetramers, ascending) and the
    ``_tetras`` rows (tetramer -> the genomes that hold it, ascending)."""
    g, t = np.divmod(keys, NTETRAMERS)
    genomes = _blobs(g, t, n_genomes)
    order = np.lexsort((g, t))
    tets, start = np.unique(t[order], return_index=True)
    gs = g[order].astype("<i4")
    ends = np.append(start[1:], len(order))
    tetras = [(int(k), gs[s:e].tobytes())
              for k, s, e in zip(tets.tolist(), start.tolist(), ends.tolist())]
    return np.bincount(g, minlength=n_genomes).tolist(), genomes, tetras


def write_db(path: str, coll: Collection, seed: int, stream: int) -> None:
    """Write ``coll`` as a FastAAI database at ``path`` (a new file)."""
    prots = protein_names(len(coll.sets))
    n_genomes = len(coll.genome_names)
    rng = np.random.default_rng(_seq(seed, 3, stream))
    conn = sqlite3.connect(path)
    try:
        cur = conn.cursor()
        cur.execute("PRAGMA journal_mode=OFF")
        cur.execute("PRAGMA synchronous=OFF")
        cur.execute(
            "CREATE TABLE 'genome_metadata' (genome_name TEXT, genome_id "
            "INTEGER PRIMARY KEY, genome_length INTEGER, genome_class "
            "INTEGER, SCP_count INTEGER)")
        cur.executemany(
            "INSERT INTO genome_metadata VALUES (?, ?, ?, 0, ?)",
            [(name, g, 3_500_000 + g, len(prots))
             for g, name in enumerate(coll.genome_names)])
        cur.execute(
            "CREATE TABLE 'scp_data' (genome_id INTEGER, SCP_acc TEXT, "
            "SCP_score REAL, tetra_count INTEGER)")
        cur.execute(
            "CREATE TABLE index_protein (protein_number INTEGER PRIMARY KEY, "
            "protein_string VARCHAR(255) NOT NULL)")
        cur.execute(
            "CREATE TABLE protein_index (protein_string VARCHAR(255) NOT NULL "
            "PRIMARY KEY, protein_number INTEGER)")
        cur.executemany("INSERT INTO index_protein VALUES (?, ?)",
                        list(enumerate(prots, start=1)))
        cur.executemany("INSERT INTO protein_index VALUES (?, ?)",
                        [(n, i) for i, n in enumerate(prots, start=1)])
        scores = rng.uniform(100, 500, (len(prots), n_genomes))
        with ThreadPoolExecutor(_threads()) as ex:
            tables = ex.map(lambda k: _rows(k, n_genomes), coll.sets)
            for p, (prot, (counts, genomes, tetras)) in enumerate(
                    zip(prots, tables)):
                cur.executemany(
                    "INSERT INTO scp_data VALUES (?, ?, ?, ?)",
                    zip(range(n_genomes), [prot] * n_genomes,
                        scores[p].tolist(), counts))
                cur.execute(f"CREATE TABLE '{prot}_genomes' (genome_id "
                            "INTEGER PRIMARY KEY, tetramers BLOB)")
                cur.executemany(
                    f"INSERT INTO '{prot}_genomes' VALUES (?, ?)", genomes)
                cur.execute(f"CREATE TABLE '{prot}_tetras' (tetramer "
                            "INTEGER PRIMARY KEY, genomes BLOB)")
                cur.executemany(
                    f"INSERT INTO '{prot}_tetras' VALUES (?, ?)", tetras)
        conn.commit()
    finally:
        conn.close()


@dataclass
class Databases:
    """What one seed made: the target database (all-vs-all and query
    subset: the only one), the query database (two-database mode), the
    query list (query-subset mode), and the compacted width of each protein
    over every genome of the run."""

    target: str
    query: str | None
    widths: np.ndarray  # int64 (P,)
    n_genomes: int  # genomes over both databases
    query_list: str | None = None


def mode(config: dict) -> str:
    """The configuration's mode, checked with its query count."""
    name, g = config.get("mode"), config["n_genomes"]
    q = config.get("n_query_genomes")
    if name not in MODES:
        raise ValueError(f"unknown mode {name!r}: one of {MODES}")
    if name == "all_vs_all" and q is not None:
        raise ValueError("all_vs_all takes no n_query_genomes")
    if name == "query_target" and not (q is not None and q >= 1):
        raise ValueError(f"query_target needs n_query_genomes >= 1, has {q}")
    if name == "query_subset" and not (q is not None and 1 <= q < g):
        raise ValueError(f"query_subset needs 1 <= n_query_genomes < "
                         f"n_genomes = {g}, has {q}")
    return name


def query_names(seed: int, config: dict) -> list[str]:
    """The query subset's genome names: ``n_query_genomes`` distinct names
    of the database, in an order drawn from the seed."""
    picks = np.random.default_rng(_seq(seed, 4)).choice(
        config["n_genomes"], size=config["n_query_genomes"], replace=False)
    names = genome_names("", config["n_genomes"])
    return [names[i] for i in picks.tolist()]


def make(config: dict, seed: int, directory: str) -> Databases:
    """The configuration's database(s), and its query list where it has
    one, from ``seed`` in ``directory``."""
    kind = mode(config)
    files, names = ["target.db"], [genome_names("", config["n_genomes"])]
    if kind == "query_target":
        files.append("query.db")
        names.append(genome_names("q_", config["n_query_genomes"]))
    colls = list(zip(files, collections(
        seed, names, ancestors(seed, config), config["change_rate"])))
    paths = []
    for i, (name, coll) in enumerate(colls):
        path = os.path.join(directory, name)
        write_db(path, coll, seed, i)
        paths.append(path)
    widths = np.array([
        len(np.unique(np.concatenate([c.sets[p] % NTETRAMERS
                                      for _, c in colls])))
        for p in range(config["n_proteins"])], dtype=np.int64)
    query_list = None
    if kind == "query_subset":
        query_list = os.path.join(directory, "queries.txt")
        with open(query_list, "w") as fp:
            fp.write("".join(n + "\n" for n in query_names(seed, config)))
    return Databases(
        target=paths[0], query=paths[1] if len(paths) > 1 else None,
        widths=widths, n_genomes=sum(len(c.genome_names) for _, c in colls),
        query_list=query_list)


def main(argv: list[str] | None = None) -> None:
    """``python -m port_bench.gen CONFIG SEED DIR``: the configuration's
    database(s) and query list (CONFIG a JSON object) from SEED in DIR;
    prints what ``make`` returns as JSON."""
    import json
    import sys

    import time

    t0 = time.perf_counter()
    config, seed, directory = (argv if argv is not None else sys.argv[1:])
    dbs = make(json.loads(config), int(seed), directory)
    print(json.dumps({"target": dbs.target, "query": dbs.query,
                      "query_list": dbs.query_list,
                      "widths": dbs.widths.tolist(),
                      "n_genomes": dbs.n_genomes,
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
