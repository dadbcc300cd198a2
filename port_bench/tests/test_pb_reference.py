"""The plain reference against a brute-force set-intersection AJI, and
against the port's CLI on the CPU at tiny sizes; the comparison's
numbers."""

import math
import os

import numpy as np
import pytest
import torch

from port_bench import gen, reference
from port_bench.tests.pb_tiny import write_sets

# Four genomes, three proteins.  Genomes 0 and 3 share nothing in protein
# 0 (left out of N there); genome 2 shares nothing with genome 3 in any
# protein (N = 0); genome 3 lacks protein 2 (T = 0).
SETS = [
    [{1, 2, 3, 4}, {10, 11, 12}, {20, 21}],
    [{2, 3, 5}, {10, 12, 13, 14}, {20, 22, 23}],
    [{1, 4, 5, 6}, {11, 13}, {21, 24}],
    [{7, 8}, {15, 16}, set()],
]
QUERY = [
    [{1, 7}, {10, 15, 16}, {20}],
    [{40}, {41}, {24, 21}],
]


def brute(rows, cols, t_row, t_col, empty_is_zero=False):
    """AJI of every (row, col) genome by set arithmetic, in ascending
    protein order; t_row / t_col give each genome's T per protein."""
    out = np.zeros((len(rows), len(cols)))
    for i, a in enumerate(rows):
        for j, b in enumerate(cols):
            s, n = 0.0, 0
            for p in range(len(a)):
                c = len(a[p] & b[p])
                if c:
                    s += c / (t_row[i][p] + t_col[j][p] - c)
                    n += 1
            out[i, j] = s / n if n else (0.0 if empty_is_zero else math.nan)
    return out


def same(a, b):
    return np.array_equal(a, b, equal_nan=True)


@pytest.mark.parametrize("empty_is_zero", [False, True])
def test_all_vs_all_matches_brute_force(tmp_path, empty_is_zero):
    path = str(tmp_path / "a.db")
    write_sets(path, SETS)
    sizes = [[len(s) for s in g] for g in SETS]
    want = brute(SETS, SETS, sizes, sizes, empty_is_zero)
    np.fill_diagonal(want, 0.0)
    got = reference.aji(path, empty_is_zero=empty_is_zero, row_block=3)
    assert same(got.aji, want)
    assert got.row_names == got.col_names == gen.genome_names("", 4)
    assert math.isnan(want[2, 3]) != empty_is_zero  # N = 0
    # genomes 1 and 2 share nothing in protein 2: N = 2
    assert want[1, 2] == (1 / (3 + 4 - 1) + 1 / (4 + 2 - 1)) / 2


def test_query_target_layout_and_t_read(tmp_path):
    """Rows are the queries, columns the targets; T is read at id i for
    query i and at id nq + j for target j over [targets, queries]."""
    t, q = str(tmp_path / "t.db"), str(tmp_path / "q.db")
    write_sets(t, SETS)
    write_sets(q, QUERY, prefix="q_")
    union = [[len(s) for s in g] for g in SETS + QUERY]
    nq = len(QUERY)
    want = brute(QUERY, SETS, union[:nq],
                 [union[nq + j] for j in range(len(SETS))])
    got = reference.aji(t, q)
    assert got.row_names == gen.genome_names("q_", 2)
    assert got.col_names == gen.genome_names("", 4)
    assert same(got.aji, want)
    # the T read differs from the genomes' own sizes
    plain = brute(QUERY, SETS, [[len(s) for s in g] for g in QUERY],
                  [[len(s) for s in g] for g in SETS])
    assert not same(plain, want)


@pytest.mark.parametrize("queries", [[3, 0], [1, 2, 0], [2]],
                         ids=["two", "three", "one"])
def test_query_subset_rows(tmp_path, queries):
    """The query subset's rows are the all-vs-all matrix's rows of the
    listed genomes, in list order, with 0 at each query's own cell."""
    path = str(tmp_path / "a.db")
    write_sets(path, SETS)
    full = reference.aji(path)
    names = [full.row_names[g] for g in queries]
    got = reference.aji(path, queries=names, row_block=2)
    assert got.row_names == names
    assert got.col_names == full.col_names
    assert same(got.aji, full.aji[queries])
    assert (got.aji[np.arange(len(queries)), queries] == 0).all()
    f32 = reference.aji(path, queries=names, dtype=torch.float32)
    assert same(f32.aji, reference.aji(path, dtype=torch.float32).aji[queries])
    with pytest.raises(ValueError, match="query list"):
        reference.aji(path, queries=names + ["nothere"])
    with pytest.raises(ValueError, match="query list"):
        reference.aji(path, queries=names + names[:1])


def test_read_names(tmp_path):
    path = tmp_path / "q.txt"
    path.write_text("b.fna\n a.fna\tc.fna\n\n")
    assert reference.read_names(str(path)) == ["b.fna", "a.fna", "c.fna"]


def test_lower_precision_differs(tmp_path):
    path = str(tmp_path / "a.db")
    write_sets(path, SETS)
    f64 = reference.aji(path)
    f32 = reference.aji(path, dtype=torch.float32)
    assert np.allclose(f32.aji, f64.aji, equal_nan=True, rtol=1e-6)
    assert not same(f32.aji, f64.aji)


def run_cli(argv):
    import parfastaai_tpu_torch.cli as cli

    assert cli.run(argv + ["--quiet", "--device", "cpu"]) == 0


@pytest.mark.parametrize("flags,env", [
    ([], {}), ([], {"PARFASTAAI_EXACT_HOST_BYTES": "1"}),
    (["--streamed"], {}), (["--fast"], {})],
    ids=["dense", "banded", "streamed", "fast"])
@pytest.mark.parametrize("mode", ["all_vs_all", "query_target",
                                  "query_subset"], ids=["avsa", "qdb", "qsub"])
def test_port_cli_agrees(tmp_path, monkeypatch, flags, env, mode):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = dict(n_genomes=30, n_proteins=4, tetramers_mean=20,
               size_log_sd=0.46, change_rate=0.2, mode=mode)
    if mode != "all_vs_all":
        cfg["n_query_genomes"] = 7
    d = gen.make(cfg, 2**33 + 1, str(tmp_path))
    out = str(tmp_path / "out.csv")
    run_cli([d.target, out] + (["-r", d.query] if d.query else [])
            + (["-q", d.query_list] if d.query_list else []) + flags)
    kind = "exact" if not flags else "f32"
    queries = reference.read_names(d.query_list) if d.query_list else None
    ref = reference.aji(d.target, d.query, queries=queries,
                        empty_is_zero=kind == "f32")
    rows = np.arange(len(ref.row_names))
    got = reference.compare(reference.read_csv(out), ref, kind, rows)
    if kind == "exact":
        assert got == {"labels_differing": 0, "values_differing": 0,
                       "text_rows_differing": 0}
        with open(out, "rb") as fp:
            text = fp.read()
        want = ("," + ",".join(ref.col_names) + "\n").encode() + b"".join(
            (ref.row_names[i] + "," + ",".join(
                reference.format_double(v) for v in ref.aji[i]) + "\n"
             ).encode() for i in rows)
        assert text == want
    else:
        assert got["labels_differing"] == 0
        assert 0 < got["max_abs_gap"] < 1e-6
    assert os.path.getsize(out) > 0


def test_compare_counts_faults(tmp_path):
    path = str(tmp_path / "a.db")
    write_sets(path, SETS)
    ref = reference.aji(path)
    out = str(tmp_path / "a.csv")

    def write(mat, names, header):
        with open(out, "w") as fp:
            fp.write("," + ",".join(header) + "\n")
            for name, row in zip(names, mat):
                fp.write(name + "," + ",".join(
                    reference.format_double(v) for v in row) + "\n")
        return reference.read_csv(out)

    rows = np.arange(4)
    good = write(ref.aji, ref.row_names, ref.col_names)
    assert reference.compare(good, ref, "exact", rows) == {
        "labels_differing": 0, "values_differing": 0,
        "text_rows_differing": 0}
    bad = ref.aji.copy()
    bad[0, 1] = np.nextafter(bad[0, 1], 1.0)
    got = reference.compare(write(bad, ref.row_names, ref.col_names), ref,
                            "exact", rows)
    assert got["values_differing"] == 1 and got["text_rows_differing"] == 1
    assert reference.compare(write(bad, ref.row_names, ref.col_names), ref,
                             "f32", rows)["max_abs_gap"] > 0
    names = list(ref.row_names)
    names[1] = "x"
    assert reference.compare(write(ref.aji, names, ref.col_names), ref,
                             "exact", rows)["labels_differing"] == 1
    short = write(ref.aji[:3], ref.row_names[:3], ref.col_names)
    got = reference.compare(short, ref, "exact", rows[:3])
    assert got["labels_differing"] == 1 and got["values_differing"] == 4
    assert reference.compare(short, ref, "f32", rows)["max_abs_gap"] == np.inf
