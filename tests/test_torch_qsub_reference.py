"""The port's ``-q`` (query-subset) call against the benchmark's plain
reference (``port_bench/reference.py``), on the CPU at a tiny size.

``port_bench.gen`` makes a seeded query-subset database and its query
list; ``cli.run`` writes the CSV; the reference recomputes the listed
genomes' rows of the all-vs-all matrix from the ``'{SCP}_genomes'``
tables, in list order, with 0 at each genome's own cell.  The exact routes
(the dense default and the banded engine it routes to above its host
budget) must write the reference's bytes; ``--streamed`` computes in f32
and is held to the f32 paths' tolerance.  Each route runs on the seed's
list and on a list in reverse database order."""

import numpy as np
import pytest
import torch

from parfastaai_tpu_torch import cli
from port_bench import gen, reference

CONFIG = dict(mode="query_subset", n_genomes=30, n_query_genomes=7,
              n_proteins=4, tetramers_mean=20, size_log_sd=0.46,
              change_rate=0.2)
SEED = 2**33 + 22
# --streamed sums each J_p in f32 with the kernel's divide: the f32 paths
# stay within ~1.4e-7 of the exact f64 AJI relative to it, and an AJI is
# at most 1.
STREAMED_GAP = 1e-6
ROUTES = {
    "dense": ([], {}),
    "banded": ([], {"PARFASTAAI_EXACT_HOST_BYTES": "1"}),
    "streamed": (["--streamed"], {}),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    return gen.make(CONFIG, SEED, str(tmp_path_factory.mktemp("qsub_ref")))


def query_list(made, order, tmp_path) -> tuple[str, list[str]]:
    """The seed's list, or its genomes in reverse database order."""
    names = reference.read_names(made.query_list)
    if order == "seed":
        return made.query_list, names
    everyone = gen.genome_names("", CONFIG["n_genomes"])
    names = sorted(names, key=everyone.index, reverse=True)
    path = tmp_path / "reversed.txt"
    path.write_text("".join(n + "\n" for n in names))
    return str(path), names


def csv_text(ref: reference.Matrix) -> bytes:
    """The reference's matrix as ParFastAAI writes it."""
    lines = ["," + ",".join(ref.col_names)] + [
        name + "," + ",".join(reference.format_double(v) for v in row)
        for name, row in zip(ref.row_names, ref.aji)]
    return "".join(line + "\n" for line in lines).encode()


@pytest.mark.parametrize("order", ["seed", "reversed"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_query_subset_csv_matches_the_reference(made, tmp_path, monkeypatch,
                                                route, order):
    flags, env = ROUTES[route]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    listed, names = query_list(made, order, tmp_path)
    everyone = gen.genome_names("", CONFIG["n_genomes"])
    positions = [everyone.index(n) for n in names]
    assert positions != sorted(positions)  # not the database's order
    out = tmp_path / "out.csv"
    assert cli.run([made.target, str(out), "-q", listed, *flags, "--quiet",
                    "--device", "cpu"]) == 0
    exact = not flags
    ref = reference.aji(made.target, queries=names, empty_is_zero=not exact)
    assert ref.row_names == names
    # the listed genomes' rows of the all-vs-all matrix, in list order
    full = reference.aji(made.target, empty_is_zero=not exact)
    want = full.aji[positions]
    want[np.arange(len(names)), positions] = 0
    assert np.array_equal(ref.aji, want, equal_nan=True)
    got = reference.read_csv(str(out))
    assert got.row_names == names and got.header == everyone
    if exact:
        assert out.read_bytes() == csv_text(ref)
    else:
        rows = np.arange(len(names))
        numbers = reference.compare(got, ref, "f32", rows)
        assert numbers["labels_differing"] == 0
        assert numbers["max_abs_gap"] < STREAMED_GAP
