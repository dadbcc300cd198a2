"""The port's library API (``parfastaai_tpu_torch.api``) against the JAX
package's (``parfastaai_tpu.api``) on the CPU, on small synthetic
databases: ``aji`` with the exact engine bit-equal (matrix, pairs, CSV
bytes) and with the fast engine within 1e-6, ``aji_to_csv`` with the
banded exact engine byte-equal and with the f32 streamed engine to its
stated tolerance (the same header and row names as bytes, the text ``0``
in the same cells, values within rtol 1e-6), ``staged`` and
PARFASTAAI_STAGED against the JAX package's staged runs, the same error
codes, and the streamed engines on a mesh of one device byte-identical
to the JAX API's (tests/test_torch_mesh_streamed.py holds the mesh
engines' cells)."""

import os
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

import parfastaai_tpu.api as jax_api
import parfastaai_tpu_torch.api as api
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu.types import PFAAIError as JaxPFAAIError
from parfastaai_tpu_torch.types import ErrorCode, PFAAIError

QUERIES = [f"synthetic_genome_{i:05d}.fna.gz" for i in (30, 2, 17)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 40-genome target DB and a 24-genome query DB with disjoint genome
    names (6 proteins, pool 300, ~100 tetramers per genome)."""
    d = tmp_path_factory.mktemp("torch_api")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=40, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=1)
    generate(query, n_genomes=24, n_proteins=6, pool_size=300,
             tetras_per_genome=100, seed=2)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    return {"target": target, "query": query}


def _mode_kw(mode, dbs) -> dict:
    if mode == "qt":
        return {"query_db": dbs["query"]}
    if mode == "qt_noswap":
        return {"query_db": dbs["query"], "compat_qt_t_swap": False}
    if mode == "qsub":
        return {"query_subset": QUERIES}
    return {}


MODES = ["all", "qsub", "qt", "qt_noswap"]


@pytest.mark.parametrize("mode", MODES)
def test_aji_exact_bit_equal(mode, dbs, tmp_path):
    kw = _mode_kw(mode, dbs)
    want = jax_api.aji(dbs["target"], **kw)
    got = api.aji(dbs["target"], device="cpu", **kw)
    assert got.row_names == want.row_names and got.col_names == want.col_names
    np.testing.assert_array_equal(got.matrix, want.matrix)
    for field in ("genome_a", "genome_b", "s", "n", "aji"):
        np.testing.assert_array_equal(
            getattr(got.pairs, field), getattr(want.pairs, field))
    got.to_csv(str(tmp_path / "port.csv"), ";")
    want.to_csv(str(tmp_path / "jax.csv"), ";")
    assert (tmp_path / "port.csv").read_bytes() == (
        tmp_path / "jax.csv").read_bytes()


@pytest.mark.parametrize("divide", [{}, {"precise": True}, {"approx": True}],
                         ids=["newton", "precise", "approx"])
@pytest.mark.parametrize("mode", ["all", "qsub", "qt"])
def test_aji_fast_within_tolerance(mode, divide, dbs):
    kw = {**_mode_kw(mode, dbs), **divide}
    want = jax_api.aji(dbs["target"], engine="fast", **kw)
    got = api.aji(dbs["target"], engine="fast", device="cpu", **kw)
    np.testing.assert_array_equal(got.pairs.n, want.pairs.n)
    np.testing.assert_allclose(got.pairs.s, want.pairs.s, rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.matrix, want.matrix, rtol=1e-6, atol=0)


@pytest.mark.parametrize("engine", ["exact", "fast"])
def test_aji_to_csv_writes_to_csv_of_aji(engine, dbs, tmp_path):
    got, want = tmp_path / "direct.csv", tmp_path / "result.csv"
    api.aji_to_csv(str(got), dbs["target"], engine=engine, device="cpu",
                   separator=";")
    api.aji(dbs["target"], engine=engine, device="cpu").to_csv(str(want), ";")
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("mode", MODES)
def test_streamed_exact_bytes_equal(mode, dbs, tmp_path, monkeypatch):
    """The banded exact engine through both APIs (the JAX side on its device
    count path) and ``engine="exact"``: the same bytes."""
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    kw = dict(_mode_kw(mode, dbs), band=7, col_chunk=5)
    got, want, exact = (tmp_path / n for n in ("port.csv", "jax.csv", "exact.csv"))
    api.aji_to_csv(str(got), dbs["target"], engine="streamed-exact",
                   device="cpu", **kw)
    jax_api.aji_to_csv(str(want), dbs["target"], engine="streamed-exact", **kw)
    api.aji_to_csv(str(exact), dbs["target"], device="cpu", **_mode_kw(mode, dbs))
    assert got.read_bytes() == want.read_bytes() == exact.read_bytes()


def _table(csv: bytes, sep=","):
    lines = csv.decode().split("\n")
    rows = [ln.split(sep) for ln in lines[1:-1]]
    return (lines[0], [r[0] for r in rows],
            np.array([r[1:] for r in rows], dtype=object))


@pytest.mark.parametrize("jax_leg", ["host", "device"])
@pytest.mark.parametrize("mode", MODES)
def test_streamed_matches_jax(mode, jax_leg, dbs, tmp_path, monkeypatch):
    if jax_leg == "device":
        monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    kw = dict(_mode_kw(mode, dbs), band=7, col_chunk=5, separator=";")
    got, want = tmp_path / "port.csv", tmp_path / "jax.csv"
    api.aji_to_csv(str(got), dbs["target"], engine="streamed", device="cpu", **kw)
    jax_api.aji_to_csv(str(want), dbs["target"], engine="streamed", **kw)
    g_head, g_names, g = _table(got.read_bytes(), ";")
    w_head, w_names, w = _table(want.read_bytes(), ";")
    assert g_head == w_head and g_names == w_names and g.shape == w.shape
    np.testing.assert_array_equal(g == "0", w == "0")
    np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                               rtol=1e-6, atol=0)


def test_streamed_resume_and_block_shape(dbs, tmp_path):
    """``resume`` continues a cut file, and band / col_chunk reach the
    engine uncapped (the bytes do not depend on them)."""
    full, part = tmp_path / "full.csv", tmp_path / "part.csv"
    api.aji_to_csv(str(full), dbs["target"], engine="streamed", device="cpu")
    whole = full.read_bytes()
    part.write_bytes(b"\n".join(whole.split(b"\n")[: 1 + 14]) + b"\nsynth")
    api.aji_to_csv(str(part), dbs["target"], engine="streamed", device="cpu",
                   band=6, col_chunk=9, resume=True)
    assert part.read_bytes() == whole


def _code(module, exc_type, fn, *args, **kw) -> int:
    with pytest.raises(exc_type) as e:
        getattr(module, fn)(*args, **kw)
    return int(e.value.code)


ERRORS = {
    "both_query_kinds": ("aji", lambda d: dict(query_db=d["query"],
                                               query_subset=QUERIES)),
    "unknown_engine": ("aji", lambda d: dict(engine="bogus")),
    "streamed_engine_in_aji": ("aji", lambda d: dict(engine="streamed")),
    "unknown_query": ("aji", lambda d: dict(query_subset=["no_such_genome"])),
    "streamed_exact_precise": (
        "aji_to_csv", lambda d: dict(engine="streamed-exact", precise=True)),
    "streamed_exact_approx": (
        "aji_to_csv", lambda d: dict(engine="streamed-exact", approx=True)),
    "streamed_approx_off_the_device": (
        "aji_to_csv", lambda d: dict(engine="streamed", approx=True)),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_codes_match_jax(case, dbs, tmp_path):
    fn, make_kw = ERRORS[case]
    kw = make_kw(dbs)
    out = tmp_path / "x.csv"
    args = (str(out), dbs["target"]) if fn == "aji_to_csv" else (dbs["target"],)
    want = _code(jax_api, JaxPFAAIError, fn, *args, **kw)
    got = _code(api, PFAAIError, fn, *args, device="cpu", **kw)
    assert got == want == int(ErrorCode.CONSTRUCT_ERROR)
    assert not out.exists()


def test_missing_database_code_matches_jax(tmp_path):
    missing = str(tmp_path / "nope.db")
    with pytest.raises(Exception) as want:
        jax_api.aji(missing)
    with pytest.raises(Exception) as got:
        api.aji(missing, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert getattr(got.value, "code", None) == getattr(want.value, "code", None)


# engine="sharded" and a mesh under exact / fast run since the mesh was
# ported (tests/test_torch_mesh.py::test_api_sharded_matches_jax); a mesh
# under the streamed engines since its second slice (a staged one and a
# mesh larger than the process group: tests/test_torch_mesh_streamed.py)
STREAMED_MESH = {
    "streamed_mesh": dict(engine="streamed", mesh=(1, 1)),
    "streamed_exact_mesh": dict(engine="streamed-exact", mesh=(1, 1)),
}


@pytest.mark.parametrize("case", sorted(STREAMED_MESH))
def test_streamed_mesh_of_one_device_matches_jax(case, dbs, tmp_path,
                                                 monkeypatch):
    """``aji_to_csv`` with a streamed engine on a (1, 1) mesh in one
    process: the JAX API's bytes at the same mesh (its device leg) and the
    port's bytes without the mesh."""
    kw = STREAMED_MESH[case]
    monkeypatch.setenv("PARFASTAAI_FORCE_DEVICE", "1")
    paths = {k: tmp_path / f"{k}.csv" for k in ("jax", "port", "one")}
    jax_api.aji_to_csv(str(paths["jax"]), dbs["target"], **kw)
    api.aji_to_csv(str(paths["port"]), dbs["target"], device="cpu", **kw)
    api.aji_to_csv(str(paths["one"]), dbs["target"], device="cpu",
                   engine=kw["engine"])
    got = paths["port"].read_bytes()
    assert got == paths["jax"].read_bytes() == paths["one"].read_bytes()


def _both(fn, engine, dbs, tmp_path, **kw):
    """(port, JAX) results of one call of ``fn`` with ``engine`` through
    both APIs, the JAX side on its device leg (where it stages): the
    AJIResult of ``aji``, the CSV bytes of ``aji_to_csv``."""
    out = {}
    for name, module, extra in (("jax", jax_api, {}),
                                ("port", api, {"device": "cpu"})):
        path = tmp_path / f"{name}.csv"
        args = (str(path), dbs["target"]) if fn == "aji_to_csv" else (
            dbs["target"],)
        os.environ["PARFASTAAI_FORCE_DEVICE"] = "1"
        try:
            res = getattr(module, fn)(*args, engine=engine, **extra, **kw)
        finally:
            del os.environ["PARFASTAAI_FORCE_DEVICE"]
        out[name] = path.read_bytes() if fn == "aji_to_csv" else res
    return out["port"], out["jax"]


def _assert_parity(engine, got, want) -> None:
    """The stated tolerance of ``engine`` between port and JAX results."""
    if engine == "fast":
        np.testing.assert_array_equal(got.pairs.n, want.pairs.n)
        np.testing.assert_allclose(got.pairs.s, want.pairs.s, rtol=1e-6,
                                   atol=0)
    elif engine == "exact":
        np.testing.assert_array_equal(got.matrix, want.matrix)
    elif engine == "streamed-exact":
        assert got == want
    else:
        g_head, g_names, g = _table(got)
        w_head, w_names, w = _table(want)
        assert g_head == w_head and g_names == w_names and g.shape == w.shape
        np.testing.assert_array_equal(g == "0", w == "0")
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-6, atol=0)


def _resident(fn, engine, dbs, tmp_path, **kw):
    """The port's ``staged=False`` result of the same call."""
    out = tmp_path / "resident.csv"
    args = (str(out), dbs["target"]) if fn == "aji_to_csv" else (dbs["target"],)
    res = getattr(api, fn)(*args, engine=engine, device="cpu", staged=False,
                           **kw)
    return out.read_bytes() if fn == "aji_to_csv" else res


def _same(fn, got, want) -> None:
    if fn == "aji":
        np.testing.assert_array_equal(got.matrix, want.matrix)
        np.testing.assert_array_equal(got.pairs.s, want.pairs.s)
    else:
        assert got == want


STAGED = {
    "fast": ("aji", "fast", {}),
    "fast_qsub": ("aji", "fast", {"query_subset": QUERIES}),
    "fast_qt": ("aji", "fast", "qt"),
    "streamed": ("aji_to_csv", "streamed", {"band": 7, "col_chunk": 5}),
    "streamed_qt": ("aji_to_csv", "streamed", "qt"),
    "streamed_exact": (
        "aji_to_csv", "streamed-exact", {"band": 7, "col_chunk": 5}),
    "streamed_exact_qsub": (
        "aji_to_csv", "streamed-exact", {"query_subset": QUERIES}),
}


@pytest.mark.parametrize("case", sorted(STAGED))
def test_staged_matches_jax_and_resident(case, dbs, tmp_path):
    """``staged=True`` runs the staged slab engines: the JAX package's
    staged result to each engine's stated tolerance, and the bytes of
    ``staged=False`` (no bucket is split into chunks at this size)."""
    fn, engine, kw = STAGED[case]
    if kw == "qt":
        kw = {"query_db": dbs["query"]}
    got, want = _both(fn, engine, dbs, tmp_path, staged=True, **kw)
    _assert_parity(engine, got, want)
    _same(fn, got, _resident(fn, engine, dbs, tmp_path, **kw))


@pytest.mark.parametrize("staged", [None, False])
def test_staged_none_and_false_are_accepted(staged, dbs, tmp_path):
    out = tmp_path / "x.csv"
    api.aji_to_csv(str(out), dbs["target"], engine="streamed", device="cpu",
                   staged=staged)
    assert out.read_bytes().count(b"\n") == 41
    assert api.aji(dbs["target"], engine="fast", device="cpu",
                   staged=staged).matrix.shape == (40, 40)


@pytest.mark.parametrize("value,staged", [
    ("1", True), ("true", True), ("0", False), ("no", False), ("", False)])
@pytest.mark.parametrize("fn,engine", [
    ("aji", "exact"), ("aji", "fast"), ("aji_to_csv", "streamed"),
    ("aji_to_csv", "streamed-exact")])
def test_staged_env_is_read_as_the_reference_reads_it(
        value, staged, fn, engine, dbs, tmp_path, monkeypatch):
    """With ``staged=None`` PARFASTAAI_STAGED decides ("0", "no" and an
    empty value: resident; any other value: staged slabs on the banded
    engines, while ``exact`` uploads the whole tensor, as in the JAX
    package), and the result is the JAX package's under the same variable
    to the engine's stated tolerance.  An explicit ``staged=False``
    overrides the variable; at this size the two give the same bytes."""
    from parfastaai_tpu_torch import engine as port_engine

    monkeypatch.setenv("PARFASTAAI_STAGED", value)
    stores = []
    real = port_engine._Staged.__init__
    monkeypatch.setattr(port_engine._Staged, "__init__",
                        lambda *a: stores.append(1) or real(*a))
    got, want = _both(fn, engine, dbs, tmp_path)
    _assert_parity(engine, got, want)
    assert bool(stores) == (staged and engine != "exact")
    _same(fn, got, _resident(fn, engine, dbs, tmp_path))


def test_device_is_named_never_guessed(dbs, tmp_path, monkeypatch):
    """The default device is cuda; without CUDA a call raises and writes
    nothing, and an unknown device name raises too."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.csv"
    for kw in ({}, {"device": "cuda"}, {"device": "tpu"}):
        for engine in ("exact", "streamed", "streamed-exact"):
            with pytest.raises(PFAAIError) as e:
                api.aji_to_csv(str(out), dbs["target"], engine=engine, **kw)
            assert e.value.code == ErrorCode.CONSTRUCT_ERROR
    assert not out.exists()


def test_package_does_not_import_the_api():
    """As in the JAX package, ``import parfastaai_tpu_torch`` leaves the
    API module to its users."""
    code = ("import sys, parfastaai_tpu_torch; "
            "print('parfastaai_tpu_torch.api' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"
