"""Real multi-process runs of the port's streamed engines on the CPU
(gloo): one process per mesh device, launched with PARFASTAAI_COORDINATOR
/ PARFASTAAI_NUM_PROCESSES / PARFASTAAI_PROCESS_ID, as in
test_torch_multiproc.py.

* ``--streamed --exact --mesh R,S`` writes, from process 0 alone, the bytes
  of the JAX CLI's one-process run at the same mesh (its 8 virtual CPU
  devices) and of the port's one-process default call, on 2 and 4
  processes (3 with a rank past the mesh), in the three modes, with
  ``--resume``, and with meta-only staged slabs (PARFASTAAI_HBM_BYTES=1 and a PARFASTAAI_SLAB_BYTES that
  holds about two slabs, so that the store evicts at almost every fetch).
* ``--streamed --mesh R,1`` writes the bytes of the port's one-process
  ``--streamed`` (under the same environment); ``--streamed --mesh R,S``
  with S > 1 holds the JAX CLI's at the same mesh (its device leg) to the
  f32 engine's stated tolerance: the same header and row names as bytes,
  the text ``0`` in the same cells, values within rtol 1e-6.
* The other ranks get a database path that does not exist and output
  paths of their own: they print nothing and write nothing.
* A failure on process 0 (an output file it cannot open, the writer
  fault hook PARFASTAAI_TEST_WORKER_FAULT, a database it cannot read)
  gives every rank the same non-zero exit code and no CSV.

Every wait has a timeout of TIMEOUT seconds."""

import os
import sqlite3

import pytest

from parfastaai_tpu.cli import run as jax_run
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu_torch.cli import run
from test_torch_cli import assert_streamed_close
from test_torch_multiproc import _launch, _said

# a band of 10 rows (rounded up to the mesh's rows) and chunks of 16
# columns: several bands and blocks, the mirror on all-vs-all runs
BLOCKS = ["--band", "10", "--col-chunk", "16"]
# meta-only staging: no budget, slabs of about two proteins at 41 genomes
META_ONLY = {"PARFASTAAI_HBM_BYTES": "1", "PARFASTAAI_SLAB_BYTES": "30000"}


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 41-genome target DB (G pads to two rows), a 19-genome query DB
    with disjoint names (5 proteins: P pads to two and four shards) and a
    query-subset list."""
    d = tmp_path_factory.mktemp("torch_multiproc_streamed")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=41, n_proteins=5, pool_size=300,
             tetras_per_genome=100, seed=8)
    generate(query, n_genomes=19, n_proteins=5, pool_size=300,
             tetras_per_genome=100, seed=9)
    with sqlite3.connect(query) as conn:
        conn.execute("UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    qfile = d / "queries.txt"
    qfile.write_text("synthetic_genome_00030.fna.gz\nsynthetic_genome_00002.fna.gz\n")
    return {"target": target, "query": query, "qfile": str(qfile)}


def _mode_args(mode, dbs):
    return {"all": [], "qt": ["-r", dbs["query"]],
            "qsub": ["-q", dbs["qfile"]]}[mode]


def _ranks(dbs, tmp_path, n, flags, mode="all", env=None, out0=None):
    """The port's CLI on ``n`` processes; the other ranks get paths that
    do not exist for every input and outputs of their own.  Returns
    [(exit code, stdout, stderr)] and the output paths."""
    outs = [out0 or tmp_path / "rank0.csv"] + [
        tmp_path / f"rank{i}.csv" for i in range(1, n)]
    extra = _mode_args(mode, dbs)

    def argv_of(rank):
        args = [dbs["target"], str(outs[rank]), *flags, *extra]
        if rank:
            missing = {dbs["target"]: "not_here.db", dbs["qfile"]: "no.txt",
                       dbs["query"]: "no_query.db"}
            args = [str(tmp_path / missing[a]) if a in missing else a
                    for a in args]
        return args

    return _launch(argv_of, n, env), outs


def _one_process(dbs, tmp_path, name, flags, mode="all", env=None,
                 jax=False):
    """One process of the port's CLI (or the JAX CLI on its device leg)
    with ``flags`` under ``env``: the CSV's bytes."""
    out = tmp_path / f"{name}.csv"
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        argv = [dbs["target"], str(out), "--quiet", *flags,
                *_mode_args(mode, dbs)]
        if jax:
            os.environ["PARFASTAAI_FORCE_DEVICE"] = "1"
            saved.setdefault("PARFASTAAI_FORCE_DEVICE", None)
            assert jax_run(argv) == 0
        else:
            assert run([*argv, "--device", "cpu"]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out.read_bytes()


def _ran_once(ran, outs, meta_only=False):
    """Every rank exited 0, the others printed and wrote nothing, and
    process 0 said what it broadcast."""
    assert [r[0] for r in ran] == [0] * len(ran), [r[2] for r in ran]
    assert "backend gloo" in ran[0][1] and "Presence broadcast" in ran[0][1]
    assert ("metadata + T only" in ran[0][1]) == meta_only
    if meta_only:
        assert "staged slabs" in ran[0][1]
    assert all(not r[1] and not _said(r[2]) for r in ran[1:]), [
        r[2] for r in ran]
    assert outs[0].exists() and not any(p.exists() for p in outs[1:])


EXACT = [
    ("2,1", 2, "all", None), ("1,2", 2, "all", None),
    ("2,2", 4, "all", None), ("1,2", 2, "qt", None),
    ("2,1", 2, "qsub", None), ("1,2", 2, "all", META_ONLY),
    ("2,2", 4, "all", META_ONLY), ("1,2", 3, "all", META_ONLY),
]


@pytest.mark.parametrize(
    "mesh,n,mode,env", EXACT,
    ids=["2x1", "1x2", "2x2", "1x2_two_db", "2x1_query_subset",
         "1x2_meta_only", "2x2_meta_only",
         # rank 2 lies past the mesh: it joins every gather and slab
         # broadcast with zero cells and uploads nothing
         "1x2_meta_only_3_processes"])
def test_exact_mesh_csv_equals_jax_cli(mesh, n, mode, env, dbs, tmp_path):
    flags = ["--streamed", "--exact", "--mesh", mesh, *BLOCKS]
    ran, outs = _ranks(dbs, tmp_path, n, flags, mode, env)
    _ran_once(ran, outs, meta_only=env is not None)
    want = _one_process(dbs, tmp_path, "jax", flags[:4] + BLOCKS, mode,
                        jax=True)
    default = _one_process(dbs, tmp_path, "default", [], mode)
    assert outs[0].read_bytes() == want == default


F32 = [
    ("2,1", 2, "all", None), ("2,1", 2, "qt", None),
    ("2,1", 2, "all", META_ONLY), ("1,2", 2, "all", None),
    ("2,2", 4, "all", None), ("1,2", 2, "qsub", None),
    ("2,2", 4, "all", META_ONLY),
]


@pytest.mark.parametrize(
    "mesh,n,mode,env", F32,
    ids=["2x1", "2x1_two_db", "2x1_meta_only", "1x2", "2x2",
         "1x2_query_subset", "2x2_meta_only"])
def test_f32_mesh_csv(mesh, n, mode, env, dbs, tmp_path):
    """Row splits: the port's one-process bytes (under the same
    environment).  Protein splits: the JAX CLI's at the same mesh, to the
    stated tolerance; on these inputs (one width bucket, two shards) also
    its bytes, since two partials add in either order."""
    flags = ["--streamed", "--mesh", mesh, *BLOCKS]
    ran, outs = _ranks(dbs, tmp_path, n, flags, mode, env)
    _ran_once(ran, outs, meta_only=env is not None)
    got = outs[0].read_bytes()
    if mesh.endswith(",1"):
        assert got == _one_process(dbs, tmp_path, "one",
                                   ["--streamed", *BLOCKS], mode, env)
        return
    want = _one_process(dbs, tmp_path, "jax", flags, mode, env, jax=True)
    assert_streamed_close(got, want)
    if mesh == "1,2":
        assert got == want


def _cut(path, keep_lines: int, extra: bytes = b"") -> None:
    """Keeps the header and ``keep_lines`` rows of ``path``, plus
    ``extra`` (a trailing partial write)."""
    lines = path.read_bytes().split(b"\n")
    path.write_bytes(b"\n".join(lines[: keep_lines + 1]) + b"\n" + extra)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_resume_across_processes(exact, dbs, tmp_path):
    """``--resume`` on two processes: process 0 reads the resume point
    from a CSV cut inside its third band (a partial line at its end) and
    every rank restarts there; the result is the whole run's bytes."""
    engine = ["--streamed", "--exact"] if exact else ["--streamed"]
    flags = [*engine, "--mesh", "2,1", *BLOCKS]
    whole = _one_process(dbs, tmp_path, "whole", [*engine, *BLOCKS])
    out0 = tmp_path / "resumed.csv"
    out0.write_bytes(whole)
    _cut(out0, 25, b"synthetic_genome_000")
    ran, outs = _ranks(dbs, tmp_path, 2, [*flags, "--resume"], out0=out0)
    _ran_once(ran, outs)
    assert out0.read_bytes() == whole


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "f32"])
def test_without_mesh_process_0_computes(exact, dbs, tmp_path):
    """``--streamed`` (and ``--exact``) on two processes without a mesh:
    the other rank returns at once, process 0 computes alone, says so,
    and writes the one-process bytes."""
    flags = ["--streamed", "--exact"] if exact else ["--streamed"]
    ran, outs = _ranks(dbs, tmp_path, 2, [*flags, *BLOCKS])
    assert [r[0] for r in ran] == [0, 0]
    assert "WARNING" in ran[0][2] and "primary process only" in ran[0][2]
    assert not ran[1][1] and not _said(ran[1][2]) and not outs[1].exists()
    assert outs[0].read_bytes() == _one_process(
        dbs, tmp_path, "one", [*flags, *BLOCKS])


@pytest.mark.parametrize(
    "flags,env",
    [(["--streamed", "--exact", "--mesh", "1,2"], {}),
     (["--streamed", "--mesh", "2,1"], {}),
     (["--streamed", "--exact", "--mesh", "2,1"], META_ONLY)],
    ids=["exact", "f32", "exact_meta_only"])
def test_unwritable_output_stops_every_rank(flags, env, dbs, tmp_path):
    """Process 0 cannot open its CSV (a directory that does not exist):
    the failure reaches every rank through the decisions' broadcast, and
    every rank exits with the same code, without a CSV."""
    out0 = tmp_path / "no_dir" / "out.csv"
    ran, outs = _ranks(dbs, tmp_path, 2, [*flags, *BLOCKS], env=env,
                       out0=out0)
    codes = [r[0] for r in ran]
    assert codes[0] != 0 and codes == [codes[0]] * 2
    assert all("No such file or directory" in r[2] for r in ran)
    assert not any(p.exists() for p in outs)


@pytest.mark.parametrize(
    "flags", [["--streamed", "--exact", "--mesh", "1,2"],
              ["--streamed", "--mesh", "2,1"]], ids=["exact", "f32"])
def test_writer_fault_stops_every_rank(flags, dbs, tmp_path):
    """Process 0's finish worker or CSV writer fails (the fault hook):
    the abort flag stops every rank at the same block or band, and every
    rank raises the same error and exits with the same code."""
    ran, outs = _ranks(dbs, tmp_path, 2, [*flags, *BLOCKS],
                       env={"PARFASTAAI_TEST_WORKER_FAULT": "1"})
    codes = [r[0] for r in ran]
    assert codes[0] != 0 and codes == [codes[0]] * 2
    assert all("injected" in r[2] for r in ran)
    assert not outs[1].exists()


def test_primary_db_error_reaches_every_rank(dbs, tmp_path):
    """A database that process 0 cannot read, under ``--streamed --exact
    --mesh``: every rank exits with the JAX CLI's code, and none writes."""
    bad = tmp_path / "bad.db"
    outs = [tmp_path / f"rank{i}.csv" for i in range(2)]
    ran = _launch(lambda r: [str(bad), str(outs[r]), "--streamed", "--exact",
                             "--mesh", "2"], 2)
    want = jax_run([str(bad), str(tmp_path / "jax.csv"), "--quiet"])
    assert want != 0
    assert [r[0] for r in ran] == [want, want]
    assert not any(p.exists() for p in outs)
