"""Real multi-process runs of the port's CLI on the CPU (gloo): one process
per mesh device, launched with PARFASTAAI_COORDINATOR /
PARFASTAAI_NUM_PROCESSES / PARFASTAAI_PROCESS_ID.

* ``--mesh 2,1`` and ``1,2`` on two processes and ``2,2`` on four write,
  from process 0 alone, the bytes of the JAX CLI's one-process run at the
  same mesh (its 8 virtual CPU devices): a row split moves cells between
  ranks, and a sum of two protein shards does not depend on its order.
* The other ranks get a database path that does not exist and output
  paths of their own: they never open the database (metadata, queries and
  presence arrive by broadcast) and write nothing.
* A failure on process 0 (a missing or corrupt database) gives every rank
  the same exit code.
* A multi-process ``--streamed`` run without a mesh (``--exact`` too, and
  a default call routed to the banded exact engine) computes on process 0
  alone; the streamed engines' meshes are in
  test_torch_multiproc_streamed.py.

Every wait has a timeout of TIMEOUT seconds."""

import os
import re
import socket
import sqlite3
import subprocess
import sys

import pytest

from parfastaai_tpu.cli import run as jax_run
from parfastaai_tpu.tools.synth_db import generate
from parfastaai_tpu_torch.cli import run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
LAUNCH_VARS = ("PARFASTAAI_COORDINATOR", "MASTER_ADDR", "RANK",
               "WORLD_SIZE", "LOCAL_RANK")
# Ranks run at a lower priority, so that their start-up bursts do not
# crowd the test runner's other workers.
NICE = ("nice", "-n", "10")


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 41-genome target DB (G pads to two rows), a 19-genome query DB
    with disjoint names (5 proteins: P pads to two shards) and a
    query-subset list."""
    d = tmp_path_factory.mktemp("torch_multiproc")
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(argv_of, n: int, env: dict | None = None):
    """The port's CLI in ``n`` processes of one gloo group, rank i with
    ``argv_of(i)``: [(exit code, stdout, stderr)] in rank order."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    procs = [
        subprocess.Popen(
            [*NICE, sys.executable, "-m", "parfastaai_tpu_torch",
             *argv_of(rank),
             "--device", "cpu"],
            env={**base, **(env or {}), "PYTHONPATH": REPO,
                 "OMP_NUM_THREADS": "1",
                 "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                 "PARFASTAAI_NUM_PROCESSES": str(n),
                 "PARFASTAAI_PROCESS_ID": str(rank)},
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for rank in range(n)
    ]
    ran = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            ran.append((p.returncode, out, err))
        return ran
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=TIMEOUT)


def _said(stderr: str) -> list[str]:
    """What a rank wrote to stderr, less torch.distributed's own log
    lines (``[W... socket.cpp:...] [c10d] ...``)."""
    return [ln for ln in stderr.splitlines()
            if not re.match(r"\[[WI]\d+ .*\] \[c10d\]", ln)]


def _mode_args(mode, dbs):
    return {"all": [], "qt": ["-r", dbs["query"]],
            "qsub": ["-q", dbs["qfile"]]}[mode]


@pytest.mark.parametrize(
    "mesh,n,mode",
    [("2,1", 2, "all"), ("1,2", 2, "all"), ("2,2", 4, "all"),
     ("1,2", 2, "qt"), ("2,1", 2, "qsub")],
    ids=["2x1", "1x2", "2x2", "1x2_two_db", "2x1_query_subset"],
)
def test_mesh_csv_equals_jax_cli(mesh, n, mode, dbs, tmp_path):
    extra = _mode_args(mode, dbs)
    missing = str(tmp_path / "not_here.db")
    outs = [tmp_path / f"rank{i}.csv" for i in range(n)]
    dumps = [tmp_path / f"rank{i}_jac.csv" for i in range(n)]
    traces = [tmp_path / f"trace{i}" for i in range(n)]

    def argv_of(rank):
        args = [dbs["target"] if rank == 0 else missing, str(outs[rank]),
                "--mesh", mesh, "--dump-jac", str(dumps[rank]),
                "--profile", str(traces[rank]), *extra]
        if rank and mode == "qsub":
            args[args.index(dbs["qfile"])] = str(tmp_path / "no_list.txt")
        if rank and mode == "qt":
            args[args.index(dbs["query"])] = str(tmp_path / "no_query.db")
        return args

    ran = _launch(argv_of, n)
    assert [r[0] for r in ran] == [0] * n, [r[2] for r in ran]
    assert "backend gloo" in ran[0][1] and "Presence broadcast" in ran[0][1]
    assert all(not r[1] for r in ran[1:])  # the other ranks print nothing
    assert outs[0].exists() and dumps[0].exists() and traces[0].exists()
    assert not any(p.exists() for p in outs[1:] + dumps[1:] + traces[1:])
    want, want_jac = tmp_path / "jax.csv", tmp_path / "jax_jac.csv"
    assert jax_run([dbs["target"], str(want), "--quiet", "--mesh", mesh,
                    "--dump-jac", str(want_jac), *extra]) == 0
    assert outs[0].read_bytes() == want.read_bytes()
    assert dumps[0].read_bytes() == want_jac.read_bytes()


@pytest.mark.parametrize("corrupt", [False, True], ids=["missing", "corrupt"])
def test_primary_db_error_reaches_every_rank(corrupt, dbs, tmp_path):
    """A database that process 0 cannot read: every rank exits with the
    code the JAX CLI gives it (a raw sqlite3 error too), and none writes."""
    db = tmp_path / "bad.db"
    if corrupt:
        db.write_bytes(b"SQLite format 3\x00" + b"\xde\xad\xbe\xef" * 64)
    outs = [tmp_path / f"rank{i}.csv" for i in range(2)]
    ran = _launch(lambda r: [str(db), str(outs[r]), "--mesh", "2"], 2)
    want = jax_run([str(db), str(tmp_path / "jax.csv"), "--quiet"])
    assert want != 0
    assert [r[0] for r in ran] == [want, want]
    assert all("ERROR (SQLITE" in r[2] for r in ran)
    assert not any(p.exists() for p in outs)


@pytest.mark.parametrize(
    "flags,env",
    [(["--streamed"], {}), (["--streamed", "--exact"], {}),
     ([], {"PARFASTAAI_EXACT_HOST_BYTES": "1"})],
    ids=["streamed", "streamed_exact", "banded_auto"],
)
def test_multiprocess_streamed_engines_run_on_process_0(flags, env, dbs,
                                                        tmp_path):
    """The streamed and banded exact engines without a mesh on two
    processes (the default call routed to the banded exact engine too):
    process 0 computes alone with a WARNING and writes the one-process
    bytes (the exact ones: the JAX CLI's); the other rank returns at once,
    prints nothing and writes nothing.  Their meshes are in
    test_torch_multiproc_streamed.py."""
    outs = [tmp_path / f"rank{i}.csv" for i in range(2)]
    ran = _launch(lambda r: [dbs["target"], str(outs[r]), *flags], 2, env)
    assert [r[0] for r in ran] == [0, 0], [r[2] for r in ran]
    assert "WARNING" in ran[0][2] and not ran[1][1] and not _said(ran[1][2])
    assert not outs[1].exists()
    want = tmp_path / "one.csv"
    if flags == ["--streamed"]:
        assert run([dbs["target"], str(want), "--quiet", "--device", "cpu",
                    *flags]) == 0
    else:
        assert jax_run([dbs["target"], str(want), "--quiet", *flags]) == 0
    assert outs[0].read_bytes() == want.read_bytes()


def test_multiprocess_default_call_writes_once(dbs, tmp_path):
    """Without --mesh every rank runs the whole exact path (as in the JAX
    package); process 0 alone writes the CSV, with the one-process
    bytes."""
    outs = [tmp_path / f"rank{i}.csv" for i in range(2)]
    ran = _launch(lambda r: [dbs["target"], str(outs[r]), "--quiet"], 2)
    assert [r[0] for r in ran] == [0, 0]
    assert not outs[1].exists()
    want = tmp_path / "jax.csv"
    assert jax_run([dbs["target"], str(want), "--quiet"]) == 0
    assert outs[0].read_bytes() == want.read_bytes()
