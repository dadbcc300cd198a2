"""``parfastaai_tpu_torch.parallel.distributed`` on the CPU: the identities
of a one-process run, and real two-process gloo runs of the broadcasts,
the gather and the single-reader presence broadcast (chunked, meta-only,
and the error slot).

The two-process cases launch this file as a script, once per rank, with
the PARFASTAAI_* launch variables; each rank checks what it received and
exits 0, or with the error code it raised.  Every wait has a timeout."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from parfastaai_tpu_torch.etl.database import MetaOnlyM, PresenceData
from parfastaai_tpu_torch.parallel import distributed
from parfastaai_tpu_torch.types import DBMetaData, ErrorCode, PFAAIError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
LAUNCH_VARS = ("PARFASTAAI_COORDINATOR", "MASTER_ADDR", "RANK",
               "WORLD_SIZE", "LOCAL_RANK")
# Ranks run at a lower priority, so that their start-up bursts do not
# crowd the test runner's other workers.
NICE = ("nice", "-n", "10")


def _presence(seed: int = 7, P: int = 5, G: int = 11, K: int = 21):
    """A PresenceData from numpy (K not a multiple of 8: the packed bits'
    padding is cut off again)."""
    rng = np.random.default_rng(seed)
    m = (rng.random((P, G, K)) < 0.4).astype(np.uint8)
    meta = DBMetaData(protein_set=tuple(f"p{i}" for i in range(P)),
                      genome_set=tuple(f"g{i}" for i in range(G)))
    return PresenceData(
        meta=meta, m=m, t=m.sum(axis=2, dtype=np.int32),
        widths=np.full(P, K, np.int32),
        tetramer_ids=[np.arange(K, dtype=np.int32) for _ in range(P)],
    )


def _same(a: PresenceData, b: PresenceData) -> bool:
    return (
        a.meta == b.meta and np.array_equal(a.m, b.m) and a.m.dtype == b.m.dtype
        and np.array_equal(a.t, b.t) and np.array_equal(a.widths, b.widths)
        and all(np.array_equal(x, y)
                for x, y in zip(a.tetramer_ids, b.tetramer_ids))
    )


# ---- one process ---------------------------------------------------------


def test_no_launch_environment_means_one_process(monkeypatch):
    for k in LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    assert distributed.init_distributed("cpu") is False
    assert distributed.world_size() == 1 and distributed.rank() == 0
    assert distributed.is_primary() and distributed.backend() is None
    assert distributed.wire() == torch.device("cpu")


def test_one_process_identities():
    obj = {"a": np.arange(3), "b": "x"}
    assert distributed.broadcast_pyobj(obj) is obj
    assert distributed.broadcast_from_primary(41) == 41
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(distributed.gather_to_host(x), x)
    np.testing.assert_array_equal(
        distributed.gather_to_host(torch.from_numpy(x)), x)
    pres = _presence()
    assert distributed.broadcast_presence(pres) is pres
    assert distributed.broadcast_presence(pres, meta_only=True) is pres
    err = PFAAIError(ErrorCode.SQLITE_DB_ERROR, "no such database")
    with pytest.raises(PFAAIError) as e:
        distributed.broadcast_presence(None, error=err)
    assert e.value is err


# ---- two processes -------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(case: str, n: int = 2, env: dict | None = None) -> list[int]:
    """Run this file as ``case`` in ``n`` processes of one gloo group;
    their exit codes, in rank order."""
    port = _free_port()
    procs = []
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    for rank in range(n):
        procs.append(subprocess.Popen(
            [*NICE, sys.executable, os.path.abspath(__file__), case],
            env={**base, **(env or {}), "PYTHONPATH": REPO,
                 "OMP_NUM_THREADS": "1",
                 "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                 "PARFASTAAI_NUM_PROCESSES": str(n),
                 "PARFASTAAI_PROCESS_ID": str(rank)},
            cwd=REPO,
        ))
    try:
        return [p.wait(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=TIMEOUT)


def test_two_process_pyobj_int_and_gather():
    assert _launch("pyobj") == [0, 0]


def test_two_process_presence_chunked():
    """64 bytes per chunk: one protein per broadcast (11 x 3 packed bytes
    a protein), five chunks, and the exact presence on rank 1."""
    env = {"PARFASTAAI_BCAST_CHUNK_BYTES": "64"}
    assert _launch("presence", env=env) == [0, 0]


def test_two_process_presence_one_chunk():
    assert _launch("presence_whole") == [0, 0]


def test_two_process_meta_only():
    assert _launch("meta_only") == [0, 0]


def test_two_process_error_slot():
    """Process 0's failure, sent in the header's place: both ranks raise
    its PFAAIError (exit with its code) instead of waiting."""
    code = int(ErrorCode.SQLITE_MEM_ALLOC_ERROR)  # not a traceback's 1
    assert _launch("error") == [code, code]


def test_three_process_gather_order():
    assert _launch("gather3", n=3) == [0, 0, 0]


def _worker(case: str) -> int:
    """One rank of a multi-process case: checks what it received."""
    assert distributed.init_distributed("cpu") is True
    assert distributed.backend() == "gloo"
    rank, world = distributed.rank(), distributed.world_size()
    primary = distributed.is_primary()
    try:
        if case == "pyobj":
            sent = {"name": "x", "arr": np.arange(5) * 3,
                    "err": PFAAIError(ErrorCode.CONSTRUCT_ERROR, "boom")}
            got = distributed.broadcast_pyobj(sent if primary else None)
            assert got["name"] == "x" and np.array_equal(got["arr"], sent["arr"])
            assert got["err"].code == ErrorCode.CONSTRUCT_ERROR
            assert distributed.broadcast_pyobj(b"" if primary else 1) == b""
            assert distributed.broadcast_from_primary(
                123 if primary else -1) == 123
        if case in ("pyobj", "gather3"):
            mine = np.full((2, 3), rank, np.int32)
            full = distributed.gather_to_host(torch.from_numpy(mine))
            want = np.repeat(np.arange(world, dtype=np.int32), 2)[:, None]
            assert np.array_equal(full, np.broadcast_to(want, (2 * world, 3)))
        elif case in ("presence", "presence_whole"):
            calls = []
            bcast = distributed._bcast
            distributed._bcast = lambda t: calls.append(t.shape) or bcast(t)
            want = _presence()
            got = distributed.broadcast_presence(want if primary else None)
            assert got is want if primary else _same(got, want)
            # the header's length and bytes, then the chunks
            chunks = 5 if case == "presence" else 1
            assert len(calls) == 2 + chunks, calls
        elif case == "meta_only":
            want = _presence()
            got = distributed.broadcast_presence(
                want if primary else None, meta_only=True)
            assert got.slab_broadcast is True
            if primary:
                assert got is want
            else:
                assert isinstance(got.m, MetaOnlyM)
                assert got.m.shape == want.m.shape
                assert np.array_equal(got.t, want.t)
                try:
                    np.asarray(got.m)
                except PFAAIError as e:
                    assert e.code == ErrorCode.CONSTRUCT_ERROR
                else:
                    raise AssertionError("MetaOnlyM gave data")
        elif case == "error":
            err = PFAAIError(ErrorCode.SQLITE_MEM_ALLOC_ERROR, "no memory")
            distributed.broadcast_presence(
                None, error=err if primary else None)
            raise AssertionError("the error slot raised nothing")
        return 0
    except PFAAIError as e:
        return int(e.code)
    finally:
        distributed.close()


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
