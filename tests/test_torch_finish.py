"""The dense exact engine's f64 finish of a pair list (``ops.finish``) on
the CPU: the plain PyTorch version bit-equal to the host's
``jaccard_finish`` (native and NumPy loop) and to the JAX package's, and
the wrapper's routing and checks.  ``tests/test_torch_cuda.py`` holds the
kernel to the port's host finish on the same cases on the card."""

import os

import numpy as np
import pytest
import torch

import parfastaai_tpu.native
from parfastaai_tpu import engine as jax_engine
from parfastaai_tpu_torch import engine
from parfastaai_tpu_torch.ops import finish


def finish_case(seed: int, P: int, G: int, n: int, dtype=np.int16,
                t_max: int = 300):
    """Counts (P, n) of ``dtype``, T (P, G) int32 below ``t_max`` and two
    (n,) int32 id vectors: each count at most the smaller T, protein 1 all
    zero (where P > 1), the first pairs with no protein shared (N = 0)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, t_max, (P, G)).astype(np.int32)
    da = rng.integers(0, G, n).astype(np.int32)
    db = rng.integers(0, G, n).astype(np.int32)
    cap = np.minimum(t[:, da], t[:, db])
    counts = (rng.random((P, n)) * (cap + 1)).astype(np.int64)
    counts = np.minimum(counts, cap)
    if P > 1:
        counts[1] = 0
    counts[:, : min(n, 5)] = 0
    return counts.astype(dtype), t, da, db


def host_finish(counts, t, da, db):
    """``engine.jaccard_finish`` on the case, with the gathered T."""
    return engine.jaccard_finish(counts, t[:, da], t[:, db])


CASES = [
    # seed, P, G, n, dtype, t_max
    (0, 7, 50, 1000, np.int16, 300),
    (1, 80, 64, 777, np.int16, 300),
    (2, 5, 30, 333, np.int32, 300),
    (3, 6, 40, 257, np.int32, 2**15 + 40),  # the int32 wire's T
    (4, 3, 10, 1, np.int16, 300),
    (5, 1, 10, 64, np.int32, 300),
    (6, 4, 10, 0, np.int16, 300),
]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"s{c[0]}")
def test_plain_finish_bit_equal_to_host_finish(case, native, monkeypatch):
    if not native:
        monkeypatch.setattr(engine, "native_jaccard_finish",
                            lambda *a: None)
        monkeypatch.setattr(parfastaai_tpu.native, "native_jaccard_finish",
                            lambda *a: None)
    counts, t, da, db = finish_case(*case)
    s_ref, n_ref = host_finish(counts, t, da, db)
    s_jax, n_jax = jax_engine.jaccard_finish(counts, t[:, da], t[:, db])
    s, n = finish.finish_pairs_plain(
        *(torch.from_numpy(x) for x in (counts, t, da, db)))
    assert s.dtype == torch.float64 and n.dtype == torch.int32
    for s_want, n_want in ((s_ref, n_ref), (s_jax, n_jax)):
        assert np.array_equal(s.numpy(), s_want)
        assert np.array_equal(n.numpy(), n_want)
    if len(n_ref):
        assert (n_ref[: min(len(n_ref), 5)] == 0).all()


def test_finish_pairs_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    calls = []
    real = finish.finish_pairs_plain

    def plain(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(finish, "finish_pairs_plain", plain)
    counts, t, da, db = finish_case(7, 4, 20, 100)
    before = finish.LAUNCHES
    s, n = finish.finish_pairs(
        *(torch.from_numpy(x) for x in (counts, t, da, db)))
    assert len(calls) == 1 and finish.LAUNCHES == before
    s_ref, n_ref = host_finish(counts, t, da, db)
    assert np.array_equal(s.numpy(), s_ref)
    assert np.array_equal(n.numpy(), n_ref)


def _operands(**change):
    counts, t, da, db = finish_case(8, 3, 20, 50)
    ops = {"counts": torch.from_numpy(counts), "t": torch.from_numpy(t),
           "denom_a": torch.from_numpy(da), "denom_b": torch.from_numpy(db)}
    for name, fn in change.items():
        ops[name] = fn(ops[name])
    return ops


@pytest.mark.parametrize("change,error,match", [
    ({"t": lambda x: x[:2]}, ValueError, "differ in P"),
    ({"denom_a": lambda x: x[:49]}, ValueError, "does not match n_pairs"),
    ({"denom_b": lambda x: x[None]}, ValueError, "does not match n_pairs"),
    ({"counts": lambda x: x[0]}, ValueError, r"\(P, n\)"),
    ({"counts": lambda x: x.to(torch.int64)}, TypeError, "int16 or int32"),
    ({"counts": lambda x: x.to(torch.uint8)}, TypeError, "int16 or int32"),
    ({"t": lambda x: x.to(torch.int64)}, TypeError, "t must be int32"),
    ({"denom_b": lambda x: x.to(torch.int64)}, TypeError, "denom_b must"),
    ({"t": lambda x: x.t().contiguous().t()}, ValueError, "contiguous"),
    ({"counts": lambda x: x.t().contiguous().t()}, ValueError, "contiguous"),
    ({"t": lambda x: x.to("meta")}, ValueError, "different devices"),
], ids=["t_P", "ids_n", "ids_2d", "counts_1d", "counts_i64", "counts_u8",
        "t_i64", "ids_i64", "t_strided", "counts_strided", "mixed_devices"])
def test_finish_pairs_rejects_what_the_kernel_does_not_take(
        change, error, match):
    with pytest.raises(error, match=match):
        finish.finish_pairs(**_operands(**change))


def test_finish_pairs_raises_off_cuda_and_cpu():
    ops = {k: v.to("meta") for k, v in _operands().items()}
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        finish.finish_pairs(**ops)


def test_finish_library_builds_its_one_source(monkeypatch, tmp_path):
    """The finish kernel is a library of its own: its build compiles
    csrc/finish_f64.cu alone (none of the wgmma sources) and links it under
    its own name, whose tag follows its source and not the count kernels'."""
    import stat

    from parfastaai_tpu_torch.ops import _build

    log = tmp_path / "nvcc.log"
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    fake = bindir / "nvcc"
    fake.write_text(
        f"#!/bin/sh\necho \"$@\" >> {log}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift\n"
        "done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    path = _build.build("pfaai_finish", _build._FINISH_SRCS, [])
    tag = _build._tag(_build._FINISH_SRCS, [])
    assert os.path.basename(path) == f"libpfaai_finish_{tag}.so"
    assert tag != _build._tag()
    lines = log.read_text().splitlines()
    compiles = [ln for ln in lines if " -c " in ln]
    assert len(compiles) == 1 and compiles[0].endswith("finish_f64.cu")
    assert len(lines) == 2 and " -shared " in lines[1]
    assert not any(src in ln for ln in lines
                   for src in ("sn_rect.cu", "sn_square_wgmma.cu"))
    # a second call finds the library and runs no nvcc
    assert _build.build("pfaai_finish", _build._FINISH_SRCS, []) == path
    assert len(log.read_text().splitlines()) == 2
