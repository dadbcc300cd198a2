#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

1. Builds the CUDA kernels from the sources in this checkout (nvcc) and
   checks each against its plain PyTorch version on the card, in every
   divide mode, at the main path's block shape, at a ragged shape and at a
   K wider than the TPU package's single-block limit.  Kernel and plain
   times are taken with CUDA events at the main path's shape.
2. Runs the port's CLI once, in process, as a user would:
   ``--fast --device cuda`` all-vs-all on a synthetic database at the
   benchmark's size (4096 genomes, 80 proteins, pool 1200, 400 tetramers
   per genome, seed 0), with every kernel launch counter reset just before
   and read just after.  A band of 64 rows of the result is then checked
   against exact integer counts finished in f64 on the host (numpy).
3. Prints the card's name and power limit, one JSON line of kernel results
   and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, and prints no result line, when CUDA is not available or
any phase fails.  Needs one card.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# (name, P, A, B, K): the main path's block (one 1024-row band against all
# 4096 columns of the K=1280 bucket), a ragged edge, and K > 32768.
SHAPES = [
    ("main", 80, 1024, 4096, 1280),
    ("ragged", 3, 70, 130, 256),
    ("wide_k", 2, 256, 256, 34816),
]
MODES = [
    ("newton", {}),
    ("approx", {"approx": True}),
    ("precise", {"precise": True}),
]
# Tolerances against the plain version (IEEE divide): the Newton-refined
# reciprocal keeps S within 2e-6 relative, the raw approximate reciprocal
# keeps AJI within 1e-3 relative; N is always exact and S is bit-equal
# under the IEEE divide.
RTOL_NEWTON_S = 2e-6
RTOL_APPROX_AJI = 1e-3
# End-to-end run and its host check.
E2E = dict(n_genomes=4096, n_proteins=80, pool_size=1200, tetras_per_genome=400)
BAND_ROWS = 64
RTOL_E2E_AJI = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def captured_stdout(lines: list):
    """Capture file descriptor 1 (print() and the CLI's phase timers, which
    hold their own handle on stdout) into ``lines``."""
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile(mode="w+") as tmp:
        os.dup2(tmp.fileno(), 1)
        try:
            yield
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
            tmp.seek(0)
            lines.extend(tmp.read().splitlines())


def random_block(gen, dev, P, A, B, K):
    import torch

    from parfastaai_tpu_torch.ops.sn_rect import clamp_t

    # Density of the synthetic databases' compacted presence (400 of ~1200).
    ma = (torch.rand((P, A, K), generator=gen, device=dev) < 0.33).to(torch.uint8)
    mb = (torch.rand((P, B, K), generator=gen, device=dev) < 0.33).to(torch.uint8)
    ta = clamp_t(ma.sum(dim=2, dtype=torch.int32))
    tb = clamp_t(mb.sum(dim=2, dtype=torch.int32))
    return ma, mb, ta, tb


def kernel_phase(dev) -> dict:
    """Kernel against plain version at every shape and mode."""
    import torch

    from parfastaai_tpu_torch.ops import sn_rect

    gen = torch.Generator(device=dev).manual_seed(SEED)
    report = {}
    for name, P, A, B, K in SHAPES:
        ma, mb, ta, tb = random_block(gen, dev, P, A, B, K)
        s_ref, n_ref = sn_rect.fused_sn_block_plain(ma, mb, ta, tb)
        shared = n_ref > 0
        aji_ref = s_ref[shared] / n_ref[shared]
        for mode, kw in MODES:
            s, n = sn_rect.fused_sn_block(ma, mb, ta, tb, **kw)
            torch.cuda.synchronize()
            if not torch.equal(n, n_ref):
                fail(f"{name}/{mode}: N differs from the plain version")
            err = (s - s_ref).abs()
            max_abs = float(err.max())
            if mode == "precise":
                ok = torch.equal(s, s_ref)
                bound = "bit-equal"
            elif mode == "newton":
                ok = bool((err <= RTOL_NEWTON_S * s_ref.abs()).all())
                bound = f"rtol {RTOL_NEWTON_S}"
            else:
                aji = s[shared] / n[shared]
                ok = bool(
                    ((aji - aji_ref).abs() <= RTOL_APPROX_AJI * aji_ref.abs()).all()
                )
                bound = f"AJI rtol {RTOL_APPROX_AJI}"
            print(
                f"sn_rect {name} P={P} A={A} B={B} K={K} {mode}: "
                f"N exact, S max_abs_err={max_abs:.3e} ({bound}) "
                f"{'ok' if ok else 'FAIL'}"
            )
            if not ok:
                fail(f"{name}/{mode}: S outside {bound}")
            report[(name, mode)] = max_abs
        if name == "main":
            report["ms"] = cuda_ms(lambda: sn_rect.fused_sn_block(ma, mb, ta, tb), 5)
            report["plain_ms"] = cuda_ms(
                lambda: sn_rect.fused_sn_block_plain(ma, mb, ta, tb), 3
            )
            macs = P * A * B * K
            print(
                f"sn_rect main shape: kernel {report['ms']:.3f} ms "
                f"({macs / report['ms'] / 1e9:.3f} TMAC/s), plain "
                f"{report['plain_ms']:.3f} ms "
                f"({macs / report['plain_ms'] / 1e9:.3f} TMAC/s)"
            )
        del ma, mb, ta, tb, s_ref, n_ref
        torch.cuda.empty_cache()
    return report


def synth_db() -> str:
    from parfastaai_tpu_torch.host import generate_synth_db

    tag = "_".join(f"{k}{v}" for k, v in E2E.items())
    path = os.path.join(tempfile.gettempdir(), f"parfastaai_synth_{tag}_s{SEED}.db")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        tmp = f"{path}.tmp{os.getpid()}"
        generate_synth_db(tmp, seed=SEED, **E2E)
        os.replace(tmp, path)
        print(f"synthetic DB generated in {time.perf_counter() - t0:.1f} s")
    return path


def exact_band(m: np.ndarray, t: np.ndarray, rows: int):
    """(S f64, N int32) of rows 0..rows-1 against every genome: integer
    counts per protein, then S += c / (ta + tb - c) and N += 1 over the
    proteins that share tetramers, in ascending protein order."""
    P, G, _ = m.shape
    s = np.zeros((rows, G), np.float64)
    n = np.zeros((rows, G), np.int32)
    for p in range(P):
        mp = m[p].astype(np.float32)  # exact: counts < 2^24
        c = np.rint(mp[:rows] @ mp.T).astype(np.int64)
        shared = c > 0
        denom = t[p, :rows, None].astype(np.int64) + t[p][None, :] - c
        s[shared] += c[shared] / denom[shared]
        n += shared
    return s, n


def band_check(db: str, csv_path: str, dev) -> None:
    """Rows 0..BAND_ROWS-1 of the run against exact f64 on the host."""
    from parfastaai_tpu_torch import engine
    from parfastaai_tpu_torch.host import SCPDatabase

    db_ = SCPDatabase(db)
    try:
        presence = db_.load_presence()
    finally:
        db_.close()
    G = presence.m.shape[1]
    R = BAND_ROWS
    s64, n64 = exact_band(presence.m, presence.t, R)
    rows = np.arange(R, dtype=np.int32)
    cols = np.arange(G, dtype=np.int32)
    s_e, n_e = engine._banded_sn(presence, rows, cols, rows, cols, dev)
    if not np.array_equal(n_e, n64):
        fail("band check: engine N differs from exact counts")
    with np.errstate(divide="ignore", invalid="ignore"):
        aji64 = s64 / n64
        aji_e = s_e.astype(np.float64) / n_e
    if not np.allclose(aji_e, aji64, rtol=RTOL_E2E_AJI, atol=0, equal_nan=True):
        fail("band check: engine AJI outside rtol 1e-6 of exact f64")
    want = aji64.copy()
    want[rows, rows] = 0.0  # the CSV leaves the diagonal untouched
    with open(csv_path) as fp:
        header = fp.readline().rstrip("\n").split(",")
        got = np.array(
            [[float(v) for v in fp.readline().rstrip("\n").split(",")[1:]]
             for _ in range(R)]
        )
        n_lines = 1 + R + sum(1 for _ in fp)
    if len(header) != G + 1 or n_lines != G + 1 or got.shape != (R, G):
        fail(f"CSV shape: {n_lines} lines, {len(header)} header fields")
    if not np.all(np.isfinite(got)):
        fail("CSV band holds non-finite values")
    if not np.allclose(got, want, rtol=RTOL_E2E_AJI, atol=0):
        fail("band check: CSV AJI outside rtol 1e-6 of exact f64")
    err = np.abs(got - want) / np.where(want == 0, 1.0, np.abs(want))
    print(
        f"band check: rows 0..{R - 1} x {G} columns, N exact, "
        f"AJI max rel err {err.max():.3e} (rtol {RTOL_E2E_AJI}) ok"
    )


def e2e_phase(dev) -> dict:
    from parfastaai_tpu_torch import cli
    from parfastaai_tpu_torch.host import native_lib
    from parfastaai_tpu_torch.ops import sn_rect

    db = synth_db()
    print(
        "native host library:",
        "loaded" if native_lib() is not None else
        "NOT loaded (Python CSV formatter)",
    )
    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_")
    try:
        out = os.path.join(out_dir, "aji.csv")
        lines: list[str] = []
        sn_rect.LAUNCHES = 0
        t0 = time.perf_counter()
        with captured_stdout(lines):
            rc = cli.run([db, out, "--fast", "--device", "cuda"])
        wall = time.perf_counter() - t0
        launches = sn_rect.LAUNCHES
        text = "\n".join(lines)
        print(text)
        if rc != 0:
            fail(f"CLI --fast exited {rc}")
        if launches == 0:
            fail("the --fast run launched no sn_rect kernel")
        phases = {
            m.group(1).strip(): float(m.group(2))
            for m in re.finditer(r"^\s*(.+?)\s*: ([0-9.]+) ms", text, re.M)
        }
        G = E2E["n_genomes"]
        jac_s = phases["JAC + AJI"] / 1e3
        print(
            f"e2e --fast G={G}: wall {wall:.3f} s, sn_rect launches {launches}, "
            f"{G * (G - 1) // 2 / jac_s:.4e} genome pairs/s over JAC + AJI; "
            "split ms: "
            + ", ".join(
                f"{k} {phases.get(k, 0.0):.1f}"
                for k in ("Presence ETL", "host bucketize", "H2D", "gather",
                          "kernel", "D2H", "host assembly", "pair gather",
                          "CSV write")
            )
        )
        band_check(db, out, dev)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": launches}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    dev = torch.device("cuda")
    from parfastaai_tpu_torch.ops import _build

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    print(
        f"kernel build + load: {time.perf_counter() - t0:.1f} s "
        f"({'compiled by nvcc now' if _build.build_log else 'library was already built'})"
    )
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    kern = kernel_phase(dev)
    e2e = e2e_phase(dev)
    if "jax" in sys.modules:
        fail("jax was imported")

    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "sn_rect",
        "route": "cuda",
        "source": "parfastaai_tpu_torch/csrc/sn_rect.cu",
        "replaces": "parfastaai_tpu/ops/pallas_intersect.py:1112",
        "launches": e2e["launches"],
        "max_abs_err": kern[("main", "newton")],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
