#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the repository root:

    python3 chip_smoke.py

1. Builds the CUDA kernels (nvcc) and the host library (g++) from the
   sources in this checkout; fails where ptxas reports a spill in a wgmma
   kernel, serializes its wgmma or injects a wait into a two-count-set
   body; checks in the kernels' SASS (cuobjdump) that every instantiation
   that the sources build runs on the tensor cores (sn_rect and
   sn_square_wgmma, each update, packing and walk: IGMMA, the warpgroup
   product, and asynchronous copies, no __dp4a; packed rows also the
   shared-memory stores of their split into nibbles), and checks each
   kernel against its plain PyTorch version on the card, in every divide
   mode:
   * sn_rect at the --fast path's block shape, at ragged shapes (one with
     a single protein), at a K of one kernel slice, at a K wider than the
     TPU package's single-block limit and at the kb bench's block, with a
     K sweep at the --fast block that splits its time into a slope per
     presence column and an intercept;
   * the whole-matrix kernel behind ``sn_square.fused_aji``,
     sn_square_wgmma (int8 wgmma in 128 x 128 tiles), at the benchmark's
     shape through every route: ``fused_aji``'s default plan, one and two
     proteins per step, the full square, nibble-packed rows (triu and full,
     also at an odd K), the diagonal walk (one launch) and the band walks
     (one launch per band row of 128), each launching sn_square_wgmma alone
     with S and N bit-symmetric, and the K-blocked plans; with a K sweep
     that splits its time into a slope per presence column and an
     intercept (``lean`` in every divide mode, ``pipe``, ``mxu_outer``,
     ``fused``, ``counts`` and packed rows under Newton); every route also
     at ragged, one-tile and one-slice shapes and at a K wider than the TPU
     package's single-block limit;
   * the two-proteins-per-step variants ``pipe``, ``fused`` /
     ``mxu_outer`` (sn_square_wgmma's two-count-set bodies, one launch
     each), ``counts`` (its one-count-set pair loop, bit-equal to its plain
     version in every divide mode) and ``f32gram`` (the default's body) at
     the benchmark's shape, a ragged G, an odd P, one kernel slice per
     protein and one protein, each launching sn_square_wgmma once and
     bit-equal to the kernel whose values it keeps (``lean``, ``fused`` or
     ``mxu_outer``);
   * ``counts`` at the benchmark's shape against its library call: one
     ``torch._int_mm`` of the proteins' slabs side by side, (G, P K) by its
     transpose, whose f32 cast must equal the kernel's S bit for bit; the
     call and its relayout copy are timed apart.
   Kernel and plain times are taken with CUDA events at the main shapes
   (the median of 5 runs of back-to-back calls),
   and each kernel's bound (the larger of its bytes over the card's
   memory rate and the MACs its function needs over the int8 tensor-core
   peak: P K G (G + 1) / 2 for a symmetric square, whatever tiles the
   kernel walks) is computed from the same inputs.
2. Runs the port's CLI once, in process, as a user would:
   ``--fast --device cuda`` all-vs-all on a synthetic database at the
   benchmark's size (4096 genomes, 80 proteins, pool 1200, 400 tetramers
   per genome, seed 0), with every kernel launch counter reset just before
   and read just after.  A band of 64 rows of the result is then checked
   against exact integer counts finished in f64 on the host (numpy).
2a. Runs the multi-GPU engine (``--mesh``, ``engine.compute_sharded``)
   on the database of step 2, after printing the GPU count
   (``torch.cuda.device_count()``) and the backend of its two-process
   leg.  Leg (a): ``--mesh 1,1 --device cuda`` in process, launch
   counters reset just before and read just after (sn_rect once, the
   whole square, no other kernel), its first 64 rows against exact f64
   (``band_check``) and its agreement with step 2's CSV printed.  Leg
   (b): ``--mesh 2,1`` and ``--mesh 1,2`` through the CLI in two
   processes each (PARFASTAAI_COORDINATOR on a local port; NCCL with two
   cards or more, else gloo with both ranks on cuda:0; every rank with a
   timeout), each rank reporting its own launch counts (sn_rect once, no
   other kernel): only rank 0 writes, 2,1's CSV has 1,1's bytes, 1,2's
   first 64 rows are within 1e-6 of exact f64, and rank 0's phases (ETL,
   Presence broadcast, JAC + AJI with its H2D / kernel / scp all-reduce /
   row gather split, CSV write) and the wall are printed.  Then the
   bench's mesh mode in process: the (1, 1) mesh step against the direct
   leg (sn_rect alone, 81 launches each).
3. Runs the f32 streamed engine on the card through the CLI
   (``--streamed --device cuda``): at full width on the database of step 2
   with the default band and chunk, launch counters reset just before and
   read just after (sn_rect once per 1024 x 4096 block, no other kernel),
   its first 64 rows held against step 2's exact f64 within the ``--fast``
   tolerance with the diagonal the text ``0``, and its wall, genome pairs
   per second and stage split printed.  On a 1024-genome database of the
   same generator under ``--precise``: the symmetric walk in 256 x 256
   blocks (10 of 16 computed), the same with PARFASTAAI_MIRROR_BYTES=1
   (16 of 16, and the NOTE on stderr), one block for the whole square, a
   ``--resume`` from a file cut inside its second band, a ``--profile``
   run and the library API's ``engine="streamed"`` must all write the same
   bytes with the reckoned launch counts, and their first 256 rows must
   equal, as text, the plain version's on the card (per bucket
   ``fused_sn_block_plain``, summed in bucket order, ``_mask_aji``, the
   formatter).  From the Chrome traces of ``--profile`` (one at each size)
   the device-busy milliseconds (the union of kernel and copy intervals)
   are printed beside the phase's wall.
4. Runs the exact path on the card.  On a 1024-genome database of the same
   generator: the default (dense) call, which must launch the f64 finish
   kernel once and no other hand-written kernel, ``--streamed --exact``
   (the banded exact engine on its symmetric walk) and the same with
   PARFASTAAI_MIRROR_BYTES=1 (the full square) must write the same bytes,
   and a ``--resume`` from the second file cut inside a band must restore
   it.  Then the CLI with no flag but ``--device cuda`` on the 4096-genome
   database of step 2: it must route itself into the banded exact engine,
   launch none of the hand-written kernels (its device work is the library
   int8 Gram), and its first 64 rows must equal, as text, the formatter's
   output on exact f64 computed on the host (numpy): both accumulate IEEE
   f64 in ascending protein order, so this is equality, not a tolerance.
   Its wall, genome pairs per second and stage split are printed.
5. Runs staged presence slabs on the card at two sizes, each under a
   device budget lowered through PARFASTAAI_HBM_BYTES.  Leg A, the CLI on
   the 4096-genome database of step 2 under a budget of a third of its
   bucketed presence and slabs of a sixth of that budget
   (PARFASTAAI_SLAB_BYTES): ``--fast --staged``, ``--streamed`` and the
   default call (auto-routed into the banded exact engine), the last two
   staged by the budget alone; each CSV is held against the resident CSV
   of steps 2-4 (the default call's bytes equal, the f32 ones equal or
   within rtol 1e-6 with the text ``0`` in the same cells), with launch
   counters reset just before and read just after each call (sn_rect > 0
   in the first two, no hand-written kernel in the third).  Leg B, the TPU
   record's shape in memory (80 proteins, 4096 genomes, 51200 presence
   columns, made with numpy from the seed) under its budget of 14.9 GiB:
   ``engine.compute_streamed`` in 1024 x 1024 blocks, auto-staged, held
   against the same presence run resident on the card to the same
   tolerance; then sn_rect at the run's chunk shape against its plain
   version.  Each prints its walls, stage split, uploaded bytes over the
   bucketed presence, the slab store's peak against its cap (which it may
   pass by one slab at most) and ``torch.cuda.max_memory_allocated``
   beside the budget.
5a. Runs the streamed engines over the mesh through the CLI on the
   database of step 2 (``streamed_mesh_phase``), in two processes each
   (NCCL with two GPUs or more, else gloo with every rank on cuda:0;
   ``2,2`` of each mesh leg in four with four GPUs or more):
   ``--streamed --mesh 2,1`` and ``1,2``, ``--streamed --exact --mesh
   2,1`` and ``1,2``, ``--streamed --staged --mesh 2,1`` and ``--streamed
   --exact --mesh 1,2`` under leg A's budget and slabs (process 0 prints
   the meta-only broadcast line and its slab counters), and ``--streamed
   --exact`` without a mesh.  Each rank reports its launches: sn_rect as
   reckoned from the plan in the f32 legs, no hand-written kernel in the
   exact ones; only rank 0 writes; the exact CSVs have the default call's
   bytes, the f32 row splits ``--streamed``'s (staged: leg A's staged
   CSV's), the protein splits' first rows are within 1e-6 of exact f64.
   Rank 0's phases and each leg's wall from launch to the last exit are
   printed.
5b. Runs the bench's e2e mode (``PARFASTAAI_BENCH_MODE=e2e python -m
   parfastaai_tpu_torch.bench``) on the database of step 2: in this
   process with every leg and PARFASTAAI_BENCH_EXACT_MESH=1,1, launch
   counters reset just before and read just after (sn_rect on the fused
   and streamed legs, no kernel on the exact ones), then in two processes
   with EXACT_MESH=2,1 (process 0 alone prints).  Each run's JSON line
   must parse; its exact and mesh CSVs must be the default call's bytes,
   its fused and streamed ones those of (or within RTOL_E2E_AJI of) the
   --fast and --streamed calls'; the line and each leg's split, launches
   and genome pairs per second are printed.
6. Runs ``python -m parfastaai_tpu_torch.bench`` in process in kernel mode
   (the whole-matrix fused AJI path, launch counters reset just before and
   read just after), once with the default update, which must launch
   sn_square_wgmma and no other kernel, and once with each
   ``PARFASTAAI_BENCH_VARIANT`` above (each must launch sn_square_wgmma
   alone, once per ``fused_aji`` call: 81 times), and in kb mode, echoing
   their JSON lines; checks a band of ``fused_aji`` on the bench's workload
   against exact f64; and calls ``fused_aji`` with ``packed=True`` on the
   same workload (launch counters reset just before and read just after:
   sn_square_wgmma once, no other kernel), against the default plan's
   result.  Then ``ops.intersection_counts`` and ``ops.pair_counts`` on
   the card at a small size, equal to ``int_gram`` and to exact counts.
   Then the dense exact engine's f64 finish kernel (``ops.finish``, built
   as its own library, its build's seconds printed) at the pair lists of
   the benchmark's qsub and qdb cells: S and N bit-equal to the host's
   native finish and to the plain version on the card, and the kernel's,
   the plain version's and the host path's times beside its bound.
7. Prints the card's name and power limit, one JSON line of kernel results,
   one of the finish kernel's (with step 4's dense call's launches) and,
   last, ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --finish-only`` builds the libraries and runs step
4's dense call (its launches alone) and the finish kernel's checks and
times of step 6, then prints the card line, the finish kernel's JSON line
and the result line.

``python3 chip_smoke.py --mesh-only`` runs steps 2, 2a, 5a and 5b's
two-process launch alone (for
a machine with several GPUs, whose legs then run on NCCL, four processes
too with four GPUs or more, and the bench's mesh mode in one process per
GPU; step 5a's references, ``--streamed`` and the default call, run in
this process first), then prints the mesh phases' report and the result
line.

Exits non-zero, and prints no result line, when CUDA is not available,
when the native host library does not build, when any phase fails, or when
the run loaded ``jax`` or anything of the JAX package.  Needs one card.
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
# 4096 columns of the K=1280 bucket), a ragged edge, K > 32768, and the kb
# bench's block (the regime of the TPU's _pallas_sn_rect_kb).  Times are
# taken at "main" and "kb".
SHAPES = [
    ("main", 80, 1024, 4096, 1280),
    ("ragged", 3, 70, 130, 256),
    # neither A nor B a multiple of the kernel's 128 x 128 block, one protein
    ("ragged_p1", 1, 77, 131, 256),
    # one 128-byte slice per protein: the ring wraps across proteins at once
    ("one_slice", 9, 129, 300, 128),
    ("wide_k", 2, 256, 256, 34816),
    ("kb", 16, 1024, 1024, 51200),
]
# K sweep of sn_rect at the main shape's P, A, B and of sn_square_wgmma at
# the bench shape's P, G (presence columns; packed rows hold half as many
# bytes).
K_SWEEP = (640, 1280, 2560)
# Kernel times: the median of TIMED_RUNS runs of back-to-back calls, each
# run between its own pair of CUDA events, after one warm-up.
TIMED_RUNS = 5
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
# sn_square_wgmma at the benchmark's shape (bench.py: P=80, G=4096, K=1280,
# ~400 of 1280 present), a ragged G, and K past the TPU's single-block
# limit.
SQUARE_MAIN = (80, 4096, 1280)
SQUARE_DENSITY = 400 / 1280
# Then: one ragged 128 x 128 tile, and a diagonal tile with a one-row edge
# at one kernel slice per protein.
SQUARE_SMALL = [("ragged", 3, 300, 256), ("wide_k", 2, 256, 34816),
                ("one_tile", 3, 77, 256), ("one_slice", 9, 129, 128)]
# The 2p variants, each with the update whose values it keeps (None:
# ``counts``, whose S is the sum of the counts: no divide, so bit-equal to
# its plain version in every mode), checked at the bench shape and at these
# (a ragged G, an odd P, one kernel slice per protein, one protein).
VARIANTS = {"pipe": "lean", "mxu_outer": "fused", "fused": "mxu_outer",
            "counts": None, "f32gram": "lean"}
VARIANT_SMALL = [("ragged", 3, 300, 256), ("odd_p", 5, 700, 1280),
                 ("one_slice", 9, 129, 128), ("p1", 1, 300, 256)]
# The variants on sn_square_wgmma's bodies other than the default's: two
# count sets (pipe; fused and mxu_outer, one launch) and one a pair
# (counts); f32gram runs the default's (lean).
WGMMA_VARIANTS = ("pipe", "mxu_outer", "fused", "counts")
# fused_aji calls of one kernel-mode bench run at its default knobs: one
# warm-up, then 5 timed runs of 16 calls (bench.kernel_bench).
BENCH_CALLS = 1 + 5 * 16
# The K-blocked plans timed at bench.py's kb shape (P=16, 1024, K=51200).
SQUARE_KB = (16, 1024, 51200)
# The bench runs with its default knobs, in kernel mode and in kb mode.
BENCH_KB_ENV = {"PARFASTAAI_BENCH_MODE": "kb"}
PALLAS = "parfastaai_tpu/ops/pallas_intersect.py"
# def lines of the TPU kernels each CUDA kernel replaces: sn_square_wgmma
# takes _pallas_sn_sym_2p (402) with its bodies (219, 253, 315 and f32gram's
# _gram 82, 339), _pallas_sn_sym and _pallas_sn (802, 744, packed too),
# their K-blocked twins (593, 636) and the walks (867, 949, 1035)
REPLACES = {
    "sn_rect": (1112, 697),
    "sn_square_wgmma": (402, 219, 253, 315, 82, 339, 802, 744, 593, 636, 867,
                        949, 1035),
}
KERNELS = tuple(REPLACES)
# Device-memory rate (bytes/s) by a substring of
# torch.cuda.get_device_name, from NVIDIA's H100 data sheet; the int8
# tensor-core peak beside it is bench.INT8_PEAK_MACS.
MEMORY_RATE = {
    "H100 80GB HBM3": 3.35e12,
    "H100 SXM": 3.35e12,
    "H100 NVL": 3.9e12,
    "H100 PCIe": 2.0e12,
}
# End-to-end run and its host check.
E2E = dict(n_genomes=4096, n_proteins=80, pool_size=1200, tetras_per_genome=400)
BAND_ROWS = 64
RTOL_E2E_AJI = 1e-6
# The exact path's byte comparisons (dense, banded, banded without the
# mirror, resumed) run at this many genomes of the E2E generator.
EXACT_SMALL_G = 1024
# The streamed engine's byte comparisons at EXACT_SMALL_G: block edge of
# the symmetric walk, and the rows held against the plain version.
STREAMED_BLOCK = 256
STREAMED_PLAIN_ROWS = 256
# Staged slabs.  Leg A: the CLI on the E2E database under a device budget
# of a third of its bucketed presence and slabs of a sixth of that budget
# (the 256 MiB floor of the default slab size would exceed the budget).
STAGED_BUDGET_SHARE = 3
STAGED_SLAB_SHARE = 6
# Leg B: the TPU record's shape in memory (80 proteins, 4096 genomes, 51200
# presence columns, ~400 tetramers per genome and protein) under the
# record's budget of 14.9 GiB, in blocks of 1024 x 1024.
LEG_B = dict(P=80, G=4096, K=51200, tetras=400)
LEG_B_BUDGET = int(14.9 * 2**30)
LEG_B_BLOCK = 1024


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


def bound(macs: float, nbytes: float) -> dict:
    """The least time this card could take: MACs over its dense int8
    tensor-core peak (the inputs are 0/1 bytes, also where a kernel
    multiplies them as f16) or bytes (each input read once, each output
    written once) over its memory rate, whichever is larger."""
    import torch

    from parfastaai_tpu_torch import bench

    kind = torch.cuda.get_device_name(0)
    peak_macs = bench.int8_peak(kind)
    peak_bytes = next((v for k, v in MEMORY_RATE.items() if k in kind), None)
    if peak_macs is None or peak_bytes is None:
        fail(f"no peak rates listed for {kind!r}")
    by_ops, by_bytes = macs / peak_macs * 1e3, nbytes / peak_bytes * 1e3
    return {"bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def rect_bound(P, A, B, K) -> dict:
    return bound(P * A * B * K, P * (A + B) * (K + 4) + A * B * 8)


def square_bound(P, G, K, symmetric: bool = True) -> dict:
    """Bound of S, N of the G x G square: the MACs the function needs (the
    upper triangle with its diagonal when the square is computed as
    symmetric, K unpadded), not those a kernel's tiles execute."""
    macs = P * K * (G * (G + 1) // 2 if symmetric else G * G)
    return bound(macs, P * G * (K + 4) + G * G * 8)


def median_ms(fn, runs: int = 5) -> float:
    """Median milliseconds of ``runs`` calls of ``fn`` on the card, each
    between its own pair of CUDA events, after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` on the card: the median over
    TIMED_RUNS runs of the mean of ``reps`` back-to-back calls, each run
    between its own pair of CUDA events, after one warm-up.  (A single run
    of 5 calls moved by up to 19% between runs of one tree.)"""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


@contextlib.contextmanager
def captured_stdout(lines: list, fd: int = 1):
    """Capture file descriptor 1 (print() and the CLI's phase timers, which
    hold their own handle on stdout), or ``fd`` 2 for stderr, into
    ``lines``."""
    stream = sys.stdout if fd == 1 else sys.stderr
    stream.flush()
    saved = os.dup(fd)
    with tempfile.TemporaryFile(mode="w+") as tmp:
        os.dup2(tmp.fileno(), fd)
        try:
            yield
        finally:
            stream.flush()
            os.dup2(saved, fd)
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
        for mode, kw in MODES:
            s, n = sn_rect.fused_sn_block(ma, mb, ta, tb, **kw)
            report[(name, mode)] = check(
                f"sn_rect {name} P={P} A={A} B={B} K={K}", s, n, s_ref,
                n_ref, mode,
            )
        if name in ("main", "kb"):
            ms = cuda_ms(lambda: sn_rect.fused_sn_block(ma, mb, ta, tb), 5)
            plain_ms = cuda_ms(
                lambda: sn_rect.fused_sn_block_plain(ma, mb, ta, tb), 3
            )
            report[(name, "ms")], report[(name, "plain_ms")] = ms, plain_ms
            report[(name, "bound")] = b = rect_bound(P, A, B, K)
            macs = P * A * B * K
            print(
                f"sn_rect {name} shape: kernel {ms:.3f} ms "
                f"({macs / ms / 1e9:.3f} TMAC/s), plain {plain_ms:.3f} ms "
                f"({macs / plain_ms / 1e9:.3f} TMAC/s), bound "
                f"{b['bound_ms']:.3f} ms by {b['bound_by']} "
                f"({b['bound_ms'] / ms:.1%} of the kernel's time)"
            )
        del ma, mb, ta, tb, s_ref, n_ref
        torch.cuda.empty_cache()
    _, P, A, B, _ = SHAPES[0]
    times = {}
    for K in K_SWEEP:
        ma, mb, ta, tb = random_block(gen, dev, P, A, B, K)
        times[K] = {
            mode: cuda_ms(lambda: sn_rect.fused_sn_block(ma, mb, ta, tb, **kw), 5)
            for mode, kw in MODES
        }
        del ma, mb, ta, tb
        torch.cuda.empty_cache()
    for mode, _ in MODES:
        print_sweep(f"sn_rect K sweep P={P} A={A} B={B} {mode}",
                    [times[K][mode] for K in K_SWEEP])
    return report


def print_sweep(label: str, t: list) -> None:
    """One line of a K sweep: the times at K_SWEEP, the slope between
    neighbours in us per presence column, and the intercept at K = 0."""
    slopes = [(t[i + 1] - t[i]) / (K_SWEEP[i + 1] - K_SWEEP[i]) * 1e3
              for i in range(len(t) - 1)]
    print(
        f"{label}: "
        + ", ".join(f"K={K} {ms:.3f} ms" for K, ms in zip(K_SWEEP, t))
        + "; us per presence column "
        + ", ".join(f"{v:.3f}" for v in slopes)
        + f"; intercept {t[0] - slopes[0] * K_SWEEP[0] / 1e3:.3f} ms"
    )


def check(label: str, s, n, s_ref, n_ref, mode: str) -> float:
    """Kernel (s, n) against the plain version's: N exact; S bit-equal
    under the IEEE divide, within RTOL_NEWTON_S under Newton, AJI within
    RTOL_APPROX_AJI under the raw reciprocal.  Returns S's max abs err."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(n, n_ref):
        fail(f"{label}/{mode}: N differs from the plain version")
    err = (s - s_ref).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    if mode == "precise":
        ok = torch.equal(s, s_ref)
        bound = "bit-equal"
    elif mode == "newton":
        ok = bool((err <= RTOL_NEWTON_S * s_ref.abs()).all())
        bound = f"rtol {RTOL_NEWTON_S}"
    else:
        shared = n_ref > 0
        aji, aji_ref = s[shared] / n[shared], s_ref[shared] / n_ref[shared]
        ok = bool(((aji - aji_ref).abs() <= RTOL_APPROX_AJI * aji_ref.abs()).all())
        bound = f"AJI rtol {RTOL_APPROX_AJI}"
    print(f"{label} {mode}: N exact, S max_abs_err={max_abs:.3e} ({bound}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{label}/{mode}: S outside {bound}")
    return max_abs


def random_square(gen, dev, P, G, K, density):
    import torch

    from parfastaai_tpu_torch.ops.sn_rect import clamp_t

    m = (torch.rand((P, G, K), generator=gen, device=dev) < density).to(torch.uint8)
    t = m.sum(dim=2, dtype=torch.int32)
    return m, t, clamp_t(t)


def square_checks(label, m, t_raw, tc, s_ref, n_ref, modes) -> dict:
    """Every route of sn_square against the plain version's (s_ref, n_ref)
    of (m, tc), each with S and N bit-symmetric and launching
    sn_square_wgmma alone: a band walk once per band row of 128, every other
    route once.  ``modes`` are the divide modes to check.  Returns the max
    abs errors by (route, mode); the default plan's route is "default"."""
    import torch

    from parfastaai_tpu_torch.ops import sn_square

    mp = sn_square.pack_nibbles(m)
    nt = -(-m.shape[1] // sn_square.WGMMA_TILE)
    sq = sn_square.fused_sn_square
    errs = {}
    for mode in modes:
        kw = dict(MODES)[mode]
        (aji, s, n), ran = launched(
            lambda: sn_square.fused_aji(m, t_raw, **kw))
        errs[("default", mode)] = check(
            f"sn_square {label} fused_aji default", s, n, s_ref, n_ref, mode)
        if not torch.equal(torch.isnan(aji), n == 0):
            fail(f"{label}: AJI NaN pattern differs from N == 0")
        for name, run, want in (
            ("default", None, 1),
            ("1 protein/step", lambda: sq(m, tc, **kw), 1),
            ("2 proteins/step base", lambda: sq(
                m, tc, pairs_per_step=2, update="base", **kw), 1),
            ("full square", lambda: sq(m, tc, symmetric=False, **kw), 1),
            ("packed", lambda: sq(mp, tc, packed=True, **kw), 1),
            ("packed full", lambda: sq(mp, tc, packed=True, symmetric=False,
                                       **kw), 1),
            ("diag", lambda: sn_square.sn_sym_diag(m, tc, **kw), 1),
            ("packed diag", lambda: sn_square.sn_sym_diag(
                mp, tc, packed=True, **kw), 1),
            ("bands", lambda: sn_square.sn_sym_bands(m, tc, **kw), nt),
            ("packed bands", lambda: sn_square.sn_sym_bands(
                mp, tc, packed=True, **kw), nt),
            ("bands_2p", lambda: sn_square.sn_sym_bands_2p(m, tc, **kw), nt),
            ("fused_aji full", lambda: sn_square.fused_aji(
                m, t_raw, symmetric=False, **kw)[1:], 1),
            ("fused_aji packed", lambda: sn_square.fused_aji(
                m, t_raw, packed=True, **kw)[1:], 1),
        ):
            if run is not None:
                (s, n), ran = launched(run)
                errs[(name, mode)] = check(f"sn_square {label} {name}", s, n,
                                           s_ref, n_ref, mode)
            if ran != {**dict.fromkeys(ran, 0), "sn_square_wgmma": want}:
                fail(f"{label}/{mode}: {name} should launch sn_square_wgmma "
                     f"{want} times and nothing else: {ran}")
            if not (torch.equal(s, s.T) and torch.equal(n, n.T)):
                fail(f"{label}/{mode}: S or N of {name} is not bit-symmetric")
        _, s, n = sn_square.fused_aji(m, t_raw, variant="fused", **kw)
        check(f"sn_square {label} variant=fused vs lean plain", s, n, s_ref,
              n_ref, "newton" if mode == "precise" else mode)
    print(f"sn_square {label}: every route launched sn_square_wgmma alone "
          f"(the band walks {nt} times, the others once), S and N "
          "bit-symmetric")
    del mp
    return errs


def variant_checks(label, m, t_raw, tc) -> dict:
    """Each 2p variant through ``fused_aji`` against its plain version in
    every divide mode, and bit-equal (torch.equal) to the two-proteins-
    per-step kernel with the update whose values it keeps.  Returns the
    max abs errors under Newton by variant."""
    import torch

    from parfastaai_tpu_torch.ops import sn_square

    errs = {}
    for variant, like in VARIANTS.items():
        s_ref, n_ref = sn_square.fused_sn_square_plain(m, tc, update=variant)
        for mode, kw in MODES:
            before = read_launches()
            _, s, n = sn_square.fused_aji(m, t_raw, variant=variant, **kw)
            ran = {k: v - before[k] for k, v in read_launches().items()}
            if ran != {**dict.fromkeys(ran, 0), "sn_square_wgmma": 1}:
                fail(f"{label}: variant={variant} should launch "
                     f"sn_square_wgmma once and nothing else: {ran}")
            err = check(f"sn_square {label} variant={variant}", s, n, s_ref,
                        n_ref, mode if like else "precise")
            if mode == "newton":
                errs[variant] = err
            if like is None:
                continue
            ws, wn = sn_square.fused_sn_square(
                m, tc, pairs_per_step=2, update=like, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(s, ws) and torch.equal(n, wn)):
                fail(f"{label}/{mode}: variant={variant} differs from the "
                     f"{like} kernel")
            print(f"sn_square {label} variant={variant} {mode}: bit-equal to "
                  f"the {like} kernel")
        del s_ref, n_ref
    return errs


def square_phase(dev) -> dict:
    """The whole-matrix kernel against its plain versions at the bench
    shape, small shapes and a wide K; kernel and plain times at the bench
    shape, each with the MACs that its route's tiles execute."""
    import torch

    from parfastaai_tpu_torch.ops import sn_square
    from parfastaai_tpu_torch.ops.sn_rect import clamp_t

    gen = torch.Generator(device=dev).manual_seed(SEED)
    P, G, K = SQUARE_MAIN
    m, t_raw, tc = random_square(gen, dev, P, G, K, SQUARE_DENSITY)
    label = f"main P={P} G={G} K={K}"
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, tc)
    errs = square_checks(label, m, t_raw, tc, s_ref, n_ref,
                         [mode for mode, _ in MODES])
    variant_errs = variant_checks(label, m, t_raw, tc)
    library = counts_library(m, tc)
    # packed at an odd K (the wrapper pads one zero column, then packs)
    mo = m[:, :, : K - 1].contiguous()
    to = mo.sum(dim=2, dtype=torch.int32)
    s_o, n_o = sn_square.fused_sn_square_plain(mo, clamp_t(to))
    for mode, kw in MODES:
        for symmetric in (True, False):
            (_, s, n), ran = launched(lambda: sn_square.fused_aji(
                mo, to, packed=True, symmetric=symmetric, **kw))
            check(f"sn_square main P={P} G={G} K={K - 1} packed "
                  f"{'triu' if symmetric else 'full'}", s, n, s_o, n_o, mode)
            if ran != {**dict.fromkeys(ran, 0), "sn_square_wgmma": 1} or not (
                    torch.equal(s, s.T) and torch.equal(n, n.T)):
                fail(f"odd K packed: launches {ran}, or S / N not symmetric")
    del mo, to, s_o, n_o, s, n

    # times at the bench shape
    sq = sn_square.fused_sn_square
    mp = sn_square.pack_nibbles(m)
    nt = G // sn_square.WGMMA_TILE
    plan_of = sn_square.fused_aji_plan
    wgmma_macs = plan_of(P, G, K)["mxu_macs"]
    full_macs = plan_of(P, G, K, symmetric=False)["mxu_macs"]
    diag_macs = wgmma_macs // (nt * (nt + 1) // 2) * (nt // 2 + 1) * nt
    routes = [
        ("packed", lambda: sq(mp, tc, packed=True),
         plan_of(P, G, K, packed=True)["mxu_macs"], True),
        ("packed full", lambda: sq(mp, tc, packed=True, symmetric=False),
         plan_of(P, G, K, packed=True, symmetric=False)["mxu_macs"], False),
        ("diag", lambda: sn_square.sn_sym_diag(m, tc), diag_macs, True),
        ("bands", lambda: sn_square.sn_sym_bands(m, tc), wgmma_macs, True),
        ("bands_2p", lambda: sn_square.sn_sym_bands_2p(m, tc), wgmma_macs,
         True),
    ]
    times = time_all(label, (P, G, K), [
        ("wgmma triu, 2 proteins/step (fused_aji default)",
         lambda: sq(m, tc, pairs_per_step=2), wgmma_macs, True),
        # the same launch: the wgmma kernel's protein loop has no steps
        ("wgmma triu, 1 protein/step", lambda: sq(m, tc), wgmma_macs, True),
        ("wgmma full square", lambda: sq(m, tc, symmetric=False), full_macs,
         False),
        *routes,
        *((variant, lambda v=variant: sq(m, tc, pairs_per_step=2, update=v),
           plan_of(P, G, K, variant=variant)["mxu_macs"], True)
          for variant in VARIANTS),
        ("plain", lambda: sn_square.fused_sn_square_plain(m, tc),
         P * G * G * K, True),
        ("packed plain", lambda: sn_square.fused_sn_square_plain(
            mp, tc, packed=True), P * G * G * K, True),
        *((f"{variant} plain", lambda v=variant:
           sn_square.fused_sn_square_plain(m, tc, update=v), P * G * G * K,
           True)
          for variant in VARIANTS),
        ("fused_aji default", lambda: sn_square.fused_aji(m, t_raw),
         wgmma_macs, True),
    ])
    # one call of each moved route, counters set to 0 just before it
    route_launches = {name: launched(run)[1]["sn_square_wgmma"]
                      for name, run, _, _ in routes}
    del m, mp, t_raw, tc, s_ref, n_ref
    torch.cuda.empty_cache()

    # K sweep at the bench shape's P and G: lean in every divide mode, the
    # other bodies and packed rows under Newton
    sweep = {}
    for Ks in K_SWEEP:
        m, _, tc = random_square(gen, dev, P, G, Ks, SQUARE_DENSITY)
        sweep[Ks] = {mode: cuda_ms(lambda: sq(m, tc, **kw), 5)
                     for mode, kw in MODES}
        for v in WGMMA_VARIANTS:
            sweep[Ks][v] = cuda_ms(
                lambda: sq(m, tc, pairs_per_step=2, update=v), 5)
        mp = sn_square.pack_nibbles(m)
        sweep[Ks]["packed"] = cuda_ms(lambda: sq(mp, tc, packed=True), 5)
        del m, mp, tc
        torch.cuda.empty_cache()
    for key in (*(mode for mode, _ in MODES), *WGMMA_VARIANTS, "packed"):
        what = f"lean {key}" if key in dict(MODES) else f"{key} newton"
        print_sweep(f"sn_square_wgmma K sweep P={P} G={G} triu {what}",
                    [sweep[Ks][key] for Ks in K_SWEEP])

    for label, P, G, K in SQUARE_SMALL:
        m, t_raw, tc = random_square(gen, dev, P, G, K, 0.33)
        s_ref, n_ref = sn_square.fused_sn_square_plain(m, tc)
        square_checks(f"{label} P={P} G={G} K={K}", m, t_raw, tc, s_ref,
                      n_ref, [mode for mode, _ in MODES])
    for label, P, G, K in VARIANT_SMALL:
        m, t_raw, tc = random_square(gen, dev, P, G, K, 0.33)
        variant_checks(f"{label} P={P} G={G} K={K}", m, t_raw, tc)

    # the K-blocked plans (kb_sym, kb_full) at the kb bench's shape
    P, G, K = SQUARE_KB
    m, t_raw, tc = random_square(gen, dev, P, G, K, SQUARE_DENSITY)
    label = f"kb P={P} G={G} K={K}"
    s_ref, n_ref = sn_square.fused_sn_square_plain(m, tc)
    for symmetric in (True, False):
        plan = sn_square.fused_aji_plan(P, G, K, symmetric=symmetric)
        for mode in ("newton", "precise"):
            _, s, n = sn_square.fused_aji(m, t_raw, symmetric=symmetric,
                                          **dict(MODES)[mode])
            check(f"sn_square {label} fused_aji {plan['mode']}", s, n, s_ref,
                  n_ref, mode)
    times.update(time_all(label, (P, G, K), [
        ("kb_sym", lambda: sq(m, tc), plan_of(P, G, K)["mxu_macs"], True),
        ("kb_full", lambda: sq(m, tc, symmetric=False),
         plan_of(P, G, K, symmetric=False)["mxu_macs"], False),
        ("kb plain", lambda: sn_square.fused_sn_square_plain(m, tc),
         P * G * G * K, True),
    ]))
    del m, t_raw, tc, s_ref, n_ref, s, n
    torch.cuda.empty_cache()
    # one bound for the triu routes, each of which computes the symmetric
    # square; the full square's for the full walks
    b = square_bound(*SQUARE_MAIN)
    b_full = square_bound(*SQUARE_MAIN, symmetric=False)
    print(f"sn_square main: bound {b['bound_ms']:.3f} ms by {b['bound_by']} "
          f"of the symmetric square, {b_full['bound_ms']:.3f} ms of the full "
          f"one; the triu tiles execute {wgmma_macs:.4e} MACs")

    def entry(name, plain, err, bound_of=b, **extra):
        return {"max_abs_err": err, "ms": times[name],
                "plain_ms": times[plain], **bound_of, "library_ms": None,
                **extra}

    return {
        "max_abs_err": errs[("default", "newton")],
        "ms": times["wgmma triu, 2 proteins/step (fused_aji default)"],
        "plain_ms": times["plain"], **b,
        # the other updates beside the default plan (their bench runs'
        # launches); the library call of counts' function is one int8 GEMM
        "variants": {v: entry(v, f"{v} plain", variant_errs[v],
                              **(library if v == "counts" else {}))
                     for v in (*WGMMA_VARIANTS, "f32gram")},
        # the routes that ran on __dp4a and f16 kernels before: one call's
        # launches each (counters set to 0 just before it)
        "routes": {name: entry(name, "packed plain" if "packed" in name
                               else "plain", errs[(name, "newton")],
                               b_full if "full" in name else b,
                               launches=route_launches[name])
                   for name, _, _, _ in routes},
    }


def counts_library(m, tc) -> dict:
    """``counts``' function as one library call: with X the proteins' (G,
    K) slabs side by side, (G, P K) int8, S = f32(X X^T) by
    ``torch._int_mm``.  Every partial sum of the kernel is an integer
    below P K < 2^24, so its S must equal the call's bit for bit.  The
    kernel, the call and the relayout copy that builds X are each timed as
    the median of 5 calls.  Returns the call's and the copy's ms."""
    import torch

    from parfastaai_tpu_torch.ops import sn_square

    P, G, K = m.shape
    if P * K >= 1 << 24:
        fail(f"counts_library: P K = {P * K} is not below 2^24")
    m8 = m.view(torch.int8)
    relayout = lambda: m8.permute(1, 0, 2).reshape(G, P * K)  # noqa: E731
    x = relayout()
    if not x.is_contiguous():
        fail("counts_library: X is not one contiguous (G, P K) copy")
    gram = lambda: torch._int_mm(x, x.t())  # noqa: E731
    counts = lambda: sn_square.fused_sn_square(  # noqa: E731
        m, tc, pairs_per_step=2, update="counts")
    s, n = counts()
    if not (torch.equal(gram().to(torch.float32), s) and not n.any()):
        fail("counts: S differs from the f32 cast of torch._int_mm(X, X^T) "
             "or N is not 0")
    ms = {"kernel": median_ms(counts), "library": median_ms(gram),
          "relayout": median_ms(relayout)}
    print(f"counts P={P} G={G} K={K}: S bit-equal to the f32 cast of "
          f"torch._int_mm(X, X^T), X = (G, P K) int8; median of 5: kernel "
          f"{ms['kernel']:.3f} ms, torch._int_mm {ms['library']:.3f} ms, "
          f"relayout copy {ms['relayout']:.3f} ms")
    return {"library_ms": ms["library"], "relayout_ms": ms["relayout"],
            "median_ms": ms["kernel"]}


def time_all(label: str, shape, timed) -> dict:
    """CUDA-event ms of each (name, fn, executed MACs, symmetric)
    (``cuda_ms``: the median of TIMED_RUNS runs), printed with the int8
    MACs per second that the call executes and the bound of the function
    it computes (``square_bound`` at ``shape``)."""
    times = {}
    for name, fn, macs, symmetric in timed:
        times[name] = cuda_ms(fn, 3 if "plain" in name else 5)
        b = square_bound(*shape, symmetric)["bound_ms"]
        print(f"sn_square {label} {name}: {times[name]:.3f} ms "
              f"({macs / times[name] / 1e9:.3f} TMAC/s executed; bound "
              f"{b:.3f} ms, {b / times[name]:.1%} of its time)")
    return times


def bench_phase(dev) -> dict:
    """The bench module in kernel mode (the whole-matrix path, launch
    counters reset just before and read just after) and in kb mode; then a
    band of fused_aji on the bench's workload against exact f64."""
    import torch

    from parfastaai_tpu_torch import bench
    from parfastaai_tpu_torch.ops import sn_rect, sn_square

    def run(env: dict, name: str, what: str) -> dict:
        """One kernel-mode bench run with every launch counter set to 0
        just before it and read just after; fails unless it launched
        ``name`` and no other kernel."""
        reset_launches()
        t0 = time.perf_counter()
        result = bench.main(env)
        wall = time.perf_counter() - t0
        ran = read_launches()
        if ran[name] == 0 or any(v for k, v in ran.items() if k != name):
            fail(f"the kernel-mode bench{what} should launch {name} alone "
                 f"and launched {ran}")
        if f"impl=cuda {name}" not in result["metric"]:
            fail(f"the bench{what} names another kernel than {name}: "
                 f"{result['metric']}")
        if result["mfu"] is None or not 0 < result["mfu"] <= 1:
            fail(f"the bench{what} reads mfu {result['mfu']}")
        print(f"bench kernel mode{what}: {wall:.1f} s in process, {name} "
              f"launches {ran[name]}")
        return ran

    launches = run({}, "sn_square_wgmma", "")["sn_square_wgmma"]
    variant_launches = {}
    for variant in VARIANTS:
        ran = run({"PARFASTAAI_BENCH_VARIANT": variant}, "sn_square_wgmma",
                  f" variant={variant}")["sn_square_wgmma"]
        if ran != BENCH_CALLS:
            fail(f"the bench variant={variant} launched sn_square_wgmma "
                 f"{ran} times, not {BENCH_CALLS}")
        variant_launches[variant] = ran
    t0 = time.perf_counter()
    sn_rect.LAUNCHES = 0
    bench.main(BENCH_KB_ENV)
    print(f"bench kb mode: {time.perf_counter() - t0:.1f} s in process, "
          f"sn_rect launches {sn_rect.LAUNCHES}")

    m, t = bench.workload(SQUARE_MAIN[1])
    md, td = torch.from_numpy(m).to(dev), torch.from_numpy(t).to(dev)
    aji, s, n = sn_square.fused_aji(md, td)
    # packed presence: one library call on the same workload
    (_, s_p, n_p), ran = launched(
        lambda: sn_square.fused_aji(md, td, packed=True))
    torch.cuda.synchronize()
    if ran != {**dict.fromkeys(ran, 0), "sn_square_wgmma": 1}:
        fail(f"fused_aji(packed=True) should launch sn_square_wgmma once "
             f"and nothing else: {ran}")
    check("bench workload fused_aji packed vs the default plan", s_p, n_p, s,
          n, "newton")
    packed_launches = ran["sn_square_wgmma"]
    del md, td, s, s_p, n_p
    R = BAND_ROWS
    s64, n64 = exact_band(m, t, R)
    if not np.array_equal(n[:R].cpu().numpy(), n64):
        fail("bench workload: fused_aji N differs from exact counts")
    got = aji[:R].double().cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        want = s64 / n64
    if not np.allclose(got, want, rtol=RTOL_E2E_AJI, atol=0, equal_nan=True):
        fail("bench workload: fused_aji AJI outside rtol 1e-6 of exact f64")
    err = np.nanmax(np.abs(got - want) / np.abs(want))
    print(f"bench workload band: rows 0..{R - 1} x {m.shape[1]} columns, N "
          f"exact, AJI max rel err {err:.3e} (rtol {RTOL_E2E_AJI}) ok")
    return launches, variant_launches, packed_launches


def synth_db(n_genomes: int | None = None) -> str:
    """The E2E generator's database, at ``n_genomes`` genomes if given."""
    from parfastaai_tpu_torch.tools.synth_db import generate

    args = dict(E2E, n_genomes=n_genomes or E2E["n_genomes"])
    tag = "_".join(f"{k}{v}" for k, v in args.items())
    path = os.path.join(tempfile.gettempdir(), f"parfastaai_synth_{tag}_s{SEED}.db")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        tmp = f"{path}.tmp{os.getpid()}"
        generate(tmp, seed=SEED, **args)
        os.replace(tmp, path)
        print(f"synthetic DB of {args['n_genomes']} genomes generated in "
              f"{time.perf_counter() - t0:.1f} s")
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


def band_check(db: str, csv_path: str, dev) -> np.ndarray:
    """Rows 0..BAND_ROWS-1 of the run against exact f64 on the host.
    Returns that exact (BAND_ROWS, G) f64 AJI with the diagonal at 0, as
    the CSV holds it."""
    from parfastaai_tpu_torch import engine
    from parfastaai_tpu_torch.etl.database import SCPDatabase

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
    return want


def cli_phases(text: str) -> dict:
    """The milliseconds of every ``label: x ms`` line the CLI printed."""
    return {
        m.group(1).strip(): float(m.group(2))
        for m in re.finditer(r"^\s*(.+?)\s*: ([0-9.]+) ms", text, re.M)
    }


def reset_launches() -> None:
    from parfastaai_tpu_torch.ops import finish, sn_rect, sn_square

    sn_square.WGMMA_LAUNCHES = sn_rect.LAUNCHES = finish.LAUNCHES = 0


def read_launches() -> dict:
    from parfastaai_tpu_torch.ops import finish, sn_rect, sn_square

    return {"sn_square_wgmma": sn_square.WGMMA_LAUNCHES,
            "sn_rect": sn_rect.LAUNCHES, "finish_f64": finish.LAUNCHES}


def launched(fn) -> tuple:
    """(fn's result, {kernel: launches}) with every launch counter set to
    0 just before the call and read just after."""
    reset_launches()
    out = fn()
    return out, read_launches()


def dense_cli_leg(out_dir: str, db: str) -> tuple[str, str, float, int]:
    """The CLI's default call on ``db``, small enough for the dense exact
    engine, with every launch counter set to 0 just before it and read just
    after: (CSV path, what it printed, wall s, finish_f64 launches).  Fails
    unless it launched finish_f64 once and no other kernel."""
    reset_launches()
    out, text, _, wall = cli_call(out_dir, db, "dense")
    ran = read_launches()
    if ran != {**dict.fromkeys(ran, 0), "finish_f64": 1}:
        fail(f"the dense default call launched {ran}, reckoned finish_f64 "
             "once alone")
    return out, text, wall, ran["finish_f64"]


def cli_call(out_dir: str, db: str, name: str, flags=(), env=None):
    """One CLI run on the card under ``env``: (CSV path, what it printed,
    what it wrote to stderr, wall s).  Fails unless it exits 0."""
    from parfastaai_tpu_torch import cli

    out = os.path.join(out_dir, f"{name}.csv")
    lines: list[str] = []
    errs: list[str] = []
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        t0 = time.perf_counter()
        with captured_stdout(lines), captured_stdout(errs, fd=2):
            rc = cli.run([db, out, "--device", "cuda", *flags])
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    if rc != 0:
        print("\n".join(lines + errs))
        fail(f"CLI {' '.join(flags) or '(default)'} {env or ''} exited {rc}")
    return out, "\n".join(lines), "\n".join(errs), wall


def read_bytes(path: str) -> bytes:
    with open(path, "rb") as fp:
        return fp.read()


def device_busy_ms(trace_path: str) -> tuple[float, int, int]:
    """(device-busy ms, device events, all events) of a Chrome trace of
    ``--profile``: the union of the intervals of its kernel, memcpy and
    memset events."""
    with open(trace_path) as fp:
        events = json.load(fp)["traceEvents"]
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
        for e in events
        if e.get("ph") == "X"
        and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
    )
    busy, end = 0.0, float("-inf")
    for t0, t1 in spans:
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e3, len(spans), len(events)


def streamed_phase(dev, want_band: np.ndarray, keep_dir: str) -> int:
    """The f32 streamed engine on the card through the CLI: the full-width
    call, whose first rows are held against ``want_band`` (exact f64), then
    the byte comparisons, the plain version, --profile and the library API
    at EXACT_SMALL_G genomes.  Moves the full-width CSV into ``keep_dir``
    as streamed.csv.  Returns the full-width call's sn_rect launches."""
    import torch

    from parfastaai_tpu_torch import api, engine
    from parfastaai_tpu_torch.cli import PROFILE_TRACE
    from parfastaai_tpu_torch.etl.database import SCPDatabase, bucket_bounds
    from parfastaai_tpu_torch.io.csv_writer import format_matrix
    from parfastaai_tpu_torch.ops import sn_rect

    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_streamed_")

    def launches_of(db, name, flags, env=None, *, want=None):
        """A CLI run with every launch counter set to 0 just before it and
        read just after: only sn_rect may move, ``want`` times if given."""
        reset_launches()
        out, text, err, wall = cli_call(out_dir, db, name, flags, env)
        ran = read_launches()
        n = ran.pop("sn_rect")
        if n == 0 or any(ran.values()) or (want is not None and n != want):
            fail(f"--streamed {' '.join(flags)} {env or ''}: sn_rect launched "
                 f"{n} times (reckoned {want}), other kernels {ran}")
        return out, text, err, wall, n

    def profiled(db, name, flags):
        """A --profile run: (CSV path, device-busy ms, phase ms)."""
        trace_dir = os.path.join(out_dir, f"{name}_trace")
        out, text, _, _ = cli_call(out_dir, db, name,
                                   [*flags, "--profile", trace_dir])
        trace = os.path.join(trace_dir, PROFILE_TRACE)
        if os.listdir(trace_dir) != [PROFILE_TRACE]:
            fail(f"--profile wrote {os.listdir(trace_dir)} into its directory")
        busy, n_dev, n_all = device_busy_ms(trace)
        if n_dev == 0:
            fail(f"--profile {name}: the trace holds no device event")
        phase = cli_phases(text)["Streamed AJI + CSV"]
        print(f"--streamed --profile {name}: trace of "
              f"{os.path.getsize(trace)} bytes, {n_all} events, {n_dev} on "
              f"the device; device busy {busy:.3f} ms of the phase's "
              f"{phase:.1f} ms under the profiler "
              f"({busy / phase:.2%} busy, {1 - busy / phase:.2%} idle)")
        return out, busy, phase

    try:
        # the full width
        db = synth_db()
        G, R = E2E["n_genomes"], BAND_ROWS
        out, text, _, wall, launches = launches_of(db, "full", ["--streamed"])
        print(text)
        if f"Wrote {G} x {G} AJI matrix to {out} (streamed) on cuda" not in text:
            fail("--streamed did not end with the streamed engine's line")
        with open(out) as fp:
            names = fp.readline().rstrip("\n").split(",")[1:]
            rows = [fp.readline().rstrip("\n").split(",") for _ in range(R)]
            n_lines = 1 + R + sum(1 for _ in fp)
        if len(names) != G or n_lines != G + 1 or any(
                len(r) != G + 1 for r in rows):
            fail(f"--streamed CSV shape: {n_lines} lines, {len(names)} columns")
        if [r[0] for r in rows] != names[:R]:
            fail("--streamed CSV: row names differ from the header's")
        if any(rows[i][1 + i] != "0" for i in range(R)):
            fail("--streamed CSV: a diagonal cell is not the text 0")
        got = np.array([[float(v) for v in r[1:]] for r in rows])
        if not np.all(np.isfinite(got)) or not np.allclose(
                got, want_band, rtol=RTOL_E2E_AJI, atol=0):
            fail("--streamed CSV: AJI outside rtol 1e-6 of exact f64")
        err = np.abs(got - want_band) / np.where(
            want_band == 0, 1.0, np.abs(want_band))
        phases = cli_phases(text)
        pairs = G * (G - 1) // 2
        print(
            f"e2e --streamed G={G}: wall {wall:.3f} s, sn_rect launches "
            f"{launches}, rows 0..{R - 1} within {err.max():.3e} of exact "
            f"f64 (rtol {RTOL_E2E_AJI}), "
            f"{pairs / (phases['Streamed AJI + CSV'] / 1e3):.4e} genome "
            f"pairs/s over Streamed AJI + CSV, {pairs / wall:.4e} over the "
            "wall; split ms (stages overlap): "
            + ", ".join(
                f"{k} {phases.get(k, 0.0):.1f}"
                for k in ("Presence ETL", "Streamed AJI + CSV",
                          "host bucketize", "H2D", "gather", "kernel",
                          "AJI mask", "D2H", "host assembly", "CSV write",
                          "producer wait", "writer wait")
            )
        )
        full_profiled, _, _ = profiled(db, "full_profiled", ["--streamed"])
        if read_bytes(full_profiled) != read_bytes(out):
            fail(f"G={G}: --profile changed the CSV's bytes")
        os.replace(out, os.path.join(keep_dir, "streamed.csv"))

        # the mirror, resume, --profile and the API, for bytes
        small = synth_db(EXACT_SMALL_G)
        db_ = SCPDatabase(small)
        try:
            presence = db_.load_presence()
        finally:
            db_.close()
        n_buckets = len(bucket_bounds(presence.widths)[1])
        B, Gs = STREAMED_BLOCK, EXACT_SMALL_G
        nb = -(-Gs // B)
        blocks = ["--band", str(B), "--col-chunk", str(B)]
        flags = ["--streamed", "--precise", *blocks]
        mirrored, _, err_on, wall_on, n_on = launches_of(
            small, "mirrored", flags, want=nb * (nb + 1) // 2 * n_buckets)
        full, _, err_off, wall_off, n_off = launches_of(
            small, "square", flags, {"PARFASTAAI_MIRROR_BYTES": "1"},
            want=nb * nb * n_buckets)
        one, _, _, wall_one, n_one = launches_of(
            small, "one_block",
            ["--streamed", "--precise", "--band", "1024", "--col-chunk", "4096"],
            want=n_buckets)
        if "mirror disabled" in err_on or not re.search(
                r"NOTE: symmetric mirror disabled \(assembled-band store \d+ B "
                r"exceeds PARFASTAAI_MIRROR_BYTES=1\)", err_off):
            fail("the mirror's NOTE on stderr: with the mirror "
                 f"{err_on!r}, without it {err_off!r}")
        want = read_bytes(mirrored)
        if want.count(b"\n") != Gs + 1:
            fail(f"G={Gs}: the --streamed CSV has {want.count(b'\n')} lines")
        # header, one band, half of the second and a torn line
        lines = want.split(b"\n")
        cut = 1 + B + B // 2
        resumed = os.path.join(out_dir, "resumed.csv")
        with open(resumed, "wb") as fp:
            fp.write(b"\n".join(lines[:cut]) + b"\n" + lines[cut][:37])
        _, _, err_res, wall_res, n_res = launches_of(
            small, "resumed", [*flags, "--resume"],
            want=(nb - 1) * nb * n_buckets)
        if "--resume keeps earlier bands" not in err_res:
            fail(f"--resume on a symmetric run did not say why the mirror is "
                 f"off: {err_res!r}")
        prof, _, _ = profiled(small, "profiled", flags)
        lib = os.path.join(out_dir, "api.csv")
        api.aji_to_csv(lib, small, engine="streamed", precise=True, band=B,
                       col_chunk=B, device="cuda")
        for name, path in (("without the mirror", full), ("in one block", one),
                           ("resumed", resumed), ("under --profile", prof),
                           ("through api.aji_to_csv", lib)):
            if read_bytes(path) != want:
                fail(f"G={Gs}: the --streamed --precise CSV {name} differs "
                     "from the symmetric walk's")

        # against the plain version on the card
        Rp = STREAMED_PLAIN_ROWS
        s = n = None
        for _, md, td in engine.to_device_buckets(presence, dev):
            s_b, n_b = sn_rect.fused_sn_block_plain(
                md[:, :Rp].contiguous(), md, td[:, :Rp].contiguous(), td)
            s = s_b if s is None else s + s_b
            n = n_b if n is None else n + n_b
        plain = engine._mask_aji(s, n).cpu().numpy()
        plain[np.arange(Rp), np.arange(Rp)] = 0.0
        names = lines[0].decode().split(",")[1:]
        want_rows = [f"{names[i]},{row}" for i, row in enumerate(
            format_matrix(plain.astype(np.float64), ","))]
        got_rows = [ln.decode() for ln in lines[1 : 1 + Rp]]
        differ = [i for i in range(Rp) if got_rows[i] != want_rows[i]]
        if differ:
            i = differ[0]
            cells = [(j, a, b) for j, (a, b) in enumerate(
                zip(got_rows[i].split(","), want_rows[i].split(","))) if a != b]
            fail(f"--streamed --precise: {len(differ)} of the first {Rp} rows "
                 f"differ as text from the plain version on the card; row {i}: "
                 f"{len(cells)} cells, first (column, CSV, plain) {cells[:3]}")
        print(
            f"streamed G={Gs} --precise: {B} x {B} blocks on the symmetric "
            f"walk ({n_on} launches), the full square ({n_off}), one block "
            f"({n_one}), a --resume from a file cut inside its second band "
            f"({n_res}), --profile and api.aji_to_csv write the same "
            f"{len(want)} bytes over {n_buckets} width bucket(s) (walls "
            f"{wall_on:.3f}, {wall_off:.3f}, {wall_one:.3f}, {wall_res:.3f} "
            f"s); rows 0..{Rp - 1} equal the plain version's on the card as "
            "text"
        )
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches


def exact_phase(want_band: np.ndarray, keep_dir: str) -> int:
    """The exact path on the card: byte comparisons of its routes at
    EXACT_SMALL_G genomes, then the CLI's default call at the E2E size,
    whose first rows must equal ``want_band`` as text, and whose CSV moves
    into ``keep_dir`` as default.csv.  Returns the dense call's finish_f64
    launches."""
    from parfastaai_tpu_torch.io.csv_writer import format_matrix

    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_exact_")

    def call(db: str, name: str, flags=(), env=None) -> tuple[str, str, float]:
        out, text, _, wall = cli_call(out_dir, db, name, flags, env)
        return out, text, wall

    read = read_bytes
    try:
        small = synth_db(EXACT_SMALL_G)
        banded_flags = ["--streamed", "--exact"]
        dense, dense_text, dense_wall, dense_launches = dense_cli_leg(
            out_dir, small)
        banded, banded_text, banded_wall = call(small, "banded", banded_flags)
        full, _, full_wall = call(small, "full", banded_flags,
                                  {"PARFASTAAI_MIRROR_BYTES": "1"})
        if "banded exact" in dense_text or "(banded exact)" not in banded_text:
            fail(f"G={EXACT_SMALL_G}: the dense call or --streamed --exact "
                 "took the other's route")
        want = read(dense)
        if want.count(b"\n") != EXACT_SMALL_G + 1:
            fail(f"G={EXACT_SMALL_G}: the dense CSV has "
                 f"{want.count(b'\n')} lines")
        for name, path in (("--streamed --exact", banded),
                           ("--streamed --exact without the mirror", full)):
            if read(path) != want:
                fail(f"G={EXACT_SMALL_G}: the CSV of {name} differs from the "
                     "dense default call's")
        # header, one band of 512 rows, 100 rows of the next and a torn line
        lines = want.split(b"\n")
        with open(banded, "wb") as fp:
            fp.write(b"\n".join(lines[: 1 + 512 + 100]) + b"\n" + lines[700][:37])
        _, _, resume_wall = call(small, "banded", [*banded_flags, "--resume"])
        if read(banded) != want:
            fail(f"G={EXACT_SMALL_G}: --resume did not restore the CSV")
        print(
            f"exact path G={EXACT_SMALL_G}: dense, --streamed --exact, the "
            "same without the mirror and a --resume from a file cut inside "
            f"a band write the same {len(want)} bytes (walls {dense_wall:.3f}, "
            f"{banded_wall:.3f}, {full_wall:.3f}, {resume_wall:.3f} s)"
        )

        db = synth_db()
        reset_launches()
        out, text, wall = call(db, "default")
        ran = read_launches()
        print(text)
        if "routing through the banded exact engine" not in text:
            fail("the default call did not route to the banded exact engine")
        if any(ran.values()):
            fail(f"the default call launched hand-written kernels: {ran}")
        G, R = E2E["n_genomes"], BAND_ROWS
        with open(out) as fp:
            names = fp.readline().rstrip("\n").split(",")[1:]
            got = [fp.readline().rstrip("\n") for _ in range(R)]
            n_lines = 1 + R + sum(1 for _ in fp)
        if len(names) != G or n_lines != G + 1:
            fail(f"default CSV shape: {n_lines} lines, {len(names)} columns")
        rows = format_matrix(want_band, ",")
        differ = [i for i in range(R) if got[i] != f"{names[i]},{rows[i]}"]
        if differ:
            fail(f"default call: rows {differ[:5]} of the CSV differ from the "
                 "host's exact f64")
        os.replace(out, os.path.join(keep_dir, "default.csv"))
        phases = cli_phases(text)
        pairs = G * (G - 1) // 2
        print(
            f"e2e default G={G}: wall {wall:.3f} s, routed to the banded "
            f"exact engine, kernel launches {sum(ran.values())}, rows "
            f"0..{R - 1} byte-equal to exact f64, "
            f"{pairs / (phases['Banded exact + CSV'] / 1e3):.4e} genome "
            f"pairs/s over Banded exact + CSV, {pairs / wall:.4e} over the "
            "wall; split ms (stages overlap): "
            + ", ".join(
                f"{k} {phases.get(k, 0.0):.1f}"
                for k in ("Presence ETL", "Banded exact + CSV",
                          "host bucketize", "H2D", "Gram", "D2H",
                          "host finish", "CSV write", "producer wait",
                          "worker wait")
            )
        )
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return dense_launches


def e2e_phase(dev, keep_dir: str) -> dict:
    """The --fast CLI call at the E2E size, its first rows against exact
    f64; its CSV moves into ``keep_dir`` as fast.csv."""
    from parfastaai_tpu_torch import cli
    from parfastaai_tpu_torch.ops import sn_rect

    db = synth_db()
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
        phases = cli_phases(text)
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
        band = band_check(db, out, dev)
        os.replace(out, os.path.join(keep_dir, "fast.csv"))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": launches, "band": band}


# One rank of a multi-process CLI run: the CLI's own entry, then this
# process's launch counters (they start at 0 with the process).
MESH_RANK = (
    "import sys\n"
    "from parfastaai_tpu_torch import cli\n"
    "from parfastaai_tpu_torch.ops import sn_rect, sn_square\n"
    "rc = cli.run(sys.argv[1:])\n"
    "print(f'LAUNCHES sn_rect={sn_rect.LAUNCHES} '\n"
    "      f'sn_square_wgmma={sn_square.WGMMA_LAUNCHES}', flush=True)\n"
    "sys.exit(rc)\n"
)
MESH_RANK_TIMEOUT = 300
LAUNCH_VARS = ("PARFASTAAI_COORDINATOR", "MASTER_ADDR", "RANK", "WORLD_SIZE",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(what: str, argv: list, n: int, env: dict | None = None):
    """``argv`` (rank i's output paths through ``{rank}``) in ``n``
    processes of one group (PARFASTAAI_COORDINATOR on a free local port):
    [(stdout, stderr)] in rank order, and the wall from launch to the last
    exit.  Fails on a non-zero exit or a rank that outlives
    MESH_RANK_TIMEOUT (every rank is then killed)."""
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [a.replace("{rank}", str(i)) for a in argv],
            env={**base, **(env or {}), "PYTHONPATH": root,
                 "PARFASTAAI_COORDINATOR": f"127.0.0.1:{port}",
                 "PARFASTAAI_NUM_PROCESSES": str(n),
                 "PARFASTAAI_PROCESS_ID": str(i)},
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(n)
    ]
    done = []
    try:
        for p in procs:
            done.append(p.communicate(timeout=MESH_RANK_TIMEOUT))
    except subprocess.TimeoutExpired:
        fail(f"{what}: a rank ran past {MESH_RANK_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    for i, (p, (out, err)) in enumerate(zip(procs, done)):
        if p.returncode != 0:
            print(out, err)
            fail(f"{what}: rank {i} exited {p.returncode}")
    return done, wall


def mesh_ranks(db: str, out_dir: str, name: str, flags: list, n: int,
               env: dict | None = None):
    """The CLI with ``flags --device cuda`` in ``n`` processes, each with
    an output path of its own: [(CSV path, stdout, {kernel: launches},
    stderr)] in rank order, and the wall from launch to the last exit."""
    out = os.path.join(out_dir, f"{name}_rank{{rank}}.csv")
    done, wall = launch_ranks(
        " ".join(flags),
        [sys.executable, "-c", MESH_RANK, db, out, *flags, "--device",
         "cuda"], n, env)
    ranks = []
    for i, (text, err) in enumerate(done):
        counts = re.search(r"LAUNCHES sn_rect=(\d+) sn_square_wgmma=(\d+)",
                           text)
        if counts is None:
            fail(f"{' '.join(flags)}: rank {i} reported no launch counts")
        ranks.append((out.replace("{rank}", str(i)), text,
                      {"sn_rect": int(counts.group(1)),
                       "sn_square_wgmma": int(counts.group(2))}, err))
    return ranks, wall


def rows_against(csv_path: str, want_band: np.ndarray) -> float:
    """The largest relative error of the CSV's first BAND_ROWS rows against
    ``want_band`` (exact f64); fails outside RTOL_E2E_AJI."""
    with open(csv_path) as fp:
        fp.readline()
        got = np.array([[float(v) for v in fp.readline().split(",")[1:]]
                        for _ in range(BAND_ROWS)])
    if got.shape != want_band.shape or not np.all(np.isfinite(got)):
        fail(f"{csv_path}: first rows of shape {got.shape}, or not finite")
    err = np.abs(got - want_band) / np.where(want_band == 0, 1.0,
                                             np.abs(want_band))
    if err.max() > RTOL_E2E_AJI:
        fail(f"{csv_path}: AJI {err.max():.3e} from exact f64 (rtol "
             f"{RTOL_E2E_AJI})")
    return float(err.max())


MESH_SPLIT = ("Presence ETL", "Presence broadcast", "JAC + AJI", "H2D",
              "kernel", "scp all-reduce", "row gather", "CSV write")


def mesh_phase(dev, want_band: np.ndarray, keep_dir: str) -> dict:
    """The multi-GPU engine (``--mesh``, ``engine.compute_sharded``) on the
    card at the E2E size.  Leg (a): ``--mesh 1,1`` in this process, one
    sn_rect launch (the whole square) and no other kernel, its first rows
    against exact f64 (``band_check``) and its agreement with the --fast
    CSV.  Leg (b): ``--mesh 2,1`` and ``--mesh 1,2`` in two processes each
    (NCCL with two cards or more, else gloo with both ranks on cuda:0),
    and with four cards or more ``4,1`` and ``2,2`` in four: one sn_rect
    launch a rank, only rank 0 writes, a row split's bytes equal 1,1's (a
    row split moves cells between ranks, not their arithmetic), a protein
    split's first rows within RTOL_E2E_AJI of exact f64.  Then the bench's
    mesh mode, in this process ((1, 1) and the direct leg) and, with two
    cards or more, in one process per card.  Returns launches, walls and
    the bench's lines."""
    import torch

    from parfastaai_tpu_torch import bench

    n_gpu = torch.cuda.device_count()
    backend = "nccl" if n_gpu >= 2 else "gloo"
    print(f"mesh: {n_gpu} GPU(s) (torch.cuda.device_count()); multi-process "
          f"backend {backend}"
          + ("" if backend == "nccl" else ", every rank on cuda:0"))
    db = synth_db()
    G = E2E["n_genomes"]
    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_mesh_")
    report = {"gpus": n_gpu, "backend": backend}
    legs = [("2,1", 2), ("1,2", 2)]
    if n_gpu >= 4:
        legs += [("4,1", 4), ("2,2", 4)]
    try:
        reset_launches()
        one, text, _, wall = cli_call(out_dir, db, "mesh1x1", ["--mesh", "1,1"])
        ran = read_launches()
        print(text)
        if ran != {"sn_square_wgmma": 0, "sn_rect": 1, "finish_f64": 0}:
            fail(f"--mesh 1,1 launched {ran}, reckoned sn_rect once alone")
        band_check(db, one, dev)
        agree = csv_agreement(one, os.path.join(keep_dir, "fast.csv"), False)
        phases = cli_phases(text)
        print(f"mesh 1,1 G={G}: wall {wall:.3f} s, sn_rect launches 1; "
              f"against --fast: {agree}; split ms: "
              + ", ".join(f"{k} {phases.get(k, 0.0):.1f}" for k in MESH_SPLIT))
        report["1,1"] = {"launches": [1], "wall_s": wall,
                         "jac_ms": phases["JAC + AJI"]}
        for spec, n in legs:
            ranks, wall = mesh_ranks(db, out_dir, f"mesh{spec.replace(',', 'x')}",
                                     ["--mesh", spec], n)
            primary_text = ranks[0][1]
            print(primary_text)
            if f"backend {backend}, rank 0 on cuda:0" not in primary_text:
                fail(f"--mesh {spec}: not the {backend} backend with rank 0 "
                     "on cuda:0")
            launches = [r[2]["sn_rect"] for r in ranks]
            if launches != [1] * n or any(r[2]["sn_square_wgmma"]
                                          for r in ranks):
                fail(f"--mesh {spec}: launches {[r[2] for r in ranks]}, "
                     "reckoned sn_rect once a rank alone")
            if any(os.path.exists(r[0]) for r in ranks[1:]):
                fail(f"--mesh {spec}: a rank other than 0 wrote a CSV")
            if spec.endswith(",1"):
                if read_bytes(ranks[0][0]) != read_bytes(one):
                    fail(f"--mesh {spec} on {n} processes: not the bytes of "
                         "--mesh 1,1")
                held = "byte-identical to --mesh 1,1"
            else:
                held = (f"rows 0..{BAND_ROWS - 1} within "
                        f"{rows_against(ranks[0][0], want_band):.3e} of exact "
                        f"f64 (rtol {RTOL_E2E_AJI})")
            os.remove(ranks[0][0])
            phases = cli_phases(primary_text)
            print(f"mesh {spec} G={G} on {n} processes ({backend}): wall "
                  f"{wall:.3f} s (from launch to the last exit), sn_rect "
                  f"launches per rank {launches}, only rank 0 wrote, {held}; "
                  "rank 0 split ms: "
                  + ", ".join(f"{k} {phases.get(k, 0.0):.1f}"
                              for k in MESH_SPLIT))
            report[spec] = {"launches": launches, "wall_s": wall,
                            "jac_ms": phases["JAC + AJI"],
                            "broadcast_ms": phases["Presence broadcast"]}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    # the bench's mesh mode in this process: the (1, 1) mesh step against
    # the direct leg, BENCH_CALLS launches each
    reset_launches()
    report["bench"] = [bench.main({"PARFASTAAI_BENCH_MODE": "mesh"})]
    ran = read_launches()
    if ran != {"sn_square_wgmma": 0, "sn_rect": 2 * BENCH_CALLS,
               "finish_f64": 0}:
        fail(f"the bench's mesh mode launched {ran}, reckoned sn_rect "
             f"{2 * BENCH_CALLS} times alone")
    report["bench_mesh_launches"] = ran["sn_rect"]
    if n_gpu >= 2:
        done, wall = launch_ranks(
            "the bench's mesh mode", [sys.executable, "-m",
                                      "parfastaai_tpu_torch.bench"],
            n_gpu, {"PARFASTAAI_BENCH_MODE": "mesh"})
        outs = [out for out, _ in done]
        print(outs[0].strip())
        print(f"bench mesh mode on {n_gpu} processes: {wall:.1f} s")
        report["bench"].append(json.loads(outs[0].strip().splitlines()[-1]))
    return report


def csv_agreement(got_path: str, want_path: str, exact: bool) -> str:
    """Holds the CSV at ``got_path`` against the one at ``want_path``:
    the same bytes where ``exact``; else the same bytes, or the f32
    engines' tolerance (the same header and row names, the text ``0`` in
    the same cells, values within RTOL_E2E_AJI).  Returns what held."""
    got, want = read_bytes(got_path), read_bytes(want_path)
    if got == want:
        return f"byte-identical ({len(got)} bytes)"
    if exact:
        fail(f"{got_path}: not the bytes of {want_path}")
    g_lines, w_lines = got.split(b"\n"), want.split(b"\n")
    if g_lines[0] != w_lines[0] or len(g_lines) != len(w_lines):
        fail(f"{got_path}: header or line count differs from {want_path}")
    rows = worst = 0
    for g, w in zip(g_lines[1:-1], w_lines[1:-1]):
        if g == w:
            continue
        rows += 1
        g_name, g_vals = g.split(b",", 1)
        w_name, w_vals = w.split(b",", 1)
        gt, wt = (np.array(x.split(b",")) for x in (g_vals, w_vals))
        if g_name != w_name or gt.shape != wt.shape or not np.array_equal(
                gt == b"0", wt == b"0"):
            fail(f"{got_path}: row {g_name!r} differs from {want_path} in "
                 "its name, width or zero cells")
        gf, wf = gt.astype(np.float64), wt.astype(np.float64)
        err = np.abs(gf - wf) / np.where(wf == 0, 1.0, np.abs(wf))
        worst = max(worst, float(err.max()))
    if worst > RTOL_E2E_AJI:
        fail(f"{got_path}: AJI {worst:.3e} from {want_path} (rtol "
             f"{RTOL_E2E_AJI})")
    return (f"{rows} of {len(g_lines) - 2} rows differ in bytes, max rel "
            f"err {worst:.3e} (rtol {RTOL_E2E_AJI}), zero cells equal")


SLAB_LINE = re.compile(
    r"staged slabs\s*: (\d+) uploads, (\d+) hits, uploaded (\d+) B "
    r"\(([0-9.]+) x the bucketed presence\), peak held (\d+) B of a "
    r"(\d+) B cap")


def staged_cli_leg(keep_dir: str) -> int:
    """Leg A: three CLI calls on the E2E database under a device budget of
    a third of its bucketed presence (PARFASTAAI_HBM_BYTES) and slabs of a
    sixth of that budget (PARFASTAAI_SLAB_BYTES), each CSV held against
    the resident call's in ``keep_dir``.  Returns the sn_rect launches of
    the --streamed call."""
    import torch

    from parfastaai_tpu_torch import engine
    from parfastaai_tpu_torch.etl.database import SCPDatabase, bucket_bounds

    db = synth_db()
    db_ = SCPDatabase(db)
    try:
        presence = db_.load_presence()
    finally:
        db_.close()
    pres_bytes = engine.presence_device_bytes(presence)
    budget = pres_bytes // STAGED_BUDGET_SHARE
    slab_bytes = budget // STAGED_SLAB_SHARE
    env = {"PARFASTAAI_HBM_BYTES": str(budget),
           "PARFASTAAI_SLAB_BYTES": str(slab_bytes)}
    n_buckets = len(bucket_bounds(presence.widths)[1])
    del presence
    print(f"staged leg A: bucketed presence {pres_bytes} B in {n_buckets} "
          f"bucket(s), PARFASTAAI_HBM_BYTES={budget}, "
          f"PARFASTAAI_SLAB_BYTES={slab_bytes}")
    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_staged_")
    launches = {}
    try:
        for name, flags, want, phase, hand_kernels in (
            ("fast", ["--fast", "--staged"], "fast.csv", "JAC + AJI", True),
            ("streamed", ["--streamed"], "streamed.csv",
             "Streamed AJI + CSV", True),
            ("default", [], "default.csv", "Banded exact + CSV", False),
        ):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            reset_launches()
            out, text, _, wall = cli_call(out_dir, db, f"staged_{name}", flags,
                                          env)
            ran = read_launches()
            peak_alloc = torch.cuda.max_memory_allocated()
            slab = SLAB_LINE.search(text)
            if slab is None:
                print(text)
                fail(f"staged {name}: the CLI printed no staged slabs line")
            n_up, hits, up, ratio, peak, cap = slab.groups()
            if int(cap) != int(budget * 0.75) or int(up) <= 0:
                fail(f"staged {name}: cap {cap} B, uploaded {up} B")
            if int(peak) > int(cap) + slab_bytes:
                fail(f"staged {name}: the store held {peak} B, over its cap "
                     f"plus one slab")
            if hand_kernels != (ran["sn_rect"] > 0) or ran["sn_square_wgmma"]:
                fail(f"staged {name}: launches {ran}")
            if name == "default" and "routing through the banded" not in text:
                fail("staged default call: not routed to the banded engine")
            agree = csv_agreement(out, os.path.join(keep_dir, want),
                                  exact=name == "default")
            if name == "streamed":
                # the staged mesh leg's one-process twin (same slabs)
                os.replace(out, os.path.join(keep_dir, "staged_streamed.csv"))
            else:
                os.remove(out)
            launches[name] = ran["sn_rect"]
            phases = cli_phases(text)
            print(
                f"staged leg A {' '.join(flags) or '(default)'} G="
                f"{E2E['n_genomes']}: wall {wall:.3f} s, {phase} "
                f"{phases[phase]:.1f} ms, sn_rect launches {ran['sn_rect']}; "
                f"{n_up} uploads, {hits} hits, uploaded {up} B = {ratio} x "
                f"the bucketed presence; store peak {peak} B, cap {cap} B, "
                f"budget {budget} B; max_memory_allocated "
                f"{peak_alloc} B ({before} B allocated before); against the "
                f"resident CSV: {agree}; split ms (stages overlap): "
                + ", ".join(f"{k} {v:.1f}" for k, v in phases.items())
            )
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return launches["streamed"]


def streamed_mesh_legs(n_gpu: int) -> list:
    """The streamed engines' mesh legs: (engine, --mesh spec or None,
    processes, staged under leg A's budget).  Two processes each, and with
    four GPUs or more each mesh leg at 2,2 too."""
    legs = [("streamed", "2,1", 2, False), ("streamed", "1,2", 2, False),
            ("exact", "2,1", 2, False), ("exact", "1,2", 2, False),
            ("streamed", "2,1", 2, True), ("exact", "1,2", 2, True),
            ("exact", None, 2, False)]
    if n_gpu >= 4:
        legs += list(dict.fromkeys((engine, "2,2", 4, staged)
                                   for engine, spec, _, staged in legs
                                   if spec))
    return legs


def streamed_launches(plan, G: int, rows: int, target: int | None) -> int:
    """sn_rect launches of each rank of a G x G ``--streamed --mesh`` run
    at the CLI's default band and chunk: one per width bucket (staged:
    per chunk of ``_split_plan`` at ``target``) and block on or above the
    diagonal, the band rounded up to the mesh's rows."""
    import torch

    from parfastaai_tpu_torch import engine

    band, chunk = min(1024, G), min(4096, G)
    band = -(-band // rows) * rows
    n = 0
    for r0 in range(0, G, band):
        for c0 in range(0, G, chunk):
            if c0 + chunk <= r0:
                continue
            n_ids = max(min(band, G - r0), min(chunk, G - c0))
            n += len(plan) if target is None else len(list(
                engine._split_plan(plan, n_ids, torch.device("cuda"),
                                   target)))
    return n


def resident_references(keep_dir: str) -> None:
    """``--streamed`` and the default call on the E2E database, in this
    process, into ``keep_dir`` as streamed.csv and default.csv (the
    streamed mesh legs' references where the streamed and exact phases did
    not run)."""
    db = synth_db()
    for name, flags in (("streamed", ["--streamed"]), ("default", [])):
        out, _, _, wall = cli_call(keep_dir, db, f"{name}_one", flags)
        os.replace(out, os.path.join(keep_dir, f"{name}.csv"))
        print(f"reference {' '.join(flags) or '(default)'} G="
              f"{E2E['n_genomes']}: wall {wall:.3f} s")


def streamed_mesh_phase(want_band: np.ndarray, keep_dir: str) -> dict:
    """The streamed engines over the mesh (``--streamed --mesh``,
    ``--streamed --exact --mesh``) and on two processes without one, on
    the E2E database through the CLI, NCCL with two GPUs or more, else
    gloo with every rank on cuda:0.  Each rank reports its launches:
    sn_rect as reckoned from the plan (``streamed_launches``) in the f32
    legs, no hand-written kernel in the exact ones.  Only rank 0 writes.
    The exact legs write default.csv's bytes; the f32 row splits
    streamed.csv's (staged: leg A's staged one-process CSV, where it ran,
    and streamed.csv's within tolerance); the f32 protein splits' first
    rows are within RTOL_E2E_AJI of exact f64.  The staged legs run under
    leg A's budget and slabs, process 0 broadcasting the metadata and T
    alone.  Prints rank 0's phases and the wall of each leg; returns
    {leg: launches per rank, wall and phases}."""
    import torch

    from parfastaai_tpu_torch import engine
    from parfastaai_tpu_torch.etl.database import SCPDatabase

    n_gpu = torch.cuda.device_count()
    backend = "nccl" if n_gpu >= 2 else "gloo"
    db = synth_db()
    db_ = SCPDatabase(db)
    try:
        presence = db_.load_presence()
    finally:
        db_.close()
    plan = engine._bucket_plan(presence)
    G = presence.m.shape[1]
    budget = engine.presence_device_bytes(presence) // STAGED_BUDGET_SHARE
    slab_bytes = budget // STAGED_SLAB_SHARE
    del presence
    staged_env = {"PARFASTAAI_HBM_BYTES": str(budget),
                  "PARFASTAAI_SLAB_BYTES": str(slab_bytes)}
    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_streamed_mesh_")
    report = {}
    try:
        for eng, spec, n, staged in streamed_mesh_legs(n_gpu):
            flags = ["--streamed"] + (["--exact"] if eng == "exact" else [])
            if staged and eng == "streamed":
                flags.append("--staged")
            if spec:
                flags += ["--mesh", spec]
            rows = int(spec.split(",")[0]) if spec else 1
            label = " ".join(flags) + (" (leg A's budget)" if staged else "")
            name = "_".join(f.strip("-") for f in flags).replace(",", "x")
            ranks, wall = mesh_ranks(db, out_dir, name, flags, n,
                                     staged_env if staged else None)
            text = ranks[0][1]
            if f"backend {backend}, rank 0 on cuda:0" not in text:
                print(text)
                fail(f"{label}: not the {backend} backend with rank 0 on "
                     "cuda:0")
            if any(os.path.exists(r[0]) for r in ranks[1:]):
                fail(f"{label}: a rank other than 0 wrote a CSV")
            launches = [r[2]["sn_rect"] for r in ranks]
            want_launches = [0] * n if eng == "exact" else [
                streamed_launches(plan, G, rows,
                                  slab_bytes if staged else None)] * n
            if any(r[2]["sn_square_wgmma"] for r in ranks) or (
                    launches != want_launches):
                fail(f"{label}: launches {[r[2] for r in ranks]}, reckoned "
                     f"sn_rect {want_launches} alone")
            if staged and ("metadata + T only" not in text
                           or SLAB_LINE.search(text) is None):
                print(text)
                fail(f"{label}: no meta-only broadcast or slab line on rank 0")
            if not spec and "WARNING" not in ranks[0][3]:
                fail(f"{label}: rank 0 said nothing of computing alone")
            got = ranks[0][0]
            if eng == "exact":
                held = csv_agreement(got, os.path.join(keep_dir, "default.csv"),
                                     exact=True)
            elif rows > 1 and spec.endswith(",1"):
                twin = os.path.join(keep_dir, "staged_streamed.csv")
                if staged and os.path.exists(twin):
                    csv_agreement(got, twin, exact=True)
                held = csv_agreement(
                    got, os.path.join(keep_dir, "streamed.csv"),
                    exact=not staged)
                if staged and os.path.exists(twin):
                    held = f"leg A's staged bytes; against --streamed: {held}"
            else:
                held = (f"rows 0..{BAND_ROWS - 1} within "
                        f"{rows_against(got, want_band):.3e} of exact f64 "
                        f"(rtol {RTOL_E2E_AJI}); against --streamed: "
                        + csv_agreement(got, os.path.join(keep_dir,
                                                          "streamed.csv"),
                                        exact=False))
            os.remove(got)
            phases = cli_phases(text)
            slab = SLAB_LINE.search(text)
            print(f"{label} G={G} on {n} processes ({backend}): wall "
                  f"{wall:.3f} s (from launch to the last exit), sn_rect "
                  f"launches per rank {launches}, only rank 0 wrote, {held}"
                  + (f"; rank 0's store: {slab.group(0)}" if slab else "")
                  + "; rank 0 split ms: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()))
            report[f"{label} x{n}"] = {"launches": launches, "wall_s": wall,
                                       "phases_ms": phases}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return report


# The bench's e2e mode on the E2E database: every leg (the fused, streamed
# and exact legs), the exact one also over a mesh.
BENCH_E2E_ENV = {"PARFASTAAI_BENCH_MODE": "e2e", "PARFASTAAI_BENCH_EXACT": "1"}
# The e2e legs whose engine launches sn_rect; the exact legs launch none.
BENCH_E2E_RECT_LEGS = ("fused", "streamed")
# Each leg's CSV suffix and the resident CSV of steps 2-4 it is held
# against (exact legs: the same bytes; f32 legs: csv_agreement).
BENCH_E2E_CSVS = {"fused": ("", "fast.csv"),
                  "streamed": ("_streamed", "streamed.csv"),
                  "exact": ("_exact", "default.csv"),
                  "exact_mesh": ("_exact_mesh", "default.csv")}


def bench_e2e_check(what: str, text: str, out_dir: str, keep_dir: str):
    """The e2e JSON line (the last of ``text``) parsed, each leg's split
    and launches printed, its CSVs held against the resident CSVs in
    ``keep_dir``; fails unless sn_rect launched on the fused and streamed
    legs and on no exact leg.  Returns the parsed line."""
    import filecmp

    try:
        result = json.loads(text.splitlines()[-1])
    except (IndexError, ValueError):
        fail(f"{what}: no JSON line in {text[-2000:]!r}")
    print(f"{what} JSON: {json.dumps(result)}")
    legs = result["legs"]
    if set(legs) != set(BENCH_E2E_CSVS):
        fail(f"{what}: legs {sorted(legs)}")
    if result["phases"].get("banded_exact_mesh_bytes_identical") is not True:
        fail(f"{what}: the mesh leg's CSV was not found identical")
    G = E2E["n_genomes"]
    for leg, entry in legs.items():
        rect = entry["kernel_launches"]["sn_rect"]
        if (rect > 0) != (leg in BENCH_E2E_RECT_LEGS) or (
                entry["kernel_launches"]["sn_square_wgmma"]):
            fail(f"{what}: leg {leg} launched {entry['kernel_launches']}")
        suffix, ref = BENCH_E2E_CSVS[leg]
        got = os.path.join(out_dir, f"pfaai_bench_e2e_{G}{suffix}.csv")
        want = os.path.join(keep_dir, ref)
        if leg.startswith("exact"):
            if not filecmp.cmp(got, want, shallow=False):
                fail(f"{what}: the {leg} leg's CSV is not {ref}'s bytes")
            held = f"{ref}'s bytes"
        else:
            held = f"vs {ref}: " + csv_agreement(got, want, exact=False)
        print(
            f"  {leg}: {entry['seconds']:.3f} s, wall {entry['wall_seconds']:.3f}"
            f" s, {entry['pairs_per_sec']:.4e} genome pairs/s over the leg, "
            f"{entry['pairs_per_sec_wall']:.4e} over the wall; launches "
            f"{entry['kernel_launches']}; {held}; split ms: "
            + ", ".join(f"{k} {v:.1f}" for k, v in entry["split_ms"].items()))
    return result


def bench_e2e_phase(keep_dir: str) -> dict:
    """``python -m parfastaai_tpu_torch.bench`` in e2e mode, in this
    process, on the E2E database with every leg and the (1, 1) mesh,
    launch counters reset just before and read just after: sn_rect on the
    fused and streamed legs (their sum), no other kernel; the exact and
    mesh CSVs are the default call's bytes, the fused and streamed ones
    the --fast and --streamed calls'.  Returns the launches per leg."""
    from parfastaai_tpu_torch import bench

    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_bench_e2e_")
    env = {**BENCH_E2E_ENV, "PARFASTAAI_BENCH_EXACT_MESH": "1,1",
           "PARFASTAAI_BENCH_DB": synth_db(), "PARFASTAAI_BENCH_OUT": out_dir,
           "PARFASTAAI_BENCH_G": str(E2E["n_genomes"])}
    lines: list[str] = []
    try:
        reset_launches()
        with captured_stdout(lines):
            bench.main(env)
        ran = read_launches()
        result = bench_e2e_check("bench e2e (1,1)", "\n".join(lines),
                                 out_dir, keep_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    legs = {leg: e["kernel_launches"]["sn_rect"]
            for leg, e in result["legs"].items()}
    if ran["sn_square_wgmma"] or ran["sn_rect"] != sum(legs.values()):
        fail(f"bench e2e: launches {ran}, legs {legs}")
    return legs


def bench_e2e_ranks(keep_dir: str) -> dict:
    """The bench's e2e mode with PARFASTAAI_BENCH_EXACT_MESH=2,1 in two
    processes (NCCL with two cards or more, else gloo with both ranks on
    cuda:0): process 0 runs the ETL and the direct legs, broadcasts the
    presence, both ranks join the mesh leg; only process 0 prints, and
    its CSVs are held as in ``bench_e2e_phase``.  Returns rank 0's sn_rect
    launches per leg and the wall from launch to the last exit."""
    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_bench_e2e_ranks_")
    env = {**BENCH_E2E_ENV, "PARFASTAAI_BENCH_EXACT_MESH": "2,1",
           "PARFASTAAI_BENCH_DB": synth_db(), "PARFASTAAI_BENCH_OUT": out_dir,
           "PARFASTAAI_BENCH_G": str(E2E["n_genomes"])}
    what = "bench e2e EXACT_MESH=2,1 (two processes)"
    try:
        done, wall = launch_ranks(
            what, [sys.executable, "-m", "parfastaai_tpu_torch.bench"], 2, env)
        if done[1][0].strip():
            fail(f"{what}: rank 1 printed {done[1][0][:500]!r}")
        result = bench_e2e_check(what, done[0][0], out_dir, keep_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"{what}: wall {wall:.3f} s from launch to the last exit, presence "
          f"broadcast {result['phases']['presence_broadcast'] * 1e3:.1f} ms")
    return {"launches": {leg: e["kernel_launches"]["sn_rect"]
                         for leg, e in result["legs"].items()},
            "wall_s": wall}


def count_ops_phase(dev) -> None:
    """``ops.intersection_counts`` and ``ops.pair_counts`` on their
    default device, the card, at a small size: equal to ``int_gram`` of
    each protein on the card and to exact counts on the host (numpy)."""
    import torch

    from parfastaai_tpu_torch.ops import intersection_counts, pair_counts
    from parfastaai_tpu_torch.ops.fused import int_gram

    P, G, K = 3, 300, 256
    gen = np.random.default_rng(SEED)
    m = (gen.random((P, G, K)) < 0.3).astype(np.uint8)
    md = torch.from_numpy(m).to(dev).view(torch.int8)
    ref = np.stack([int_gram(md[p], md[p]).cpu().numpy() for p in range(P)])
    host = np.stack([np.rint(m[p].astype(np.float32) @ m[p].T.astype(
        np.float32)).astype(np.int32) for p in range(P)])
    got = intersection_counts(m)
    if not (np.array_equal(got, ref) and np.array_equal(got, host)):
        fail("intersection_counts differs from int_gram / exact counts")
    a, b = np.triu_indices(G, k=1)
    pairs = pair_counts(m, a, b)
    if not np.array_equal(pairs, host[:, a, b]):
        fail("pair_counts differs from exact counts")
    print(f"count ops on the card: intersection_counts ({P}, {G}, {G}) and "
          f"pair_counts of {len(a)} pairs (tile 128) equal int_gram and exact "
          "counts ok")


# The dense exact engine's finish (csrc/finish_f64.cu) at the pair lists of
# the benchmark's two dense cells: (name, P, G_t, n_pairs).
FINISH_SHAPES = [("qsub", 80, 4096, 1_965_824), ("qdb", 80, 4352, 1_048_576)]


def finish_phase(dev) -> dict:
    """``ops.finish.finish_pairs`` (the f64 finish kernel, its own library)
    at the dense cells' shapes: its first build's seconds, S and N bit-equal
    to the host's native ``jaccard_finish`` and to the plain version on the
    card, and the kernel's, the plain version's and the host path's times
    (the counts' download, the two T gathers and the native sum) beside
    the kernel's bound (its bytes: counts, T, the ids, S and N, each once,
    over the memory rate)."""
    import torch

    from parfastaai_tpu_torch import engine
    from parfastaai_tpu_torch.ops import _build, finish

    _build.build_log = ""
    t0 = time.perf_counter()
    _build.load_finish()
    print(f"finish kernel build + load: {time.perf_counter() - t0:.1f} s "
          f"({'compiled by nvcc now' if _build.build_log else 'library was already built'})")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas:   {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    report = {}
    for name, P, G, n in FINISH_SHAPES:
        t = torch.randint(150, 250, (P, G), generator=gen, device=dev,
                          dtype=torch.int32)
        da, db = (torch.randint(0, G, (n,), generator=gen, device=dev,
                                dtype=torch.int32) for _ in range(2))
        cap = torch.minimum(t[:, da.long()], t[:, db.long()])
        counts = (torch.rand((P, n), generator=gen, device=dev) * (cap + 1)
                  ).to(torch.int32).clamp(max=cap).to(torch.int16)
        del cap
        (s, nn), ran = launched(
            lambda: finish.finish_pairs(counts, t, da, db))
        torch.cuda.synchronize()
        if ran != {**dict.fromkeys(ran, 0), "finish_f64": 1}:
            fail(f"finish {name}: launches {ran}, reckoned finish_f64 once "
                 "alone")
        t_host = time.perf_counter()
        c_h, t_h = counts.cpu().numpy(), t.cpu().numpy()
        ta, tb = t_h[:, da.cpu().numpy()], t_h[:, db.cpu().numpy()]
        s_ref, n_ref = engine.jaccard_finish(c_h, ta, tb)
        host_s = time.perf_counter() - t_host
        del ta, tb
        s_plain, n_plain = finish.finish_pairs_plain(counts, t, da, db)
        for label, (a, b) in (("host", (s_ref, n_ref)),
                              ("plain", (s_plain.cpu().numpy(),
                                         n_plain.cpu().numpy()))):
            if not (np.array_equal(s.cpu().numpy(), a)
                    and np.array_equal(nn.cpu().numpy(), b)):
                fail(f"finish {name}: S / N differ from the {label} finish")
        ms = cuda_ms(lambda: finish.finish_pairs(counts, t, da, db), 20)
        plain_ms = cuda_ms(
            lambda: finish.finish_pairs_plain(counts, t, da, db), 3)
        # counts, T, the two int32 id vectors, S (f64) and N (int32)
        nbytes = (counts.numel() * counts.element_size() + t.numel() * 4
                  + n * (4 + 4 + 8 + 4))
        b = bound(0, nbytes)
        report[name] = {"P": P, "G_t": G, "n_pairs": n, "ms": ms,
                        "plain_ms": plain_ms, "host_ms": host_s * 1e3, **b}
        print(f"finish_f64 {name} P={P} G_t={G} n={n}: bit-equal to the host "
              f"and plain finish ok; kernel {ms:.3f} ms, plain {plain_ms:.3f}"
              f" ms, host path {host_s * 1e3:.1f} ms, bound "
              f"{b['bound_ms']:.3f} ms by {b['bound_by']} "
              f"({b['bound_ms'] / ms:.1%} of the kernel's time)")
        del counts, t, da, db, s, nn, s_plain, n_plain
        torch.cuda.empty_cache()
    return report


def record_presence():
    """Leg B's presence, made with numpy from SEED: LEG_B's P proteins, G
    genomes and K columns of compacted tetramers, LEG_B['tetras'] draws
    per genome and protein (duplicates fall together)."""
    from parfastaai_tpu_torch.etl.database import PresenceData
    from parfastaai_tpu_torch.types import DBMetaData

    P, G, K, n = LEG_B["P"], LEG_B["G"], LEG_B["K"], LEG_B["tetras"]
    rng = np.random.default_rng(SEED)
    m = np.zeros((P, G, K), np.uint8)
    t = np.zeros((P, G), np.int32)
    rows = np.arange(G)[:, None]
    for p in range(P):
        cols = np.sort(rng.integers(0, K, size=(G, n)), axis=1)
        m[p][rows, cols] = 1
        t[p] = 1 + np.count_nonzero(np.diff(cols, axis=1), axis=1)
    meta = DBMetaData(protein_set=tuple(f"P{p}" for p in range(P)),
                      genome_set=tuple(f"g{i:05d}" for i in range(G)))
    return PresenceData(meta=meta, m=m, t=t, widths=np.full(P, K, np.int32),
                        tetramer_ids=[np.arange(K, dtype=np.int32)] * P)


def staged_record_leg(dev) -> dict:
    """Leg B: the TPU record's shape in memory (LEG_B) under the record's
    budget (LEG_B_BUDGET): compute_streamed, auto-staged, in blocks of
    LEG_B_BLOCK, against the same presence run resident on the card; then
    sn_rect at the run's chunk shape against its plain version."""
    import dataclasses

    import torch

    from parfastaai_tpu_torch import engine
    from parfastaai_tpu_torch.ops import sn_rect

    t0 = time.perf_counter()
    presence = record_presence()
    G = presence.m.shape[1]
    names = presence.meta.genome_set
    ids = np.arange(G, dtype=np.int32)
    pres_bytes = engine.presence_device_bytes(presence)
    plan = engine._bucket_plan(presence)
    print(f"staged leg B: presence P={LEG_B['P']} G={G} K={LEG_B['K']} made "
          f"in {time.perf_counter() - t0:.1f} s, {presence.m.nbytes} B on "
          f"the host, {pres_bytes} B bucketed")
    out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_record_")
    saved = {k: os.environ.pop(k, None)
             for k in ("PARFASTAAI_HBM_BYTES", "PARFASTAAI_SLAB_BYTES")}
    runs = {}
    try:
        os.environ["PARFASTAAI_HBM_BYTES"] = str(LEG_B_BUDGET)
        if not engine._use_staged(presence, dev):
            fail("leg B: the presence fits the budget; nothing to stage")
        chunks = list(engine._split_plan(plan, LEG_B_BLOCK, dev))
        for name, staged in (("staged", None), ("resident", False)):
            pres = dataclasses.replace(presence)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch._C._host_emptyCache()  # the page-locked blocks of before
            torch.cuda.reset_peak_memory_stats()
            out = os.path.join(out_dir, f"{name}.csv")
            phases: dict = {}
            reset_launches()
            t1 = time.perf_counter()
            engine.compute_streamed(
                pres, ids, ids, out, names, names, dev, band=LEG_B_BLOCK,
                col_chunk=LEG_B_BLOCK, phases=phases, staged=staged)
            wall = time.perf_counter() - t1
            ran = read_launches()
            if ran["sn_rect"] == 0 or ran["sn_square_wgmma"]:
                fail(f"leg B {name}: launches {ran}")
            runs[name] = dict(out=out, wall=wall, launches=ran["sn_rect"],
                              phases=phases,
                              peak_alloc=torch.cuda.max_memory_allocated(),
                              stats=engine.slab_stats(pres, dev))
            del pres
        st = runs["staged"]["stats"]
        if st is None or runs["resident"]["stats"] is not None:
            fail("leg B: the staged run kept no slab store, or the "
                 "resident run made one")
        biggest = max(len(idx) * LEG_B_BLOCK * kb for _, _, idx, kb in chunks)
        if st["peak"] > st["cap"] + biggest:
            fail(f"leg B: the store held {st['peak']} B, over its cap "
                 f"{st['cap']} B plus one slab ({biggest} B)")
        agree = csv_agreement(runs["staged"]["out"], runs["resident"]["out"],
                              exact=False)
        for name, r in runs.items():
            print(
                f"staged leg B {name}: wall {r['wall']:.3f} s, sn_rect "
                f"launches {r['launches']}, max_memory_allocated "
                f"{r['peak_alloc']} B, budget {LEG_B_BUDGET} B; split ms "
                "(stages overlap): " + ", ".join(
                    f"{k} {v * 1e3:.1f}" for k, v in r["phases"].items()))
        print(f"staged leg B: {len(chunks)} chunks a block, {st['slabs']} "
              f"uploads of slabs up to {biggest} B, {st['hits']} hits, "
              f"uploaded {st['uploaded']} B = "
              f"{st['uploaded'] / pres_bytes:.3f} x the bucketed presence, "
              f"store peak {st['peak']} B of a {st['cap']} B cap; against "
              f"the resident run: {agree}")
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
        shutil.rmtree(out_dir, ignore_errors=True)
    del presence
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()
    # sn_rect at the run's first chunk shape against its plain version
    _, _, idx, kb = chunks[0]
    P, A = len(idx), LEG_B_BLOCK
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ma, mb, ta, tb = random_block(gen, dev, P, A, A, kb)
    s_ref, n_ref = sn_rect.fused_sn_block_plain(ma, mb, ta, tb)
    errs = {}
    for mode, kw in MODES:
        s, n = sn_rect.fused_sn_block(ma, mb, ta, tb, **kw)
        errs[mode] = check(f"sn_rect staged chunk P={P} A=B={A} K={kb}", s,
                           n, s_ref, n_ref, mode)
    ms = cuda_ms(lambda: sn_rect.fused_sn_block(ma, mb, ta, tb), 5)
    plain_ms = cuda_ms(lambda: sn_rect.fused_sn_block_plain(ma, mb, ta, tb), 3)
    b = rect_bound(P, A, A, kb)
    print(f"sn_rect staged chunk P={P} A=B={A} K={kb}: kernel {ms:.3f} ms "
          f"({P * A * A * kb / ms / 1e9:.3f} TMAC/s), plain {plain_ms:.3f} "
          f"ms, bound {b['bound_ms']:.3f} ms by {b['bound_by']}")
    del ma, mb, ta, tb, s_ref, n_ref, s, n
    torch.cuda.empty_cache()
    return {"launches": runs["staged"]["launches"],
            "chunk": {"shape": [P, A, A, kb], "max_abs_err": errs["newton"],
                      "ms": ms, "plain_ms": plain_ms, **b,
                      "library_ms": None}}


def host_library_phase() -> None:
    """The port's native host library (ETL, f64 finish, CSV formatter),
    built with g++ from parfastaai_tpu_torch/native/*.cpp at first use.
    The host times of a run assume it, so a run without it fails."""
    from parfastaai_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.get_lib()
    if lib is None:
        fail("the native host library did not build or load (g++ with "
             "OpenMP; PARFASTAAI_NO_NATIVE must be unset)")
    print(f"native host library: loaded in {time.perf_counter() - t0:.1f} s "
          f"({'compiled by g++ now' if native.built_now else 'was already built'}"
          f", sqlite loader {'on' if lib.sqlite_available() else 'off'})")


def sass_phase() -> None:
    """From the toolkit's cuobjdump on the built library: integer warpgroup
    products (IGMMA) and asynchronous copies (LDGSTS) and no __dp4a (IDP)
    in every sn_rect and sn_square_wgmma kernel (every divide mode and, for
    the square, every update: lean, pipe, pair, counts; lean also on packed
    rows, whose split into nibbles stores to shared memory (STS), and over
    the diagonal and band walks).  Fails unless every instantiation that
    the sources build was found and passed."""
    from parfastaai_tpu_torch.ops import _build, sn_square

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", _build.build()],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump failed: {out.stderr.strip()}")
    funcs, name = {}, None
    for line in out.stdout.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    checked, found = 0, set()
    for name, body in funcs.items():
        kernel = next((k for k in KERNELS if f"{k}_kernel" in name), None)
        if kernel is None:
            continue
        sass = "\n".join(body)
        targs = re.search(r"_kernelI((?:Li\d+E)+)E", name)
        key = (kernel, *re.findall(r"Li(\d+)E", targs.group(1)))
        found.add(key)
        ops = {op: len(re.findall(rf"\b{op}\b", sass))
               for op in ("IGMMA", "LDGSTS", "IDP", "STS")}
        packed = kernel == "sn_square_wgmma" and key[3] == "1"
        ok = (ops["IGMMA"] > 0 and ops["LDGSTS"] > 0 and ops["IDP"] == 0
              and (ops["STS"] > 0 or not packed))
        checked += 1
        print(f"SASS {kernel} {name}: {ops['IGMMA']} IGMMA, {ops['LDGSTS']} "
              f"LDGSTS, {ops['STS']} STS, {ops['IDP']} IDP "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"SASS of {name}: {ops}")
    # what the sources build: sn_rect per divide mode; sn_square_wgmma per
    # divide mode, update, packing and walk: lean on 0/1 bytes and packed
    # rows over the list, the diagonals and the bands, the two-set updates
    # on 0/1 bytes over the list, and counts (which never divides) once
    modes = [str(i) for i in range(len(MODES))]
    code = {u: str(c) for u, c in sn_square._WGMMA_UPDATES.items()}
    walks = [str(w) for w in (sn_square._WALK_LIST, sn_square._WALK_DIAG,
                              sn_square._WALK_BAND)]
    built = {("sn_rect", m) for m in modes} | {
        ("sn_square_wgmma", m, code["lean"], pk, w)
        for m in modes for pk in "01" for w in walks} | {
        ("sn_square_wgmma", m, code[u], "0", "0")
        for m in modes for u in ("pipe", "fused")} | {
        ("sn_square_wgmma", "0", code["counts"], "0", "0")}
    if found != built or checked != len(built):
        fail(f"SASS: checked {checked} tensor-core kernels, found "
             f"{sorted(found)}, the sources build {sorted(built)}")
    print(f"SASS: {checked} tensor-core kernels, every one the sources build")


def print_ok() -> None:
    """The result line, last: the card's kind and the device count."""
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


def main() -> None:
    import torch

    mesh_only = sys.argv[1:] == ["--mesh-only"]
    finish_only = sys.argv[1:] == ["--finish-only"]
    if sys.argv[1:] and not (mesh_only or finish_only):
        fail(f"usage: {sys.argv[0]} [--mesh-only | --finish-only]")
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
    entry_name = ""
    for line in _build.build_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            entry_name = entry.group(1)
            print(f"  ptxas: {entry_name}")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas:   {line.strip()}")
            if (("sn_rect" in entry_name or "sn_square_wgmma" in entry_name)
                    and re.search(r"[1-9]\d* bytes spill", line)):
                fail(f"ptxas spills registers in {entry_name}")
        # ptxas serializes every wgmma of a kernel whose accumulators are
        # read while products may be in flight (C7514)
        if "wgmma.mma_async instructions are serialized" in line:
            fail(f"ptxas: {line.strip()}")
        # and a wait it injects into a two-count-set body (sn_square_wgmma
        # update 1 or 2) makes kPipe's epilogue wait for its own slice's
        # products; the counts loop (update 3) must have none either
        injected = re.search(r"warpgroup\.wait is injected.*function '(\w+)'",
                             line)
        if injected and re.search(r"sn_square_wgmma_kernelILi\dELi[123]E",
                                  injected.group(1)):
            fail(f"ptxas: {line.strip()}")

    host_library_phase()
    if finish_only:
        out_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_dense_")
        try:
            _, _, wall, launches = dense_cli_leg(out_dir,
                                                 synth_db(EXACT_SMALL_G))
        finally:
            shutil.rmtree(out_dir, ignore_errors=True)
        print(f"dense default call G={EXACT_SMALL_G}: finish_f64 launches "
              f"{launches}, no count kernel, wall {wall:.3f} s")
        fin = {"launches": launches, **finish_phase(dev)}
        print(card_line())
        print(json.dumps({"finish_f64": fin}))
        print_ok()
        return
    if mesh_only:
        keep_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_resident_")
        try:
            band = e2e_phase(dev, keep_dir)["band"]
            mesh = mesh_phase(dev, band, keep_dir)
            resident_references(keep_dir)
            mesh["streamed"] = streamed_mesh_phase(band, keep_dir)
            mesh["bench_e2e_ranks"] = bench_e2e_ranks(keep_dir)
        finally:
            shutil.rmtree(keep_dir, ignore_errors=True)
        print(card_line())
        print(json.dumps({"mesh": mesh}))
        print_ok()
        return
    sass_phase()
    kern = kernel_phase(dev)
    square = square_phase(dev)
    keep_dir = tempfile.mkdtemp(prefix="parfastaai_smoke_resident_")
    try:
        e2e = e2e_phase(dev, keep_dir)
        mesh = mesh_phase(dev, e2e["band"], keep_dir)
        streamed_launches = streamed_phase(dev, e2e["band"], keep_dir)
        dense_launches = exact_phase(e2e["band"], keep_dir)
        staged_launches = staged_cli_leg(keep_dir)
        streamed_mesh = streamed_mesh_phase(e2e["band"], keep_dir)
        bench_e2e = bench_e2e_phase(keep_dir)
        bench_e2e_two = bench_e2e_ranks(keep_dir)
    finally:
        shutil.rmtree(keep_dir, ignore_errors=True)
    record = staged_record_leg(dev)
    whole, whole_variants, packed_launches = bench_phase(dev)
    count_ops_phase(dev)
    # the dense default call's launches (exact_phase) beside the kernel's
    # times at the dense cells' shapes
    fin = {"launches": dense_launches, **finish_phase(dev)}
    # every entry module of the port is loaded by now, the library API too
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "parfastaai_tpu"))
    if "parfastaai_tpu_torch.api" not in sys.modules:
        fail("the run did not load parfastaai_tpu_torch.api")
    if leaked:
        fail(f"the run loaded {leaked[:5]}: the port imports neither jax nor "
             "the JAX package")

    print(card_line())
    results = {
        # launches: the --fast CLI run's; the --streamed CLI run's, its
        # staged twin's (leg A), leg B's and the --mesh runs' beside it
        "sn_rect": {"launches": e2e["launches"],
                    "launches_streamed": streamed_launches,
                    "launches_staged": staged_launches,
                    "launches_staged_record": record["launches"],
                    # per rank of each --mesh run (two processes for 2,1
                    # and 1,2), and the GPU count and backend they had
                    "launches_mesh": {spec: mesh[spec]["launches"]
                                      for spec in mesh if "," in spec},
                    "launches_bench_mesh": mesh["bench_mesh_launches"],
                    # per rank of each streamed engine's mesh leg
                    # (--streamed [--exact] [--staged] --mesh, processes)
                    "launches_streamed_mesh": {
                        leg: r["launches"] for leg, r in streamed_mesh.items()},
                    # per leg of the bench's e2e mode in this process, and
                    # rank 0's of its two-process EXACT_MESH=2,1 launch
                    "launches_bench_e2e": bench_e2e,
                    "launches_bench_e2e_ranks": bench_e2e_two["launches"],
                    "mesh_gpus": mesh["gpus"],
                    "mesh_backend": mesh["backend"],
                    # leg B's chunk shape (P, A, B, K), the kb kernel shape
                    "staged_chunk": record["chunk"],
                    "max_abs_err": kern[("main", "newton")],
                    "ms": kern[("main", "ms")],
                    "plain_ms": kern[("main", "plain_ms")],
                    **kern[("main", "bound")]},
        # the default plan's (its bench run), with the other updates (their
        # bench runs) and the other routes (one call each; packed: one
        # fused_aji call on the bench's workload) beside it
        "sn_square_wgmma": {"launches": whole, **square},
    }
    for v, entry in results["sn_square_wgmma"]["variants"].items():
        entry["launches"] = whole_variants[v]
    results["sn_square_wgmma"]["routes"]["packed"]["launches"] = (
        packed_launches)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"parfastaai_tpu_torch/csrc/{name}.cu",
        "replaces": ", ".join(f"{PALLAS}:{line}" for line in REPLACES[name]),
        **results[name],
        # no single PyTorch call computes P Gram products, the per-protein
        # transform and the two running sums (counts' call is in its
        # variant's entry)
        "library_ms": None,
    } for name in KERNELS]}))
    # replaces no TPU kernel: the JAX package finishes on the host
    print(json.dumps({"finish_f64": fin}))
    print_ok()


if __name__ == "__main__":
    main()
