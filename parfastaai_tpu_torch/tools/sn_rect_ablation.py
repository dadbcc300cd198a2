"""What binds the sn_rect kernel: times of csrc/sn_rect.cu with one part of
its block body (csrc/sn_wgmma.cuh) cut.

Run on a machine with an NVIDIA GPU and nvcc:

    python -m parfastaai_tpu_torch.tools.sn_rect_ablation

Builds four copies of the kernel into a temporary directory: as it is, without the global loads after the ring's first fill (``noload``: the
products and the epilogue alone), without the wgmma products (``nomma``:
the feed from L2 and the epilogue on zero counts alone), and without the
epilogue's transform (``noepi``).  The cut copies compute nothing useful;
only their times mean something.  Each is timed with CUDA events at the
``--fast`` path's block (P=80, 1024 x 4096) at K = 1280 and 2560 and at
the kb block (P=16, 1024 x 1024, K=51200), and the feed-only time is also
given as bytes per second out of L2 (every block's rows of every slice).
Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from ..ops import _build, sn_rect

SHAPES = [(80, 1024, 4096, 1280), (80, 1024, 4096, 2560),
          (16, 1024, 1024, 51200)]
HEADER = "sn_wgmma.cuh"
# (name, [(text of csrc/sn_wgmma.cuh to replace, replacement), ...]): the
# block body that sn_rect and sn_square_wgmma share
CUTS = [
    ("full", []),
    ("noload", [
        ("    if (lp < P) load_slice((stage + kSt - 2) % kSt);",
         "    if (lp < 0) load_slice((stage + kSt - 2) % kSt);")]),
    ("nomma", [
        ("      wgmma_m64n128k32(d, da + 2 * k32, db + 2 * k32, (ks | j) != 0);",
         "      (void)da, (void)db, (void)k32;")]),
    # every update's epilogue: kLean's column groups, add_terms' (the
    # two-count-set updates) and kCounts' conversion
    ("noepi", [
        ("        for (int j = 0; j < kNT; ++j) {",
         "        for (int j = 0; j < 0; ++j) {"),
        ("  for (int j = kJ0; j < kJ1; ++j) {",
         "  for (int j = kJ0; j < kJ0; ++j) {"),
        ("          s[i] = __fadd_rn(s[i], __int2float_rn(cnt[i]));",
         "          (void)cnt[i];")]),
]


def build_variants(tmp: str, source: str = "sn_rect.cu",
                   entry: str = "sn_rect_launch", n_pointers: int = 6,
                   n_ints: int = 5) -> dict:
    """Build one library per cut into ``tmp``: csrc/``source`` beside a
    copy of the shared header with the cut made (all nvcc runs started
    together), and bind ``entry`` (``n_pointers`` pointers, ``n_ints``
    ints, the stream) in each."""
    csrc = os.path.join(os.path.dirname(_build.BUILD_DIR), "csrc")
    with open(os.path.join(csrc, HEADER)) as fp:
        header = fp.read()
    procs = {}
    for name, replacements in CUTS:
        text = header
        for old, new in replacements:
            if header.count(old) != 1:
                raise SystemExit(f"cut {name!r}: its text is not in {HEADER} "
                                 "exactly once; bring CUTS up to date")
            text = text.replace(old, new)
        # the source includes the header by name: its copy's own directory
        # is searched first
        os.mkdir(os.path.join(tmp, name))
        with open(os.path.join(tmp, name, HEADER), "w") as fp:
            fp.write(text)
        cu = shutil.copy(os.path.join(csrc, source), os.path.join(tmp, name))
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS[:6], "-shared", "-o",
             os.path.join(tmp, f"{name}.so"), cu],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        )
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {name} copy:\n{err}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        getattr(lib, entry).argtypes = [vp] * n_pointers + [ci] * n_ints + [vp]
        getattr(lib, entry).restype = ci
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int = 5) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    with tempfile.TemporaryDirectory(prefix="sn_rect_ablation_") as tmp:
        libs = build_variants(tmp)
        for P, A, B, K in SHAPES:
            ma = (torch.rand((P, A, K), generator=gen, device=dev) < 0.33).to(
                torch.uint8)
            mb = (torch.rand((P, B, K), generator=gen, device=dev) < 0.33).to(
                torch.uint8)
            ta = sn_rect.clamp_t(ma.sum(dim=2, dtype=torch.int32))
            tb = sn_rect.clamp_t(mb.sum(dim=2, dtype=torch.int32))
            s = torch.empty((A, B), dtype=torch.float32, device=dev)
            n = torch.empty((A, B), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch(lib):
                rc = lib.sn_rect_launch(
                    ma.data_ptr(), mb.data_ptr(), ta.data_ptr(),
                    tb.data_ptr(), s.data_ptr(), n.data_ptr(), P, A, B, K, 0,
                    stream)
                if rc != 0:
                    raise SystemExit(f"launch failed: cudaError {rc}")

            ms = {name: cuda_ms(lambda lib=lib: launch(lib))
                  for name, lib in libs.items()}
            tile = sn_rect.TILE
            staged = -(-A // tile) * -(-B // tile) * 2 * tile * K * P
            print(
                f"sn_rect P={P} A={A} B={B} K={K}: "
                + ", ".join(f"{name} {t:.3f} ms" for name, t in ms.items())
                + f"; feed alone {staged / ms['nomma'] / 1e9:.3f} TB/s out of "
                f"L2, products alone {P * A * B * K / ms['noload'] / 1e9:.3f} "
                "TMAC/s"
            )
            del ma, mb
    sys.stdout.flush()


if __name__ == "__main__":
    main()
