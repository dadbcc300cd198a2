"""The wgmma kernels of this checkout against those of another checkout.

Run on a machine with an NVIDIA GPU and nvcc:

    python -m parfastaai_tpu_torch.tools.wgmma_ab OTHER_CSRC [--other-square-ints 6]

OTHER_CSRC is the ``csrc/`` directory of the other checkout, for example
the parent commit unpacked with ``git archive``.  Builds csrc/sn_rect.cu
and csrc/sn_square_wgmma.cu of both checkouts with nvcc, each into a
library of its own, and prints, for every instantiation that both build,
ptxas's registers and spills and whether the two SASS instruction mixes
(the count of each opcode) are the same; a kernel that took fewer template
arguments in one checkout is matched with their value 0 (for
sn_square_wgmma's update, packing and walk: ``lean`` on 0/1 bytes over a
tile list).  Then it times, in the Newton
mode and in turns (other, this, this, other), sn_rect at the ``--fast``
block (P=80, 1024 x 4096, K=1280) and the square's ``lean`` update at the
whole-matrix bench's shape (P=80, G=4096, K=1280, upper-triangle tiles).
A square C entry takes 10 ints, one from before its ``packed``, ``walk``
and ``walk_arg`` arguments 7 (``--other-square-ints 7``, the default),
one from before its ``update`` 6.  Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import tempfile

import torch

from ..ops import _build, sn_rect, sn_square
from .sn_rect_ablation import cuda_ms
from .sn_square_ablation import N_INTS

SOURCES = ("sn_rect.cu", "sn_square_wgmma.cu")
KERNEL = re.compile(r"(sn_rect|sn_square_wgmma)_kernelI((?:Li\d+E)+)E")
# template arguments a key carries: (mode,) and (mode, update, packed,
# walk), the missing ones 0
N_ARGS = 4


def kernel_key(name: str) -> tuple | None:
    """(kernel, template arguments...) of a mangled wgmma kernel name,
    padded with 0 to N_ARGS arguments."""
    m = KERNEL.search(name)
    if not m:
        return None
    args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(2))]
    return (m.group(1), *args, *[0] * (N_ARGS - len(args)))


def ptxas_report(log: str) -> dict:
    """{kernel key: (registers, spill store bytes, spill load bytes)} from
    the ``-Xptxas -v`` report of a build."""
    out, key = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            key = kernel_key(entry.group(1))
            if key:
                out[key] = [None, 0, 0]
            continue
        if key is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out[key][1:] = [int(spill.group(1)), int(spill.group(2))]
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[key][0] = int(regs.group(1))
    return {k: tuple(v) for k, v in out.items()}


def sass_mix(text: str) -> dict:
    """{kernel key: Counter of opcodes} from ``cuobjdump -sass`` output."""
    out, key = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            key = kernel_key(line.split("Function : ", 1)[1])
            if key:
                out[key] = collections.Counter()
            continue
        op = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if key and op:
            out[key][op.group(1)] += 1
    return out


def build(csrc: str, out_dir: str, tag: str) -> dict:
    """{source: (library path, ptxas report, SASS mix)} of csrc's wgmma
    kernels, one nvcc per source, all started together."""
    procs = {}
    for src in SOURCES:
        lib = os.path.join(out_dir, f"{tag}_{src}.so")
        procs[src] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
             os.path.join(csrc, src)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    built = {}
    for src, (lib, proc) in procs.items():
        log = proc.communicate()[1]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {tag} {src}:\n{log}")
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        built[src] = (lib, ptxas_report(log), sass_mix(sass))
    return built


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other_csrc")
    ap.add_argument("--other-square-ints", type=int, default=7,
                    choices=(6, 7, N_INTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU with CUDA")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    this_csrc = os.path.join(os.path.dirname(_build.BUILD_DIR), "csrc")
    with tempfile.TemporaryDirectory(prefix="wgmma_ab_") as tmp:
        this = build(this_csrc, tmp, "this")
        other = build(args.other_csrc, tmp, "other")
        for src in SOURCES:
            for key in sorted(set(this[src][1]) & set(other[src][1])):
                print(f"{key}: registers/spill stores/spill loads other "
                      f"{other[src][1][key]}, this {this[src][1][key]}; "
                      "same SASS instruction mix: "
                      f"{other[src][2].get(key) == this[src][2].get(key)}")
        libs = {}
        for tag, built, n_ints in (("other", other, args.other_square_ints),
                                   ("this", this, N_INTS)):
            rect = ctypes.CDLL(built["sn_rect.cu"][0])
            rect.sn_rect_launch.argtypes = ([ctypes.c_void_p] * 6
                                            + [ctypes.c_int] * 5
                                            + [ctypes.c_void_p])
            square = ctypes.CDLL(built["sn_square_wgmma.cu"][0])
            square.sn_square_wgmma_launch.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * n_ints
                + [ctypes.c_void_p])
            libs[tag] = (rect, square, n_ints)
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        P, A, B, K, G = 80, 1024, 4096, 1280, 4096
        ma = (torch.rand((P, A, K), generator=gen, device=dev) < 0.33).to(
            torch.uint8)
        mb = (torch.rand((P, B, K), generator=gen, device=dev) < 0.33).to(
            torch.uint8)
        ta = sn_rect.clamp_t(ma.sum(dim=2, dtype=torch.int32))
        tb = sn_rect.clamp_t(mb.sum(dim=2, dtype=torch.int32))
        m = (torch.rand((P, G, K), generator=gen, device=dev) < 0.3125).to(
            torch.uint8)
        t = sn_rect.clamp_t(m.sum(dim=2, dtype=torch.int32))
        tiles = sn_square._tile_list(-(-G // sn_square.WGMMA_TILE), True, dev)
        s = torch.empty((G, G), dtype=torch.float32, device=dev)
        n = torch.empty((G, G), dtype=torch.int32, device=dev)

        def rect_call(tag):
            rc = libs[tag][0].sn_rect_launch(
                ma.data_ptr(), mb.data_ptr(), ta.data_ptr(), tb.data_ptr(),
                s.data_ptr(), n.data_ptr(), P, A, B, K, 0, stream)
            if rc != 0:
                raise SystemExit(f"{tag} sn_rect launch: cudaError {rc}")

        def square_call(tag):
            ints = [P, G, K, tiles.shape[0], 1, 0, 0, 0, 0, 0][:libs[tag][2]]
            rc = libs[tag][1].sn_square_wgmma_launch(
                m.data_ptr(), t.data_ptr(), tiles.data_ptr(), s.data_ptr(),
                n.data_ptr(), *ints, stream)
            if rc != 0:
                raise SystemExit(f"{tag} sn_square_wgmma launch: "
                                 f"cudaError {rc}")

        for label, call in (("sn_rect --fast block", rect_call),
                            ("sn_square_wgmma lean, bench shape",
                             square_call)):
            ms = [(tag, cuda_ms(lambda tag=tag: call(tag), 10))
                  for tag in ("other", "this", "this", "other")]
            print(f"{label}: " + ", ".join(f"{tag} {v:.3f} ms"
                                           for tag, v in ms))


if __name__ == "__main__":
    main()
