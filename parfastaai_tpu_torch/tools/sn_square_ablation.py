"""What binds the sn_square_wgmma kernel: times of
csrc/sn_square_wgmma.cu with one part of its block body cut.

Run on a machine with an NVIDIA GPU and nvcc:

    python -m parfastaai_tpu_torch.tools.sn_square_ablation [--update U ...]

The square counterpart of ``tools.sn_rect_ablation``, with its cuts of the
block body that the two kernels share (csrc/sn_wgmma.cuh): the kernel as it
is, without the global loads after the ring's first fill (``noload``: the
products and the epilogue alone), without the wgmma products (``nomma``:
the feed from L2 and the epilogue on zero counts alone), and without the
epilogue's transform (``noepi``).  The cut copies compute nothing useful;
only their times mean something.  ``--update`` names the body's updates to
time, each of ``lean`` (the default plans; ``base`` and ``f32gram`` run
it too), ``pipe``, ``fused`` / ``mxu_outer`` (the two-count-set bodies;
one launch), ``counts`` (one count set a pair, no transform) and
``packed`` (``lean`` on nibble-packed rows, split into low and high
nibbles on chip; default: ``lean``); the cuts apply to every update, so
``noepi`` against ``full`` of ``pipe`` is the epilogue that its schedule
leaves exposed.  Each is timed with CUDA events over the upper-triangle
tiles at the whole-matrix bench's shape (P=80, G=4096) at K = 1280 and
2560 presence columns and at the K-blocked shape (P=16, G=1024,
K=51200), and the feed-only time is also given as bytes per second out
of L2 (every block's rows of every slice: packed rows are half as many
bytes).  Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import tempfile

import torch

from ..ops import sn_rect, sn_square
from .sn_rect_ablation import build_variants, cuda_ms

SHAPES = [(80, 4096, 1280), (80, 4096, 2560), (16, 1024, 51200)]
# csrc/sn_square_wgmma.cu's C entry: m, t, tiles, s, n; P, G, K, n_blocks,
# mirror, mode, update, packed, walk, walk_arg; the stream
N_POINTERS, N_INTS = 5, 10
# the choices of --update: the body's updates, and lean on packed rows
UPDATES = sorted({*sn_square._WGMMA_UPDATES, "packed"})


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--update", nargs="+", default=["lean"],
                    choices=UPDATES)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU with CUDA")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip())
    gen = torch.Generator(device=dev).manual_seed(0)
    tile = sn_square.WGMMA_TILE
    with tempfile.TemporaryDirectory(prefix="sn_square_ablation_") as tmp:
        libs = build_variants(tmp, "sn_square_wgmma.cu",
                              "sn_square_wgmma_launch", N_POINTERS, N_INTS)
        for P, G, K in SHAPES:
            m = (torch.rand((P, G, K), generator=gen, device=dev) < 0.3125).to(
                torch.uint8)
            t = sn_rect.clamp_t(m.sum(dim=2, dtype=torch.int32))
            mp = sn_square.pack_nibbles(m)
            tiles = sn_square._tile_list(-(-G // tile), True, dev)
            s = torch.empty((G, G), dtype=torch.float32, device=dev)
            n = torch.empty((G, G), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            n_tiles = tiles.shape[0]
            macs = n_tiles * tile * tile * K * P
            for update in args.update:
                packed = update == "packed"
                code = sn_square._WGMMA_UPDATES["lean" if packed else update]
                rows = mp if packed else m
                kb = rows.shape[2]
                staged = n_tiles * 2 * tile * kb * P

                def launch(lib):
                    rc = lib.sn_square_wgmma_launch(
                        rows.data_ptr(), t.data_ptr(), tiles.data_ptr(),
                        s.data_ptr(), n.data_ptr(), P, G, kb, n_tiles, 1, 0,
                        code, int(packed), 0, 0, stream)
                    if rc != 0:
                        raise SystemExit(f"launch failed: cudaError {rc}")

                ms = {name: cuda_ms(lambda lib=lib: launch(lib))
                      for name, lib in libs.items()}
                print(
                    f"sn_square_wgmma {update} P={P} G={G} K={K} ({n_tiles} "
                    "triu tiles): "
                    + ", ".join(f"{name} {v:.3f} ms" for name, v in ms.items())
                    + f"; feed alone {staged / ms['nomma'] / 1e9:.3f} TB/s out "
                    f"of L2, products alone {macs / ms['noload'] / 1e9:.3f} "
                    "TMAC/s", flush=True,
                )
            del m, mp
    sys.stdout.flush()


if __name__ == "__main__":
    main()
