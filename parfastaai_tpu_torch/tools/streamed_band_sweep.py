"""Where the f32 streamed engine's time goes as the band height changes.

Run on a machine with an NVIDIA GPU:

    python -m parfastaai_tpu_torch.tools.streamed_band_sweep [--genomes 4096]
        [--bands 1024,512,1024,512,256] [--slab-mib 16] [--device cuda]

Generates the synthetic database of the end-to-end runs (80 proteins, pool
1200, 400 tetramers per genome, seed 0), loads it once, and runs
``engine.compute_streamed`` all-vs-all on the card once per listed band
height with the CLI's default column chunk (a height may be listed twice,
so that two heights take turns within one call), printing each run's wall
and stage split.  All CSVs must hold the same bytes.  The writer thread
formats one band at a time: at 4096 genomes a band of 1024 rows is 33.5 MB
as f64, a band of 512 rows half of that, so the pair shows what the size
of the writer's per-band arrays costs the ``CSV write`` stage.
``--slab-mib`` sets the size of the f64 slab that the writer converts and
formats at a time (``engine._FORMAT_SLAB_BYTES``; one value, or one per
listed band, so that two sizes take turns; 64 MiB holds a whole 1024 x
4096 band).  Prints the
card's name and power limit first; ``--device cpu`` (for a dry run at a
small size) prints no card and its times are no device times.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import tempfile
import time

from .. import engine
from ..device import resolve_device
from ..etl.database import SCPDatabase
from ..modes import all_vs_all_axes
from ..types import PFAAIError
from .synth_db import generate

STAGES = ("gather", "kernel", "AJI mask", "D2H", "host assembly", "CSV write",
          "producer wait", "writer wait")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomes", type=int, default=4096)
    ap.add_argument("--bands", default="1024,512,1024,512,256")
    ap.add_argument("--slab-mib", default="")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    bands = [int(b) for b in args.bands.split(",")]
    default_mib = engine._FORMAT_SLAB_BYTES / 2**20
    slabs = [float(x) for x in args.slab_mib.split(",") if x] or [default_mib]
    if len(slabs) == 1:
        slabs *= len(bands)
    if len(slabs) != len(bands):
        raise SystemExit("streamed_band_sweep: --slab-mib takes one value or "
                         "one per band")
    try:
        device = resolve_device(args.device)
    except PFAAIError as e:
        raise SystemExit(f"streamed_band_sweep: {e}") from e
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip())
    with tempfile.TemporaryDirectory(prefix="parfastaai_sweep_") as tmp:
        path = os.path.join(tmp, "synth.db")
        generate(path, n_genomes=args.genomes, n_proteins=80, pool_size=1200,
                 tetras_per_genome=400, seed=0)
        db = SCPDatabase(path)
        try:
            presence = db.load_presence()
        finally:
            db.close()
        axes = all_vs_all_axes(db.meta)
        engine.to_device_buckets(presence, device)  # upload once, untimed
        digests = set()
        slab_default = engine._FORMAT_SLAB_BYTES
        for band, mib in zip(bands, slabs):
            out = os.path.join(tmp, f"band{band}.csv")
            phases: dict[str, float] = {}
            engine._FORMAT_SLAB_BYTES = int(mib * 2**20)
            try:
                t0 = time.perf_counter()
                engine.compute_streamed(
                    presence, axes.row_db_ids, axes.col_db_ids, out,
                    axes.query_names, axes.target_names, device, band=band,
                    phases=phases,
                )
                wall = time.perf_counter() - t0
            finally:
                engine._FORMAT_SLAB_BYTES = slab_default
            with open(out, "rb") as fp:
                digests.add(hashlib.sha256(fp.read()).hexdigest())
            print(f"G={args.genomes} band {band} slab {mib:g} MiB on "
                  f"{device}: wall "
                  f"{wall * 1e3:.1f} ms; "
                  + ", ".join(f"{k} {phases.get(k, 0.0) * 1e3:.1f}"
                              for k in STAGES))
        if len(digests) != 1:
            raise SystemExit(
                "streamed_band_sweep: the CSVs differ between bands")
        print(f"all {len(bands)} CSVs hold the same bytes")


if __name__ == "__main__":
    main()
