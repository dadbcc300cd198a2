"""Where the banded exact engine's time goes as the band height changes.

Run on a machine with an NVIDIA GPU:

    python -m parfastaai_tpu_torch.tools.exact_band_sweep [--genomes 4096]
        [--bands 512,480,512,480,256] [--device cuda]

Generates the synthetic database of the end-to-end runs (80 proteins, pool
1200, 400 tetramers per genome, seed 0), loads it once, and runs
``engine.compute_streamed_exact`` all-vs-all on the card once per listed
band height (a height may be listed twice, so that two heights take turns
within one call), printing each run's wall and stage split.  All CSVs must
hold the same bytes.  The native f64 finish walks a block's proteins at a
stride of band x band count cells; a band of 512 makes that stride a power
of two, a band of 480 does not, so the pair shows what cache-set aliasing
costs the ``host finish`` stage.  Prints the card's name and power limit
first; ``--device cpu`` (for a dry run at a small size) prints no card and
its times are no device times.
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

STAGES = ("host bucketize", "H2D", "Gram", "D2H", "host finish", "CSV write",
          "producer wait", "worker wait")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--genomes", type=int, default=4096)
    ap.add_argument("--bands", default="512,480,512,480,256")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except PFAAIError as e:
        raise SystemExit(f"exact_band_sweep: {e}") from e
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
        for band in (int(b) for b in args.bands.split(",")):
            out = os.path.join(tmp, f"band{band}.csv")
            phases: dict[str, float] = {}
            t0 = time.perf_counter()
            engine.compute_streamed_exact(
                presence, axes.row_db_ids, axes.col_db_ids, out,
                axes.query_names, axes.target_names, device, band=band,
                phases=phases,
            )
            wall = time.perf_counter() - t0
            with open(out, "rb") as fp:
                digests.add(hashlib.sha256(fp.read()).hexdigest())
            print(f"G={args.genomes} band {band} on {device}: wall "
                  f"{wall * 1e3:.1f} ms; "
                  + ", ".join(f"{k} {phases.get(k, 0.0) * 1e3:.1f}"
                              for k in STAGES))
        if len(digests) != 1:
            raise SystemExit("exact_band_sweep: the CSVs differ between bands")
        print(f"all {len(args.bands.split(','))} CSVs hold the same bytes")


if __name__ == "__main__":
    main()
