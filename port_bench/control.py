"""Readings that set the limits of ``correct``: the program's, and the
control's.

    python3 -m port_bench.control --workload <name> --seeds <n> [<n> ...]

For each seed, in one process: the cell's database(s) and query list, one
CLI call with the cell's flags writing a real CSV (the checked call of a
run), and its numbers against the plain reference (the program's reading);
then the reference itself computed one precision below what the
configuration states, put in the program's place (the control's reading):
float32 for the f64 output, bfloat16 for the f32 output.  One JSON line per
seed.  The limits sit above every program reading and below every control
reading; ``PERF.md`` gives both.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import gen, harness, reference

LOWER = {"exact": torch.float32, "f32": torch.bfloat16}


def as_csv(matrix: reference.Matrix, rows: np.ndarray) -> reference.Csv:
    """``matrix`` as the CSV it would write, with the text of ``rows``."""
    lines = [b""] * len(matrix.row_names)
    for i in rows:
        lines[i] = (matrix.row_names[i] + reference.SEP + reference.SEP.join(
            reference.format_double(v) for v in matrix.aji[i])).encode()
    return reference.Csv(list(matrix.col_names), list(matrix.row_names),
                         matrix.aji, lines, 0)


def control_numbers(cell: harness.Cell, dbs: gen.Databases, seed: int,
                    device: str) -> dict[str, float]:
    """The control's numbers: the reference in the next lower precision
    against the reference."""
    kind, _ = harness.compared(cell)
    tdb = reference.read_database(dbs.target)
    qdb = reference.read_database(dbs.query) if dbs.query else None
    queries = harness.queries_of(dbs)
    want = reference.aji(tdb, qdb, queries=queries, device=device,
                         empty_is_zero=kind == "f32")
    low = reference.aji(tdb, qdb, queries=queries, device=device,
                        dtype=LOWER[kind], empty_is_zero=kind == "f32")
    rows = harness.sample_rows(len(want.row_names), seed)
    return reference.compare(as_csv(low, rows), want, kind, rows)


def readings(cell: harness.Cell, seed: int, device: str) -> dict:
    """One seed's program and control readings."""
    import parfastaai_tpu_torch.cli as cli

    with tempfile.TemporaryDirectory(prefix="port_bench_") as tmp:
        dbs = gen.make(cell.config, seed, tmp)
        out = os.path.join(tmp, "checked.csv")
        t0 = time.perf_counter()
        rc = cli.run(harness._argv(cell, dbs, out, device))
        t1 = time.perf_counter()
        program = (harness.check(cell, dbs, out, seed, device) if rc == 0
                   else None)
        t2 = time.perf_counter()
        control = control_numbers(cell, dbs, seed, device)
    return {"workload": cell.name, "seed": seed, "rc": rc,
            "program": program, "control": control,
            "call_s": t1 - t0, "reference_s": t2 - t1,
            "control_s": time.perf_counter() - t2}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
