"""Run one cell of the port's benchmark and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``python3 -m port_bench.run`` works too).
The last line of standard output is the result's JSON object; the last
lines of standard error name each number that decided ``correct`` beside
its limit.  Exits non-zero, with no result, where CUDA is missing or has
fewer cards than the cell asks for, and where JAX or the JAX package got
loaded.

Every run fixes its host threads before it imports anything that starts
them: the process is pinned to the first ``THREADS`` CPUs it may use, and
OpenMP (the port's native library and torch), BLAS, the port's ETL and
torch's intra-op pool each get that many threads.  The line ``host
threads:`` on standard error records them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, _root)
    __package__ = "port_bench"

# The card machine's cores.
THREADS = 8
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS",
               "PARFASTAAI_ETL_THREADS")


def pin_host_threads() -> list[int]:
    """Pin this process to its first ``THREADS`` CPUs and give every
    thread pool that many threads; returns the CPUs."""
    cpus = sorted(os.sched_getaffinity(0))[:THREADS]
    os.sched_setaffinity(0, cpus)
    for key in THREAD_VARS:
        os.environ[key] = str(len(cpus))
    return cpus


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cpus = pin_host_threads()

    import torch

    import parfastaai_tpu_torch.cli  # noqa: F401 — the program under test
    from port_bench import harness

    torch.set_num_threads(len(cpus))
    print(f"host threads: CPUs {cpus}; {len(cpus)} threads each for "
          f"{', '.join(THREAD_VARS)} and torch ({torch.get_num_threads()})",
          file=sys.stderr)

    cell = harness.find_cell(harness.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on a card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    loaded = harness.jax_modules()
    if loaded:
        print(f"JAX or the JAX package got loaded: {loaded}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
