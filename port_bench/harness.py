"""The benchmark of the PyTorch port: one cell, one run, one result line.

A run makes the cell's database(s), and its query list in query-subset
mode, from ``--seed``, warms the CLI with one call, then drives
``parfastaai_tpu_torch.cli.run`` with the cell's flags in a closed loop
(one call in flight) for ``--seconds``, each call writing its CSV over the
same file in the run's temporary directory.  One more call after the
window writes a CSV of its own, which the plain reference
(``reference.py``) judges.  ``--trace 1`` runs the same loop with spans
and ``torch.profiler`` and reports the per-layer metrics instead of the
end-to-end ones.

Everything a cell is made of is found by name: the workload and its metrics
in ``BENCHMARK.json``, the configuration in the file that entry names, the
traffic in ``traffic/<name>.json`` and each metric's reader in
``metrics/<name>.py`` (a ``read(run)`` that returns a number, or None where
the run holds nothing to read).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from . import gen, reference, trace

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "parfastaai_tpu")


def process_age() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as fp:
            ticks = int(fp.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return None


START = time.perf_counter() - (process_age() or 0.0)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    chips: int
    home: str = HERE  # the benchmark's folder: traffic/, metrics/


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fp:
        return json.load(fp)


def _covers(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(bench: dict, name: str, root: str = ROOT,
              home: str = HERE) -> Cell:
    """The workload ``name`` with its configuration, traffic and metrics;
    ``root`` holds the configuration files' paths, ``home`` the traffic."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as fp:
        config = json.load(fp)
    with open(os.path.join(home, "traffic", w["traffic"] + ".json")) as fp:
        traffic = json.load(fp)
    gen.mode(config)
    if (traffic.get("loop", "closed"), traffic.get("in_flight", 1)) != (
            "closed", 1):
        raise ValueError(f"traffic {w['traffic']!r}: the harness runs a "
                         "closed loop with one call in flight")
    return Cell(
        name=name, config=config, traffic=traffic, chips=int(w["chips"]),
        home=home,
        end_to_end=[m for m in bench["end_to_end"] if _covers(m, name)],
        per_layer=[m for m in bench["per_layer"] if _covers(m, name)])


def reader(metric: str, home: str = HERE):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = os.path.join(home, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def make_databases(config: dict, seed: int, directory: str,
                   log=sys.stderr) -> gen.Databases:
    """``gen.make`` in a child process, so that none of the generator's
    memory stays in this process's resident set; the pages it wrote go to
    disk before it returns, and not in the background during the window."""
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.gen", json.dumps(config),
         str(seed), directory], cwd=ROOT, capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"the generator failed: {out.stderr[-2000:]}")
    made = json.loads(out.stdout.strip().splitlines()[-1])
    t0 = time.perf_counter()
    os.sync()
    print(f"database(s): {made['seconds']:.3f} s in the generator, "
          f"{time.perf_counter() - t0:.3f} s to sync; widths K_p "
          f"{made['widths']}", file=log)
    return gen.Databases(made["target"], made["query"],
                         np.asarray(made["widths"]), made["n_genomes"],
                         made["query_list"])


def rss_bytes() -> int:
    with open("/proc/self/statm") as fp:
        return int(fp.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def pairs_per_call(config: dict) -> int:
    """Genome pairs whose AJI one call writes: in query-subset mode each
    query against every other genome, each query pair once."""
    g, mode = config["n_genomes"], gen.mode(config)
    if mode == "query_target":
        return config["n_query_genomes"] * g
    if mode == "query_subset":
        q = config["n_query_genomes"]
        return q * (g - q) + q * (q - 1) // 2
    return g * (g - 1) // 2


class PeakRss:
    """The process's peak resident set while it runs: ``statm`` sampled
    every 20 ms from a thread (``VmHWM`` counts from process start, and
    some kernels refuse its reset through ``/proc/self/clear_refs``)."""

    def __init__(self):
        self._stop = threading.Event()
        self._peak = rss_bytes()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self) -> None:
        while not self._stop.wait(0.02):
            self._peak = max(self._peak, rss_bytes())

    def read(self) -> int:
        self._stop.set()
        self._thread.join()
        return max(self._peak, rss_bytes())


@dataclass
class Run:
    """What a run measured; the metric readers' input."""

    cell: Cell
    device_name: str
    seconds: float
    pairs_per_call: int
    widths: np.ndarray
    n_genomes: int
    setup_s: float = 0.0
    window_s: float = 0.0
    calls: list = field(default_factory=list)  # (ok, seconds) per call
    peak_rss_bytes: int = 0
    spans: trace.Spans | None = None
    trace: trace.Trace | None = None


def _argv(cell: Cell, dbs: gen.Databases, out: str, device: str) -> list[str]:
    argv = [dbs.target, out]
    if dbs.query:
        argv += ["-r", dbs.query]
    if dbs.query_list:
        argv += ["-q", dbs.query_list]
    return argv + list(cell.traffic["flags"]) + ["--quiet", "--device", device]


def _call(cli, argv, spans: trace.Spans | None) -> bool:
    if spans is None:
        return cli.run(argv) == 0
    with spans.span("call"):
        return cli.run(argv) == 0


def _window(run: Run, cli, argv, spans) -> None:
    t0 = time.perf_counter()
    end = t0
    while end - t0 < run.seconds:
        if spans is not None:
            spans.call += 1
        c0 = time.perf_counter()
        try:
            ok = _call(cli, argv, spans)
        except Exception as e:  # noqa: BLE001 — a failed call is counted
            print(f"call {len(run.calls)}: {type(e).__name__}: {e}",
                  file=sys.stderr)
            ok = False
        end = time.perf_counter()
        run.calls.append((ok, end - c0))
    run.window_s = end - t0


def _traced_window(run: Run, cli, argv, tmp: str, device: str) -> list[str]:
    """The window under spans and the profiler; returns the card's
    samples."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        activities.append(ProfilerActivity.CUDA)
    run.spans = trace.Spans()
    sampler = trace.CardSampler()
    sampler.start()
    try:
        with profile(activities=activities) as prof:
            with trace.instrument(cli, run.spans):
                with record_function(trace.PREFIX + "window"):
                    _window(run, cli, argv, run.spans)
                if device == "cuda":
                    torch.cuda.synchronize()
    finally:
        samples = sampler.stop()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    del prof
    run.trace = trace.read_trace(path)
    os.remove(path)
    return samples


def compared(cell: Cell) -> tuple[str, dict[str, float]]:
    """The comparison kind of the cell's output and each number's limit."""
    kind = cell.traffic["output"]
    limits = {"labels_differing": 0}
    if kind == "exact":
        limits.update(values_differing=0, text_rows_differing=0)
    else:
        limits["max_abs_gap"] = cell.traffic["max_abs_gap"]
    return kind, limits


def sample_rows(n_rows: int, seed: int, k: int = 32) -> np.ndarray:
    """Rows whose text the exact comparison reads, drawn from the seed,
    with the first and the last."""
    rng = np.random.default_rng(gen._seq(seed, 3))
    picks = rng.choice(n_rows, size=min(k, n_rows), replace=False)
    return np.unique(np.concatenate([[0, n_rows - 1], picks]))


def queries_of(dbs: gen.Databases) -> list[str] | None:
    """The query subset's names in list order, or None."""
    return reference.read_names(dbs.query_list) if dbs.query_list else None


def check(cell: Cell, dbs: gen.Databases, csv_path: str, seed: int,
          device: str) -> dict[str, dict]:
    """The checked call's CSV against the plain reference: each number
    compared with its limit."""
    kind, limits = compared(cell)
    ref = reference.aji(dbs.target, dbs.query, queries=queries_of(dbs),
                        device=device, empty_is_zero=(kind == "f32"))
    got = reference.read_csv(csv_path)
    numbers = reference.compare(got, ref, kind,
                                sample_rows(len(ref.row_names), seed))
    # A number that is not finite (a missing cell) is no reading: None.
    return {k: {"value": v if np.isfinite(v) else None, "limit": limits[k]}
            for k, v in numbers.items()}


def passes(checks: dict[str, dict]) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def jax_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules
                   if m.split(".", 1)[0] in FORBIDDEN})


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", log=sys.stderr) -> dict:
    """One run of ``cell``; returns the result line's object."""
    import torch

    import parfastaai_tpu_torch.cli as cli

    if device == "cuda":
        device_name = torch.cuda.get_device_name(0)
        print(f"card: {trace.card_name_and_limit()}", file=log)
    else:
        device_name = "cpu"
    with tempfile.TemporaryDirectory(prefix="port_bench_") as tmp:
        t0 = time.perf_counter()
        rss0 = rss_bytes()
        dbs = make_databases(cell.config, seed, tmp, log)
        t1 = time.perf_counter()
        rss1 = rss_bytes()
        run = Run(cell=cell, device_name=device_name, seconds=seconds,
                  pairs_per_call=pairs_per_call(cell.config),
                  widths=dbs.widths, n_genomes=dbs.n_genomes)
        argv = _argv(cell, dbs, os.path.join(tmp, "window.csv"), device)
        warm_ok = cli.run(argv) == 0
        if device == "cuda":
            torch.cuda.synchronize()
        gc.collect()
        rss2 = rss_bytes()
        rss = PeakRss()
        run.setup_s = time.perf_counter() - START
        print(f"set-up {run.setup_s:.3f} s: imports and start "
              f"{t0 - START:.3f} s, database(s) {t1 - t0:.3f} s, warm call "
              f"{run.setup_s - (t1 - START):.3f} s; RSS before the database(s) "
              f"{rss0} B, after {rss1} B, after the warm call {rss2} B",
              file=log)
        samples = []
        if traced:
            samples = _traced_window(run, cli, argv, tmp, device)
        else:
            _window(run, cli, argv, None)
        run.peak_rss_bytes = rss.read()
        if samples:
            print("card samples (clocks.sm, power.draw, power.limit, "
                  f"temperature): {samples}", file=log)
        print(f"window {run.window_s:.3f} s: calls (ok, s) {run.calls}; "
              f"peak RSS {run.peak_rss_bytes} B", file=log)
        if run.spans is not None:
            for name in ("etl", "engine", "csv"):
                print(f"{name} s per call: {run.spans.per_call(name)}",
                      file=log)
            total: dict[str, float] = {}
            for _, phases in run.spans.phases:
                for key, seconds in phases.items():
                    total[key] = total.get(key, 0.0) + seconds
            print("engine phases, ms a call: " + ", ".join(
                f"{k} {1e3 * v / len(run.calls):.1f}"
                for k, v in total.items()), file=log)
        out = os.path.join(tmp, "checked.csv")
        t0 = time.perf_counter()
        try:
            checked_ok = cli.run(_argv(cell, dbs, out, device)) == 0
        except Exception as e:  # noqa: BLE001 — a failed call is counted
            print(f"checked call: {type(e).__name__}: {e}", file=log)
            checked_ok = False
        memory_peak = (torch.cuda.max_memory_reserved()
                       if device == "cuda" else 0)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        if checked_ok:
            checks = check(cell, dbs, out, seed, device)
        else:
            checks = {k: {"value": None, "limit": v}
                      for k, v in compared(cell)[1].items()}
        print(f"checked call {t1 - t0:.3f} s, reference and comparison "
              f"{time.perf_counter() - t1:.3f} s", file=log)
    failed = sum(not ok for ok, _ in run.calls) + (not checked_ok)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = reader(m["name"], cell.home)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": bool(warm_ok and failed == 0 and passes(checks)),
        "attempted": len(run.calls) + 1,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": device_name, "count": 1,
                   "memory_peak_bytes": int(memory_peak)},
    }
    if traced and run.trace is not None:
        busy = trace.length(run.trace.busy())
        result["device"].update(busy_s=busy, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_by_span()}
    result["checks"] = checks
    return result
