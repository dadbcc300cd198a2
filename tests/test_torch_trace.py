"""The port's span recorder (``parfastaai_tpu_torch.utils.timing``) on the
CPU: nothing recorded and no ``record_function`` while it is off; under
``torch.profiler`` every span of the default call (banded route) and of the
``-r`` call (dense route) with its parent, one call id per ``cli.run`` and
the worker's spans under the engine span; a ``-r`` call's ATTACH and SCP
join as leaves of ``cli.open``; the engines' ``phases`` equal to
their spans' sums key by key; spans closed on an exception; the verbose
lines' text; ``--profile``'s trace holding the worker's spans on the
trace's clock; a ``--quiet --fast`` call that never synchronises in its
stage clock; a dense ``-q`` call's query list, finish split, Gram and
mirror counters; and the dense ``compute``'s host finish on the CPU
(``device_finish_pairs`` 0)."""

import io
import json
import os
import re
import sqlite3
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from parfastaai_tpu_torch import cli, engine, modes, native
from parfastaai_tpu_torch.etl.database import SCPDatabase
from parfastaai_tpu_torch.tools.synth_db import generate
from parfastaai_tpu_torch.utils import timing

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G_TARGET, G_QUERY = 40, 12


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """A 40-genome target DB and a 12-genome query DB (5 proteins, disjoint
    genome names)."""
    d = tmp_path_factory.mktemp("torch_trace")
    target, query = str(d / "target.db"), str(d / "query.db")
    generate(target, n_genomes=G_TARGET, n_proteins=5, pool_size=300,
             tetras_per_genome=100, seed=5)
    generate(query, n_genomes=G_QUERY, n_proteins=5, pool_size=300,
             tetras_per_genome=100, seed=6)
    with sqlite3.connect(query) as conn:
        conn.execute(
            "UPDATE genome_metadata SET genome_name = 'q_' || genome_name")
    return {"target": target, "query": query}


@pytest.fixture(scope="module")
def single(dbs):
    db = SCPDatabase(dbs["target"])
    presence = db.load_presence()
    db.close()
    return db.meta, presence


def _profiled_call(argv) -> timing.Call:
    """``cli.run(argv)`` under ``torch.profiler``; its recorded call."""
    before = len(timing.calls) and timing.calls[-1]
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.run(argv) == 0
    assert timing.calls[-1] is not before
    return timing.calls[-1]


def _by_name(c: timing.Call) -> dict[str, list[timing.Span]]:
    out: dict[str, list[timing.Span]] = {}
    for s in c.spans:
        out.setdefault(s.name, []).append(s)
    return out


def _parent_names(c: timing.Call) -> dict[str, set]:
    ids = {s.id: s.name for s in c.spans}
    out: dict[str, set] = {}
    for s in c.spans:
        out.setdefault(s.name, set()).add(ids.get(s.parent))
    return out


def test_off_records_nothing_and_calls_no_record_function(
        dbs, tmp_path, monkeypatch):
    made = []
    real = torch.profiler.record_function

    def spy(*args, **kwargs):
        made.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    before = list(timing.calls)
    out = tmp_path / "off.csv"
    assert cli.run([dbs["target"], str(out), "--quiet", "--device", "cpu"]) == 0
    assert cli.run([dbs["target"], str(tmp_path / "qt.csv"), "--quiet",
                    "--device", "cpu", "-r", dbs["query"]]) == 0
    assert list(timing.calls) == before and made == []
    # outside a recorded call, without phases: one shared object, nothing
    # allocated for it
    assert timing.span("engine") is timing.span("cli.run") is timing._NULL
    assert not timing.active() and timing.handoff() is None
    # the spy sees a recorded call's spans
    with timing.recording():
        assert cli.run([dbs["target"], str(out), "--quiet", "--device",
                        "cpu"]) == 0
    assert ("pfaai.cli.run",) in made and ("pfaai.engine",) in made


BANDED = {
    "cli.open": "cli.run", "cli.pairs": "cli.run", "etl": "cli.run",
    "etl.widths": "etl", "etl.alloc": "etl", "etl.fill": "etl",
    "engine": "cli.run", "engine.open": "engine",
    "engine.bucketize": "engine", "engine.upload": "engine",
    "engine.block": "engine", "engine.gram": "engine.block",
    "engine.producer_wait": "engine", "engine.tail": "engine",
    "worker.wait": "engine", "worker.finish": "engine",
    "worker.csv": "engine", "cli.free": "cli.run",
}
DENSE = {
    "cli.open": "cli.run", "cli.attach": "cli.open", "cli.join": "cli.open",
    "cli.pairs": "cli.run", "etl": "cli.run",
    "etl.widths": "etl", "etl.alloc": "etl", "etl.fill": "etl",
    "etl.merge": "etl", "engine": "cli.run", "engine.upload": "engine",
    "engine.gram": "engine", "engine.d2h": "engine",
    "engine.finish": "engine", "csv": "cli.run", "cli.free": "cli.run",
}


@pytest.mark.parametrize("route", ["banded", "dense_qt"])
def test_profiled_call_records_every_span_with_its_parent(
        route, dbs, single, tmp_path, monkeypatch):
    argv = [dbs["target"], str(tmp_path / "x.csv"), "--quiet", "--device",
            "cpu"]
    if route == "banded":
        monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
        want = BANDED
    else:
        argv += ["-r", dbs["query"]]
        want = DENSE
    c = _profiled_call(argv)
    names, parents = _by_name(c), _parent_names(c)
    assert len(names["cli.run"]) == 1 and parents["cli.run"] == {None}
    for name, parent in want.items():
        assert name in names, name
        assert parents[name] == {parent}, name
    # one call id, every span inside the call's own span
    root = names["cli.run"][0]
    assert {s.call for s in c.spans} == {c.id}
    assert all(root.start <= s.start <= s.end <= root.end for s in c.spans)
    # counters where the work is counted
    (etl,) = names["etl"]
    assert 0 < etl.counters["useful_bytes"] <= etl.counters["presence_bytes"]
    (pairs,) = names["cli.pairs"]
    if route == "banded":
        assert pairs.counters["pairs"] == G_TARGET * (G_TARGET - 1) // 2
        (eng,) = names["engine"]
        assert eng.counters["blocks"] == len(names["engine.block"]) > 0
        assert eng.counters["mirrored"] == 0
        assert sum(s.counters["rows"] for s in names["worker.csv"]) == G_TARGET
    else:
        assert pairs.counters["pairs"] == G_TARGET * G_QUERY
        assert len(names["etl.fill"]) == 2  # the two databases
        assert names["csv"][0].counters["rows"] == G_QUERY
        assert names["csv"][0].counters["mirrored"] == 0
        # one Gram a shared protein over the union of both databases
        (gram,) = names["engine.gram"]
        n_prot = len(single[0].protein_set)  # both databases have them all
        assert gram.counters == {
            "gram_cells": n_prot * (G_TARGET + G_QUERY) ** 2,
            "gathered": n_prot * G_TARGET * G_QUERY}


G_QSUB, Q_QSUB, P_QSUB = 1200, 600, 4


@pytest.fixture(scope="module")
def qsub(tmp_path_factory):
    """A 1200-genome DB of 4 proteins and a list of 600 of its genomes in
    reverse database order: a dense ``-q`` call whose finish takes
    milliseconds on the CPU, well above its spans' own cost."""
    d = tmp_path_factory.mktemp("torch_trace_qsub")
    path, listed = str(d / "qsub.db"), str(d / "queries.txt")
    generate(path, n_genomes=G_QSUB, n_proteins=P_QSUB, pool_size=300,
             tetras_per_genome=100, seed=7)
    db = SCPDatabase(path)
    names = db.meta.genome_set[::-1][:Q_QSUB]
    db.close()
    with open(listed, "w") as fp:
        fp.write("\n".join(names) + "\n")
    return path, listed


def test_query_subset_call_records_its_list_finish_split_and_counters(
        qsub, tmp_path):
    """A dense ``-q`` call: ``cli.queries`` (a leaf, counter ``queries``),
    the finish's two children inside ``engine.finish`` with no ``phases``
    key and most of its time, the Gram's computed and kept entries, and
    the CSV's mirrored pairs."""
    path, listed = qsub
    c = _profiled_call([path, str(tmp_path / "q.csv"), "-q", listed,
                        "--quiet", "--device", "cpu"])
    names, parents = _by_name(c), _parent_names(c)
    q, g = Q_QSUB, G_QSUB
    n_pairs = q * (g - q) + q * (q - 1) // 2
    (queries,) = names["cli.queries"]
    assert parents["cli.queries"] == {"cli.run"}
    assert queries.counters == {"queries": q}
    assert queries.id not in {s.parent for s in c.spans}
    assert names["cli.pairs"][0].counters["pairs"] == n_pairs
    (gram,) = names["engine.gram"]
    assert gram.counters == {"gram_cells": P_QSUB * g * g,
                             "gathered": P_QSUB * n_pairs}
    (finish,) = names["engine.finish"]
    (gather,) = names["engine.finish.gather"]
    (total,) = names["engine.finish.sum"]
    assert parents["engine.finish.gather"] == {"engine.finish"}
    assert parents["engine.finish.sum"] == {"engine.finish"}
    assert finish.key == "host finish"
    assert gather.key is None and total.key is None
    assert (finish.start <= gather.start <= gather.end <= total.start
            <= total.end <= finish.end)
    inside = (gather.end - gather.start) + (total.end - total.start)
    assert inside > 0.5 * (finish.end - finish.start)
    (csv,) = names["csv"]
    assert csv.counters == {"rows": q, "mirrored": q * (q - 1) // 2}


@pytest.mark.parametrize("mode", ["avsa", "qt", "qsub"])
def test_csv_counts_its_mirrored_pairs(mode, dbs, single, tmp_path):
    """``csv``'s ``mirrored``: every pair of a dense all-vs-all call, none
    of a ``-r`` call, the query pairs of a ``-q`` call."""
    argv = [dbs["target"], str(tmp_path / "m.csv"), "--quiet", "--device",
            "cpu"]
    want = G_TARGET * (G_TARGET - 1) // 2
    if mode == "qt":
        argv += ["-r", dbs["query"]]
        want = 0
    elif mode == "qsub":
        listed = tmp_path / "queries.txt"
        listed.write_text("\n".join(single[0].genome_set[:G_QUERY]))
        argv += ["-q", str(listed)]
        want = G_QUERY * (G_QUERY - 1) // 2
    with timing.recording():
        assert cli.run(argv) == 0
    (csv,) = _by_name(timing.calls[-1])["csv"]
    assert csv.counters["mirrored"] == want


@pytest.mark.parametrize("mode", ["avsa", "qt", "qsub"])
def test_dense_compute_on_the_cpu_finishes_on_the_host(mode, dbs, single):
    """``engine.compute`` on the CPU: the host finish, its gather and sum
    inside ``engine.finish`` after the counts' ``engine.d2h``, and
    ``device_finish_pairs`` 0 (the card's finish would count every
    pair)."""
    meta, presence = single
    if mode == "qt":
        from parfastaai_tpu_torch.etl.database import QueryTargetDatabase

        db = QueryTargetDatabase(dbs["target"], dbs["query"])
        meta, presence = db.meta, db.load_presence()
        db.close()
        pairs = modes.query_target(meta)
    elif mode == "qsub":
        pairs = modes.query_subset(meta, meta.genome_set[:G_QUERY])
    else:
        pairs = modes.all_vs_all(meta)
    with timing.call(force=True) as c:
        engine.compute(presence, pairs, CPU)
    names, parents = _by_name(c), _parent_names(c)
    (fin,) = names["engine.finish"]
    (d2h,) = names["engine.d2h"]
    assert fin.counters == {"device_finish_pairs": 0}
    assert parents["engine.finish.gather"] == {"engine.finish"}
    assert parents["engine.finish.sum"] == {"engine.finish"}
    assert d2h.end <= fin.start


@pytest.mark.parametrize("mode", ["avsa", "qt", "qsub"])
def test_two_database_open_records_attach_and_join(mode, dbs, single,
                                                    tmp_path):
    """A ``-r`` call's ``cli.open`` holds two leaves, ``cli.attach`` and
    then ``cli.join`` (counter ``shared_scps``: P); a one-database call
    (all-vs-all, ``-q``) records neither."""
    argv = [dbs["target"], str(tmp_path / "o.csv"), "--quiet", "--device",
            "cpu"]
    if mode == "qt":
        argv += ["-r", dbs["query"]]
    elif mode == "qsub":
        listed = tmp_path / "queries.txt"
        listed.write_text("\n".join(single[0].genome_set[:G_QUERY]))
        argv += ["-q", str(listed)]
    with timing.recording():
        assert cli.run(argv) == 0
    c = timing.calls[-1]
    names, parents = _by_name(c), _parent_names(c)
    (opened,) = names["cli.open"]
    if mode != "qt":
        assert "cli.attach" not in names and "cli.join" not in names
        return
    (attach,) = names["cli.attach"]
    (join,) = names["cli.join"]
    assert parents["cli.attach"] == parents["cli.join"] == {"cli.open"}
    assert not {attach.id, join.id} & {s.parent for s in c.spans}
    assert (opened.start <= attach.start <= attach.end <= join.start
            <= join.end <= opened.end)
    assert attach.key is None and join.key is None
    assert attach.counters == {}
    assert join.counters == {"shared_scps": len(single[0].protein_set)}


@pytest.mark.parametrize("loader", ["native", "no_native"])
def test_union_fill_counts_its_mapped_columns(dbs, tmp_path, monkeypatch,
                                              loader):
    """A ``-r`` call records the union (``etl.merge``) and one ``etl.fill``
    a database, whose ``mapped_columns`` add up to both databases' widths;
    a one-database call maps nothing."""
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    if loader == "no_native":
        monkeypatch.setenv("PARFASTAAI_NO_NATIVE", "1")
        monkeypatch.setattr(native, "_TRIED", False)
        monkeypatch.setattr(native, "_LIB", None)
    widths = 0
    for path in (dbs["target"], dbs["query"]):
        db = SCPDatabase(path)
        widths += int(db.load_presence().widths.sum())
        db.close()
    with timing.recording():
        assert cli.run([dbs["target"], str(tmp_path / "qt.csv"), "--quiet",
                        "--device", "cpu", "-r", dbs["query"]]) == 0
        qt = _by_name(timing.calls[-1])
        assert cli.run([dbs["target"], str(tmp_path / "one.csv"), "--quiet",
                        "--device", "cpu"]) == 0
        one = _by_name(timing.calls[-1])
    assert len(qt["etl.merge"]) == 1 and len(qt["etl.fill"]) == 2
    assert sum(s.counters["mapped_columns"] for s in qt["etl.fill"]) == widths
    assert "etl.merge" not in one
    assert sum(s.counters.get("mapped_columns", 0)
               for s in one["etl.fill"]) == 0


def test_worker_spans_carry_the_call_and_the_engine_span(
        dbs, tmp_path, monkeypatch):
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    argv = [dbs["target"], str(tmp_path / "x.csv"), "--quiet", "--device",
            "cpu"]
    first, second = _profiled_call(argv), _profiled_call(argv)
    assert first.id != second.id
    for c in (first, second):
        (eng,) = _by_name(c)["engine"]
        workers = [s for s in c.spans if s.thread == "pfaai-exact-finish"]
        assert {s.name for s in workers} == {
            "worker.wait", "worker.finish", "worker.csv"}
        assert {(s.call, s.parent) for s in workers} == {(c.id, eng.id)}
        assert all(eng.start <= s.start <= s.end <= eng.end for s in workers)


def _recorded(fn) -> tuple[dict, timing.Call]:
    phases: dict = {}
    with timing.call(force=True) as c:
        fn(phases)
    return phases, c


def _engine_runs(single, tmp_path):
    meta, presence = single
    axes = modes.all_vs_all_axes(meta)
    pairs = modes.all_vs_all(meta)
    out = str(tmp_path / "e.csv")
    ids = (presence, axes.row_db_ids, axes.col_db_ids, out,
           axes.query_names, axes.target_names, CPU)
    return {
        "banded": lambda ph: engine.compute_streamed_exact(
            *ids, band=7, col_chunk=5, phases=ph),
        "streamed": lambda ph: engine.compute_streamed(
            *ids, band=7, col_chunk=5, phases=ph),
        "dense": lambda ph: engine.compute(presence, pairs, CPU, phases=ph),
        "dense_qsub": lambda ph: engine.compute(
            presence, modes.query_subset(meta, list(meta.genome_set[::-3])),
            CPU, phases=ph),
        "fast": lambda ph: engine.compute_fast(presence, pairs, CPU,
                                               phases=ph),
    }


@pytest.mark.parametrize("route", ["banded", "streamed", "dense", "fast",
                                   "dense_qsub"])
def test_phases_equal_the_spans_key_by_key(route, single, tmp_path):
    """Each ``phases`` key holds the summed seconds of the spans recorded
    under it (on the CPU every stage is host-timed; the banded engines'
    ``D2H`` is a CUDA-event sum, 0 here, with no span)."""
    meta, presence = single
    presence.__dict__.pop("_torch_cache", None)  # upload anew
    phases, c = _recorded(_engine_runs(single, tmp_path)[route])
    assert phases
    keyed = {s.key for s in c.spans if s.key is not None}
    assert keyed <= set(phases)
    for key, seconds in phases.items():
        spans = [s.end - s.start for s in c.spans if s.key == key]
        assert sum(spans) == pytest.approx(seconds, rel=1e-9, abs=1e-12), key
        assert spans or (key == "D2H" and route in ("banded", "streamed"))


def test_spans_close_on_an_exception(dbs, tmp_path, monkeypatch):
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    monkeypatch.setenv("PARFASTAAI_TEST_WORKER_FAULT", "1")
    with timing.recording():
        with pytest.raises(RuntimeError, match="injected finish-worker"):
            cli.run([dbs["target"], str(tmp_path / "x.csv"), "--quiet",
                     "--device", "cpu"])
    c = timing.calls[-1]
    names = _by_name(c)
    for name in ("cli.run", "engine", "engine.tail", "cli.free"):
        (s,) = names[name]
        assert s.start <= s.end, name
    assert not timing.active()
    # a bare span too, and the thread's stack unwinds
    with timing.call(force=True) as bare:
        with pytest.raises(ValueError):
            with timing.span("outer"):
                with timing.span("inner"):
                    raise ValueError("x")
        with timing.span("after"):
            pass
    parents = _parent_names(bare)
    assert parents["inner"] == {"outer"} and parents["after"] == {"cli.run"}


def test_phase_timer_keeps_its_line():
    pattern = re.compile(
        r"^JAC \+ AJI          : \d+\.\d ms; peak RSS \d+\.\d MB\n$")
    for recorded in (False, True):
        out = io.StringIO()
        with timing.call(force=recorded) as c:
            with timing.phase_timer("JAC + AJI          ", out=out,
                                    name="engine"):
                timing.count(blocks=2)
        assert pattern.match(out.getvalue()), out.getvalue()
        if recorded:
            (eng,) = _by_name(c)["engine"]
            assert eng.counters == {"blocks": 2}
    quiet = io.StringIO()
    with timing.phase_timer("CSV write          ", out=quiet, enabled=False):
        pass
    assert quiet.getvalue() == ""


def test_verbose_cli_lines_keep_their_text(dbs, tmp_path):
    """The CLI's phase lines, as an operator sees them (a fresh process:
    the timers print through the stdout taken at import)."""
    out = subprocess.run(
        [sys.executable, "-m", "parfastaai_tpu_torch", dbs["target"],
         str(tmp_path / "v.csv"), "--device", "cpu", "-r", dbs["query"]],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    for label in ("DB open + metadata ", "Presence ETL       ",
                  "  Column merge     ", "JAC + AJI          ",
                  "CSV write          "):
        pattern = re.compile(
            "^" + re.escape(label) + r": \d+\.\d ms; peak RSS \d+\.\d MB$")
        assert sum(bool(pattern.match(ln)) for ln in lines) == 1, label


def test_profile_trace_holds_the_worker_spans(dbs, tmp_path, monkeypatch):
    monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")
    trace_dir = tmp_path / "prof"
    assert cli.run([dbs["target"], str(tmp_path / "x.csv"), "--quiet",
                    "--device", "cpu", "--profile", str(trace_dir)]) == 0
    events = json.loads(
        (trace_dir / cli.PROFILE_TRACE).read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "pfaai_span"]
    (eng,) = [e for e in ours if e["name"] == "engine"]
    workers = [e for e in ours if e["name"].startswith("worker.")]
    assert {e["name"] for e in workers} == {
        "worker.wait", "worker.finish", "worker.csv"}
    assert len({e["tid"] for e in workers}) == 1
    assert workers[0]["tid"] != eng["tid"]
    assert all(eng["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= eng["ts"] + eng["dur"] for e in workers)
    assert all(e["args"]["parent"] == eng["args"]["id"] for e in workers)
    # the appended copy of a main-thread span sits on its profiler range
    (annotated,) = [e for e in events if e.get("cat") == "user_annotation"
                    and e["name"] == timing.PREFIX + "engine"]
    assert abs(annotated["ts"] - eng["ts"]) < 1e3  # µs
    assert abs(annotated["dur"] - eng["dur"]) < 1e3
    names = {e["args"]["name"] for e in events
             if e.get("ph") == "M" and e["tid"] == eng["tid"]}
    assert names == {"pfaai MainThread"}


def test_quiet_fast_call_never_syncs_between_blocks(dbs, tmp_path,
                                                    monkeypatch):
    """Without a printed or recorded split, ``compute_fast``'s stage clock
    never waits for the device: the one ``_sync`` left is the upload's."""
    calls = []
    real = engine._sync

    def spy(device):
        calls.append(threading.current_thread().name)
        return real(device)

    monkeypatch.setattr(engine, "_sync", spy)
    argv = [dbs["target"], str(tmp_path / "f.csv"), "--fast", "--device",
            "cpu"]
    assert cli.run([*argv, "--quiet"]) == 0
    assert len(calls) == 1
    calls.clear()
    with timing.recording():
        assert cli.run([*argv, "--quiet"]) == 0
    assert len(calls) > 1  # the recorded split laps every stage


def test_calls_keep_the_last_few():
    for _ in range(timing.CALLS_KEPT + 3):
        with timing.call(force=True) as last:
            pass
    assert len(timing.calls) == timing.CALLS_KEPT
    assert timing.calls[-1] is last
    assert [s.name for s in last.spans] == ["cli.run"]


def test_a_handed_off_thread_records_into_the_call():
    with timing.call(force=True) as c:
        with timing.span("engine"):
            handed = timing.handoff()

            def work():
                with timing.attached(handed):
                    with timing.span("worker.finish"):
                        timing.count(rows=3)
                assert not timing.active()

            t = threading.Thread(target=work, name="w")
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    names = _by_name(c)
    (w,) = names["worker.finish"]
    assert (w.call, w.parent, w.thread) == (c.id, names["engine"][0].id, "w")
    assert w.counters == {"rows": 3}
    events = timing.chrome_events(c, base_ns=c.wall_anchor_ns)
    x = {e["name"]: e for e in events if e["ph"] == "X"}
    assert 0.0 <= x["cli.run"]["ts"] < 1e3  # µs after the call's anchor
    assert np.isclose(x["worker.finish"]["dur"],
                      (w.end - w.start) * 1e6)
