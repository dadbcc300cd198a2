"""``correct`` fails where it should: the control (the reference one
precision below the configuration's, in the program's place), and a run
of each cell with its timed path broken underneath.  Tiny cells on the
CPU; the harness's look for a card is skipped."""

import os

import pytest
import torch

import parfastaai_tpu_torch.cli as cli
from parfastaai_tpu_torch import engine
from parfastaai_tpu_torch.io import csv_writer
from port_bench import control, gen, harness
from port_bench.tests.pb_tiny import CELLS, tiny_cell

SEED = 2**31 + 99


@pytest.fixture(autouse=True)
def cell_route(monkeypatch, request):
    """At a tiny size the all-vs-all default call is dense; the cell's is
    banded (4096 genomes exceed the CLI's host budget): set the budget so
    that it takes the cell's route."""
    name = request.node.callspec.params.get("name", "")
    if name == "avsa-g4096-exact":
        monkeypatch.setenv("PARFASTAAI_EXACT_HOST_BYTES", "1")


def run(name):
    return harness.run_cell(tiny_cell(name), SEED, 0.3, False, device="cpu",
                            log=open(os.devnull, "w"))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(name)
    assert r["correct"] and r["failed"] == 0, r


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(tmp_path, name):
    cell = tiny_cell(name)
    dbs = gen.make(cell.config, SEED, str(tmp_path))
    numbers = control.control_numbers(cell, dbs, SEED, "cpu")
    _, limits = harness.compared(cell)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    assert not harness.passes(checks), checks
    assert control.LOWER[cell.traffic["output"]] in (torch.float32,
                                                      torch.bfloat16)


def alter_answer(monkeypatch):
    """One AJI changed where the engines produce it."""
    finish, block, mask = (engine.jaccard_finish, engine.jaccard_finish_block,
                           engine._mask_aji)

    def finish_altered(*a):
        s, n = finish(*a)
        s = s.copy()
        s[0] += 0.01 * n[0]
        return s, n

    def block_altered(*a):
        s, n = block(*a)
        s = s.copy()
        s[0, -1] += 0.01 * n[0, -1]
        return s, n

    def mask_altered(*a):
        out = mask(*a).clone()
        out[0, -1] += 0.01
        return out

    monkeypatch.setattr(engine, "jaccard_finish", finish_altered)
    monkeypatch.setattr(engine, "jaccard_finish_block", block_altered)
    monkeypatch.setattr(engine, "_mask_aji", mask_altered)


def drop_half(monkeypatch):
    """Half of the proteins left out: the AJI is the mean over the rest."""
    for cls in (cli.SCPDatabase, cli.QueryTargetDatabase):
        load = cls.load_presence

        def halved(self, *a, _load=load, **k):
            presence = _load(self, *a, **k)
            presence.m[presence.m.shape[0] // 2:] = 0
            return presence

        monkeypatch.setattr(cls, "load_presence", halved)


@pytest.mark.parametrize("fault", [alter_answer, drop_half],
                         ids=["answer_altered", "half_left_out"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    r = run(name)
    assert not r["correct"], r
    assert not harness.passes(r["checks"])
    assert r["failed"] == 0  # the calls ran; their answers are wrong


def swap_queries(monkeypatch):
    """The first two names of the query list read in swapped order: their
    rows come out swapped."""
    load = cli.load_query_genomes

    def swapped(path):
        names = load(path)
        return [names[1], names[0]] + names[2:]

    monkeypatch.setattr(cli, "load_query_genomes", swapped)


def self_not_zero(monkeypatch):
    """The first query's own cell written as 1 where the CSV's matrix is
    built."""
    build = csv_writer.aji_matrix

    def with_self(pairs, aji):
        mat = build(pairs, aji)
        mat[0, pairs.row_db_ids[0]] = 1.0
        return mat

    monkeypatch.setattr(csv_writer, "aji_matrix", with_self)


@pytest.mark.parametrize("fault", [swap_queries, self_not_zero],
                         ids=["queries_swapped", "self_not_zero"])
def test_query_subset_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    r = run("qsub-q512-g4096-exact")
    assert not r["correct"], r
    assert r["checks"]["values_differing"]["value"] > 0
    assert r["failed"] == 0
