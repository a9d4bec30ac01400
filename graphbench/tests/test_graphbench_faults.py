"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run of a cell (cut to scale 8 on the CPU, the
harness's look for a card skipped) with one fault planted in the program:
a superstep that returns its state unchanged, half of a batch left out, an
answer altered where it is produced (``graphbench/faults.py``, which reads
the same faults on the card at the cells' own size).  One card runs no
exchange between cards, so that fault has no place here."""
from __future__ import annotations

import importlib.util
import json
import time

import pytest

import faults

TRAVERSALS = ("rmat20.sssp64", "uniform20.sssp64", "rmat20.bfs64")


def entry(cell):
    return "sssp_batched" if "sssp" in cell else "bfs_batched"


def run_cell(root, cell, capsys, trace=0):
    spec = importlib.util.spec_from_file_location(
        "graphbench_run_under_test", root / "graphbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--workload", cell, "--seed", str(2**31 + 99),
                   "--seconds", "0.3", "--trace", str(trace)], root=root,
                  device="cpu", t_start=time.perf_counter())
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", TRAVERSALS)
def test_sound_run_is_correct(tiny_root, cell, capsys):
    result = run_cell(tiny_root, cell, capsys)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAVERSALS)
def test_state_left_unchanged(tiny_root, cell, capsys):
    with faults.plant("unchanged", entry(cell)):
        assert run_cell(tiny_root, cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", TRAVERSALS)
def test_half_the_batch_left_out(tiny_root, cell, capsys):
    with faults.plant("half", entry(cell)):
        assert run_cell(tiny_root, cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", TRAVERSALS)
def test_answer_altered_where_produced(tiny_root, cell, capsys):
    """One value of every answer moves by one float32 step as the program
    hands it back."""
    with faults.plant("altered", entry(cell)):
        assert run_cell(tiny_root, cell, capsys)["correct"] is False


def test_faults_are_lifted_after_the_run(tiny_root, capsys):
    for fault in faults.FAULTS:
        with faults.plant(fault, "sssp_batched"):
            pass
    assert run_cell(tiny_root, "rmat20.sssp64", capsys)["correct"] is True


@pytest.mark.parametrize("cell", TRAVERSALS)
def test_one_slot_wrong(tiny_root, cell, capsys, monkeypatch):
    """The last slot of every batch comes back wrong: the sample holds
    every slot, so the run is not correct."""
    import numpy as np
    import repro_torch.algorithms as algos

    real = getattr(algos, entry(cell))

    def last_slot_wrong(engine, roots):
        res, steps = real(engine, roots)
        res = res.copy()
        res[-1, np.isfinite(res[-1]) & (res[-1] > 0)] += 1.0
        return res, steps

    monkeypatch.setattr(algos, entry(cell), last_slot_wrong)
    assert run_cell(tiny_root, cell, capsys)["correct"] is False
