"""The port's spans and counters (``repro_torch.runtime.tracing``) on the CPU.

BFS and SSSP batches at scale 8 on the hybrid and reference backends:
tracing off records nothing and hands out the shared no-op span; tracing on
leaves the answers and step counts bit for bit as they were; spans nest
inside their parents and share their call's id; one ``bsp.superstep`` span
and one vote counter tick per superstep; a forced direction moves only its
own counter; and a span's stamps, taken on the clock of ``torch.profiler``'s
host events, enclose the profiler's events of the ops issued inside it.
"""
import collections
import importlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import BSPEngine
from repro_torch.runtime import tracing

talg = importlib.import_module("repro_torch.algorithms")

SCALE = 8
SOURCES = [0, 5, 17, 42]
ALGS = ["sssp_batched", "bfs_batched"]
BACKENDS = ["hybrid", "reference"]
VOTES = ("bsp.supersteps.push", "bsp.supersteps.pull",
         "bsp.supersteps.mixed")


@pytest.fixture(scope="module")
def pg():
    g = TG.rmat(SCALE, 16, seed=3).with_uniform_weights(seed=1)
    return TPT.partition(g, 2, TPT.HIGH)


@pytest.fixture(scope="module")
def engines(pg):
    return {b: BSPEngine(pg, backend=b, device="cpu") for b in BACKENDS}


@pytest.fixture
def traced():
    """Tracing on for one test, off and empty after it."""
    tracing.reset()
    tracing.enable()
    try:
        yield
    finally:
        tracing.disable()
        tracing.reset()


def _call(engines, alg, backend):
    return getattr(talg, alg)(engines[backend], SOURCES)


def _traced_call(engines, alg, backend):
    _call(engines, alg, backend)          # build the split outside the call
    tracing.reset()
    out = _call(engines, alg, backend)
    return out, tracing.snapshot()


CASES = pytest.mark.parametrize("alg,backend", [
    (a, b) for a in ALGS for b in BACKENDS])


@CASES
def test_off_records_nothing(engines, alg, backend):
    tracing.disable()
    tracing.reset()
    _call(engines, alg, backend)
    assert tracing.snapshot() == {"spans": [], "counters": {}}
    assert tracing.span("bsp.superstep", step=1) is tracing.NULL_SPAN
    assert tracing.span("entry.upload") is tracing.NULL_SPAN
    with tracing.span("entry.upload") as s:
        assert s is tracing.NULL_SPAN
    tracing.count("bsp.supersteps.push")
    assert tracing.snapshot() == {"spans": [], "counters": {}}


@CASES
def test_traced_answers_bit_equal(engines, alg, backend, traced):
    tracing.disable()
    want, want_steps = _call(engines, alg, backend)
    tracing.enable()
    (got, got_steps), rec = _traced_call(engines, alg, backend)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_steps, want_steps)
    assert rec["spans"]


@CASES
def test_spans_nest_and_share_the_call_id(engines, alg, backend, traced):
    _, rec = _traced_call(engines, alg, backend)
    spans = rec["spans"]
    roots = [s for s in spans if s[3] == -1]
    assert [s[0] for s in roots] == [f"entry.{alg}"]
    call = roots[0][4]
    for name, start, end, parent, cid, attrs in spans:
        assert end is not None and start <= end, name
        assert cid == call, name
        if parent >= 0:
            pname, pstart, pend = spans[parent][:3]
            assert pstart <= start and end <= pend, (name, pname)
            assert spans[parent][4] == cid
        assert all(isinstance(v, int) for v in attrs.values())
    names = collections.Counter(s[0] for s in spans)
    for want in ("entry.upload", "engine.execute", "bsp.superstep",
                 "bsp.loop_read", "bsp.messages", "bsp.vote",
                 "bsp.vote_read", "bsp.finish", "engine.direction_stats",
                 "entry.result_copy", "entry.steps_copy"):
        assert names[want] >= 1, want


@CASES
def test_one_superstep_span_per_superstep(engines, alg, backend, traced):
    (_, steps), rec = _traced_call(engines, alg, backend)
    supersteps = [s for s in rec["spans"] if s[0] == "bsp.superstep"]
    assert [s[5]["step"] for s in supersteps] == list(range(int(
        np.max(steps))))
    # the loop reads its vote before every superstep and once to stop
    reads = [s for s in rec["spans"] if s[0] == "bsp.loop_read"]
    assert len(reads) == len(supersteps) + 1


@CASES
def test_vote_counters_add_up_to_the_supersteps(engines, alg, backend,
                                                traced):
    (_, steps), rec = _traced_call(engines, alg, backend)
    c = rec["counters"]
    assert sum(c.get(k, 0) for k in VOTES) == int(np.max(steps))
    pushes = sum(1 for s in rec["spans"] if s[0] == "bsp.push")
    assert pushes == c.get(VOTES[0], 0) + c.get(VOTES[2], 0)
    pulls = sum(1 for s in rec["spans"] if s[0] == "bsp.pull")
    assert pulls == c.get(VOTES[1], 0) + c.get(VOTES[2], 0)


@pytest.mark.parametrize("direction", ["push", "pull"])
@CASES
def test_forced_direction_moves_its_counter_only(pg, alg, backend, direction,
                                                  traced):
    eng = BSPEngine(pg, backend=backend, device="cpu", direction=direction)
    (_, steps), rec = _traced_call({backend: eng}, alg, backend)
    c = rec["counters"]
    assert c.get(f"bsp.supersteps.{direction}") == int(np.max(steps))
    assert set(c) & set(VOTES) == {f"bsp.supersteps.{direction}"}


@CASES
def test_span_stamps_enclose_the_profiler_events(engines, alg, backend,
                                                 traced):
    """Every op the profiler saw start inside a span ends inside it, and
    the entry span holds them all (one clock for both)."""
    _call(engines, alg, backend)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(engines, alg, backend)
    spans = tracing.snapshot()["spans"]
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert len(ops) > 10
    root = spans[0]
    assert root[0] == f"entry.{alg}"
    for name, s, e in ops:
        assert root[1] <= s and e <= root[2], name
    checked = 0
    for sname, s0, s1, *_ in spans:
        for name, s, e in ops:
            if s0 <= s <= s1:
                assert e <= s1, (name, sname)
                checked += 1
    assert checked >= len(ops)


def test_shared_clock_on_single_ops(traced):
    x = torch.arange(4096, dtype=torch.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("a"):
            torch.cumsum(x, 0)
        with tracing.span("b"):
            torch.cumprod(x, 0)
    spans = {s[0]: s for s in tracing.snapshot()["spans"]}
    ev = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()}
    for span_name, op in (("a", "aten::cumsum"), ("b", "aten::cumprod")):
        s0, s1 = spans[span_name][1:3]
        assert s0 <= ev[op][0] and ev[op][1] <= s1, op
    assert ev["aten::cumprod"][0] >= spans["a"][2]


def test_recorder_basics(traced):
    with tracing.span("outer", step=3):
        with tracing.span("inner"):
            tracing.count("c")
            tracing.count("c", 2)
    with tracing.span("next"):
        pass
    rec = tracing.snapshot()
    (o, i, n) = rec["spans"]
    assert (o[0], o[3], o[5]) == ("outer", -1, {"step": 3})
    assert (i[0], i[3], i[4]) == ("inner", 0, o[4])
    assert n[3] == -1 and n[4] != o[4]         # a new root, a new call
    assert rec["counters"] == {"c": 3}
    # a span open across a reset is dropped, and the stack starts anew
    with tracing.span("open"):
        tracing.reset()
    assert tracing.snapshot()["spans"] == []
    with tracing.span("after"):
        pass
    assert tracing.snapshot()["spans"][0][3] == -1


def test_each_thread_has_its_own_stack(traced):
    seen = {}

    def work():
        with tracing.span("worker"):
            seen["parent"] = None
    with tracing.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join()
    spans = {s[0]: s for s in tracing.snapshot()["spans"]}
    assert spans["worker"][3] == -1
    assert spans["worker"][4] != spans["main"][4]


def test_threads_record_without_losing_spans_or_counts(traced):
    """More threads than cores, each opening nested spans and counting,
    with the interpreter switching threads as often as it can."""
    threads, rounds = 4 * (os.cpu_count() or 1), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(rounds):
                with tracing.span(f"outer.{t}", step=i):
                    with tracing.span(f"inner.{t}"):
                        tracing.count("c")
        pool = [threading.Thread(target=work, args=(t,))
                for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(old)
    rec = tracing.snapshot()
    assert rec["counters"] == {"c": threads * rounds}
    spans = rec["spans"]
    assert len(spans) == 2 * threads * rounds
    for name, start, end, parent, call, _ in spans:
        assert end is not None and start <= end
        if name.startswith("inner."):
            outer = spans[parent]
            assert outer[0] == "outer." + name.split(".")[1]
            assert outer[4] == call and outer[1] <= start <= end <= outer[2]
        else:
            assert parent == -1


def test_tracing_is_off_by_default():
    src = str(Path(tracing.__file__).resolve().parents[2])
    code = ("from repro_torch.runtime import tracing; "
            "print(tracing.enabled(), tracing.span('x') is tracing.NULL_SPAN)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.stdout.split() == ["False", "True"]
