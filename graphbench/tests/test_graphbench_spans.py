"""The span reader's arithmetic on synthetic events (``gblib/spans.py``),
the span metrics' readers, and whole traced runs on the CPU with and
without the program's spans."""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import pytest

from gblib import spans, trace
from test_graphbench_faults import run_cell

MS = 1_000_000
REPO = Path(__file__).resolve().parents[2]
SPAN_METRICS = ("push_ms.teps", "push_ms.bfs", "pull_ms.teps",
                "gather_ms.teps", "gather_ms.bfs", "csr_build_s",
                "kernel_load_s")
DEVICE_METRICS = SPAN_METRICS[:5]


@pytest.fixture(autouse=True)
def _tracing_off_after():
    """Loading a span reader turns the program's tracing on; each test
    leaves it off and empty."""
    yield
    tracing = sys.modules.get("repro_torch.runtime.tracing")
    if tracing is not None:
        tracing.disable()
        tracing.reset()


def _reader(root, name):
    path = root / "graphbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"m_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# one call, 0-20 ms: entry (root) > superstep > push (2-6), pull (8-12);
# entry > result_copy (15-19)
SPANS = [("entry.sssp_batched", 0, 20 * MS, -1),
         ("bsp.superstep", 1 * MS, 13 * MS, 0),
         ("bsp.push", 2 * MS, 6 * MS, 1),
         ("bsp.pull", 8 * MS, 12 * MS, 1),
         ("entry.result_copy", 15 * MS, 19 * MS, 0)]


def test_kernel_goes_to_the_innermost_span_of_its_launch():
    device = [("scatter", 5 * MS, 9 * MS, 3 * MS),     # launched in push
              ("scan", 9 * MS, 10 * MS, 11 * MS),      # in pull, ran early
              ("vote", 12 * MS, 13 * MS, 7 * MS),      # superstep, no child
              ("Memcpy DtoH", 17 * MS, 19 * MS, 16 * MS)]
    s = spans.summarize(device, SPANS, [(0, 20 * MS)])
    assert s["device_s"] == pytest.approx({
        "bsp.push": 0.004, "bsp.pull": 0.001, "bsp.superstep": 0.001,
        "entry.result_copy": 0.002})
    assert s["below_root_s"] == pytest.approx(0.008)
    assert s["dtoh_copies"] == 1 and s["calls"] == 1
    assert s["device_by_span"][0] == ["bsp.push", pytest.approx(0.004)]


def test_kernel_launched_outside_every_span():
    device = [("k", 21 * MS, 22 * MS, 20 * MS + 1),
              ("lost", 23 * MS, 24 * MS, None)]     # no runtime call found
    s = spans.summarize(device, SPANS, [(0, 30 * MS)])
    assert s["device_s"] == pytest.approx({spans.OUTSIDE: 0.002})
    assert s["below_root_s"] == 0


def test_idle_gaps_split_at_span_boundaries():
    # busy 2-4 and 14-16 only: idle 0-2, 4-14, 16-20
    device = [("a", 2 * MS, 4 * MS, 2 * MS), ("b", 14 * MS, 16 * MS, 3 * MS)]
    s = spans.summarize(device, SPANS, [(0, 20 * MS)])
    idle = s["idle_s"]
    # 0-1 entry, 1-2 superstep; 4-6 push, 6-8 superstep, 8-12 pull,
    # 12-13 superstep, 13-14 entry; 16-19 result_copy, 19-20 entry
    assert idle == pytest.approx({
        "entry.sssp_batched": 0.003, "bsp.superstep": 0.004,
        "bsp.push": 0.002, "bsp.pull": 0.004, "entry.result_copy": 0.003})
    assert s["idle_total_s"] == pytest.approx(0.016)


def test_idle_outside_every_span_and_the_calls():
    """Two calls, 0-10 and 20-30 ms, spans only over the first: the second
    call's idle time is outside any span, the client's 10-20 is no one's."""
    sp = [("entry.bfs_batched", 0, 10 * MS, -1)]
    s = spans.summarize([("k", 2 * MS, 4 * MS, 1 * MS)], sp,
                        [(20 * MS, 30 * MS), (0, 10 * MS)])
    assert s["calls"] == 2
    assert s["idle_s"] == pytest.approx({"entry.bfs_batched": 0.008,
                                         spans.OUTSIDE: 0.010})


def test_device_seconds_add_up_to_the_trace():
    device = [("scatter", 5 * MS, 9 * MS, 3 * MS),
              ("scan", 9 * MS, 11 * MS, 9 * MS),
              ("edge", -2 * MS, 1 * MS, None),               # clipped: 1 ms
              ("late", 19 * MS, 25 * MS, 16 * MS),           # clipped: 1 ms
              ("Memcpy DtoH", 17 * MS, 18 * MS, 16 * MS)]
    windows = [(0, 20 * MS)]
    s = spans.summarize(device, SPANS, windows)
    t = trace.summarize([d[:3] for d in device], [], windows)
    assert s["device_total_s"] == pytest.approx(sum(s["device_s"].values()))
    assert s["device_total_s"] == pytest.approx(sum(t["device_s"].values()))
    assert s["device_total_s"] == pytest.approx(0.009)
    # a copy is counted where it was launched, inside the calls or not
    assert s["dtoh_copies"] == 1
    late = [("Memcpy DtoH", 20 * MS + 5, 20 * MS + 9, 19 * MS),
            ("Memcpy DtoH", 1 * MS, 2 * MS, -1 * MS)]
    assert spans.summarize(late, SPANS, windows)["dtoh_copies"] == 1
    # idle is what the trace's busy union leaves, whoever it is charged to
    assert s["idle_total_s"] == pytest.approx(t["window_s"] - t["busy_s"])


def test_innermost_segments():
    segs = spans.innermost(SPANS + [("open", 3 * MS, None, 2)])
    assert segs == [(0, MS, 0), (MS, 2 * MS, 1), (2 * MS, 6 * MS, 2),
                    (6 * MS, 8 * MS, 1), (8 * MS, 12 * MS, 3),
                    (12 * MS, 13 * MS, 1), (13 * MS, 15 * MS, 0),
                    (15 * MS, 19 * MS, 4), (19 * MS, 20 * MS, 0)]
    # a child that outlasts its parent is cut at the parent's end
    assert spans.innermost([("p", 0, 5, -1), ("c", 2, 9, 0)]) == [
        (0, 2, 0), (2, 5, 1)]
    assert spans.span_seconds(SPANS) == pytest.approx({
        "entry.sssp_batched": 0.020, "bsp.superstep": 0.012,
        "bsp.push": 0.004, "bsp.pull": 0.004, "entry.result_copy": 0.004})


def _run(device_s, supersteps, setup, calls=4):
    return {"trace": {"spans": {"device_s": device_s, "calls": calls,
                                "setup": setup, "supersteps": supersteps}}}


def test_superstep_kinds_from_spans():
    sp = [("bsp.superstep", 0, 10, -1), ("bsp.push", 1, 2, 0),
          ("bsp.superstep", 10, 20, -1), ("bsp.pull", 11, 12, 2),
          ("bsp.superstep", 20, 30, -1), ("bsp.vote", 21, 22, 4),
          ("bsp.pull", 22, 23, 4), ("x", 24, 28, 4), ("bsp.push", 25, 26, 7),
          ("bsp.superstep", 40, 50, -1), ("bsp.push", 41, 42, 9)]
    assert spans.superstep_kinds(sp) == {"push": 2, "pull": 1, "mixed": 1}
    assert spans.superstep_kinds(sp, [(5, 35)]) == {
        "push": 0, "pull": 1, "mixed": 1}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_returns_none_without_spans(tiny_root, name):
    read = _reader(tiny_root, name).read
    assert read({}) is None
    assert read({"trace": None}) is None
    assert read({"trace": {"device_s": {}}}) is None
    assert read(_run({}, {}, {})) is None


def test_readers_on_a_run():
    readers = {n: _reader(REPO, n).read for n in SPAN_METRICS}
    run = _run({"bsp.push": 0.9, "bsp.pull": 0.2, "entry.result_copy": 0.5},
               {"push": 6, "pull": 1, "mixed": 3},
               {"graph.from_edge_list": 12.5, "kernels.load": 0.75})
    got = {n: r(run) for n, r in readers.items()}
    assert got == pytest.approx({
        "push_ms.teps": 100.0, "push_ms.bfs": 100.0,
        "pull_ms.teps": 50.0, "gather_ms.teps": 125.0, "gather_ms.bfs": 125.0,
        "csr_build_s": 12.5, "kernel_load_s": 0.75})
    # no superstep of the right kind: nothing to read
    run["trace"]["spans"]["supersteps"] = {"push": 5}
    assert readers["pull_ms.teps"](run) is None


def test_the_hook_reads_a_profiled_call(tiny_root):
    """``install`` turns the program's tracing on and ``trace.from_profiler``
    then carries the window's spans: here one SSSP call on the CPU, whose
    ops the profiler saw but which has no device events to charge."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.algorithms import sssp_batched
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.runtime import tracing

    assert spans.install(tiny_root)
    try:
        g = G.rmat(8, 16, seed=3).with_uniform_weights(seed=1)
        eng = BSPEngine(PT.partition(g, 2, PT.HIGH), backend="hybrid",
                        device="cpu")
        sssp_batched(eng, [0, 5])           # warm-up: set-up spans
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(trace.CALL_MARK):
                _, steps = sssp_batched(eng, [0, 5])
        summary = trace.from_profiler(prof)
    finally:
        tracing.disable()
        tracing.reset()
    sp = summary["spans"]
    assert not tracing.enabled()
    assert sp["setup"]["graph.from_edge_list"] > 0
    assert sp["setup"]["partition.partition"] > 0
    assert sp["calls"] == 1 and sp["device_total_s"] == 0
    assert sum(sp["supersteps"].values()) == int(steps.max())
    # the program's counters hold the warm-up call's supersteps too
    assert sum(sp["counters"].values()) == 2 * int(steps.max())
    # the busy-time summary the other metrics read is unchanged
    assert set(summary) == {"window_s", "busy_s", "dtoh_s", "device_s",
                            "device_ops", "idle_gaps", "spans"}
    idle = sp["idle_total_s"]
    assert idle == pytest.approx(summary["window_s"], rel=1e-9)
    assert sp["idle_s"].get("bsp.superstep", 0) > 0


def test_traced_run_with_the_hook(tiny_root, capsys):
    """A whole traced run on the CPU: the span metrics' readers are loaded,
    the run ends with a result, and no device metric is read from a CPU
    profile."""
    result = run_cell(tiny_root, "rmat20.sssp64", capsys, trace=1)
    assert list(result)[-1] == "checks"
    for name in SPAN_METRICS:
        assert name not in result["metrics"]


def test_traced_run_of_a_program_without_spans(tiny_root, capsys,
                                               monkeypatch):
    """A program that records no spans (the module missing): ``install``
    changes nothing and the traced run goes on without the span metrics."""
    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    monkeypatch.delattr(repro_torch.runtime, "tracing")
    assert spans.install(tiny_root) is False
    result = run_cell(tiny_root, "rmat20.bfs64", capsys, trace=1)
    assert list(result)[-1] == "checks"
    for name in SPAN_METRICS:
        assert name not in result["metrics"]
