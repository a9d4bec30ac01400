"""The port's chunked loop and continuous-batching serving layer against
the JAX package's, on the CPU.

Graph: ``rmat(8, 6, seed=13)`` with uniform weights (CC: its symmetrized
graph), 4 partitions under HIGH; 4 slots and a stream of 32 sources (the
max-out-degree hub, the min-out-degree vertex and 30 seeded vertices), as
the JAX package's ``tests/test_continuous.py`` serves them.

- ``execute(chunk=k)`` for k in {1, 3} on the reference, fused and hybrid
  backends, for BFS, SSSP and CC: the final state bit for bit equal to
  the port's resident ``execute()`` and to JAX's ``execute(chunk=k)``,
  with equal ``steps_q`` and, at every boundary, the same ``step``,
  ``fin`` and ``steps_q`` seen by an ``on_chunk`` recorder.
- ``ServeSession`` against JAX's on the same stream, slots and chunk:
  results bit for bit, per-query steps, and ``windows``, ``refills``,
  ``min_slot_refills`` and ``quarantined`` equal; every completion also
  bit for bit equal to the port's ``drain_reference`` with zero retraces.
- The JAX ``tests/test_continuous.py`` cases that need no checkpoint,
  chaos or dynamic graph, on the port's engines; the modes that raise
  naming ROADMAP items 11 and 13; a failed CUDA kernel re-raised by the
  degradation ladder and the restart policy, and a fallback held to the
  primary's device and kernel backends; the ``graph_serve`` launcher in its
  three modes (report keys equal to JAX's, ``ServeConfig``'s errors
  equal to JAX's); gloo worlds of 2 and 4 running ``continuous_selftest``
  and ``batched_selftest``.

Tolerances: min programs (BFS, SSSP, CC) bit for bit everywhere; the
batched self-test's sum programs held to the JAX reference engine at its
own tolerances, BC ``rtol=1e-4, atol=1e-4`` and PPR ``rtol=1e-4,
atol=1e-7``.
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_jaxref import JA, JEngine, JG, JPT, jbfs, jcc, jsssp

from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import BSPEngine
from repro_torch.launch import graph_serve as tgs
from repro_torch.runtime import (DegradationLadder, QuarantinePolicy,
                                 RestartPolicy, ServeSession, WorkerFailure,
                                 drain_reference, nonfinite_queries)

# ``repro_torch.algorithms`` re-exports functions named like its modules
tbfs, tcc, tsssp = (importlib.import_module(f"repro_torch.algorithms.{m}")
                    for m in ("bfs", "cc", "sssp"))
jrt = importlib.import_module("repro.runtime")
jgs = importlib.import_module("repro.launch.graph_serve")

SRC = Path(__file__).resolve().parents[1] / "src"
SLOTS = 4
STREAM = 32
KW = {"reference": {}, "fused": dict(fused=True, block_e=256),
      "hybrid": dict(backend="hybrid")}


@pytest.fixture(scope="module")
def graphs():
    """``{name: (JAX pg, port pg)}`` and the port's numpy graph."""
    jg = JG.rmat(8, 6, seed=13).with_uniform_weights(seed=1)
    tg = TG.rmat(8, 6, seed=13).with_uniform_weights(seed=1)
    jgs_, tgs_ = (jcc.symmetrize(JG.rmat(8, 6, seed=13)),
                  tcc.symmetrize(TG.rmat(8, 6, seed=13)))
    return tg, {"main": (JPT.partition(jg, 4, JPT.HIGH),
                         TPT.partition(tg, 4, TPT.HIGH)),
                "cc": (JPT.partition(jgs_, 4, JPT.HIGH),
                       TPT.partition(tgs_, 4, TPT.HIGH))}


@pytest.fixture(scope="module")
def stream(graphs):
    g = graphs[0]
    rng = np.random.default_rng(3)
    deg = g.out_degrees()
    # hub + fringe + random: mixed convergence, so slots free at
    # different boundaries and refill asymmetrically
    return np.concatenate([
        [int(np.argmax(deg)), int(np.argmin(deg))],
        rng.integers(0, g.num_vertices, size=STREAM - 2)])


def _port(pg, backend):
    return BSPEngine(pg, device="cpu", **KW[backend])


def _states(alg, pg, sources):
    """The same initial state for both packages, as numpy."""
    if alg == "bfs":
        return {"level": tbfs.multi_source_state(pg, sources)}
    if alg == "sssp":
        dist = tbfs.multi_source_state(pg, sources)
        return {"dist": dist, "active": np.isfinite(dist)}
    gids = np.arange(pg.num_vertices, dtype=np.float32)
    return {"label": pg.scatter_global(gids, np.inf)[None],
            "active": pg.vertex_mask.copy()[None]}


PROGRAMS = {"bfs": (tbfs.BFS_PROGRAM, jbfs.BFS_PROGRAM),
            "sssp": (tsssp.SSSP_PROGRAM, jsssp.SSSP_PROGRAM),
            "cc": (tcc.CC_PROGRAM, jcc.CC_PROGRAM)}


def _recorder():
    seen = []

    def hook(snap):
        seen.append((int(snap["step"]), np.asarray(snap["fin"]).copy(),
                     np.asarray(snap["steps_q"]).copy()))
    return seen, hook


def _np(state):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in state.items()}


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("alg", ["bfs", "sssp", "cc"])
@pytest.mark.parametrize("backend", sorted(KW))
def test_chunked_matches_resident_and_jax(graphs, stream, backend, alg,
                                          chunk):
    jp, tp = graphs[1]["cc" if alg == "cc" else "main"]
    state = _states(alg, tp, stream[:SLOTS])
    tprog, jprog = PROGRAMS[alg]
    eng = _port(tp, backend)
    want, want_steps = eng.execute(tprog, dict(state))
    seen, hook = _recorder()
    got, steps_q, info = eng.execute(tprog, dict(state), chunk=chunk,
                                     on_chunk=hook)
    jseen, jhook = _recorder()
    jgot, jsteps, jinfo = JEngine(jp, **KW[backend]).execute(
        jprog, dict(state), chunk=chunk, on_chunk=jhook)
    got, want, jgot = _np(got), _np(want), _np(jgot)
    for k in state:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(got[k], jgot[k], err_msg=k)
    np.testing.assert_array_equal(steps_q.numpy(), want_steps.numpy())
    np.testing.assert_array_equal(steps_q.numpy(), np.asarray(jsteps))
    assert len(seen) == len(jseen) == info["chunks"] == jinfo["chunks"]
    for (s, f, q), (js, jf, jq) in zip(seen, jseen):
        assert s == js
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(q, jq)
    assert info["final_step"] == jinfo["final_step"]
    np.testing.assert_array_equal(info["finished"], jinfo["finished"])
    assert info["refilled"] == jinfo["refilled"] == 0


@pytest.mark.parametrize("alg", ["bfs", "sssp"])
@pytest.mark.parametrize("backend", sorted(KW))
def test_session_matches_jax_and_drain(graphs, stream, backend, alg):
    """>= 8xQ stream through one resident session per backend: every
    completion bit for bit equal to JAX's session's and to the port's
    drain-batch row, with equal steps; every slot refilled, zero
    retraces."""
    jp, tp = graphs[1]["main"]
    eng = _port(tp, backend)
    want = drain_reference(eng, alg, stream, SLOTS)
    session = ServeSession(eng, alg, slots=SLOTS, chunk=2)
    qids = session.submit(stream)
    rep = session.drain()
    got = session.poll()
    js = jrt.ServeSession(JEngine(jp, **KW[backend]), alg, slots=SLOTS,
                          chunk=2)
    jqids = js.submit(stream)
    jrep = js.drain()
    jgot = js.poll()
    assert qids == jqids and len(got) == len(jgot) == STREAM
    for r, jr in zip(got, jgot):
        assert r["query"] == jr["query"] and r["source"] == jr["source"]
        np.testing.assert_array_equal(r["result"], jr["result"])
        np.testing.assert_array_equal(r["result"], want[r["query"]])
        assert r["steps"] == jr["steps"]
        assert r["quarantined"] == jr["quarantined"]
    for key in ("windows", "refills", "min_slot_refills",
                "max_slot_refills", "quarantined", "final_step",
                "completed", "submitted"):
        assert rep[key] == jrep[key], key
    assert set(rep) == set(jrep)
    assert rep["retraces"] == 0
    assert rep["refills"] == STREAM - SLOTS
    assert rep["min_slot_refills"] >= 3


def test_quarantine_matches_jax(graphs, stream):
    """A superstep budget of 2 quarantines the deep queries; the port
    reports the same queries, refills the same slots and keeps the rest
    bit for bit."""
    jp, tp = graphs[1]["main"]
    want = drain_reference(_port(tp, "reference"), "bfs", stream, SLOTS)
    quar = QuarantinePolicy(superstep_budget=2)
    session = ServeSession(_port(tp, "reference"), "bfs", slots=SLOTS,
                           chunk=2, quarantine=quar)
    session.submit(stream)
    rep = session.drain()
    results = session.poll()
    jquar = jrt.QuarantinePolicy(superstep_budget=2)
    js = jrt.ServeSession(JEngine(jp), "bfs", slots=SLOTS, chunk=2,
                          quarantine=jquar)
    js.submit(stream)
    jrep = js.drain()
    assert len(results) == STREAM               # quarantined still complete
    assert rep["quarantined"], "budget=2 should have quarantined something"
    assert rep["quarantined"] == jrep["quarantined"]
    assert quar.quarantined == jquar.quarantined
    assert rep["refills"] == jrep["refills"] == STREAM - SLOTS
    for r, jr in zip(results, js.poll()):
        np.testing.assert_array_equal(r["result"], jr["result"])
        if not r["quarantined"]:
            np.testing.assert_array_equal(r["result"], want[r["query"]])
    # reports name query ids, not slot indices
    assert {q["query"] for q in quar.quarantined} == set(rep["quarantined"])


class _Monitor:
    """A duck-typed invariant monitor recording what the engine shows it;
    it fires at every other boundary (steps 2, 6, 10, ... with chunk=2)."""

    def __init__(self):
        self.calls = []

    def observe(self, snap):
        self.calls.append(("observe", int(snap["step"]),
                           np.asarray(snap["finished"]).tolist(),
                           np.asarray(snap["steps_q"]).tolist()))
        return {"violations": int(int(snap["step"]) % 4 == 2)}

    def rebase(self, admit):
        self.calls.append(("rebase", np.asarray(admit).tolist()))


def test_monitor_is_called_as_in_jax(graphs, stream):
    jp, tp = graphs[1]["main"]
    mon, jmon = _Monitor(), _Monitor()
    session = ServeSession(_port(tp, "fused"), "sssp", slots=SLOTS, chunk=2,
                           monitor=mon)
    session.submit(stream[:12])
    rep = session.drain()
    js = jrt.ServeSession(JEngine(jp, **KW["fused"]), "sssp", slots=SLOTS,
                          chunk=2, monitor=jmon)
    js.submit(stream[:12])
    jrep = js.drain()
    assert mon.calls == jmon.calls
    assert rep["monitors_fired"] == jrep["monitors_fired"] > 0


def test_bare_kill_mask_and_stop(graphs, stream):
    """A bare mask kills; ``stop`` ends the run at its boundary: both as
    the JAX engine does, and a resumed carry finishes as one run."""
    jp, tp = graphs[1]["main"]
    state = _states("bfs", tp, stream[:SLOTS])
    kill = np.array([False, True, False, False])
    out = {}
    for name, eng, prog in (("port", _port(tp, "reference"),
                             tbfs.BFS_PROGRAM),
                            ("jax", JEngine(jp), jbfs.BFS_PROGRAM)):
        st, steps, info = eng.execute(prog, dict(state), chunk=1,
                                      on_chunk=lambda s: kill)
        st2, steps2, info2 = eng.execute(
            prog, dict(state), chunk=2, on_chunk=lambda s: {"stop": True})
        st3, steps3, info3 = eng.execute(
            prog, st2, chunk=2, start_step=info2["final_step"],
            fin=info2["finished"], steps_q=steps2)
        out[name] = (_np(st)["level"], np.asarray(steps), info,
                     info2, _np(st3)["level"], np.asarray(steps3), info3)
    p, j = out["port"], out["jax"]
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_array_equal(p[1], j[1])
    assert p[1][1] == 1                          # killed after one superstep
    assert p[3]["chunks"] == j[3]["chunks"] == 1
    assert p[3]["final_step"] == j[3]["final_step"] == 2
    np.testing.assert_array_equal(p[4], j[4])
    np.testing.assert_array_equal(p[5], j[5])
    assert p[6]["final_step"] == j[6]["final_step"]
    want, want_steps = _port(tp, "reference").execute(tbfs.BFS_PROGRAM,
                                                      dict(state))
    np.testing.assert_array_equal(p[4], want["level"].numpy())
    np.testing.assert_array_equal(p[5], want_steps.numpy())


def test_zero_retrace_across_refill_cycles(graphs):
    """>= 3 full refill cycles of every slot on the hybrid backend (the
    one that builds splits at a program's first run); a second session
    over the same engine builds nothing."""
    g, (_, tp) = graphs[0], graphs[1]["main"]
    eng = _port(tp, "hybrid")
    rng = np.random.default_rng(7)
    session = ServeSession(eng, "bfs", slots=SLOTS, chunk=2)
    session.submit(rng.integers(0, g.num_vertices, size=8 * SLOTS))
    session.drain()
    assert int(session.slot_refills.min()) >= 3
    assert session.retraces() == 0
    entries = session._cache_entries()
    assert entries >= 2            # the split and its layout were built
    s2 = ServeSession(eng, "bfs", slots=SLOTS, chunk=2)
    s2.submit(rng.integers(0, g.num_vertices, size=4 * SLOTS))
    s2.drain()
    assert s2._cache_entries() == entries


def test_ladder_handoff_carries_occupancy(graphs, stream):
    """DegradationLadder threads the session API: primary dies, the
    fallback session adopts the refilled carry and finishes bitwise."""
    tp = graphs[1]["main"][1]
    want = drain_reference(_port(tp, "reference"), "bfs", stream, SLOTS)

    class Dying(ServeSession):
        def step(self):
            raise WorkerFailure("injected primary death")

    primary = Dying(_port(tp, "fused"), "bfs", slots=SLOTS, chunk=2)
    fallback = ServeSession(_port(tp, "reference"), "bfs", slots=SLOTS,
                            chunk=2)
    primary.submit(stream)
    ladder = DegradationLadder(retries=1)
    primary.step_with_fallback(fallback, ladder)
    assert len(ladder.downgrades) == 1
    while not fallback.drained():
        fallback.step()
    results = {r["query"]: r["result"] for r in fallback.poll()}
    assert len(results) == len(stream)
    for qid, row in enumerate(want):
        np.testing.assert_array_equal(results[qid], row)


@pytest.mark.parametrize("retryable", ["default", "everything"])
def test_kernel_failure_is_reraised_not_served_around(graphs, stream,
                                                       retryable):
    """A CUDA error from a kernel launch (``torch.AcceleratorError``)
    reaches the caller: no retry, no downgrade, no handoff, even when the
    ladder's whitelist holds every ``Exception``."""
    tp = graphs[1]["main"][1]
    calls = []

    class Failing(ServeSession):
        def step(self):
            calls.append(1)
            raise torch.AcceleratorError("CUDA error: an illegal memory "
                                         "access was encountered")

    primary = Failing(_port(tp, "fused"), "bfs", slots=SLOTS, chunk=2)
    fallback = ServeSession(_port(tp, "hybrid"), "bfs", slots=SLOTS,
                            chunk=2)
    primary.submit(stream)
    ladder = (DegradationLadder(retries=2) if retryable == "default" else
              DegradationLadder(retries=2, retryable=(Exception,)))
    with pytest.raises(torch.AcceleratorError, match="illegal memory"):
        primary.step_with_fallback(fallback, ladder)
    assert calls == [1]
    assert ladder.downgrades == [] and fallback._state is None
    policy = RestartPolicy(retryable=(Exception,))
    with pytest.raises(torch.AcceleratorError):
        policy.handle(torch.AcceleratorError("CUDA error"))
    assert policy.failures == 0


@pytest.mark.parametrize("case", ["other device", "reference on a card"])
def test_fallback_stays_on_the_primary_device(graphs, case):
    """A downgrade never leaves the card: a fallback on another device, or
    a card session's fallback to the reference backend's plain PyTorch,
    is refused before the primary runs."""
    from types import SimpleNamespace

    primary = ServeSession(
        SimpleNamespace(device=torch.device("cuda", 0), backend="fused"),
        "bfs", slots=SLOTS, chunk=2)
    dev = "cpu" if case == "other device" else "cuda:0"
    fallback = ServeSession(
        SimpleNamespace(device=torch.device(dev), backend="reference"),
        "bfs", slots=SLOTS, chunk=2)
    ladder = DegradationLadder(retries=1)
    match = "device" if case == "other device" else "reference backend"
    with pytest.raises(ValueError, match=match):
        primary.step_with_fallback(fallback, ladder)
    assert ladder.downgrades == [] and primary.windows == 0


def test_handoff_mid_stream_resumes_bitwise(graphs, stream):
    """A handoff after refills have begun: the fallback (another backend)
    resumes the refilled occupancy and finishes bitwise."""
    tp = graphs[1]["main"][1]
    want = drain_reference(_port(tp, "reference"), "sssp", stream, SLOTS)
    primary = ServeSession(_port(tp, "hybrid"), "sssp", slots=SLOTS,
                           chunk=2)
    primary.submit(stream)
    while primary.refills == 0:
        assert primary.step(), "drained before any refill"
    fallback = ServeSession(_port(tp, "fused"), "sssp", slots=SLOTS,
                            chunk=2)
    primary.handoff(fallback)
    assert fallback.occupied.tolist() == primary.occupied.tolist()
    while not fallback.drained():
        fallback.step()
    results = {r["query"]: r["result"] for r in fallback.poll()}
    assert len(results) == len(stream)
    for qid, row in enumerate(want):
        np.testing.assert_array_equal(results[qid], row)


def test_admission_capacity_rejects_with_reason(graphs, stream):
    tp = graphs[1]["main"][1]
    session = ServeSession(_port(tp, "reference"), "bfs", slots=SLOTS,
                           chunk=2, queue_capacity=6)
    qids = session.submit(stream)
    rejected = [q for q in qids if q is None]
    assert len(rejected) == len(stream) - 6
    assert all(r["reason"] == "queue_full"
               for r in session.admission.rejected)
    session.drain()
    assert len(session.poll()) == 6


def test_depth_scheduler_admits_shallow_first(graphs):
    g, tp = graphs[0], graphs[1]["main"][1]
    deg = g.out_degrees()
    session = ServeSession(_port(tp, "reference"), "bfs", slots=2, chunk=2,
                           scheduler="depth",
                           depth_key=lambda s: -int(deg[s]))
    lo, hi = int(np.argmin(deg)), int(np.argmax(deg))
    session.submit([lo, lo, lo, hi])
    # the hub (shallow BFS) must jump the fringe queries in the queue
    assert session.admission._queue[0][0][1] == hi
    session.drain()
    assert len(session.poll()) == 4
    with pytest.raises(ValueError, match="depth_key"):
        ServeSession(_port(tp, "reference"), "bfs", slots=2,
                     scheduler="depth")


def test_nonfinite_queries_matches_jax():
    rng = np.random.default_rng(5)
    state = {"a": rng.random((6, 3, 5)).astype(np.float32),
             "b": rng.random((6, 3, 5)).astype(np.float32),
             "n": np.zeros((6, 3, 5), np.int32)}
    state["a"][1, 0, 0] = np.inf
    state["a"][2, 1, 1] = np.nan
    state["b"][3, 2, 2] = -np.inf
    jnf = importlib.import_module("repro.runtime.sla").nonfinite_queries
    for combine in ("min", "sum"):
        want = jnf(state, combine=combine)
        np.testing.assert_array_equal(nonfinite_queries(state, combine),
                                      want)
        np.testing.assert_array_equal(nonfinite_queries(
            {k: torch.as_tensor(v) for k, v in state.items()}, combine),
            want)
    assert nonfinite_queries({"n": state["n"]}).shape == (0,)


def test_device_states_and_gathers_equal_the_host_ones(graphs, stream):
    """The slot states made on a device and the results gathered there
    (the session's and the batched entry points' way) equal the host
    construction and the per-partition host gather bit for bit."""
    tp = graphs[1]["main"][1]
    for alg in ("bfs", "sssp"):
        form = importlib.import_module(
            "repro_torch.algorithms.continuous").continuous_form(alg)
        step0 = np.arange(SLOTS) * 3
        host = form.make_slot_state(tp, stream[:SLOTS], step0)
        dev = form.make_slot_state(tp, stream[:SLOTS], step0, device="cpu")
        for k in host:
            assert isinstance(dev[k], torch.Tensor)
            np.testing.assert_array_equal(dev[k].numpy(), host[k])
    x = np.random.default_rng(1).random((3, tp.num_parts, tp.v_max),
                                        dtype=np.float32)
    want = np.stack([tp.gather_global(row) for row in x])
    np.testing.assert_array_equal(
        tbfs.gather_batch(tp, torch.as_tensor(x)), want)
    np.testing.assert_array_equal(tbfs.gather_batch(tp, x), want)


# ---------------------------------------------------------------------------
# the execute facade and ServeConfig: modes and errors, as in JAX
# ---------------------------------------------------------------------------

def test_execute_facade_routes_all_modes(graphs):
    tp = graphs[1]["main"][1]
    eng = _port(tp, "reference")
    state = {"level": tbfs.multi_source_state(tp, [1, 2])}
    want_state, want_steps = eng.execute(tbfs.BFS_PROGRAM, dict(state))
    got_state, steps_q, info = eng.execute(tbfs.BFS_PROGRAM, dict(state),
                                           chunk=2)
    assert info["chunks"] >= 1 and info["refilled"] == 0
    np.testing.assert_array_equal(steps_q.numpy(), want_steps.numpy())
    np.testing.assert_array_equal(got_state["level"].numpy(),
                                  want_state["level"].numpy())
    got = eng.execute(tbfs.BFS_PROGRAM, dict(state), num_steps=3)
    assert got["level"].shape == want_state["level"].shape


def _messages(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    raise AssertionError("did not raise")


def test_execute_facade_actionable_errors(graphs):
    """The same errors with the same text as the JAX engine."""
    jp, tp = graphs[1]["main"]
    state = {"level": tbfs.multi_source_state(tp, [1])}
    eng, jeng = _port(tp, "reference"), JEngine(jp)
    for kw in (dict(num_steps=3, chunk=2), dict(on_chunk=lambda s: None),
               dict(max_chunks=2), dict(fin=[False]), dict(start_step=2),
               dict(monitor=_Monitor(), steps_q=[0]),
               dict(chunk=0)):
        got = _messages(lambda: eng.execute(tbfs.BFS_PROGRAM, dict(state),
                                            **kw))
        want = _messages(lambda: jeng.execute(jbfs.BFS_PROGRAM,
                                              dict(state), **kw))
        assert got == want, kw
    assert "mutually exclusive" in _messages(lambda: eng.execute(
        tbfs.BFS_PROGRAM, dict(state), num_steps=3, chunk=2))[1]


def test_tiered_engine_refuses_chunk_as_jax(graphs):
    jp, tp = graphs[1]["main"]

    def budget(plan, pg):       # the densest partition hot, the rest cold
        return plan(pg, 1 << 62, block_e=256,
                    fused=False).table[1]["hbm_bytes"]

    eng = BSPEngine(tp, device="cpu", tiered=budget(TPT.build_tier_plan, tp),
                    block_e=256)
    jeng = JEngine(jp, tiered=budget(JPT.build_tier_plan, jp), block_e=256)
    state = {"level": tbfs.multi_source_state(tp, [1])}
    got = _messages(lambda: eng.execute(tbfs.BFS_PROGRAM, dict(state),
                                        chunk=2))
    want = _messages(lambda: jeng.execute(jbfs.BFS_PROGRAM, dict(state),
                                          chunk=2))
    assert got == want and got[0] is ValueError
    session = ServeSession(eng, "bfs", slots=SLOTS)
    session.submit([1, 2])
    with pytest.raises(ValueError, match="tiered engine"):
        session.drain()


def test_unported_parts_raise_naming_the_roadmap_item(graphs, stream,
                                                      tmp_path, capsys):
    """Checkpoints, chaos and certifiers (item 13) are ported: each call
    that raised naming the item now runs.  Mutations (item 11) are ported:
    on a static engine ``mutate`` refuses as JAX's does."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import ResultCertifier

    tg, tp = graphs[0], graphs[1]["main"][1]
    eng = _port(tp, "reference")
    session = ServeSession(eng, "bfs", slots=SLOTS)
    with pytest.raises(ValueError, match="needs a dynamic engine"):
        session.mutate(None)
    # snapshot and restore: a restored session drains to the same results
    session.submit(stream[:2 * SLOTS])
    session.step()
    mgr = CheckpointManager(tmp_path / "ckpt")
    session.snapshot(mgr)
    windows = session.windows
    session.drain()
    want = {r["query"]: r["result"] for r in session.poll()}
    again = ServeSession(eng, "bfs", slots=SLOTS)
    assert again.restore(mgr) == windows == again.windows
    again.drain()
    got = {r["query"]: r["result"] for r in again.poll()}
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[q], want[q]) for q in want)
    # a certified session certifies every completion
    cert = ServeSession(eng, "bfs", slots=SLOTS,
                        certifier=ResultCertifier("bfs", tg))
    cert.submit(stream[:SLOTS])
    rep = cert.drain()
    assert rep["certified_ok"] == SLOTS and rep["recomputed"] == 0
    # execute(chaos_ctx=) runs the chunked loop with the context
    out, steps, info = eng.execute(
        tbfs.BFS_PROGRAM, {"level": tbfs.multi_source_state(tp, [1])},
        chunk=2, chaos_ctx={"round": 0})
    assert info["chunks"] >= 1
    for flag, ok in (("--chaos", "CHAOS OK"), ("--corrupt", "CORRUPT OK")):
        assert tgs.main(["--smoke", "--device", "cpu", flag]) == 0
        assert capsys.readouterr().out.splitlines()[-1] == ok
    with pytest.raises(ValueError, match="no continuous form"):
        ServeSession(eng, "bc", slots=SLOTS)


@pytest.mark.parametrize("kw", [
    dict(depth_buckets=2, queue_capacity=8),
    dict(depth_buckets=2, deadline_ms=50.0),
    dict(mutate=True, depth_buckets=2), dict(mutate=True, deadline_ms=50.0),
    dict(mutate=True, queue_capacity=8),
    dict(continuous=True, alg="bc"), dict(continuous=True, alg="ppr"),
    dict(chaos=True, mutate=True), dict(chaos=True, continuous=True),
    dict(chaos=True, corrupt=True), dict(corrupt=True, deadline_ms=50.0),
    dict(corrupt=True, alg="bc")])
def test_serve_config_errors_equal_jax(kw):
    got = _messages(lambda: tgs.ServeConfig(**kw).validate())
    want = _messages(lambda: jgs.ServeConfig(**kw).validate())
    assert got == want and got[0] is ValueError


def test_serve_config_composes():
    for kw in (dict(continuous=True, deadline_ms=50.0, queue_capacity=8,
                    depth_buckets=2), dict(deadline_ms=50.0),
               dict(queue_capacity=8), dict(depth_buckets=2),
               dict(mutate=True), dict(continuous=True, mutate=True),
               dict(continuous=True, mutate=True, depth_buckets=2,
                    deadline_ms=50.0)):
        cfg = tgs.ServeConfig(**kw).validate()
        assert cfg.mode == jgs.ServeConfig(**kw).validate().mode
    # the drills (item 13) are ported: their flags validate to JAX's modes
    for kw in (dict(chaos=True), dict(corrupt=True),
               dict(corrupt=True, alg="sssp")):
        cfg = tgs.ServeConfig(**kw).validate()
        assert cfg.mode == jgs.ServeConfig(**kw).validate().mode
        assert cfg.mode in ("chaos", "corrupt")


# ---------------------------------------------------------------------------
# the launcher, and gloo worlds
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))


@pytest.mark.parametrize("mode", [[], ["--continuous"],
                                  ["--depth-buckets", "2"]])
def test_graph_serve_smoke_report_keys_equal_jax(mode, tmp_path,
                                                 monkeypatch):
    """``python -m repro_torch.launch.graph_serve --smoke --device cpu``:
    it prints GRAPH SERVE OK and writes JAX's report keys.  Both files
    also hold their launcher's command-line arguments, which differ (the
    port adds ``--device`` and has no flags of the modes it does not
    port), so each side's own arguments are taken out first."""
    out = tmp_path / "port.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.graph_serve", "--smoke",
         "--device", "cpu", "--out", str(out), *mode], env=_env(),
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    assert "GRAPH SERVE OK" in run.stdout
    if mode == ["--continuous"]:
        assert "0 mismatches" in run.stdout
    jout = tmp_path / "jax.json"
    jax_args = []
    parse = argparse.ArgumentParser.parse_args

    def record(self, *a, **k):
        ns = parse(self, *a, **k)
        jax_args.append(set(vars(ns)))
        return ns

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    assert jgs.main(["--smoke", "--backend", "reference", "--out",
                     str(jout), *mode]) == 0
    monkeypatch.undo()
    port_args = set(vars(tgs.build_parser().parse_args([])))
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert set(got) - port_args == set(want) - jax_args[-1]
    assert got.get("retraces", 0) == 0


@pytest.fixture(scope="module")
def world_reference():
    """The JAX single-device reference on the self-tests' graph
    (``rmat(8, 4, seed=13)``, uniform weights, 4 partitions, HIGH)."""
    g = JG.rmat(8, 4, seed=13).with_uniform_weights(seed=1)
    return (g, JEngine(JPT.partition(g, 4, JPT.HIGH, include_reverse=True),
                       direction_switch=False))


def _launch(module, world, tmp_path):
    path = tmp_path / "results.npz"
    cmd = [sys.executable, "-m", module, "--world", str(world), "--device",
           "cpu", "--init", (tmp_path / "rendezvous").as_uri(),
           "--timeout", "240", "--out", str(path)]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout, np.load(path)


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_continuous_selftest(world, tmp_path, world_reference):
    stdout, got = _launch("repro_torch.launch.continuous_selftest", world,
                          tmp_path)
    assert "CONTINUOUS SELFTEST OK" in stdout
    _, jeng = world_reference
    for alg in ("bfs", "sssp"):
        want = jrt.drain_reference(jeng, alg, got["stream"], SLOTS)
        for name in ("dist_fused", "dist_hybrid"):
            np.testing.assert_array_equal(got[f"{name}/{alg}"], want,
                                          err_msg=f"{name} {alg}")


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_batched_selftest(world, tmp_path, world_reference):
    stdout, got = _launch("repro_torch.launch.batched_selftest", world,
                          tmp_path)
    assert "BATCHED SELFTEST OK" in stdout
    _, jeng = world_reference
    sources = got["sources"]
    lv, steps = JA.bfs_batched(jeng, sources)
    dv, _ = JA.sssp_batched(jeng, sources)
    bc, _ = JA.betweenness_centrality_batched(jeng, sources)
    ppr = JA.personalized_pagerank(jeng, got["reset"], num_iterations=8)
    for name in ("dist_fused", "dist_hybrid"):
        np.testing.assert_array_equal(got[f"{name}/bfs"], lv)
        np.testing.assert_array_equal(got[f"{name}/bfs_steps"],
                                      np.asarray(steps))
        np.testing.assert_array_equal(got[f"{name}/sssp"], dv)
        np.testing.assert_allclose(got[f"{name}/bc"], bc, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got[f"{name}/ppr"], ppr, rtol=1e-4,
                                   atol=1e-7)
