"""The port's result certifiers, invariant monitor and checked exchange
against the JAX package's, on the CPU.

Graph: ``rmat(7, 8, seed=0)`` (SSSP: uniform weights, seed 1; CC: its
symmetrized graph), 2 partitions under HIGH, as the JAX package's
``tests/test_verify.py`` uses.

- Certifier verdicts (``ok``, each check's name, ``ok`` and violation
  count, the failed names) equal JAX's on the port's engine fixpoints
  (reference, fused and hybrid backends) and on the perturbations
  ``tests/test_verify.py`` makes; ``recompute`` equals JAX's oracle.
- ``InvariantMonitor`` records equal JAX's over the fabricated window
  sequences of ``tests/test_verify.py`` and over sessions with refills,
  with and without a ``state.corrupt`` flip.
- The checked exchange: under ``exchange.payload`` the window raises
  ``ExchangeCorruption`` with JAX's mismatch count on the reference and
  fused backends (the hybrid on one device has no wire, in both), the
  replay is bit for bit the clean run, and a clean run counts nothing.

Everything is compared exactly: verdicts and records are integers, names
and slot lists; results bit for bit.
"""
import importlib
import re

import numpy as np
import pytest
import torch

from test_torch_jaxref import JEngine, JG, JPT, jbc, jbfs, jcc, jpr, jsssp

from repro_torch.algorithms import bc_reference, pagerank_reference
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import BSPEngine
from repro_torch.runtime import (ExchangeCorruption, FaultInjector,
                                 InvariantMonitor, ResultCertifier,
                                 ServeSession, certify, chaos,
                                 drain_reference, monitor_for)

tbfs, tcc, tsssp = (importlib.import_module(f"repro_torch.algorithms.{m}")
                    for m in ("bfs", "cc", "sssp"))
jrt = importlib.import_module("repro.runtime")
jver = importlib.import_module("repro.runtime.verify")
jchaos = importlib.import_module("repro.runtime.chaos")

KW = {"reference": {}, "fused": dict(fused=True, block_e=128),
      "hybrid": dict(backend="hybrid")}


@pytest.fixture(scope="module")
def graphs():
    """``{name: (numpy graph, JAX graph, JAX pg, port pg)}``."""
    out = {}
    for name in ("plain", "weighted", "sym"):
        tg, jg = TG.rmat(7, 8, seed=0), JG.rmat(7, 8, seed=0)
        if name == "weighted":
            tg, jg = (tg.with_uniform_weights(seed=1),
                      jg.with_uniform_weights(seed=1))
        elif name == "sym":
            tg, jg = tcc.symmetrize(tg), jcc.symmetrize(jg)
        out[name] = (tg, jg, JPT.partition(jg, 2, "high"),
                     TPT.partition(tg, 2, "high"))
    return out


def _same_verdict(v, jv):
    assert v.ok == jv.ok and v.algorithm == jv.algorithm
    assert [(c.name, c.ok, c.violations) for c in v.checks] == \
        [(c.name, c.ok, c.violations) for c in jv.checks]
    assert v.reason() == jv.reason()


def _both(alg, g, jg, result, source=None, **params):
    v = certify(alg, g, result, source=source, **params)
    jv = jver.certify(alg, jg, np.asarray(result), source=source, **params)
    _same_verdict(v, jv)
    return v


# ---------------------------------------------------------------------------
# certifiers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", sorted(KW))
@pytest.mark.parametrize("alg", ["bfs", "sssp", "cc"])
def test_verdicts_on_engine_fixpoints_equal_jax(graphs, backend, alg):
    name = {"bfs": "plain", "sssp": "weighted", "cc": "sym"}[alg]
    g, jg, _, tp = graphs[name]
    eng = BSPEngine(tp, device="cpu", **KW[backend])
    if alg == "bfs":
        res = tbfs.bfs(eng, 3)[0]
    elif alg == "sssp":
        res = tsssp.sssp(eng, 3)[0]
    else:
        res = tcc.connected_components(eng)[0]
    v = _both(alg, g, jg, res, source=None if alg == "cc" else 3)
    assert v.ok, v.summary()


def _first_reached(x):
    x = np.asarray(x, np.float64)
    return int(np.flatnonzero(np.isfinite(x) & (x > 0))[0])


@pytest.mark.parametrize("case", ["bfs_off_by_one", "bfs_fraction",
                                  "sssp_slack", "sssp_zeros",
                                  "cc_split", "pagerank_mass",
                                  "pagerank_sign", "bc_bump"])
def test_verdicts_on_perturbations_equal_jax(graphs, case):
    """The minimal perturbations of the JAX package's
    ``tests/test_verify.py``: both packages reject them, with the same
    checks failed and the same counts."""
    if case.startswith("bfs"):
        g, jg, _, tp = graphs["plain"]
        wrong = np.asarray(tbfs.bfs(BSPEngine(tp, device="cpu"), 3)[0],
                           np.float64)
        wrong[_first_reached(wrong)] += -1.0 if case.endswith("one") else 0.5
        v = _both("bfs", g, jg, wrong, source=3)
    elif case.startswith("sssp"):
        g, jg, _, tp = graphs["weighted"]
        wrong = np.asarray(tsssp.sssp(BSPEngine(tp, device="cpu"), 3)[0],
                           np.float64)
        if case == "sssp_slack":
            wrong[_first_reached(wrong)] += 1.0
        else:
            wrong = np.zeros(g.num_vertices)
        v = _both("sssp", g, jg, wrong, source=3)
    elif case == "cc_split":
        g, jg, _, tp = graphs["sym"]
        wrong = np.asarray(tcc.connected_components(
            BSPEngine(tp, device="cpu"))[0], np.float64)
        vtx = int(np.flatnonzero(wrong < np.arange(g.num_vertices))[0])
        wrong[vtx] = vtx
        v = _both("cc", g, jg, wrong)
    elif case.startswith("pagerank"):
        g, jg, _, _ = graphs["plain"]
        rank = np.asarray(pagerank_reference(g, num_iterations=20),
                          np.float64)
        np.testing.assert_array_equal(
            rank, np.asarray(jpr.pagerank_reference(jg, num_iterations=20)))
        if case == "pagerank_mass":
            wrong = rank * 1.5
        else:
            wrong = rank.copy()
            wrong[0] = -0.1
        v = _both("pagerank", g, jg, wrong, num_iterations=20)
        assert _both("pagerank", g, jg, rank, num_iterations=20).ok
    else:
        g, jg, _, _ = graphs["plain"]
        bcv = np.asarray(bc_reference(g, 3), np.float64)
        assert _both("bc", g, jg, bcv, source=3).ok
        wrong = bcv.copy()
        wrong[int(np.argmax(wrong))] += 1.0
        v = _both("bc", g, jg, wrong, source=3)
    assert not v.ok


@pytest.mark.parametrize("alg", ["bfs", "sssp", "cc", "pagerank", "bc"])
def test_recompute_equals_jax_oracle(graphs, alg):
    name = {"sssp": "weighted", "cc": "sym"}.get(alg, "plain")
    g, jg, _, _ = graphs[name]
    got = ResultCertifier(alg, g).recompute(3)
    want = jver.ResultCertifier(alg, jg).recompute(3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)
    assert ResultCertifier(alg, g).certify(got, source=3).ok


@pytest.mark.parametrize("alg", ["bfs", "sssp"])
def test_recompute_on_a_card_is_the_engines_rerun(graphs, alg):
    """A card session's recompute (``_rerun``: the query alone through the
    engine from step 0) equals the engine's drain answer bit for bit and
    passes the certifier; a CPU session's is the numpy oracle, as in the
    JAX package."""
    g, _, _, tp = graphs["weighted"]
    eng = BSPEngine(tp, device="cpu", **KW["fused"])
    sources = [3, 17, 40]
    want = drain_reference(eng, alg, sources, 4)
    cert = ResultCertifier(alg, g)
    s = ServeSession(eng, alg, slots=4, chunk=2, certifier=cert)
    for i, src in enumerate(sources):
        got = s._rerun(src)
        np.testing.assert_array_equal(got, want[i])
        assert cert.certify(got, source=src).ok
    np.testing.assert_array_equal(s._recompute(3), cert.recompute(3))


def test_certify_batch_and_unknown_algorithm(graphs):
    g, _, _, tp = graphs["plain"]
    levels = tbfs.bfs(BSPEngine(tp, device="cpu"), 3)[0]
    verdicts = ResultCertifier("bfs", g).certify_batch(
        np.stack([levels, levels]), sources=[3, 3])
    assert len(verdicts) == 2 and all(v.ok for v in verdicts)
    with pytest.raises(ValueError, match="no certifier registered"):
        ResultCertifier("nope", g)
    with pytest.raises(ValueError, match="no monitor profile"):
        monitor_for("nope")


# ---------------------------------------------------------------------------
# the invariant monitor
# ---------------------------------------------------------------------------

INF, NAN = np.inf, np.nan
# (monitor kwargs, [window (level rows, fin, steps_q, step) or
# ("rebase", mask)]): the sequences of the JAX package's tests/test_verify.py
MONITOR_CASES = {
    "monotone": (dict(combine="min", chunk=4), [
        ([[0, INF, INF], [0, INF, INF]], [False, False], [4, 4], 4),
        ([[0, 1, INF], [0, 1, 2]], [False, True], [8, 6], 8)]),
    "regression": (dict(combine="min", chunk=4), [
        ([[0, 1, 2]], [False], [4], 4), ([[0, 3, 2]], [False], [8], 8)]),
    "rebase": (dict(combine="min", chunk=4), [
        ([[0, 1], [0, 1]], [False, False], [4, 4], 4),
        ("rebase", [True, False]),
        ([[5, 9], [0, 9]], [False, False], [1, 8], 8)]),
    "finiteness": (dict(combine="min"), [
        ([[0, NAN], [0, NAN]], [False, True], [2, 2], 2)]),
    "sum_inf": (dict(combine="sum"), [([[0, INF]], [False], [1], 1)]),
    "frontier": (dict(combine="min", chunk=2), [
        ([[0, 1]], [True], [4], 4), ([[0, 1]], [False], [3], 6),
        ([[0, 1]], [False], [9], 8)]),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_monitor_records_equal_jax(case, as_tensor):
    kw, windows = MONITOR_CASES[case]
    mon = InvariantMonitor(keys=("level",), **kw)
    jmon = jver.InvariantMonitor(keys=("level",), **kw)
    for w in windows:
        if w[0] == "rebase":
            mon.rebase(w[1])
            jmon.rebase(w[1])
            continue
        level, fin, steps, step = w
        level = np.asarray(level, np.float32)
        snap = dict(state={"level": torch.as_tensor(level) if as_tensor
                           else level},
                    finished=np.asarray(fin, bool),
                    steps_q=np.asarray(steps, np.int32), step=step)
        jsnap = dict(snap, state={"level": level})
        assert mon.observe(snap) == jmon.observe(jsnap)
    assert mon.fired == jmon.fired and mon.windows == jmon.windows
    assert mon.violations == jmon.violations
    if case != "monotone":
        assert mon.violations > 0


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("alg", ["bfs", "sssp"])
def test_session_monitor_records_equal_jax(graphs, alg, corrupt):
    """A session with refills (12 sources through 4 slots) and
    ``monitor_for``: the same records at every window as JAX's, clean (no
    record fires) and with a ``state.corrupt`` flip at step 0."""
    g, jg, jp, tp = graphs["weighted"]
    sources = np.random.default_rng(5).integers(0, g.num_vertices, 12)

    def run(make, engine, mon, ch, inj):
        s = make(engine, alg, slots=4, chunk=2, monitor=mon)
        s.submit(sources)
        if inj is None:
            return s.drain()
        with ch.active(inj):
            return s.drain()

    def inj(cls):
        return (cls(sites={"state.corrupt": [{"step": 0, "flag": True}]})
                if corrupt else None)

    mon, jmon = monitor_for(alg, chunk=2), jver.monitor_for(alg, chunk=2)
    rep = run(ServeSession, BSPEngine(tp, device="cpu", **KW["fused"]),
              mon, chaos, inj(FaultInjector))
    jrep = run(jrt.ServeSession, JEngine(jp, **KW["fused"]), jmon, jchaos,
               inj(jrt.FaultInjector))
    assert mon.fired == jmon.fired and mon.windows == jmon.windows
    assert rep["monitors_fired"] == jrep["monitors_fired"]
    assert rep["refills"] == jrep["refills"] == 8
    assert (rep["monitors_fired"] > 0) == corrupt


# ---------------------------------------------------------------------------
# the checked exchange
# ---------------------------------------------------------------------------

def _tags(exc) -> int:
    return int(re.search(r"\((\d+) tag\(s\)\)", str(exc)).group(1))


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("backend", sorted(KW))
def test_checked_exchange_count_equals_jax(graphs, backend, chunk):
    _, _, jp, tp = graphs["plain"]
    state = tbfs.multi_source_state(tp, [1, 2])
    eng = BSPEngine(tp, device="cpu", **KW[backend])
    jeng = JEngine(jp, **KW[backend])

    def run(e, s):
        st, steps_q, _ = e.execute(s.BFS_PROGRAM, {"level": state.copy()},
                                   chunk=chunk)
        return s.gather_batch(e.pg, st["level"]), np.asarray(steps_q)

    clean, steps = run(eng, tbfs)
    got = want = None
    inj = FaultInjector(sites={"exchange.payload": [{"step": 0,
                                                     "flag": True}]})
    jinj = jrt.FaultInjector(sites={"exchange.payload": [{"step": 0,
                                                          "flag": True}]})
    try:
        with chaos.active(inj):
            run(eng, tbfs)
    except ExchangeCorruption as e:
        got = _tags(e)
    try:
        with jchaos.active(jinj):
            run(jeng, jbfs)
    except jrt.ExchangeCorruption as e:
        want = _tags(e)
    assert got == want
    assert (got is None) == (backend == "hybrid")
    if got is not None:
        assert got == chunk        # one flipped element per superstep
    replay, replay_steps = run(eng, tbfs)
    np.testing.assert_array_equal(replay, clean)
    np.testing.assert_array_equal(replay_steps, steps)
    jclean, jsteps = run(jeng, jbfs)
    np.testing.assert_array_equal(clean, jclean)
    np.testing.assert_array_equal(steps, jsteps)


def test_clean_windows_count_no_mismatch(graphs):
    """The guard's count is zero on clean windows and None where no
    exchange runs (the single-device hybrid)."""
    _, _, _, tp = graphs["plain"]
    state = {"level": torch.as_tensor(tbfs.multi_source_state(tp, [1]))}
    fin = torch.zeros(1, dtype=torch.bool)
    steps_q = torch.zeros(1, dtype=torch.int32)
    for backend, want in (("reference", 0), ("fused", 0), ("hybrid", None)):
        eng = BSPEngine(tp, device="cpu", **KW[backend])
        *_, bad = eng._chunk_call(tbfs.BFS_PROGRAM, 2, state, 0, fin,
                                  steps_q)
        assert (None if bad is None else int(bad)) == want, backend
