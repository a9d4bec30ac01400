"""The port's tiered (out-of-core) memory against the JAX package's, on the
CPU.

The fixture is ``tests/test_oocore.py``'s: ``uniform(8, 6, seed=0)``,
weighted, P=4, HIGH, reverse edges, ``block_e=128``, ``win_blocks=2``,
beside an RMAT scale-8 graph with the least power-of-two ``win_blocks``
that plans.  Budgets are probed, not fixed: each package's
``build_tier_plan`` table row 2 (the two densest partitions hot), in each
package's own arena bytes.  Tolerances:

- the tier plan: the same hot and cold partitions and array-equal window
  schedules; the perf model's and the footprint's numbers exactly (the
  same formulas);
- tiered against resident within the port: bit for bit, sums included,
  with equal supersteps (the windows are clean cuts and each is written
  into its own segment range; the hybrid's row plans keep every row's
  lane count);
- the port's tiered engine against the JAX package's (interpret mode):
  BFS, SSSP, CC exactly with equal steps; PageRank ``rtol=1e-6,
  atol=1e-9`` and BC ``rtol=1e-5, atol=1e-5``, the f32 reassociation
  bounds of ``tests/test_fused_superstep.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_jaxref import JEngine, JG, JPT, jbc, jbfs, jcc, jpr, jsssp

from repro.core import perf_model as jpm

from repro_torch.algorithms import (betweenness_centrality_batched,
                                    bfs_batched, connected_components,
                                    pagerank, sssp_batched)
from repro_torch.algorithms.bfs import BFS_PROGRAM, multi_source_state
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core import perf_model as tpm
from repro_torch.core.bsp import BSPEngine
from repro_torch.kernels import ell_spmv as kell

BACKENDS = ("reference", "fused", "hybrid")
ALGS = ("bfs", "sssp", "cc", "pagerank", "bc")
SOURCES = [0, 3]
BLOCK_E, WIN_BLOCKS = 128, 2


def _graphs(kind):
    if kind == "uniform":
        return (JG.uniform(8, 6, seed=0).with_uniform_weights(),
                TG.uniform(8, 6, seed=0).with_uniform_weights())
    return (JG.rmat(8, 8, seed=3).with_uniform_weights(seed=7),
            TG.rmat(8, 8, seed=3).with_uniform_weights(seed=7))


def _planning_win_blocks(pg, plan_fn):
    """The least power-of-two ``win_blocks`` whose all-cold plan exists."""
    wb = 1
    while True:
        try:
            probe = plan_fn(pg, 1 << 60, block_e=BLOCK_E, win_blocks=wb)
            plan_fn(pg, probe.table[0]["hbm_bytes"], block_e=BLOCK_E,
                    win_blocks=wb)
            return wb
        except ValueError:
            wb *= 2


@pytest.fixture(scope="module", params=["uniform", "rmat"])
def case(request):
    """``(kind, JAX pg, port pg, win_blocks)``."""
    jg, tg = _graphs(request.param)
    jp = JPT.partition(jg, 4, JPT.HIGH, include_reverse=True)
    tp = TPT.partition(tg, 4, TPT.HIGH, include_reverse=True)
    wb = (WIN_BLOCKS if request.param == "uniform"
          else _planning_win_blocks(tp, TPT.build_tier_plan))
    return request.param, jp, tp, wb


@pytest.fixture(scope="module")
def pgs():
    """The uniform fixture in both packages: ``(JAX pg, port pg)``."""
    jg, tg = _graphs("uniform")
    return (JPT.partition(jg, 4, JPT.HIGH, include_reverse=True),
            TPT.partition(tg, 4, TPT.HIGH, include_reverse=True))


def _budget(plan_fn, pg, fused, win_blocks=WIN_BLOCKS, row=2):
    probe = plan_fn(pg, 1 << 60, block_e=BLOCK_E, win_blocks=win_blocks,
                    fused=fused)
    return int(probe.table[row]["hbm_bytes"])


def _port_budget(pg, backend, **kw):
    """The port plans the fused backend's block arrays and, on the other
    two, the reference compute's edge arrays."""
    return _budget(TPT.build_tier_plan, pg, backend == "fused", **kw)


def _jax_budget(pg, backend, **kw):
    """The JAX package plans block metadata on every backend but the
    reference (``tests/test_oocore.py::_budget``)."""
    return _budget(JPT.build_tier_plan, pg, backend != "reference", **kw)


def _port(pg, backend, tiered=None, **kw):
    return BSPEngine(pg, backend=backend, device="cpu", block_e=BLOCK_E,
                     tiered=tiered, win_blocks=kw.pop("win_blocks",
                                                      WIN_BLOCKS), **kw)


def _run(eng, alg, package="port"):
    """``(result, steps or None)`` as numpy."""
    mods = dict(bfs=(bfs_batched, jbfs.bfs_batched),
                sssp=(sssp_batched, jsssp.sssp_batched),
                cc=(connected_components, jcc.connected_components),
                pagerank=(pagerank, jpr.pagerank),
                bc=(betweenness_centrality_batched,
                    jbc.betweenness_centrality_batched))
    fn = mods[alg][0 if package == "port" else 1]
    if alg == "pagerank":
        return np.asarray(fn(eng, 20)), None
    out = fn(eng) if alg == "cc" else fn(eng, SOURCES)
    return np.asarray(out[0]), np.asarray(out[1])


def _bitwise(a, b) -> bool:
    return a.shape == b.shape and bool(
        np.all((a == b) | (np.isnan(a) & np.isnan(b))))


# -- (a) the tier plan -------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_tier_plan_matches_jax(case, fused):
    _, jp, tp, wb = case
    jplan = JPT.build_tier_plan(jp, _budget(JPT.build_tier_plan, jp, fused,
                                            wb), block_e=BLOCK_E,
                                win_blocks=wb, fused=fused)
    tplan = TPT.build_tier_plan(tp, _budget(TPT.build_tier_plan, tp, fused,
                                            wb), block_e=BLOCK_E,
                                win_blocks=wb, fused=fused)
    assert len(tplan.cold) == 2
    np.testing.assert_array_equal(tplan.hot, jplan.hot)
    np.testing.assert_array_equal(tplan.cold, jplan.cold)
    for d in ("fwd", "rev"):
        js, ts = getattr(jplan, d), getattr(tplan, d)
        assert (ts.block_e, ts.win_blocks) == (js.block_e, js.win_blocks)
        for key in ("part", "start", "count"):
            np.testing.assert_array_equal(getattr(ts, key),
                                          getattr(js, key), key)
    assert len(tplan.table) == len(jplan.table)
    for t, j in zip(tplan.table, jplan.table):
        assert (t["num_hot"], t["hot"], t["feasible"]) == (
            j["num_hot"], j["hot"], j["feasible"])
    assert tplan.window_count == jplan.window_count


def test_clean_cut_raises_where_jax_raises(case):
    _, jp, tp, wb = case
    cold = np.arange(4)
    for blocks in sorted({1, wb}):
        try:
            JPT._clean_cut_windows(jp.fwd, cold, BLOCK_E, blocks)
            raised = None
        except ValueError as exc:
            raised = exc
        if raised is None:
            got = TPT._clean_cut_windows(tp.fwd, cold, BLOCK_E, blocks)
            assert got.num_windows > 0
        else:
            with pytest.raises(ValueError, match="destination run"):
                TPT._clean_cut_windows(tp.fwd, cold, BLOCK_E, blocks)


# -- (b) the paper's model and the tier split --------------------------------

_GRID = [(e, b, r, c) for e in (0.0, 1e3, 7.5e6) for b in (0.0, 123.0, 4e5)
         for r in (1e9, 3e9, 1.2e10) for c in (3e9, 5e10)]
_PART_BYTES = [[700, 300, 1100, 500], [64] * 5, [10, 0, 10, 3, 9]]


@pytest.mark.parametrize("name", [
    "constants", "params", "partition_time", "makespan", "speedup",
    "speedup_curve", "mxu_crossover_density", "predicted_vs_measured",
    "host_stream_time", "rank_tier_split", "choose_tier_split"])
def test_perf_model_equals_jax(name):
    if name == "constants":
        for k in ("PAPER_PCIE_GBPS", "PAPER_BYTES_PER_EDGE_MSG", "PAPER_C",
                  "PAPER_R_CPU", "PAPER_R_GPU", "HOST_STREAM_BW"):
            assert getattr(tpm, k) == getattr(jpm, k), k
    elif name == "params":
        assert tpm.ModelParams.paper_defaults().__dict__ == (
            jpm.ModelParams.paper_defaults().__dict__)
        for bpe, msg in ((8.0, 4.0), (12.0, 8.0)):
            assert tpm.ModelParams.tpu_defaults(bpe, msg).__dict__ == (
                jpm.ModelParams.tpu_defaults(bpe, msg).__dict__)
    elif name == "partition_time":
        for e, b, r, c in _GRID:
            assert tpm.partition_time(e, b, r, c) == jpm.partition_time(
                e, b, r, c)
    elif name == "makespan":
        for e, b, r, c in _GRID:
            args = ([e, 2 * e + 1], [b, b / 3], [r, 2 * r], c)
            assert tpm.makespan(*args) == jpm.makespan(*args)
    elif name == "speedup":
        for a, b, r, c in _GRID:
            alpha = min(a / 7.5e6, 1.0) + 0.01
            assert tpm.speedup(alpha, b / 4e5, r, c) == jpm.speedup(
                alpha, b / 4e5, r, c)
    elif name == "speedup_curve":
        alphas = np.linspace(0.05, 1.0, 9)
        for beta in (0.0, 0.1, 0.5):
            np.testing.assert_array_equal(
                tpm.speedup_curve(alphas, beta, 1e9, 3e9),
                jpm.speedup_curve(alphas, beta, 1e9, 3e9))
    elif name == "mxu_crossover_density":
        for bpe in (4.0, 8.0, 16.0):
            assert tpm.mxu_crossover_density(bpe) == (
                jpm.mxu_crossover_density(bpe))
        assert tpm.mxu_crossover_density(8.0, 1e15, 3.35e12) == (
            jpm.mxu_crossover_density(8.0, 1e15, 3.35e12))
    elif name == "predicted_vs_measured":
        rng = np.random.default_rng(0)
        for n in (1, 2, 9):
            pred, meas = rng.random(n) + 0.5, rng.random(n) + 0.5
            assert tpm.predicted_vs_measured(pred, meas) == (
                jpm.predicted_vs_measured(pred, meas))
    elif name == "host_stream_time":
        for b in (0, 1, 123456789, 10 ** 12):
            for bw in (1.0, 16e9, 55e9):
                assert tpm.host_stream_time(b, bw) == jpm.host_stream_time(
                    b, bw)
    else:
        fn = getattr(tpm, name), getattr(jpm, name)
        for part_bytes in _PART_BYTES:
            for budget in (200, 1000, 2600, 10 ** 6):
                for kw in (dict(window_bytes=100),
                           dict(window_bytes=0, part_edges=[3, 1, 4, 1, 5][
                               :len(part_bytes)], stream_bw=1e9)):
                    try:
                        want = fn[1](part_bytes, budget, **kw)
                    except ValueError:
                        with pytest.raises(ValueError, match="double-buffer"):
                            fn[0](part_bytes, budget, **kw)
                        continue
                    assert fn[0](part_bytes, budget, **kw) == want


def test_choose_tier_split_monotone():
    """A bigger budget keeps a superset of partitions hot."""
    prev: set = set()
    for budget in range(200, 3000, 100):
        try:
            hot, _ = tpm.choose_tier_split([700, 300, 1100, 500], budget,
                                           window_bytes=100)
        except ValueError:
            assert budget < 200
            continue
        cur = set(int(p) for p in hot)
        assert prev <= cur, (budget, prev, cur)
        prev = cur
    assert prev == {0, 1, 2, 3}


# -- (c) the footprint -------------------------------------------------------

@pytest.mark.parametrize("tiered", [False, True])
def test_memory_footprint_equals_jax(case, tiered):
    _, jp, tp, wb = case
    jplan = tplan = None
    if tiered:
        jplan = JPT.build_tier_plan(jp, _budget(JPT.build_tier_plan, jp,
                                                False, wb),
                                    block_e=BLOCK_E, win_blocks=wb,
                                    fused=False)
        tplan = TPT.build_tier_plan(tp, _budget(TPT.build_tier_plan, tp,
                                                False, wb),
                                    block_e=BLOCK_E, win_blocks=wb,
                                    fused=False)
    for sb in (4, 8):
        assert TPT.memory_footprint_bytes(tp, sb, tier_plan=tplan) == (
            JPT.memory_footprint_bytes(jp, sb, tier_plan=jplan))
    got = TPT.memory_residency_bytes(tp, tier_plan=tplan)
    want = JPT.memory_residency_bytes(jp, tier_plan=jplan)
    assert got["host_bytes"] == want["host_bytes"]
    # the device side adds each package's own window buffers
    extra = (0 if not tiered else jplan.stream_buffer_bytes
             - tplan.stream_buffer_bytes)
    assert got["hbm_bytes"] == want["hbm_bytes"] - extra


# -- (d) tiered == resident, bit for bit -------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("alg", ALGS)
def test_tiered_matches_resident_bitwise(pgs, backend, alg):
    tp = pgs[1]
    eng = _port(tp, backend, _port_budget(tp, backend))
    assert len(eng.tier_plan.cold) >= 2
    assert eng.tier_plan.fwd.num_windows >= 3
    res, res_steps = _run(_port(tp, backend), alg)
    got, steps = _run(eng, alg)
    assert _bitwise(res, got)
    if steps is not None:
        np.testing.assert_array_equal(steps, res_steps)


def test_tiered_rmat_matches_resident_bitwise(case):
    kind, _, tp, wb = case
    for backend in BACKENDS:
        eng = _port(tp, backend, _port_budget(tp, backend, win_blocks=wb),
                    win_blocks=wb)
        for alg in ("bfs", "pagerank"):
            res, res_steps = _run(_port(tp, backend), alg)
            got, steps = _run(eng, alg)
            assert _bitwise(res, got), (kind, backend, alg)
            if steps is not None:
                np.testing.assert_array_equal(steps, res_steps)


# -- (e) the port's tiered engine against the JAX package's -------------------

@pytest.fixture(scope="module")
def jax_tiered(pgs):
    jp = pgs[0]
    return {b: JEngine(jp, backend=b, interpret=True, block_e=BLOCK_E,
                       win_blocks=WIN_BLOCKS, tiered=_jax_budget(jp, b))
            for b in BACKENDS}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("alg", ALGS)
def test_tiered_matches_jax_tiered(pgs, jax_tiered, backend, alg):
    je = jax_tiered[backend]
    te = _port(pgs[1], backend, _port_budget(pgs[1], backend))
    np.testing.assert_array_equal(te.tier_plan.hot, je.tier_plan.hot)
    want, want_steps = _run(je, alg, "jax")
    got, steps = _run(te, alg)
    if alg == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    elif alg == "bc":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    if steps is not None:
        np.testing.assert_array_equal(steps, want_steps)


# -- (f) budgets, residency, buffers and what a tiered engine refuses --------

def test_budget_below_buffer_floor_raises(pgs):
    with pytest.raises(ValueError, match="double-buffer"):
        _port(pgs[1], "reference", 64)


@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_all_cold_completes_at_4x_capacity(pgs, backend):
    """Every partition host-tier: only the window buffers on the device,
    the host holding at least 4x the budget, the result bit for bit."""
    tp, wb = pgs[1], 3
    probe = TPT.build_tier_plan(tp, 1 << 60, block_e=BLOCK_E, win_blocks=wb,
                                fused=backend == "fused")
    row0 = probe.table[0]
    budget = int(row0["hbm_bytes"])
    assert row0["host_bytes"] >= 4 * budget
    eng = _port(tp, backend, budget, win_blocks=wb)
    assert len(eng.tier_plan.hot) == 0
    stats = eng.tiered_stats()
    assert stats["hbm_resident_bytes"] <= budget
    assert stats["device_arena_bytes"] == budget
    for alg in ("bfs", "pagerank"):
        assert _bitwise(_run(_port(tp, backend), alg)[0], _run(eng, alg)[0])


def test_residency_split_admission_fields(pgs):
    tp = pgs[1]
    eng = _port(tp, "reference", _port_budget(tp, "reference"))
    r = eng.residency_bytes()
    assert r["hbm_bytes"] + r["host_bytes"] == r["total_bytes"]
    assert r["host_bytes"] > 0
    all_res = _port(tp, "reference").residency_bytes()
    assert all_res["host_bytes"] == 0
    # streaming trades the cold graph bytes for the two window buffers
    assert r["hbm_bytes"] == (all_res["hbm_bytes"] - r["host_bytes"]
                              + eng.tier_plan.stream_buffer_bytes)
    assert _port(tp, "reference").tiered_stats() is None


@pytest.mark.parametrize("backend", BACKENDS)
def test_no_buffer_made_after_the_first_superstep(pgs, backend):
    """The counterpart of the JAX zero-retrace gate: after a program's first
    superstep a tiered run makes no host arena and no window buffer."""
    tp = pgs[1]
    eng = _port(tp, backend, _port_budget(tp, backend))
    state = {"level": multi_source_state(tp, SOURCES)}
    eng.execute(BFS_PROGRAM, state, num_steps=1)
    after_one = eng.tiered_stats()["buffers_made"]
    counts = []
    for _ in range(3):
        eng.execute(BFS_PROGRAM, state, num_steps=4)
        bfs_batched(eng, SOURCES)
        counts.append(eng.tiered_stats()["buffers_made"])
    assert counts == [after_one] * 3
    pagerank(eng, 2)
    first_pr = eng.tiered_stats()["buffers_made"]
    pagerank(eng, 3)
    assert eng.tiered_stats()["buffers_made"] == first_pr


def test_tiered_refuses_dynamic_graphs_and_chunks(pgs):
    from repro_torch.core.dynamic import DynamicGraph

    tp = pgs[1]
    dynamic = DynamicGraph(tp.source, tp.num_parts, "high", device="cpu")
    # the hybrid refuses a tiered dynamic graph, as in JAX; the reference
    # and fused backends run it (tests/test_torch_tiered_dynamic.py)
    with pytest.raises(ValueError, match="does not support dynamic graphs"):
        BSPEngine(dynamic, backend="hybrid", device="cpu", tiered=1 << 30)
    eng = _port(tp, "fused", _port_budget(tp, "fused"))
    state = {"level": multi_source_state(tp, SOURCES)}
    # chunked mode is ported and refuses a tiered engine, as in JAX
    with pytest.raises(ValueError, match="not supported on a tiered"):
        eng.execute(BFS_PROGRAM, state, chunk=2)
    with pytest.raises(ValueError, match="tiered"):
        eng.edges_for(BFS_PROGRAM)
    plan = TPT.build_tier_plan(tp, 1 << 60, block_e=2 * BLOCK_E,
                               win_blocks=WIN_BLOCKS)
    with pytest.raises(ValueError, match="block_e"):
        _port(tp, "fused", plan)


# -- (g) the plan's device bytes are the engine's ----------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("row", [1, 2, 3])
def test_hbm_bytes_are_the_engines_device_bytes(pgs, backend, row):
    tp = pgs[1]
    eng = _port(tp, backend, _port_budget(tp, backend, row=row))
    held = sum(t.nbytes for td in eng._tier.values() if td.hot is not None
               for t in td.hot.values())
    if eng._tier_stream is not None:
        held += sum(t.nbytes for bufs in eng._tier_stream.bufs
                    for t in bufs.values())
    assert all(t.device.type == "cpu" for td in eng._tier.values()
               if td.hot is not None for t in td.hot.values())
    assert held == eng.tier_plan.hbm_bytes
    assert eng.tiered_stats()["device_arena_bytes"] == held
    assert eng._fwd is None and eng._rev is None


# -- the hybrid's window row plans ------------------------------------------

def test_row_plan_keeps_each_rows_lanes():
    """Rows cut out of a planned CSR and planned with ``lanes=`` keep their
    lane counts and chunking, and no run mixes lane counts."""
    rng = np.random.default_rng(0)
    short, wide = rng.integers(0, 3, 800), rng.integers(40, 300, 400)
    lens = np.concatenate([short[:700], wide[:300], [kell.BUDGET + 5],
                           short[700:], [3 * kell.BUDGET], wide[300:]])
    rp = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    full = kell.row_plan(rp)
    lanes = kell.plan_lanes(full)
    assert len(np.unique(lanes[lanes > 0])) > 1
    assert np.array_equal(lanes == 0, lens > kell.BUDGET)
    for sel in (np.sort(rng.choice(len(lens), 300, replace=False)),
                np.arange(len(lens))):
        ptr = np.concatenate([[0], np.cumsum(lens[sel])])
        plan = kell.row_plan(ptr, lanes=lanes[sel])
        np.testing.assert_array_equal(kell.plan_lanes(plan), lanes[sel])
        runs = plan.blocks[plan.blocks[:, 2] > 0]
        for r0, r1, L in runs:
            assert np.all(lanes[sel][r0:r1] == L)
        assert plan.num_partials == int(sum(-(-n // kell.BUDGET) for n in
                                            lens[sel] if n > kell.BUDGET))
    with pytest.raises(ValueError, match="lane count"):
        kell.row_plan(rp, lanes=np.zeros(len(lens), np.int32))


def test_hybrid_windows_cover_every_cold_row(pgs):
    tp = pgs[1]
    eng = _port(tp, "hybrid", _port_budget(tp, "hybrid"))
    ht = eng._hybrid_tiered_for(BFS_PROGRAM)
    cold = np.isin(ht.arrs["slot"].numpy() // tp.v_max, eng.tier_plan.cold)
    rows = np.concatenate([ht.arena.window("rows", w).numpy()
                           for w in range(ht.arena.num_windows)])
    np.testing.assert_array_equal(rows, np.flatnonzero(cold))
    np.testing.assert_array_equal(ht.arrs["rows"].numpy(),
                                  np.flatnonzero(~cold))
    assert eng.tiered_stats()["row_tier_host_bytes"] == ht.arena.nbytes
    assert torch.equal(ht.arrs["dense"], torch.as_tensor(
        eng._splits.split(ht.cfg.k_dense, False, "min",
                          False).dense_block))
