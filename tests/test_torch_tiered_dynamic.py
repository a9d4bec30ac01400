"""The port's tiered engine over a dynamic graph against the JAX package's,
on the CPU.

The fixture is ``tests/test_oocore.py::
test_mutation_roundtrip_on_host_tier_partition``'s: ``uniform(8, 6,
seed=0)`` weighted, P=4, HIGH, reverse edges, ``mutation_capacity=64``,
``block_e=128``, ``win_blocks=2``.  Budgets are each package's
``build_tier_plan(..., dynamic=)`` table row 2 (the two densest partitions
hot) in its own bytes.  The mutations: that test's batch (two inserts and
two deletes of edges into the first cold partition), then
``edge_stream(g, 3, 24, churn=0.7, seed=4)``.  The JAX engines run their
kernels in interpret mode.

Tolerances:

- the tier plan: the hot and cold sets and the window schedules of every
  table row equal JAX's, and the port's ``hbm_bytes`` equal the tiered
  engine's device bytes exactly;
- BFS, SSSP and CC: bit for bit with equal steps against the port's
  resident dynamic engine and against the JAX tiered dynamic engine;
- PageRank: bit for bit against the port's resident engine (on the CPU
  the reference scatter sums in a fixed order), and ``rtol=1e-6,
  atol=1e-9`` against JAX, the f32 tolerance of
  ``tests/test_fused_superstep.py``.
"""
import importlib

import numpy as np
import pytest

from test_torch_jaxref import JEngine, JG, JPT, jbfs, jcc, jpr, jsssp

from repro_torch.algorithms import (bfs_batched, connected_components,
                                    pagerank, sssp_batched)
from repro_torch.algorithms.bfs import BFS_PROGRAM, multi_source_state
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import BSPEngine
from repro_torch.core.dynamic import DynamicGraph
from repro_torch.core.graph import MutationBatch
from repro_torch.data import graphs as TD
from repro_torch.launch import graph_serve as tgs

JDyn = importlib.import_module("repro.core.dynamic")
JD = importlib.import_module("repro.data.graphs")
tbfs = importlib.import_module("repro_torch.algorithms.bfs")

SOURCES = [0, 3, 17]
BLOCK_E, WIN_BLOCKS, PARTS = 128, 2, 4
PR_TOL = dict(rtol=1e-6, atol=1e-9)
BACKENDS = ("reference", "fused")


def _graphs():
    return (JG.uniform(8, 6, seed=0).with_uniform_weights(),
            TG.uniform(8, 6, seed=0).with_uniform_weights())


def _dgs(jg, tg, capacity=64):
    return (JDyn.DynamicGraph(jg, PARTS, JPT.HIGH,
                              mutation_capacity=capacity,
                              include_reverse=True),
            DynamicGraph(tg, PARTS, "high", mutation_capacity=capacity,
                         include_reverse=True, device="cpu"))


def _port_budget(td, backend, row=2, win_blocks=WIN_BLOCKS):
    probe = TPT.build_tier_plan(td.pg, 1 << 60, block_e=BLOCK_E,
                                win_blocks=win_blocks,
                                fused=backend == "fused", dynamic=td)
    return int(probe.table[row]["hbm_bytes"])


def _jax_budget(jd, backend, row=2):
    probe = JPT.build_tier_plan(jd.pg, 1 << 60, block_e=BLOCK_E,
                                win_blocks=WIN_BLOCKS,
                                fused=backend == "fused", dynamic=jd)
    return int(probe.table[row]["hbm_bytes"])


def _port(td, backend, tiered=None, win_blocks=WIN_BLOCKS):
    return BSPEngine(td, backend=backend, device="cpu", block_e=BLOCK_E,
                     tiered=tiered, win_blocks=win_blocks)


def _jax(jd, backend, tiered):
    return JEngine(jd, fused=backend == "fused", block_e=BLOCK_E,
                   interpret=True, tiered=tiered, win_blocks=WIN_BLOCKS)


def _roundtrip_batch(g, part_of, cold_p):
    """``test_mutation_roundtrip_on_host_tier_partition``'s batch: two
    inserts and two deletes of edges into partition ``cold_p``."""
    src_all, dst_all = g.edge_sources(), g.col
    sel = np.where(part_of[dst_all] == cold_p)[0][:2]
    assert len(sel) == 2
    args = (np.concatenate([np.array([1, 3], np.int64), src_all[sel]]),
            np.concatenate([np.array([7, 9], np.int64), dst_all[sel]]),
            np.array([True, True, False, False]), np.ones(4, np.float32))
    return args


def _run(eng, alg, package="port"):
    """``(result, steps or None)`` as numpy."""
    mods = dict(bfs=(bfs_batched, jbfs.bfs_batched),
                sssp=(sssp_batched, jsssp.sssp_batched),
                cc=(connected_components, jcc.connected_components),
                pagerank=(pagerank, jpr.pagerank))
    fn = mods[alg][0 if package == "port" else 1]
    if alg == "pagerank":
        return np.asarray(fn(eng, 10)), None
    out = fn(eng) if alg == "cc" else fn(eng, SOURCES)
    return np.asarray(out[0]), np.asarray(out[1])


def _bitwise(a, b) -> bool:
    return a.shape == b.shape and bool(
        np.all((a == b) | (np.isnan(a) & np.isnan(b))))


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


# -- the tier plan -----------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_tier_plan_with_overlay_matches_jax_at_every_row(graphs, fused):
    jd, td = _dgs(*graphs)
    backend = "fused" if fused else "reference"
    jtab = JPT.build_tier_plan(jd.pg, 1 << 60, block_e=BLOCK_E,
                               win_blocks=WIN_BLOCKS, fused=fused,
                               dynamic=jd).table
    ttab = TPT.build_tier_plan(td.pg, 1 << 60, block_e=BLOCK_E,
                               win_blocks=WIN_BLOCKS, fused=fused,
                               dynamic=td).table
    assert len(ttab) == len(jtab) == PARTS + 1
    static = TPT.build_tier_plan(td.pg, 1 << 60, block_e=BLOCK_E,
                                 win_blocks=WIN_BLOCKS, fused=fused).table
    planned = 0
    for row in range(PARTS + 1):
        try:
            jplan = JPT.build_tier_plan(
                jd.pg, _jax_budget(jd, backend, row), block_e=BLOCK_E,
                win_blocks=WIN_BLOCKS, fused=fused, dynamic=jd)
        except ValueError:
            # a cold partition without a clean cut: the port raises too
            with pytest.raises(ValueError, match="destination run"):
                TPT.build_tier_plan(
                    td.pg, _port_budget(td, backend, row), block_e=BLOCK_E,
                    win_blocks=WIN_BLOCKS, fused=fused, dynamic=td)
            continue
        planned += 1
        tplan = TPT.build_tier_plan(
            td.pg, _port_budget(td, backend, row), block_e=BLOCK_E,
            win_blocks=WIN_BLOCKS, fused=fused, dynamic=td)
        np.testing.assert_array_equal(tplan.hot, jplan.hot)
        np.testing.assert_array_equal(tplan.cold, jplan.cold)
        for d in ("fwd", "rev"):
            js, ts = getattr(jplan, d), getattr(tplan, d)
            for key in ("part", "start", "count"):
                np.testing.assert_array_equal(getattr(ts, key),
                                              getattr(js, key), key)
        assert (ttab[row]["num_hot"], ttab[row]["hot"]) == (
            jtab[row]["num_hot"], jtab[row]["hot"])
        # the overlay only adds bytes
        assert ttab[row]["hbm_bytes"] > static[row]["hbm_bytes"]
    assert planned >= 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_hbm_bytes_equal_the_engines_device_bytes(graphs, backend):
    for row in (2, 3, PARTS):
        _, td = _dgs(*graphs)
        eng = _port(td, backend, _port_budget(td, backend, row))
        stats = eng.tiered_stats()
        assert stats["device_arena_bytes"] == eng.tier_plan.hbm_bytes, row
        assert eng.tier_plan.hbm_bytes <= eng.tier_plan.hbm_budget_bytes
        assert stats["num_hot"] == row


# -- the restated JAX round trip ----------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_mutation_roundtrip_on_host_tier_partition(graphs, backend):
    """A batch into a cold partition, then a mixed stream: the tiered
    dynamic engine equals the resident dynamic engine and JAX's tiered
    dynamic engine after every batch."""
    jg, tg = graphs
    jd, td = _dgs(jg, tg)
    _, rd = _dgs(jg, tg)
    je = _jax(jd, backend, _jax_budget(jd, backend))
    te = _port(td, backend, _port_budget(td, backend))
    re_ = _port(rd, backend)
    np.testing.assert_array_equal(te.tier_plan.cold, je.tier_plan.cold)
    cold_p = int(te.tier_plan.cold[0])
    args = _roundtrip_batch(tg, td.pg.assignment.part_of, cold_p)
    batches = [(JG.MutationBatch(*args), MutationBatch(*args))]
    batches += list(zip(JD.edge_stream(jg, 3, 24, churn=0.7, seed=4),
                        TD.edge_stream(tg, 3, 24, churn=0.7, seed=4)))
    for i, (jb, tb) in enumerate(batches):
        jd.apply_mutations(jb)
        td.apply_mutations(tb)
        rd.apply_mutations(tb)
        assert te.dynamic_rebinds == 0
        algs = ("bfs", "sssp", "cc", "pagerank") if i in (0, 3) else (
            "bfs", "sssp")
        for alg in algs:
            got, gsteps = _run(te, alg)
            res, rsteps = _run(re_, alg)
            want, wsteps = _run(je, alg, "jax")
            if alg == "pagerank":
                assert _bitwise(got, res), (i, alg)
                np.testing.assert_allclose(got, want, **PR_TOL)
                continue
            assert _bitwise(got, res), (i, alg)
            np.testing.assert_array_equal(gsteps, rsteps)
            assert _bitwise(got, want), (i, alg)
            np.testing.assert_array_equal(gsteps, wsteps)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batches_rebuild_nothing_and_a_compaction_replans(graphs, backend):
    """Windows of 4 blocks: the compacted layout needs them to plan."""
    _, tg = graphs
    _, td = _dgs(*graphs)
    _, rd = _dgs(*graphs)
    wb = 2 * WIN_BLOCKS
    budget = _port_budget(td, backend, win_blocks=wb)
    te, re_ = _port(td, backend, budget, wb), _port(rd, backend)
    _run(te, "bfs")
    entries = te.cache_entries()
    made = te.tiered_stats()["buffers_made"]
    plan0 = te.tier_plan
    for b in TD.edge_stream(tg, 3, 24, churn=0.7, seed=4):
        td.apply_mutations(b)
        rd.apply_mutations(b)
        _run(te, "bfs")
        _run(te, "sssp")
        assert te.cache_entries() == entries
        assert te.tiered_stats()["buffers_made"] == made
    assert te.tier_plan is plan0
    td.compact()
    rd.compact()
    got, gsteps = _run(te, "sssp")
    res, rsteps = _run(re_, "sssp")
    assert _bitwise(got, res)
    np.testing.assert_array_equal(gsteps, rsteps)
    assert te.dynamic_rebinds == 1
    assert te.tiered_stats()["buffers_made"] > made
    assert te.cache_entries() > entries
    # the new plan is the budget's plan over the compacted layout
    want = TPT.build_tier_plan(td.pg, budget, block_e=BLOCK_E,
                               win_blocks=wb,
                               fused=backend == "fused", dynamic=td)
    assert te.tier_plan is not plan0
    np.testing.assert_array_equal(te.tier_plan.hot, want.hot)
    for key in ("part", "start", "count"):
        np.testing.assert_array_equal(getattr(te.tier_plan.fwd, key),
                                      getattr(want.fwd, key))
    assert (te.tiered_stats()["device_arena_bytes"]
            == te.tier_plan.hbm_bytes == want.hbm_bytes)
    # and a prebuilt plan is re-planned at its budget too
    _, td2 = _dgs(*graphs)
    te2 = _port(td2, backend, TPT.build_tier_plan(
        td2.pg, budget, block_e=BLOCK_E, win_blocks=wb,
        fused=backend == "fused", dynamic=td2), wb)
    plan2 = te2.tier_plan
    td2.compact()
    _run(te2, "bfs")
    assert te2.tier_plan is not plan2
    np.testing.assert_array_equal(te2.tier_plan.hot, TPT.build_tier_plan(
        td2.pg, budget, block_e=BLOCK_E, win_blocks=wb,
        fused=backend == "fused", dynamic=td2).hot)


@pytest.mark.parametrize("backend", BACKENDS)
def test_warm_start_equals_cold_and_jax(graphs, backend):
    jg, tg = graphs
    jd, td = _dgs(jg, tg)
    je = _jax(jd, backend, _jax_budget(jd, backend))
    te = _port(td, backend, _port_budget(td, backend))
    for jb, tb in zip(JD.edge_stream(jg, 2, 24, churn=0.7, seed=4),
                      TD.edge_stream(tg, 2, 24, churn=0.7, seed=4)):
        jd.apply_mutations(jb)
        td.apply_mutations(tb)
    prev = tbfs.bfs_batched(te, SOURCES)[0]
    jprev = jbfs.bfs_batched(je, SOURCES)[0]
    tmark, jmark = td.mark(), jd.mark()
    td.apply_mutations(TD.edge_stream(td.mutated_csr(), 1, 24, churn=1.0,
                                      seed=11)[0])
    jd.apply_mutations(JD.edge_stream(jd.mutated_csr(), 1, 24, churn=1.0,
                                      seed=11)[0])
    dirty, monotone = td.dirty_since(tmark)
    assert monotone
    warm, wsteps = tbfs.bfs_incremental(te, prev, dirty)
    cold, csteps = tbfs.bfs_batched(te, SOURCES)
    np.testing.assert_array_equal(warm, cold)
    assert wsteps.max() < csteps.max(), (wsteps, csteps)
    jwarm, jwsteps = jbfs.bfs_incremental(je, jprev, jd.dirty_since(jmark)[0])
    np.testing.assert_array_equal(warm, np.asarray(jwarm))
    np.testing.assert_array_equal(wsteps, np.asarray(jwsteps))


# -- what a tiered dynamic engine refuses -------------------------------------

def test_hybrid_refuses_a_tiered_dynamic_graph(graphs):
    _, td = _dgs(*graphs)
    with pytest.raises(ValueError, match="does not support dynamic graphs"):
        BSPEngine(td, backend="hybrid", device="cpu", tiered=1 << 30)


def test_tiered_dynamic_refuses_chunks(graphs):
    _, td = _dgs(*graphs)
    eng = _port(td, "fused", _port_budget(td, "fused"))
    state = {"level": multi_source_state(eng.pg, SOURCES)}
    with pytest.raises(ValueError, match="not supported on a tiered"):
        eng.execute(BFS_PROGRAM, state, chunk=2)


def test_graph_serve_mutates_a_tiered_engine(capsys):
    """``graph_serve --mutate --hbm-budget``: the launcher builds the
    dynamic graph in host memory and serves it tiered with no rebuild."""
    probe_args = tgs.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--mutate", "--alg", "sssp",
         "--block-e", "128", "--win-blocks", "8"])
    probe_args.scale, probe_args.mutation_batch = 8, 32
    _, dg, _ = tgs.build_engine(probe_args, dynamic=True)
    assert dg.device.type == "cpu"
    budget = int(TPT.build_tier_plan(dg.pg, 1 << 60, block_e=128,
                                     win_blocks=8, fused=True,
                                     dynamic=dg).table[1]["hbm_bytes"])
    rc = tgs.main(["--smoke", "--device", "cpu", "--mutate", "--alg",
                   "sssp", "--block-e", "128", "--win-blocks", "8",
                   "--hbm-budget", str(budget)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "tiered: 1 hot / 3 host-tier partitions" in out
    assert "retraces=0" in out and "GRAPH SERVE OK" in out


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_compaction_that_lengthens_a_run_widens_the_windows(backend):
    """Inserts into one vertex of a cold partition make its run longer
    than the windows; after the compaction the engine re-plans with the
    least doubled ``win_blocks`` that cuts the new layout, and BFS equals
    the resident engine's."""
    tg = TG.uniform(10, 4, seed=1)
    fused = backend == "fused"
    kw = dict(mutation_capacity=2048, delta_slots=2048, device="cpu")
    td, rd = (DynamicGraph(tg, 2, "high", **kw) for _ in range(2))

    def least_cut(dg, wb):
        while True:
            try:
                TPT._clean_cut_windows(dg.pg.fwd, [0, 1], BLOCK_E, wb)
                return wb
            except TPT.NoCleanCutError:
                wb *= 2

    wb = least_cut(td, 1)
    run = (wb + 1) * BLOCK_E + 1         # straddles every window cut
    src = np.resize(np.setdiff1d(np.arange(tg.num_vertices), [5]), run)
    batch = MutationBatch(src.astype(np.int64), np.full(run, 5, np.int64),
                          np.ones(run, bool), None)
    rd.apply_mutations(batch)
    rd.compact()
    wide = least_cut(rd, wb)
    assert wide > wb
    # a budget that holds the wide windows with both partitions cold
    budget = int(TPT.build_tier_plan(
        rd.pg, 1 << 60, block_e=BLOCK_E, win_blocks=wide, fused=fused,
        dynamic=rd).table[0]["hbm_bytes"])
    te = BSPEngine(td, backend=backend, device="cpu", block_e=BLOCK_E,
                   tiered=budget, win_blocks=wb)
    assert len(te.tier_plan.cold) == 2
    td.apply_mutations(batch)
    td.compact()
    got, gsteps = _run(te, "bfs")
    want, wsteps = _run(_port(rd, backend), "bfs")
    assert _bitwise(got, want)
    np.testing.assert_array_equal(gsteps, wsteps)
    assert te.tier_plan.fwd.win_blocks == wide
    assert te.tiered_stats()["device_arena_bytes"] == te.tier_plan.hbm_bytes
