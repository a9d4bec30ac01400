"""The port's dynamic graphs against the JAX package's, on the CPU.

Graphs: ``rmat(7, 4, seed=2)`` with uniform weights (CC: its symmetrized
graph) under RAND, HIGH and LOW at P = 2 or 4; mutation streams from
``edge_stream(..., seed=4)`` in both packages.

- The edge ledger (FIFO, instance ids, live weights), ``edge_stream``
  (symmetric too) and the rebuilt CSR equal JAX's; the ledger's array
  design holds an RMAT17 graph in seconds.
- ``DynamicGraph``: host mirrors and device payload after every batch,
  the ``apply_mutations`` report, ``staleness``, ``should_compact``,
  ``skew_drift``, ``dirty_since``, capacity errors, auto-compaction and
  ``memory_footprint_bytes(dynamic=)`` equal JAX's; the JAX payload
  carried across by ``convert.dynamic_payload`` equals the port's.
- Engines over the mutated graph: BFS, SSSP and CC on the reference, fused
  and hybrid backends bit for bit with equal steps against the JAX dynamic
  engine and against a fresh port engine over the rebuilt graph; PageRank
  within ``rtol=1e-6, atol=1e-9`` (the f32 tolerance of
  ``tests/test_fused_superstep.py``); BC run cold over the reverse deltas
  within ``rtol=1e-4, atol=1e-4``.
- Warm starts after an insert-only window: bit for bit a cold run in fewer
  supersteps, and JAX's warm results and steps.
- ``should_resplit`` and ``should_resplit_hybrid`` equal JAX's; a full
  spare row rebuilds the hybrid split; three batches rebuild nothing.
- The sharded engine over a dynamic graph (a world of one; gloo worlds of
  2 and 4 through ``dynamic_selftest`` and ``direction_selftest``).
- ``ServeSession.mutate`` and ``serve_continuous(mutation_stream=)``
  against drain batches; ``graph_serve --mutate`` reports JAX's keys.
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

from test_torch_jaxref import JEngine, JG, JPT, jbc, jbfs, jcc, jpr, jsssp

from repro_torch import convert
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core import perf_model as tpm
from repro_torch.core.hybrid import edge_max_ranks
from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine, batch_state
from repro_torch.core.dynamic import CapacityError, DynamicGraph
from repro_torch.data import graphs as TD
from repro_torch.launch import graph_serve as tgs
from repro_torch.runtime import ServeSession, drain_reference

JDyn = importlib.import_module("repro.core.dynamic")
JD = importlib.import_module("repro.data.graphs")
jpm = importlib.import_module("repro.core.perf_model")
jhy = importlib.import_module("repro.core.hybrid")
jgs = importlib.import_module("repro.launch.graph_serve")
tbfs, tcc, tsssp, tpr, tbc = (
    importlib.import_module(f"repro_torch.algorithms.{m}")
    for m in ("bfs", "cc", "sssp", "pagerank", "bc"))

SRC = Path(__file__).resolve().parents[1] / "src"
SOURCES = [0, 3, 17]
KW = {"reference": {}, "fused": dict(fused=True, block_e=256),
      "hybrid": dict(backend="hybrid")}


def _graphs(weighted=True, symmetric=False, scale=7):
    jg, tg = JG.rmat(scale, 4, seed=2), TG.rmat(scale, 4, seed=2)
    if symmetric:
        jg, tg = jcc.symmetrize(jg), tcc.symmetrize(tg)
    if weighted:
        jg, tg = jg.with_uniform_weights(seed=3), tg.with_uniform_weights(
            seed=3)
    return jg, tg


def _streams(jg, tg, num=3, size=24, churn=0.7, symmetric=False, seed=4):
    return (JD.edge_stream(jg, num, size, churn=churn, symmetric=symmetric,
                           seed=seed),
            TD.edge_stream(tg, num, size, churn=churn, symmetric=symmetric,
                           seed=seed))


def _same_batch(a, b):
    for k in ("src", "dst", "insert", "weight"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=k)


def _same_csr(a, b):
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col, b.col)
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        np.testing.assert_array_equal(a.weights, b.weights)


def _same_payload(jd, td):
    for rev in ([False, True] if jd.pg.rev is not None else [False]):
        jp, tp = jd.payload(rev), td.payload(rev)
        assert set(jp) == set(tp)
        for k in jp:
            np.testing.assert_array_equal(np.asarray(jp[k]), tp[k].numpy(),
                                          err_msg=f"{k} rev={rev}")
    for jds, tds in ((jd._fwd, td._fwd), (jd._rev, td._rev)):
        if jds is None:
            continue
        for k in ("tomb", "d_src", "d_dst_ext", "d_w", "d_cnt", "obox_dst",
                  "obox_used", "obox_used0", "base_p", "base_pos"):
            x, y = getattr(jds, k), getattr(tds, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=k)
        assert jds.d_free == tds.d_free
        assert jds.delta_loc == tds.delta_loc
    np.testing.assert_array_equal(jd.pg.out_deg, td.pg.out_deg)


# ---------------------------------------------------------------------------
# the ledger, the stream, the rebuild oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_ledger_stream_and_rebuild_equal_jax(symmetric, weighted):
    jg, tg = _graphs(weighted, symmetric)
    js, ts = _streams(jg, tg, num=5, size=40, churn=0.5,
                      symmetric=symmetric)
    for a, b in zip(js, ts):
        _same_batch(a, b)
    _same_csr(JG.apply_mutation_batches(jg, js),
              TG.apply_mutation_batches(tg, ts))
    jl, tl = JG.EdgeLedger(jg), TG.EdgeLedger(tg)
    for b in js:
        for i in range(len(b)):
            u, v = b.src[i], b.dst[i]
            if b.insert[i]:
                w = None if b.weight is None else b.weight[i]
                assert jl.insert(u, v, w) == tl.insert(u, v, w)
            else:
                assert jl.delete(u, v) == tl.delete(u, v)
            assert jl.alive_weights(u, v) == tl.alive_weights(u, v)
            assert jl.alive_count(u, v) == tl.alive_count(u, v)
    assert len(jl) == len(tl)
    for x, y in zip(jl.edge_list(), tl.edge_list()):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)
    ra, rb = np.random.default_rng(9), np.random.default_rng(9)
    for x, y in zip(jl.sample_alive(ra, 17), tl.sample_alive(rb, 17)):
        np.testing.assert_array_equal(x, y)


def test_ledger_fifo_pops_base_then_inserts():
    g = TG.from_edge_list(np.array([0, 1, 0]), np.array([1, 2, 1]), 3,
                          weights=np.array([2.0, 3.0, 5.0], np.float32))
    led = TG.EdgeLedger(g)
    iid = led.insert(0, 1, 7.0)
    assert iid == 3 and led.alive_weights(0, 1) == [2.0, 5.0, 7.0]
    assert led.delete(0, 1) == (0, 2.0)
    assert led.delete(0, 1) == (1, 5.0)
    assert led.delete(0, 1) == (3, 7.0)
    with pytest.raises(KeyError, match="absent edge"):
        led.delete(0, 1)
    assert len(led) == 1
    _same_csr(led.to_csr(3), TG.from_edge_list(
        np.array([1]), np.array([2]), 3, weights=np.array([3.0], np.float32)))


def test_ledger_builds_an_rmat17_graph_in_seconds():
    """The array ledger holds 2,097,152 edges without a Python object per
    edge or pair (the JAX ledger's deques take tens of seconds there)."""
    import time

    g = TG.rmat(17, 16, seed=20)
    t0 = time.perf_counter()
    led = TG.EdgeLedger(g)
    assert time.perf_counter() - t0 < 20.0
    assert len(led) == g.num_edges and not led._ins and not led._popped


# ---------------------------------------------------------------------------
# the dynamic graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("parts,strategy,reverse", [
    (2, "rand", False), (2, "high", True), (4, "low", False)])
def test_payload_and_report_equal_jax_after_each_batch(parts, strategy,
                                                        reverse):
    jg, tg = _graphs()
    js, ts = _streams(jg, tg, num=4, size=24)
    jd = JDyn.DynamicGraph(jg, parts, strategy, mutation_capacity=32,
                           include_reverse=reverse)
    td = DynamicGraph(tg, parts, strategy, mutation_capacity=32,
                      include_reverse=reverse, device="cpu")
    _same_payload(jd, td)
    marks = []
    for a, b in zip(js, ts):
        ra, rb = jd.apply_mutations(a), td.apply_mutations(b)
        assert set(ra) == set(rb)
        for k in ("num_edges", "inserts", "deletes", "monotone",
                  "compacted"):
            assert ra[k] == rb[k], k
        np.testing.assert_array_equal(np.sort(ra["dirty"]),
                                      np.sort(rb["dirty"]))
        _same_payload(jd, td)
        assert jd.staleness() == td.staleness()
        assert jd.should_compact() == td.should_compact()
        assert jd.num_edges == td.num_edges
        marks.append(td.mark())
        assert jd.mark() == marks[-1]
    assert jd.skew_drift() == td.skew_drift()
    assert (jd.should_compact(max_skew_drift=0.0)
            == td.should_compact(max_skew_drift=0.0))
    for m in [0] + marks:
        (jm, jmono), (tm, tmono) = jd.dirty_since(m), td.dirty_since(m)
        np.testing.assert_array_equal(jm, tm)
        assert jmono == tmono
        np.testing.assert_array_equal(jd.pg.scatter_dirty(jm),
                                      td.pg.scatter_dirty(tm))
    _same_csr(jd.mutated_csr(), td.mutated_csr())
    _same_csr(td.mutated_csr(), TG.apply_mutation_batches(tg, ts))
    assert (JPT.memory_footprint_bytes(jd.pg, dynamic=jd)
            == TPT.memory_footprint_bytes(td.pg, dynamic=td))
    assert (JPT.memory_residency_bytes(jd.pg, dynamic=jd)
            == TPT.memory_residency_bytes(td.pg, dynamic=td))
    # the JAX payload carried across equals the port's own
    for k, t in convert.dynamic_payload(jd.payload(), "cpu").items():
        assert torch.equal(t, td.payload()[k]), k
    # compaction folds the history: a fresh layout of the rebuilt graph
    assert td.compact() >= 0.0 and jd.compact() >= 0.0
    assert td.version == jd.version == 1 and td.log_floor == jd.log_floor
    _same_payload(jd, td)
    assert td.dirty_since(marks[0])[1] is False


def test_capacity_errors_and_auto_compaction_equal_jax():
    jg, tg = _graphs()
    js, ts = _streams(jg, tg, num=6, size=24, churn=1.0)
    # a batch over mutation_capacity
    jd = JDyn.DynamicGraph(jg, 2, "high", mutation_capacity=16)
    td = DynamicGraph(tg, 2, "high", mutation_capacity=16, device="cpu")
    with pytest.raises(JDyn.CapacityError, match="mutation_capacity"):
        jd.apply_mutations(js[0])
    with pytest.raises(CapacityError, match="mutation_capacity"):
        td.apply_mutations(ts[0])
    # delta slots that fill: the graph compacts first, then applies
    jd = JDyn.DynamicGraph(jg, 2, "high", mutation_capacity=24,
                           delta_slots=24, spare_outbox=24)
    td = DynamicGraph(tg, 2, "high", mutation_capacity=24, delta_slots=24,
                      spare_outbox=24, device="cpu")
    for a, b in zip(js, ts):
        ra, rb = jd.apply_mutations(a), td.apply_mutations(b)
        assert ra["compacted"] == rb["compacted"]
        assert jd.compactions == td.compactions
        _same_payload(jd, td)
    assert td.compactions > 0
    _same_csr(td.mutated_csr(), TG.apply_mutation_batches(tg, ts))


# ---------------------------------------------------------------------------
# engines over the mutated graph
# ---------------------------------------------------------------------------

def _engines(backend, parts, strategy, *, weighted=True, symmetric=False,
             reverse=False, stream_kw=None):
    jg, tg = _graphs(weighted, symmetric)
    js, ts = _streams(jg, tg, symmetric=symmetric, **(stream_kw or {}))
    jd = JDyn.DynamicGraph(jg, parts, strategy, mutation_capacity=96,
                           include_reverse=reverse)
    td = DynamicGraph(tg, parts, strategy, mutation_capacity=96,
                      include_reverse=reverse, device="cpu")
    return (tg, ts, jd, td, JEngine(jd, **KW[backend]),
            BSPEngine(td, device="cpu", **KW[backend]))


@pytest.mark.parametrize("backend", ["reference", "fused", "hybrid"])
@pytest.mark.parametrize("parts,strategy", [(2, "high"), (4, "rand")])
def test_min_programs_after_the_stream_equal_jax_and_a_fresh_engine(
        backend, parts, strategy):
    tg, ts, jd, td, je, te = _engines(backend, parts, strategy)
    tbfs.bfs_batched(te, SOURCES)          # builds before the stream
    for b in ts:
        td.apply_mutations(b)
    for b in _streams(*_graphs())[0]:
        jd.apply_mutations(b)
    fresh = BSPEngine(TPT.partition(TG.apply_mutation_batches(tg, ts), parts,
                                    strategy), device="cpu", **KW[backend])
    for jfn, tfn in ((jbfs.bfs_batched, tbfs.bfs_batched),
                     (jsssp.sssp_batched, tsssp.sssp_batched)):
        (jr, js_), (tr, ts_) = jfn(je, SOURCES), tfn(te, SOURCES)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(ts_, np.asarray(js_))
        np.testing.assert_array_equal(tr, tfn(fresh, SOURCES)[0])
    want = jpr.pagerank(je, num_iterations=8)
    got = tpr.pagerank(te, num_iterations=8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got, tpr.pagerank(fresh, num_iterations=8),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("backend", ["reference", "fused", "hybrid"])
def test_cc_after_a_symmetric_stream_equals_jax(backend):
    tg, ts, jd, td, je, te = _engines(backend, 2, "low", weighted=False,
                                      symmetric=True)
    for a, b in zip(_streams(*_graphs(False, True), symmetric=True)[0], ts):
        jd.apply_mutations(a)
        td.apply_mutations(b)
    (jl, js_), (tl, ts_) = (jcc.connected_components(je),
                            tcc.connected_components(te))
    np.testing.assert_array_equal(tl, jl)
    assert ts_ == js_
    np.testing.assert_array_equal(
        tl, tcc.cc_reference(TG.apply_mutation_batches(tg, ts)))


@pytest.mark.parametrize("backend", ["reference", "hybrid"])
def test_bc_runs_cold_on_the_reverse_deltas(backend):
    tg, ts, jd, td, je, te = _engines(backend, 2, "high", weighted=False,
                                      reverse=True)
    for a, b in zip(_streams(*_graphs(False))[0], ts):
        jd.apply_mutations(a)
        td.apply_mutations(b)
    got, tsteps = tbc.betweenness_centrality_batched(te, SOURCES)
    want, jsteps = jbc.betweenness_centrality_batched(je, SOURCES)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    fresh = BSPEngine(TPT.partition(TG.apply_mutation_batches(tg, ts), 2,
                                    "high", include_reverse=True),
                      device="cpu", **KW[backend])
    np.testing.assert_allclose(
        got, tbc.betweenness_centrality_batched(fresh, SOURCES)[0],
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["reference", "fused", "hybrid"])
def test_warm_starts_equal_cold_and_jax(backend):
    tg, ts, jd, td, je, te = _engines(backend, 2, "high")
    for a, b in zip(_streams(*_graphs())[0], ts):
        jd.apply_mutations(a)
        td.apply_mutations(b)
    prev = {"bfs": (tbfs.bfs_batched(te, SOURCES)[0],
                    jbfs.bfs_batched(je, SOURCES)[0]),
            "sssp": (tsssp.sssp_batched(te, SOURCES)[0],
                     jsssp.sssp_batched(je, SOURCES)[0])}
    tmark, jmark = td.mark(), jd.mark()
    ins_t = TD.edge_stream(td.mutated_csr(), 1, 24, churn=1.0, seed=11)[0]
    ins_j = JD.edge_stream(jd.mutated_csr(), 1, 24, churn=1.0, seed=11)[0]
    _same_batch(ins_j, ins_t)
    td.apply_mutations(ins_t)
    jd.apply_mutations(ins_j)
    dirty, monotone = td.dirty_since(tmark)
    assert monotone
    for name, tinc, tcold, jinc in (
            ("bfs", tbfs.bfs_incremental, tbfs.bfs_batched,
             jbfs.bfs_incremental),
            ("sssp", tsssp.sssp_incremental, tsssp.sssp_batched,
             jsssp.sssp_incremental)):
        warm, wsteps = tinc(te, prev[name][0], dirty)
        cold, csteps = tcold(te, SOURCES)
        np.testing.assert_array_equal(warm, cold, err_msg=name)
        assert wsteps.max() < csteps.max(), (name, wsteps, csteps)
        jwarm, jwsteps = jinc(je, prev[name][1], jd.dirty_since(jmark)[0])
        np.testing.assert_array_equal(warm, jwarm, err_msg=name)
        np.testing.assert_array_equal(wsteps, np.asarray(jwsteps))


def test_cc_warm_start_equals_cold_after_symmetric_inserts():
    _, tg = _graphs(False, True)
    td = DynamicGraph(tg, 2, "rand", mutation_capacity=64, device="cpu")
    te = BSPEngine(td, device="cpu", fused=True, block_e=256)
    prev, _ = tcc.connected_components(te)
    mark = td.mark()
    td.apply_mutations(TD.edge_stream(tg, 1, 24, churn=1.0, symmetric=True,
                                      seed=5)[0])
    dirty, monotone = td.dirty_since(mark)
    assert monotone
    warm, wsteps = tcc.cc_incremental(te, prev, dirty)
    cold, csteps = tcc.connected_components(te)
    np.testing.assert_array_equal(warm, cold)
    assert wsteps <= csteps


def test_incremental_without_a_form_returns_none():
    _, tg = _graphs(False)
    te = BSPEngine(TPT.partition(tg, 2, "high"), device="cpu")
    prog = tpr.make_pagerank_program(tg.num_vertices)
    state = batch_state(tpr.initial_state(te.pg))
    assert te.execute(prog, state,
                      incremental=np.zeros((2, te.pg.v_max), bool)) is None


def test_should_resplit_equals_jax():
    jg, tg = _graphs(False, scale=8)
    js, ts = _streams(jg, tg, num=3, size=48, churn=1.0)
    gm = TG.apply_mutation_batches(tg, ts)
    jm = JG.apply_mutation_batches(jg, js)
    cands = [0, 16, 32, 64, 128]
    for k in cands:
        got = tpm.should_resplit(edge_max_ranks(gm), gm.num_edges, cands,
                                 current_k=k)
        want = jpm.should_resplit(jhy.edge_max_ranks(jm), jm.num_edges,
                                  cands, current_k=k)
        assert got == want
    td = DynamicGraph(tg, 2, "high", mutation_capacity=64, device="cpu")
    jd = JDyn.DynamicGraph(jg, 2, "high", mutation_capacity=64)
    te = BSPEngine(td, device="cpu", backend="hybrid")
    je = JEngine(jd, backend="hybrid")
    for a, b in zip(js, ts):
        jd.apply_mutations(a)
        td.apply_mutations(b)
        for thr in (-1.0, 0.0, 0.10):
            assert (te.should_resplit_hybrid(thr)
                    == je.should_resplit_hybrid(thr))
            assert te.last_resplit_info == je.last_resplit_info
    assert not BSPEngine(td, device="cpu").should_resplit_hybrid()


def test_hybrid_spare_row_overflow_rebuilds_the_split():
    """Inserts into one destination beyond its row's spare slots: the split
    is rebuilt from the mutated graph, and results stay exact."""
    _, tg = _graphs()
    td = DynamicGraph(tg, 2, "high", mutation_capacity=16, device="cpu")
    te = BSPEngine(td, device="cpu", backend="hybrid", hybrid_k_dense=0,
                   dynamic_ell_spare=2)
    tbfs.bfs_batched(te, SOURCES)
    cfg, arrs = te.hybrid_for(tbfs.BFS_PROGRAM)
    assert cfg.spare and te.hybrid_dyn_rebuilds == 0
    rp0 = arrs["row_ptr"].clone()
    dst = np.full(6, 5)
    td.apply_mutations(TG.MutationBatch(np.arange(6) + 20, dst,
                                        np.ones(6, bool),
                                        np.full(6, 2.0, np.float32)))
    levels, _ = tbfs.bfs_batched(te, SOURCES)
    assert te.hybrid_dyn_rebuilds == 1
    fresh = BSPEngine(TPT.partition(td.mutated_csr(), 2, "high"),
                      device="cpu")
    np.testing.assert_array_equal(levels, tbfs.bfs_batched(fresh,
                                                           SOURCES)[0])
    # a batch that fits the spare slots writes in place: row_ptr kept
    _, arrs = te.hybrid_for(tbfs.BFS_PROGRAM)
    rp1 = arrs["row_ptr"].clone()
    assert not torch.equal(rp0, rp1)
    td.apply_mutations(TG.MutationBatch([30], [7], [True], [3.0]))
    tbfs.bfs_batched(te, SOURCES)
    assert te.hybrid_dyn_rebuilds == 1
    assert torch.equal(te.hybrid_for(tbfs.BFS_PROGRAM)[1]["row_ptr"], rp1)


def test_hybrid_spare_slots_read_the_sentinel_column():
    """Every spare slot holds the sentinel column n and the ⊗-identity, and
    the kernels' plain versions over rows of sentinels alone give the
    ⊕-identity (x carries it at n)."""
    from repro_torch.kernels.ops import bottomup_scan_op, ell_spmv_op

    _, tg = _graphs()
    td = DynamicGraph(tg, 2, "high", mutation_capacity=16, device="cpu")
    te = BSPEngine(td, device="cpu", backend="hybrid")
    cfg, arrs = te.hybrid_for(tsssp.SSSP_PROGRAM)
    n = cfg.num_vertices
    rp = arrs["row_ptr"].long()
    tail = torch.cat([torch.arange(int(rp[r + 1]) - 8, int(rp[r + 1]))
                      for r in range(n)])
    assert bool((arrs["col"][tail] == n).all())
    assert bool((arrs["val"][tail] == 0.0).all())
    x = torch.full((2, n + 1), 3.0)
    x[:, n] = float("inf")
    only = torch.arange(0, 8 * n + 1, 8, dtype=torch.int32)
    col = torch.full((8 * n,), n, dtype=torch.int32)
    y = ell_spmv_op(only, col, torch.zeros(8 * n), x, semiring="min_plus")
    assert bool(torch.isinf(y).all())
    y, _ = bottomup_scan_op(only, col, None, x, semiring="min")
    assert bool(torch.isinf(y).all())


def test_dynamic_hybrid_keeps_its_own_split():
    """In-place writes never reach the split a static engine over the same
    partitioned graph shares (``hybrid.splits_of``)."""
    _, tg = _graphs()
    td = DynamicGraph(tg, 2, "high", mutation_capacity=32, device="cpu")
    static = BSPEngine(td.pg, device="cpu", backend="hybrid")
    before, _ = tsssp.sssp_batched(static, SOURCES)
    dense0 = static.hybrid_for(tsssp.SSSP_PROGRAM)[1]["dense"].clone()
    te = BSPEngine(td, device="cpu", backend="hybrid")
    tsssp.sssp_batched(te, SOURCES)
    for b in TD.edge_stream(tg, 3, 24, seed=4):
        td.apply_mutations(b)
    tsssp.sssp_batched(te, SOURCES)
    assert torch.equal(static.hybrid_for(tsssp.SSSP_PROGRAM)[1]["dense"],
                       dense0)
    np.testing.assert_array_equal(tsssp.sssp_batched(static, SOURCES)[0],
                                  before)


@pytest.mark.parametrize("backend", ["reference", "fused", "hybrid"])
def test_three_batches_rebuild_nothing(backend):
    _, tg = _graphs()
    td = DynamicGraph(tg, 2, "high", mutation_capacity=32, device="cpu")
    te = BSPEngine(td, device="cpu", **KW[backend])
    tbfs.bfs_batched(te, SOURCES)
    tsssp.sssp_batched(te, SOURCES)
    entries = te.cache_entries()
    for b in TD.edge_stream(tg, 3, 24, seed=4):
        td.apply_mutations(b)
        tbfs.bfs_batched(te, SOURCES)
        tsssp.sssp_batched(te, SOURCES)
        assert te.cache_entries() == entries
    assert te.dynamic_rebinds == te.hybrid_dyn_rebuilds == 0
    td.compact()
    tbfs.bfs_batched(te, SOURCES)
    assert te.dynamic_rebinds == 1


def test_tiered_dynamic_raises_naming_item_11():
    """Item 11's tiered part is ported (tests/test_torch_tiered_dynamic.py);
    what still raises is the hybrid backend, with the JAX package's
    ValueError."""
    _, tg = _graphs()
    td = DynamicGraph(tg, 2, "high", device="cpu")
    with pytest.raises(ValueError, match="does not support dynamic graphs"):
        BSPEngine(td, device="cpu", backend="hybrid", tiered=1 << 30)
    assert BSPEngine(td, device="cpu", tiered=1 << 30).tier_plan is not None


@pytest.mark.parametrize("backend", ["reference", "fused", "hybrid"])
def test_sharded_engine_over_a_dynamic_graph(backend):
    """A world of one: the reference and fused backends read the payload,
    the hybrid consumes the batches by compaction; results equal a fresh
    engine over the rebuilt graph, PageRank through the fixed-step loop."""
    _, tg = _graphs()
    ts = TD.edge_stream(tg, 3, 24, seed=4)
    td = DynamicGraph(tg, 2, "high", mutation_capacity=32, device="cpu")
    te = DistributedBSPEngine(td, device="cpu", **KW[backend])
    tbfs.bfs_batched(te, SOURCES)
    for b in ts:
        td.apply_mutations(b)
    assert not te.should_resplit_hybrid()
    fresh = BSPEngine(TPT.partition(TG.apply_mutation_batches(tg, ts), 2,
                                    "high"), device="cpu")
    np.testing.assert_array_equal(tsssp.sssp_batched(te, SOURCES)[0],
                                  tsssp.sssp_batched(fresh, SOURCES)[0])
    assert td.compactions == (1 if backend == "hybrid" else 0)
    np.testing.assert_allclose(tpr.pagerank(te, num_iterations=8),
                               tpr.pagerank(fresh, num_iterations=8),
                               rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_session_mutate_keeps_drain_parity(backend):
    _, tg = _graphs()
    td = DynamicGraph(tg, 2, "high", mutation_capacity=32, device="cpu")
    te = BSPEngine(td, device="cpu", **KW[backend])
    session = ServeSession(te, "sssp", slots=4, chunk=2)
    rng = np.random.default_rng(3)
    for b in [None] + TD.edge_stream(tg, 2, 24, seed=4):
        if b is not None:
            rep = session.mutate(b)
            assert rep["num_edges"] == len(b)
        wave = rng.integers(0, tg.num_vertices, size=10)
        qids = session.submit(wave)
        session.drain()
        got = {r["query"]: r["result"] for r in session.poll()}
        want = drain_reference(te, "sssp", wave, 4)
        np.testing.assert_array_equal(np.stack([got[q] for q in qids]), want)
    assert session.retraces() == 0
    with pytest.raises(ValueError, match="dynamic engine"):
        ServeSession(BSPEngine(td.pg, device="cpu"), "bfs",
                     slots=4).mutate(None)


def test_serve_continuous_with_a_mutation_stream_equals_drain():
    _, tg = _graphs()
    td = DynamicGraph(tg, 2, "high", mutation_capacity=32, device="cpu")
    te = BSPEngine(td, device="cpu", fused=True, block_e=256)
    cfg = tgs.ServeConfig(alg="bfs", batch=4, mutate=True,
                          continuous=True).validate()
    rep = tgs.serve_continuous(
        te, tg, cfg, np.random.default_rng(1).integers(0, 128, size=16),
        dg=td, mutation_stream=TD.edge_stream(tg, 3, 24, seed=4),
        parity=True)
    assert rep["waves"] == 4 and rep["parity_checked"] == 16
    assert rep["parity_mismatches"] == 0 and rep["retraces"] == 0
    assert td.num_batches == 3


@pytest.mark.parametrize("backend", ["reference", "fused", "hybrid"])
def test_serve_mutating_refreshes_equal_jax(backend):
    """``graph_serve --mutate``'s drain regime: a mixed round refreshes the
    standing set cold, an insert-only round warm and bit-equal to cold,
    with JAX's modes and supersteps and no retrace."""
    tg, ts, jd, td, je, te = _engines(backend, 2, "high")
    tmut, jmut = td.mutated_csr(), jd.mutated_csr()
    rounds = [(JD.edge_stream(jmut, 1, 24, churn=c, seed=s)[0],
               TD.edge_stream(tmut, 1, 24, churn=c, seed=s)[0])
              for c, s in ((0.7, 12), (1.0, 13))]
    for jb, tb in rounds:
        _same_batch(jb, tb)
    kw = dict(batch=4, standing=4, query_batches_per_round=2, seed=5)
    got = tgs.serve_mutating(te, td, "bfs", batches=[b for _, b in rounds],
                             **kw)
    want = jgs.serve_mutating(je, jd, "bfs", batches=[b for b, _ in rounds],
                              **kw)
    assert got["retraces"] == 0
    for k in ("rounds", "mutation_edges", "incremental_steps", "cold_steps",
              "compactions", "resplits"):
        assert got[k] == want[k], k
    modes = []
    for g_, w_ in zip(got["per_round"], want["per_round"]):
        gr, wr = g_["refresh"], w_["refresh"]
        modes.append(gr["mode"])
        for k in ("mode", "cold_steps", "warm_steps", "bitwise_equal"):
            assert gr.get(k) == wr.get(k), k
    assert modes == ["cold", "incremental"]
    assert got["per_round"][1]["refresh"]["bitwise_equal"]


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))


def test_graph_serve_mutate_report_keys_equal_jax(tmp_path, monkeypatch):
    out = tmp_path / "port.json"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.graph_serve", "--smoke",
         "--device", "cpu", "--alg", "sssp", "--churn", "1.0", "--mutate",
         "--out", str(out)], env=_env(), capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    assert "GRAPH SERVE OK" in run.stdout
    jout = tmp_path / "jax.json"
    jax_args = []
    parse = argparse.ArgumentParser.parse_args

    def record(self, *a, **k):
        ns = parse(self, *a, **k)
        jax_args.append(set(vars(ns)))
        return ns

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    assert jgs.main(["--smoke", "--backend", "reference", "--alg", "sssp",
                     "--churn", "1.0", "--mutate", "--out", str(jout)]) == 0
    monkeypatch.undo()
    port_args = set(vars(tgs.build_parser().parse_args([])))
    got, want = json.loads(out.read_text()), json.loads(jout.read_text())
    assert set(got) - port_args == set(want) - jax_args[-1]
    assert got["retraces"] == 0 and got["incremental_steps"] is not None
    for r in got["per_round"]:
        assert r["refresh"]["bitwise_equal"]
    assert got["incremental_steps"] < got["cold_steps"]


# ---------------------------------------------------------------------------
# worlds of ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,ok", [
    ("repro_torch.launch.dynamic_selftest", "DYNAMIC SELFTEST OK"),
    ("repro_torch.launch.direction_selftest", "DIRECTION SELFTEST OK")])
@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_selftests(module, ok, world, tmp_path):
    cmd = [sys.executable, "-m", module, "--world", str(world), "--device",
           "cpu", "--init", (tmp_path / "rendezvous").as_uri(),
           "--timeout", "240"]
    out = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert ok in out.stdout


def test_direction_selftest_baselines_equal_jax():
    """The self-tests' single-device push baselines (``rmat(8, 4,
    seed=13)``, 4 partitions, HIGH) equal the JAX package's."""
    from repro_torch.algorithms.cc import symmetrize

    jg = JG.rmat(8, 4, seed=13).with_uniform_weights(seed=1)
    tg = TG.rmat(8, 4, seed=13).with_uniform_weights(seed=1)
    je = JEngine(JPT.partition(jg, 4, JPT.HIGH), direction="push")
    te = BSPEngine(TPT.partition(tg, 4, TPT.HIGH), direction="push",
                   device="cpu")
    for jfn, tfn in ((jbfs.bfs_batched, tbfs.bfs_batched),
                     (jsssp.sssp_batched, tsssp.sssp_batched)):
        np.testing.assert_array_equal(tfn(te, [0, 3, 11])[0],
                                      jfn(je, [0, 3, 11])[0])
    jgs_ = jcc.symmetrize(JG.rmat(8, 4, seed=13))
    tgs_ = symmetrize(TG.rmat(8, 4, seed=13))
    np.testing.assert_array_equal(
        tcc.connected_components(BSPEngine(TPT.partition(tgs_, 4, "high"),
                                           direction="push",
                                           device="cpu"))[0],
        jcc.connected_components(JEngine(JPT.partition(jgs_, 4, "high"),
                                         direction="push"))[0])
