"""The port's hybrid backend against the JAX package's, on the CPU.

The five algorithms on ``BSPEngine(backend="hybrid")`` with
``hybrid_k_dense`` in {None (the planner's pick), 0 (pure sparse), 128}, on
the same graph, partition and sources in both packages.  Tolerances:

- BFS, SSSP, CC: results bit for bit with equal steps, and
  ``last_direction_stats`` (directions, edges examined, switches) equal as
  integers: the vote and the work model are deterministic;
- PageRank and BC: ``rtol=1e-6`` (``atol=1e-9`` for BC's zeros), the f32
  reassociation of the two packages' row sums and dense products at
  scale 9; BC's steps equal;
- ``hybrid_plan()``: equal ``k_dense``, ``mode`` and candidates.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import (JA, JEngine, assert_same_planner_table,
                               engine_case, jbc)

from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import SUM, BSPEngine, EdgeMessage, VertexProgram

talg = importlib.import_module("repro_torch.algorithms")
tbfs = importlib.import_module("repro_torch.algorithms.bfs")
tpr = importlib.import_module("repro_torch.algorithms.pagerank")

SCALE = 9
CASES = [("rmat", 2, "high"), ("uniform", 3, "rand")]
KS = [None, 0, 128]
SOURCES = [0, 5, 17]


def _hybrid(pg, k, package, **kw):
    if package == "jax":
        return JEngine(pg, backend="hybrid", hybrid_k_dense=k, **kw)
    return BSPEngine(pg, backend="hybrid", hybrid_k_dense=k, device="cpu",
                     **kw)


@pytest.fixture(scope="module", params=[(c, k) for c in CASES for k in KS],
                ids=lambda p: "-".join(map(str, p[0])) + f"-k{p[1]}")
def engines(request):
    """``{name: (jax engine, port engine)}`` for one case and k: the
    weighted graph with reverse edges, and its symmetrized form (CC)."""
    case, k = request.param
    _, jp, tp = engine_case(*case, scale=SCALE, weighted=True,
                            include_reverse=True)
    _, jps, tps = engine_case(*case, scale=SCALE, symmetric=True)
    return {"main": (_hybrid(jp, k, "jax"), _hybrid(tp, k, "port")),
            "cc": (_hybrid(jps, k, "jax"), _hybrid(tps, k, "port"))}


def _assert_same_stats(je, te):
    js, ts = je.last_direction_stats, te.last_direction_stats
    assert set(ts) == set(js)
    for key in js:
        np.testing.assert_array_equal(ts[key], np.asarray(js[key]), key)


def test_plan(engines):
    for je, te in engines.values():
        jplan, tplan = je.hybrid_plan(), te.hybrid_plan()
        for key in ("k_dense", "mode", "candidates", "skew"):
            assert tplan[key] == jplan[key], key
        assert_same_planner_table(tplan["table"], jplan["table"])


@pytest.mark.parametrize("alg", ["bfs_batched", "sssp_batched"])
def test_traversals(engines, alg):
    je, te = engines["main"]
    want = getattr(JA, alg)(je, SOURCES)
    got = getattr(talg, alg)(te, SOURCES)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_same_stats(je, te)


def test_connected_components(engines):
    je, te = engines["cc"]
    want, got = JA.connected_components(je), talg.connected_components(te)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    _assert_same_stats(je, te)


def test_pagerank(engines):
    je, te = engines["main"]
    np.testing.assert_allclose(talg.pagerank(te, 10), JA.pagerank(je, 10),
                               rtol=1e-6, atol=0)
    assert te.last_direction_stats is None


def test_betweenness_centrality(engines):
    je, te = engines["main"]
    want, want_steps = jbc.betweenness_centrality_batched(je, SOURCES)
    got, got_steps = talg.betweenness_centrality_batched(te, SOURCES)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got_steps, want_steps)


@pytest.mark.parametrize("k", KS)
def test_bc_runs_without_reverse_partitioning(k):
    """The hybrid backend degree-splits the reverse graph itself, so BC
    needs no ``include_reverse``; the reference backend still does."""
    _, jp, tp = engine_case("rmat", 2, "rand", scale=SCALE)
    assert tp.rev is None
    want, want_steps = JA.betweenness_centrality(_hybrid(jp, k, "jax"), 0)
    got, got_steps = talg.betweenness_centrality(_hybrid(tp, k, "port"), 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert got_steps == want_steps
    with pytest.raises(ValueError, match="include_reverse"):
        talg.betweenness_centrality(BSPEngine(tp, device="cpu"), 0)


@pytest.mark.parametrize("direction", ["push", "pull"])
def test_forced_directions_match_jax_and_plain_push(direction):
    _, jp, tp = engine_case("rmat", 2, "high", scale=SCALE, weighted=True)
    plain = _hybrid(tp, 128, "port", direction_switch=False)
    je = _hybrid(jp, 128, "jax", direction=direction)
    te = _hybrid(tp, 128, "port", direction=direction)
    for alg in ("bfs_batched", "sssp_batched"):
        want = getattr(talg, alg)(plain, SOURCES)
        assert plain.last_direction_stats is None
        got = getattr(talg, alg)(te, SOURCES)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        jwant = getattr(JA, alg)(je, SOURCES)
        np.testing.assert_array_equal(got[0], jwant[0])
        _assert_same_stats(je, te)
        expect = 1 if direction == "pull" else 0
        assert (te.last_direction_stats["direction"] == expect).all()


def test_program_without_edge_message_runs_the_reference_compute():
    _, _, tp = engine_case("rmat", 2, "high", scale=SCALE)
    bare = dataclasses.replace(tbfs.BFS_PROGRAM, edge_msg=None)
    eng = _hybrid(tp, None, "port")
    level0 = tbfs.multi_source_state(tp, SOURCES)
    got, steps = eng.execute(bare, {"level": level0})
    want, want_steps = BSPEngine(tp, device="cpu").execute(
        tbfs.BFS_PROGRAM, {"level": level0})
    assert torch.equal(got["level"], want["level"])
    assert torch.equal(steps, want_steps)
    assert eng.last_direction_stats is None
    assert not eng.provides_reverse(bare)


def test_weights_do_not_leak_into_unweighted_programs():
    """BFS, CC-style min and PageRank ignore weights: on a weighted graph
    they give what the unweighted graph gives (the split packs hop counts
    and multiplicities, not weights)."""
    g = TG.rmat(SCALE, 8, seed=3)
    weighted = TPT.partition(g.with_uniform_weights(seed=7), 2, TPT.HIGH)
    plain = TPT.partition(g, 2, TPT.HIGH)
    ew, ep = _hybrid(weighted, 128, "port"), _hybrid(plain, 128, "port")
    for a, b in zip(talg.bfs_batched(ew, SOURCES),
                    talg.bfs_batched(ep, SOURCES)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(talg.pagerank(ew, 5), talg.pagerank(ep, 5))


def test_weighted_sum_program_with_mul():
    """A sum program whose weight enters as ``weight_op="mul"`` runs on the
    hybrid backend under plus_times with the weights as ⊗ values; the
    reference backend is the yardstick (rtol 1e-6: f32 reassociation)."""
    g = TG.rmat(SCALE, 8, seed=3).with_uniform_weights(lo=0.5, hi=2.0,
                                                       seed=1)
    pg = TPT.partition(g, 2, TPT.HIGH)

    def edge_fn(state, src, weight, step):
        return torch.gather(state["rank"], 2, src.expand(
            state["rank"].shape[0], -1, -1)) * weight

    def msg(vals, weight, step, consts):
        return vals["rank"] * weight

    def apply_fn(state, acc, step):
        return dict(state, rank=acc * 0.5), torch.ones(
            acc.shape[0], dtype=torch.bool)

    prog = VertexProgram(combine=SUM, edge_fn=edge_fn, apply_fn=apply_fn,
                         edge_msg=EdgeMessage(gather=("rank",), fn=msg,
                                              use_weight=True,
                                              weight_op="mul"))
    hyb = _hybrid(pg, 128, "port")
    assert hyb._hybrid_semiring(prog) == "plus_times"
    state = {"rank": torch.as_tensor(
        tpr.initial_state(pg)["rank"])[None]}
    want = BSPEngine(pg, device="cpu").execute(prog, state, num_steps=3)
    got = hyb.execute(prog, state, num_steps=3)
    np.testing.assert_allclose(got["rank"].numpy(), want["rank"].numpy(),
                               rtol=1e-6, atol=1e-12)
    assert float(got["rank"].sum()) > 0


@pytest.mark.parametrize("alg", ["pagerank", "betweenness_centrality"])
def test_float64_state_raises(alg):
    """The kernels compute in float32, so float64 state raises rather than
    run in float32 under a float64 label, as on the fused backend."""
    _, _, tp = engine_case("rmat", 2, "high", scale=6, include_reverse=True)
    arg = 0 if alg == "betweenness_centrality" else 2   # source, iterations
    for backend in ("fused", "hybrid"):
        eng = BSPEngine(tp, backend=backend, device="cpu")
        with pytest.raises(ValueError, match=f"the {backend} backend "
                           f"computes in float32"):
            getattr(talg, alg)(eng, arg, dtype=torch.float64)


def test_engines_over_one_graph_share_the_split_work():
    """The ranking, plan, layouts and splits are host work on the graph
    alone: engines that differ in direction settings reuse them."""
    _, _, tp = engine_case("rmat", 2, "high", scale=SCALE, weighted=True,
                           include_reverse=True)
    vote = _hybrid(tp, None, "port")
    pull = _hybrid(tp, None, "port", direction="pull")
    other = _hybrid(tp, 128, "port", direction_switch=False)
    assert vote.hybrid_plan() is pull.hybrid_plan()
    assert other.hybrid_plan()["k_dense"] == 128
    for prog in (tbfs.BFS_PROGRAM, tpr.make_pagerank_program(
            tp.num_vertices)):
        a, b = vote.hybrid_for(prog)[1], pull.hybrid_for(prog)[1]
        assert vote.hybrid_for(prog)[0].forced is None
        assert pull.hybrid_for(prog)[0].forced == 1
        for key in ("dense", "row_ptr", "col", "val"):
            assert torch.equal(a[key], b[key]), key
    cache = tp.hybrid_splits
    k = vote.hybrid_plan()["k_dense"]
    assert cache.layout(k, False) is cache.layout(k, False)
    assert cache.split(k, False, "min", False) is cache.split(
        k, False, "min", False)
    assert dataclasses.replace(tp).hybrid_splits is None
    np.testing.assert_array_equal(talg.bfs_batched(vote, SOURCES)[0],
                                  talg.bfs_batched(pull, SOURCES)[0])


def test_hybrid_needs_the_source_graph():
    _, _, tp = engine_case("rmat", 1, "rand", scale=6)
    with pytest.raises(ValueError, match="source"):
        BSPEngine(dataclasses.replace(tp, source=None), backend="hybrid",
                  device="cpu")
