"""The JAX package's last public entry points in the port, on the CPU:
all-sources BC (``bc_exact``), TEPS, ``to_dense``, the workload loader,
the planner's accessors and the sharded engine's ``superstep()`` hook,
each against the JAX function.

Tolerances: ``bc_exact`` against JAX's ``rtol=1e-5, atol=1e-5`` (the bound
``tests/test_fused_superstep.py`` uses between fused and reference BC)
and against the float64 Brandes oracle summed over all sources
``rtol=1e-3, atol=1e-3`` (``tests/test_core_engine.py``'s); PageRank
supersteps against JAX's ``rtol=1e-6, atol=1e-9``
(``tests/test_fused_superstep.py``'s); everything else bit for bit.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import JA, engine_case, jax_engine, jbfs, jpr

from repro_torch import algorithms as TA
from repro_torch.configs.totem_rmat import GraphWorkload
from repro_torch.core import graph as TG
from repro_torch.core import hybrid as TH
from repro_torch.core import perf_model as tpm
from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine
from repro_torch.data import TokenStream, load_workload
from repro_torch.launch.world import run_world

JH = importlib.import_module("repro.core.hybrid")
jpm = importlib.import_module("repro.core.perf_model")
jgraph = importlib.import_module("repro.core.graph")
jdata = importlib.import_module("repro.data")
jcfg = importlib.import_module("repro.configs.totem_rmat")
tbfs = importlib.import_module("repro_torch.algorithms.bfs")
tpr = importlib.import_module("repro_torch.algorithms.pagerank")

BACKENDS = ("reference", "fused", "hybrid")
KW = {"reference": {}, "fused": dict(block_e=128), "hybrid": {}}


def _engine(pg, backend):
    return BSPEngine(pg, backend=backend, device="cpu", **KW[backend])


# ---------------------------------------------------------------------------
# bc_exact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[("rmat", 2, "high"),
                                        ("uniform", 3, "rand")],
                ids=lambda c: "-".join(map(str, c)))
def bc_graph(request):
    g, jp, tp = engine_case(*request.param, scale=6, include_reverse=True)
    return g, tp, JA.bc_exact(jax_engine(jp), chunk=24)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bc_exact_matches_jax_and_the_oracle(bc_graph, backend):
    g, tp, want = bc_graph
    got = TA.bc_exact(_engine(tp, backend), chunk=24)
    assert got.dtype == np.float32 and got.shape == (g.num_vertices,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle = np.sum([TA.bc_reference(g, s).astype(np.float64)
                     for s in range(g.num_vertices)], axis=0)
    np.testing.assert_allclose(got, oracle, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("chunk", [24, None], ids=["chunk24", "one_batch"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_bc_exact_is_bitwise_the_sequential_loop(bc_graph, backend, chunk):
    """``tests/test_batched.py``'s contract in the port: 64 sources in
    chunks of 24 (two full, one padded with source 0) or one batch, bit for
    bit the per-source loop."""
    _, tp, _ = bc_graph
    eng = _engine(tp, backend)
    np.testing.assert_array_equal(TA.bc_exact(eng, chunk=chunk),
                                  TA.bc_exact_sequential(eng))


def test_bc_exact_sequential_matches_jax():
    g, jp, tp = engine_case("rmat", 2, "rand", scale=5,
                            include_reverse=True)
    np.testing.assert_allclose(
        TA.bc_exact_sequential(_engine(tp, "reference")),
        JA.bc_exact_sequential(jax_engine(jp)), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# TEPS, to_dense, the workload loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_teps_and_to_dense_match_jax(weighted):
    g, jp, tp = engine_case("rmat", 2, "high", scale=7, weighted=weighted)
    tg = TG.rmat(7, 8, seed=3)
    if weighted:
        tg = tg.with_uniform_weights(seed=7)
    np.testing.assert_array_equal(TG.to_dense(tg), jgraph.to_dense(g))
    levels, _ = TA.bfs(_engine(tp, "reference"), 0)
    jlevels, _ = JA.bfs(jax_engine(jp), 0)
    np.testing.assert_array_equal(levels, jlevels)
    for seconds in (0.25, 0.0):
        assert tbfs.teps(tg, levels, seconds) == jbfs.teps(g, jlevels,
                                                           seconds)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["rmat", "uniform"])
def test_load_workload_matches_jax(kind, weighted):
    w = GraphWorkload(f"{kind}9", 9, 8, kind)
    jw = jcfg.GraphWorkload(f"{kind}9", 9, 8, kind)
    for seed in (1, 5):
        got = load_workload(w, seed=seed, weighted=weighted)
        want = jdata.load_workload(jw, seed=seed, weighted=weighted)
        assert got.num_vertices == want.num_vertices
        np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
        np.testing.assert_array_equal(got.col, want.col)
        assert (got.weights is None) == (not weighted)
        if weighted:
            np.testing.assert_array_equal(got.weights, want.weights)
    with pytest.raises(ValueError):
        load_workload(GraphWorkload("x", 4, kind="grid"))
    assert TokenStream is not None and jdata.TokenStream is not None


# ---------------------------------------------------------------------------
# the planner's accessors
# ---------------------------------------------------------------------------

def test_dense_block_rate_matches_jax():
    for density in (1.0, 0.25, 1e-3):
        assert tpm.dense_block_rate(density) == jpm.dense_block_rate(density)
        assert (tpm.dense_block_rate(density, peak_flops=67e12)
                == jpm.dense_block_rate(density, peak_flops=67e12))


@pytest.mark.parametrize("kind", ["rmat", "uniform"])
def test_auto_split_accessors_match_jax(kind):
    """``k_dense`` for 1, 2 and 4 chips, and the split's density, dense
    fraction and predicted makespan (candidates a lane of 8 wide, so the
    ladder has rungs at this scale)."""
    g, _, _ = engine_case(kind, 1, "rand", scale=9)
    tg = (TG.rmat if kind == "rmat" else TG.uniform)(9, 8, seed=3)
    cands = [0, 8, 16, 32, 64, 128, 256]
    for chips in (1, 2, 4):
        got = TH.auto_degree_split(tg, "plus_times", candidates=cands,
                                   num_chips=chips)
        want = JH.auto_degree_split(g, "plus_times", candidates=cands,
                                    num_chips=chips)
        assert got.k_dense == want.k_dense
        assert got.model_table == want.model_table
        assert got.dense_density == want.dense_density
        assert got.dense_fraction == want.dense_fraction
        for n in (1, chips, 4):
            assert got.predicted_makespan(n) == want.predicted_makespan(n)
    assert got.mode == want.mode


@pytest.mark.parametrize("semiring,ks", [("min", [0, 0, 0, 0]),
                                         ("plus_times", [64, 64, 64, 64])])
def test_shard_wire_accessors_match_jax(semiring, ks):
    """The counterpart of ``tests/test_distributed_hybrid.py:119``: the
    padded wire values a shard ships a superstep (fewer than the dense
    ``[pl, P, o_max]`` tensor) and the scatter segments, equal to JAX's;
    on one shard nothing crosses the wire."""
    _, jp, tp = engine_case("rmat", 4, "rand", scale=9)
    for shards in (4, 2, 1):
        got = TH.shard_degree_split(tp, shards, semiring, ks[:shards])
        want = JH.shard_degree_split(jp, shards, semiring, ks[:shards])
        assert (got.wire_values_per_superstep()
                == want.wire_values_per_superstep())
        assert got.scatter_segments == want.scatter_segments
        full = got.parts_per_shard * got.num_parts * got.o_max
        if shards > 1:
            assert 0 < got.wire_values_per_superstep() < full
        else:
            assert got.wire_values_per_superstep() == 0


# ---------------------------------------------------------------------------
# superstep(): the sharded engine's benchmarking hook
# ---------------------------------------------------------------------------

def _walk(fn, state, limit=200):
    """Step ``fn`` from ``state`` until it votes finish; returns the last
    state and the steps taken."""
    for step in range(limit):
        state, fin = fn(state, step)
        assert fin.dtype == torch.bool and fin.dim() == 0
        if bool(fin):
            return state, step + 1
    raise AssertionError("no finish vote")


def _states(pg, alg):
    """The unbatched initial state of ``alg`` in the port and in JAX."""
    if alg == "bfs":
        return ({"level": tbfs.multi_source_state(pg[1], [3])[0]},
                {"level": jbfs.multi_source_state(pg[0], [3])[0]})
    return tpr.initial_state(pg[1]), jpr.initial_state(pg[0])


PROGRAMS = {"bfs": lambda n: (tbfs.BFS_PROGRAM, jbfs.BFS_PROGRAM),
            "pagerank": lambda n: (tpr.make_pagerank_program(n),
                                   jpr.make_pagerank_program(n))}
PR_STEPS = 5


@pytest.mark.parametrize("alg", ["bfs", "pagerank"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_superstep_matches_jax_step_by_step(backend, alg):
    """Each step's state and vote against JAX's ``superstep()`` on a
    one-device mesh (its reference backend): BFS to its finish bit for
    bit, ``PR_STEPS`` PageRank steps within the PageRank tolerance."""
    import jax
    from jax.sharding import Mesh

    g, jp, tp = engine_case("rmat", 2, "high", scale=7)
    jdist = importlib.import_module("repro.core.bsp").DistributedBSPEngine(
        jp, Mesh(np.array(jax.devices()[:1]), ("parts",)),
        direction_switch=False)
    teng = DistributedBSPEngine(tp, backend=backend, device="cpu",
                                **KW[backend])
    tprog, jprog = PROGRAMS[alg](g.num_vertices)
    tfn, jfn = teng.superstep(tprog), jdist.superstep(jprog)
    tstate, jstate = _states((jp, tp), alg)
    for step in range(100):
        jstate, jfin = jfn(jstate, np.int32(step))
        tstate, tfin = tfn(tstate, step)
        assert set(tstate) == set(jstate)
        for k in tstate:
            assert isinstance(tstate[k], torch.Tensor)
            got, want = tstate[k].numpy(), np.asarray(jstate[k])
            if alg == "pagerank" and k == "rank":
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
            else:
                np.testing.assert_array_equal(got, want)
        assert bool(tfin) == bool(jfin)
        if alg == "bfs" and bool(jfin):
            break
        if alg == "pagerank" and step + 1 == PR_STEPS:
            break
    assert step + 1 == PR_STEPS if alg == "pagerank" else step > 1


def _superstep_rank(group, backend, alg):
    """On each rank: ``superstep()`` from the initial state to the finish
    against ``execute`` (PageRank also ``PR_STEPS`` steps against
    ``execute(num_steps=)``); every rank returns the global results."""
    g, jp, tp = engine_case("rmat", 2, "high", scale=7)
    eng = DistributedBSPEngine(tp, group, backend=backend, device="cpu",
                               **KW[backend])
    prog = PROGRAMS[alg](g.num_vertices)[0]
    init = _states((jp, tp), alg)[0]
    batched = {k: torch.as_tensor(v)[None] for k, v in init.items()}
    fn = eng.superstep(prog)
    got, steps = _walk(fn, init)
    want, want_steps = eng.execute(prog, batched)
    out = {"same": all(torch.equal(got[k], want[k][0]) for k in got),
           "steps": (steps, int(want_steps[0]))}
    if alg == "pagerank":
        state = init
        for step in range(PR_STEPS):
            state, _ = fn(state, step)
        want = eng.execute(prog, batched, num_steps=PR_STEPS)
        out["same_n"] = all(torch.equal(state[k], want[k][0])
                            for k in state)
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("alg", ["bfs", "pagerank"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_superstep_equals_execute_on_gloo_worlds(backend, alg, world,
                                                 tmp_path):
    """The hook against ``execute`` on the same engine, bit for bit with
    equal step counts, on every rank of gloo worlds of 1 and 2."""
    outs = run_world(_superstep_rank, world, device="cpu", timeout=300,
                     init=(tmp_path / "rdv").as_uri(),
                     args=(backend, alg))
    for out in outs:
        assert out["same"] and out["steps"][0] == out["steps"][1], out
        assert out.get("same_n", True)
