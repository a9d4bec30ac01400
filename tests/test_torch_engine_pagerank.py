"""The port's engine, PageRank and personalized PageRank, on the CPU.

Both port backends against the JAX package's reference backend and the
numpy oracles over ``tests/test_core_engine.py``'s grid at scale 8.
Tolerances: against JAX ``rtol=1e-6, atol=1e-9`` (f32 sums in another
order; the bound ``tests/test_fused_superstep.py`` uses between fused and
reference); against the float64 oracles those of ``test_core_engine.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import (BACKENDS, GRID, JA, engine_case, jax_engine,
                               jpr)

from repro_torch import convert
from repro_torch.core.bsp import BSPEngine

talg = importlib.import_module("repro_torch.algorithms")
tpr = importlib.import_module("repro_torch.algorithms.pagerank")

ITERS = 15
SEEDS = [0, 3, 40]


@pytest.fixture(scope="module", params=GRID, ids=lambda c: "-".join(map(
    str, c)))
def pr_case(request):
    g, jp, tp = engine_case(*request.param)
    return (g, tp, JA.pagerank(jax_engine(jp), num_iterations=ITERS),
            JA.personalized_pagerank(jax_engine(jp), SEEDS,
                                     num_iterations=ITERS))


@pytest.mark.parametrize("backend", BACKENDS)
def test_pagerank(pr_case, backend):
    g, tp, want, _ = pr_case
    eng = BSPEngine(tp, backend=backend, block_e=128, device="cpu")
    got = talg.pagerank(eng, num_iterations=ITERS)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got, talg.pagerank_reference(g, ITERS),
                               rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("backend", BACKENDS)
def test_personalized_pagerank(pr_case, backend):
    g, tp, _, want = pr_case
    eng = BSPEngine(tp, backend=backend, block_e=128, device="cpu")
    got = talg.personalized_pagerank(eng, SEEDS, num_iterations=ITERS)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    reset = np.zeros((len(SEEDS), g.num_vertices), np.float32)
    reset[np.arange(len(SEEDS)), SEEDS] = 1.0
    np.testing.assert_allclose(
        got, talg.personalized_pagerank_reference(g, reset, ITERS),
        rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("backend", BACKENDS)
def test_converted_jax_partition_and_state(backend):
    """``convert`` carries the JAX package's partition and state pytree over;
    the port's engine run on them gives the JAX engine's ranks."""
    _, jp, _ = engine_case("rmat", 2, "high")
    tp = convert.partitioned_graph(jp)
    state = convert.state({k: v[None] for k, v in
                           jpr.initial_state(jp).items()}, device="cpu")
    assert state["mask"].dtype == torch.bool
    eng = BSPEngine(tp, backend=backend, block_e=128, device="cpu")
    out = convert.to_numpy(eng.execute(
        tpr.make_pagerank_program(tp.num_vertices),
        state, num_steps=ITERS))
    want = JA.pagerank(jax_engine(jp), num_iterations=ITERS)
    np.testing.assert_allclose(tp.gather_global(out["rank"][0]), want,
                               rtol=1e-6, atol=1e-9)


def test_float64_state_is_the_yardstick_and_fused_refuses_it():
    """``dtype=torch.float64`` runs the same entry point in float64 on the
    reference backend (against the oracle, which rounds its float64 result
    to float32: rtol 1e-6, atol 1e-12); the fused backend computes in
    float32 and raises."""
    g, _, tp = engine_case("rmat", 2, "high")
    ref = BSPEngine(tp, device="cpu")
    want = talg.pagerank_reference(g, 20)
    got64 = talg.pagerank(ref, 20, dtype=torch.float64)
    assert got64.dtype == np.float64
    np.testing.assert_allclose(got64, want, rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="float32"):
        talg.pagerank(BSPEngine(tp, backend="fused", block_e=128,
                                device="cpu"), 20, dtype=torch.float64)
