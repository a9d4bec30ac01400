"""The port's engine, betweenness centrality, on the CPU.

Both port backends against the JAX package's reference backend (single
source and a batch of sources) and the numpy Brandes oracle over
``tests/test_core_engine.py``'s grid at scale 8.  Tolerances: against JAX
``rtol=1e-5, atol=1e-5`` with equal superstep counts (the bound
``tests/test_fused_superstep.py`` uses between fused and reference BC);
against the float64 oracle that of ``test_core_engine.py``.
"""
import importlib

import numpy as np
import pytest

from test_torch_jaxref import BACKENDS, GRID, JA, engine_case, jax_engine

from repro_torch.core.bsp import BSPEngine

talg = importlib.import_module("repro_torch.algorithms")

SOURCES = [0, 7, 33]


@pytest.fixture(scope="module", params=GRID, ids=lambda c: "-".join(map(
    str, c)))
def bc_case(request):
    g, jp, tp = engine_case(*request.param, include_reverse=True)
    return (g, tp, JA.betweenness_centrality(jax_engine(jp), 0),
            JA.betweenness_centrality_batched(jax_engine(jp), SOURCES))


@pytest.mark.parametrize("backend", BACKENDS)
def test_bc(bc_case, backend):
    g, tp, (want, want_steps), _ = bc_case
    eng = BSPEngine(tp, backend=backend, block_e=128, device="cpu")
    got, steps = talg.betweenness_centrality(eng, 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert steps == want_steps
    np.testing.assert_allclose(got, talg.bc_reference(g, 0), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bc_batched(bc_case, backend):
    g, tp, _, (want, want_steps) = bc_case
    eng = BSPEngine(tp, backend=backend, block_e=128, device="cpu")
    got, steps = talg.betweenness_centrality_batched(eng, SOURCES)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(steps, want_steps)


def test_float64_bc_matches_the_float32_run():
    """The same entry point in float64 (the yardstick ``chip_smoke.py``
    uses) agrees with the float32 run to f32 rounding, rtol 1e-5, atol
    1e-5, with equal steps."""
    import torch

    _, _, tp = engine_case("rmat", 2, "high", include_reverse=True)
    ref = BSPEngine(tp, device="cpu")
    got64, steps64 = talg.betweenness_centrality(ref, 0, dtype=torch.float64)
    got32, steps32 = talg.betweenness_centrality(ref, 0)
    assert got64.dtype == np.float64 and steps64 == steps32
    np.testing.assert_allclose(got32, got64, rtol=1e-5, atol=1e-5)
