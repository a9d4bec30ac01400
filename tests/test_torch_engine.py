"""The port's engine, min-combine algorithms (BFS, SSSP, CC), on the CPU.

Both port backends (reference and fused, which takes the plain version on
the CPU) against the JAX package's reference backend and the numpy oracles,
over ``tests/test_core_engine.py``'s grid at scale 8.  Tolerance: bit for
bit, with equal superstep counts (a min is order-free).
"""
import importlib

import numpy as np
import pytest

from test_torch_jaxref import BACKENDS, GRID, JA, engine_case, jax_engine

from repro_torch.core.bsp import BSPEngine

talg = importlib.import_module("repro_torch.algorithms")

SOURCES = [0, 5, 17, 100]


def _port(tp, backend):
    return BSPEngine(tp, backend=backend, block_e=128, device="cpu")


@pytest.fixture(scope="module", params=GRID, ids=lambda c: "-".join(map(
    str, c)))
def case(request):
    return request.param


@pytest.fixture(scope="module")
def bfs_case(case):
    g, jp, tp = engine_case(*case)
    return g, tp, JA.bfs(jax_engine(jp), 0), JA.bfs_batched(jax_engine(jp),
                                                             SOURCES)


@pytest.fixture(scope="module")
def sssp_case(case):
    g, jp, tp = engine_case(*case, weighted=True)
    return g, tp, JA.sssp(jax_engine(jp), 0), JA.sssp_batched(
        jax_engine(jp), SOURCES)


@pytest.fixture(scope="module")
def cc_case(case):
    g, jp, tp = engine_case(*case, symmetric=True)
    return g, tp, JA.connected_components(jax_engine(jp))


@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs(bfs_case, backend):
    g, tp, (want, want_steps), _ = bfs_case
    got, steps = talg.bfs(_port(tp, backend), 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, talg.bfs_reference(g, 0))
    assert steps == want_steps


@pytest.mark.parametrize("backend", BACKENDS)
def test_bfs_batched(bfs_case, backend):
    g, tp, _, (want, want_steps) = bfs_case
    got, steps = talg.bfs_batched(_port(tp, backend), SOURCES)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(steps, want_steps)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sssp(sssp_case, backend):
    g, tp, (want, want_steps), _ = sssp_case
    got, steps = talg.sssp(_port(tp, backend), 0)
    np.testing.assert_array_equal(got, want)
    assert steps == want_steps
    # the oracle sums in float64: the f32 engine agrees to rounding
    np.testing.assert_allclose(got, talg.sssp_reference(g, 0), rtol=1e-5)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sssp_batched(sssp_case, backend):
    g, tp, _, (want, want_steps) = sssp_case
    got, steps = talg.sssp_batched(_port(tp, backend), SOURCES)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(steps, want_steps)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cc(cc_case, backend):
    g, tp, (want, want_steps) = cc_case
    got, steps = talg.connected_components(_port(tp, backend))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, talg.cc_reference(g))
    assert steps == want_steps
