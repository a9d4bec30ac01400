"""Direction-optimized traversal of the port against the JAX package's.

For BFS, SSSP and CC on the same graph, partition and sources, the port's
engine and the JAX engine run with the same backend and ``direction``
(``auto`` votes per query and superstep, ``pull`` forces the bottom-up scan
with its pushed boundary leg).  Tolerance: results bit for bit with equal
steps, and ``last_direction_stats`` (directions, edges examined, switches)
equal as integers: the vote and the work model are deterministic.  The
push/pull crossover fit is compared value for value.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import JEngine, JA, engine_case

from repro_torch.core import perf_model as tpm
from repro_torch.core.bsp import BSPEngine

talg = importlib.import_module("repro_torch.algorithms")
jpm = importlib.import_module("repro.core.perf_model")

CASES = [("rmat", 2, "high"), ("uniform", 3, "rand"), ("rmat", 1, "low")]
SOURCES = [0, 5, 17]


def _run(alg, pkg, engine):
    mod = talg if pkg == "port" else JA
    if alg == "bfs":
        return mod.bfs_batched(engine, SOURCES)
    if alg == "sssp":
        return mod.sssp_batched(engine, SOURCES)
    return mod.connected_components(engine)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("alg", ["bfs", "sssp", "cc"])
@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("direction", ["auto", "pull"])
def test_direction_mode_matches_jax(case, alg, backend, direction):
    _, jp, tp = engine_case(*case, weighted=alg == "sssp",
                            symmetric=alg == "cc")
    je = JEngine(jp, backend=backend, direction=direction)
    te = BSPEngine(tp, backend=backend, block_e=128, device="cpu",
                   direction=direction)
    want, got = _run(alg, "jax", je), _run(alg, "port", te)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    js, ts = je.last_direction_stats, te.last_direction_stats
    assert set(ts) == set(js)
    for key in js:
        np.testing.assert_array_equal(ts[key], np.asarray(js[key]), key)
    if direction == "pull":
        assert (ts["direction"] == 1).all()


@pytest.mark.parametrize("direction", ["auto", "push", "pull"])
def test_every_direction_is_bit_equal_to_plain_push(direction):
    g, _, tp = engine_case("rmat", 3, "low", weighted=True)
    plain = BSPEngine(tp, device="cpu", direction_switch=False)
    eng = BSPEngine(tp, backend="fused", block_e=128, device="cpu",
                    direction=direction)
    for alg in ("bfs", "sssp"):
        want, got = _run(alg, "port", plain), _run(alg, "port", eng)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert eng.last_direction_stats["edges_examined"].shape == (
            len(SOURCES),)
    assert plain.last_direction_stats is None


def test_direction_leaves_never_reach_the_caller():
    _, _, tp = engine_case("rmat", 2, "rand")
    eng = BSPEngine(tp, device="cpu", direction="pull")
    prog = importlib.import_module("repro_torch.algorithms.bfs").BFS_PROGRAM
    level0 = importlib.import_module(
        "repro_torch.algorithms.bfs").multi_source_state(tp, [0])
    state, _ = eng.execute(prog, {"level": level0})
    assert set(state) == {"level"}
    state = eng.execute(prog, {"level": level0}, num_steps=2)
    assert set(state) == {"level"}
    assert eng.last_direction_stats["direction"].shape == (1, 2)


def test_other_precisions_run_push_only():
    """The pull direction computes in float32: float64 state runs plain
    push on the reference backend, and the fused backend refuses it."""
    _, _, tp = engine_case("rmat", 2, "high")
    bfs = importlib.import_module("repro_torch.algorithms.bfs")
    level0 = bfs.multi_source_state(tp, [0])
    ref = BSPEngine(tp, device="cpu", direction="pull")
    out64, steps64 = ref.execute(bfs.BFS_PROGRAM, {
        "level": torch.as_tensor(level0, dtype=torch.float64)})
    assert ref.last_direction_stats is None
    out32, steps32 = ref.execute(bfs.BFS_PROGRAM, {"level": level0})
    np.testing.assert_array_equal(out64["level"].numpy(),
                                  out32["level"].numpy())
    assert torch.equal(steps64, steps32)
    fused = BSPEngine(tp, backend="fused", block_e=128, device="cpu",
                      direction_switch=False)
    with pytest.raises(ValueError, match="float32"):
        fused.execute(bfs.BFS_PROGRAM, {
            "level": torch.as_tensor(level0, dtype=torch.float64)})


def test_unknown_direction_raises():
    _, _, tp = engine_case("rmat", 1, "rand")
    with pytest.raises(ValueError, match="direction"):
        BSPEngine(tp, device="cpu", direction="sideways")


@pytest.mark.parametrize("backend", ["hybrid", "fused", "reference"])
def test_pull_threshold_fit_matches_jax(backend):
    degs = [0.0, 0.5, 1.0, 3.0, 8.0, 16.0, 64.0, 1000.0]
    for kmax in (None, 1, 4, 64):
        for d in degs:
            assert tpm.fit_pull_threshold(d, kmax, backend=backend) == (
                jpm.fit_pull_threshold(d, kmax, backend=backend))
    np.testing.assert_array_equal(
        tpm.fit_shard_pull_thresholds(degs, [7] * len(degs),
                                      backend=backend),
        jpm.fit_shard_pull_thresholds(degs, [7] * len(degs),
                                      backend=backend))
