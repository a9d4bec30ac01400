"""The JAX package as the port's reference, inside the test process only.

``repro.kernels.ops`` registers a batching rule behind
``optimization_barrier_p not in batching.primitive_batchers``.  On newer JAX
releases that registry is a ``PrimitiveBatchersProxy`` without
``__contains__`` and the check raises ``TypeError``, so nothing that imports
``repro.kernels.ops`` imports.  Those releases register their own rule for
the barrier, so answering "present" is correct: the shim below gives the
proxy a ``__contains__`` that returns True, and only when it lacks one
(a plain dict registry is left alone).  The port's tests import the JAX
package through this module; ``src/`` holds no shim.
"""
import importlib

import numpy as np

from jax.interpreters import batching as _batching

_registry = type(_batching.primitive_batchers)
if not hasattr(_registry, "__contains__"):
    _registry.__contains__ = lambda self, prim: True

from repro.core import graph as JG  # noqa: E402
from repro.core import partition as JPT  # noqa: E402
from repro.core.bsp import BSPEngine as JEngine  # noqa: E402
from repro import algorithms as JA  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

# ``repro.algorithms`` re-exports functions named like its modules (``bfs``,
# ``pagerank``), so the modules are fetched by their full names.
jbc = importlib.import_module("repro.algorithms.bc")
jbfs = importlib.import_module("repro.algorithms.bfs")
jcc = importlib.import_module("repro.algorithms.cc")
jpr = importlib.import_module("repro.algorithms.pagerank")
jsssp = importlib.import_module("repro.algorithms.sssp")

__all__ = ["JG", "JPT", "JEngine", "JA", "jbc", "jbfs", "jcc", "jpr",
           "jsssp", "jops", "jax_engine", "engine_case",
           "assert_same_planner_table", "GRID", "BACKENDS"]

# The grid of tests/test_core_engine.py: graph kind x parts x strategy.
GRID = [(kind, parts, strategy) for kind in ("rmat", "uniform")
        for parts in (1, 2, 3) for strategy in ("rand", "high", "low")]
BACKENDS = ("reference", "fused")


def jax_engine(pg, **kw):
    """A JAX reference-backend engine in plain push mode.  For min combines
    the direction mode is bitwise neutral, so the results are those of the
    default engine; switching it off spares the grid tests the pull
    kernel's interpret runs.  ``test_torch_direction.py`` holds the port's
    direction mode against the JAX package's."""
    return JEngine(pg, direction_switch=False, **kw)


def assert_same_planner_table(got, want):
    """The port's degree-split planner records equal the JAX package's,
    every term included: on one device ``boundary_slots`` and ``t_comm``
    are 0 in both, on a shard they are its exchange term."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w


def engine_case(kind, parts, strategy, *, scale=8, weighted=False,
                symmetric=False, include_reverse=False):
    """The same graph and partition in both packages: ``(numpy CSR graph,
    JAX PartitionedGraph, port PartitionedGraph)``."""
    from repro_torch.algorithms import cc as tcc
    from repro_torch.core import graph as TG
    from repro_torch.core import partition as TPT

    gen = {"rmat": (JG.rmat, TG.rmat), "uniform": (JG.uniform, TG.uniform)}
    jg, tg = (f(scale, 8, seed=3) for f in gen[kind])
    if weighted:
        jg, tg = jg.with_uniform_weights(seed=7), tg.with_uniform_weights(
            seed=7)
    if symmetric:
        jg, tg = jcc.symmetrize(jg), tcc.symmetrize(tg)
    jp = JPT.partition(jg, parts, strategy, include_reverse=include_reverse)
    tp = TPT.partition(tg, parts, strategy, include_reverse=include_reverse)
    return jg, jp, tp


def test_shim_makes_the_reference_importable():
    import jax
    assert jax.lax.optimization_barrier_p in _batching.primitive_batchers
    assert callable(jops.fused_superstep_op)


def test_reference_bfs_matches_its_oracle_through_the_shim():
    g = JG.rmat(7, 4, seed=2)
    eng = jax_engine(JPT.partition(g, 2, JPT.HIGH))
    got, _ = JA.bfs(eng, 0)
    np.testing.assert_array_equal(got, JA.bfs_reference(g, 0))
