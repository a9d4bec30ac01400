"""SSSP via Bellman-Ford (paper Fig. 20) as a TOTEM vertex program.

Every active vertex relaxes its edges in parallel; the paper's ``atomicMin``
becomes the engine's segment min.  Port of ``repro.algorithms.sssp``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.algorithms.bfs import (gather_batch, multi_source_state,
                                        warm_state)
from repro_torch.core.bsp import (MIN, BSPEngine, EdgeMessage,
                                  IncrementalForm, VertexProgram, gather_src)
from repro_torch.core.graph import CSRGraph
from repro_torch.runtime import tracing


def _edge_fn(state, src, weight, step):
    del step
    dist = gather_src(state["dist"], src)
    active = gather_src(state["active"].float(), src) > 0
    return torch.where(active, dist + weight, math.inf)


def _apply_fn(state, acc, step):
    del step
    dist = state["dist"]
    improved = acc < dist
    new_dist = torch.where(improved, acc, dist)
    return ({"dist": new_dist, "active": improved},
            ~improved.flatten(1).any(1))


def _edge_msg_fn(vals, weight, step, consts):
    del step, consts
    return torch.where(vals["active"] > 0, vals["dist"] + weight, math.inf)


SSSP_PROGRAM = VertexProgram(combine=MIN, edge_fn=_edge_fn,
                             apply_fn=_apply_fn,
                             edge_msg=EdgeMessage(
                                 gather=("dist", "active"), fn=_edge_msg_fn,
                                 kind="sssp", use_weight=True,
                                 weight_op="add"))


def _inc_seed(prev_state, dirty):
    """Warm state after insert-only mutations: Bellman-Ford is already a
    relaxation with an active set, so its incremental form is the program
    itself, seeded with the previous distances and the dirty frontier
    (sources of inserted edges that are themselves reached)."""
    dist = prev_state["dist"]
    return {"dist": dist,
            "active": dirty.to(torch.bool).expand_as(dist)
            & torch.isfinite(dist)}


# Min-plus fixpoints of an insert-only window are descent-reachable from the
# previous solution and every old path survives, so the warm result is
# bitwise a cold rerun's.
SSSP_PROGRAM = dataclasses.replace(
    SSSP_PROGRAM, incremental=IncrementalForm(SSSP_PROGRAM, _inc_seed))


def sssp_batched(engine: BSPEngine,
                 sources: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Run a batch of Q SSSP queries through one engine invocation.

    Returns (dists [Q, n], per-query supersteps [Q]).
    """
    pg = engine.pg
    if pg.fwd.weight is None:
        raise ValueError("SSSP needs edge weights "
                         "(graph.with_uniform_weights)")
    with tracing.span("entry.sssp_batched"):
        with tracing.span("entry.upload"):
            dist0 = multi_source_state(pg, sources, device=engine.device)
            state0 = {"dist": dist0, "active": torch.isfinite(dist0)}
        state, steps = engine.execute(SSSP_PROGRAM, state0)
        dists = gather_batch(pg, state["dist"])
        with tracing.span("entry.steps_copy"):
            return dists, steps.cpu().numpy()


def sssp(engine: BSPEngine, source: int) -> Tuple[np.ndarray, int]:
    dists, steps = sssp_batched(engine, [source])
    return dists[0], int(steps[0])


def sssp_incremental(engine: BSPEngine, prev_dists: np.ndarray,
                     dirty_global: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Warm-start SSSP solutions after insert-only mutations (see
    :func:`repro_torch.algorithms.bfs.bfs_incremental` for the
    contract)."""
    pg = engine.pg
    state = {"dist": warm_state(pg, prev_dists, engine.device)}
    st, steps = engine.execute(SSSP_PROGRAM, state,
                               incremental=pg.scatter_dirty(dirty_global))
    return gather_batch(pg, st["dist"]), steps.cpu().numpy()


def sssp_reference(g: CSRGraph, source: int) -> np.ndarray:
    """Pure-numpy Bellman-Ford oracle (edge-parallel rounds)."""
    n = g.num_vertices
    src = g.edge_sources()
    dist = np.full(n, np.inf, dtype=np.float64)
    dist[source] = 0.0
    for _ in range(n):
        cand = dist[src] + g.weights
        new = dist.copy()
        np.minimum.at(new, g.col, cand)
        if np.array_equal(new, dist, equal_nan=True):
            break
        dist = new
    return dist.astype(np.float32)
