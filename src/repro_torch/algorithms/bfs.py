"""Level-synchronous BFS (paper Fig. 11) as a TOTEM vertex program.

Push formulation with min-reduction: every vertex at the current level sends
``level + 1`` along its out-edges; the reduction keeps the minimum, and
unvisited vertices adopt it.  Port of ``repro.algorithms.bfs``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bsp import (MIN, BSPEngine, EdgeMessage,
                                  IncrementalForm, VertexProgram, gather_src)
from repro_torch.core.graph import CSRGraph
from repro_torch.core.partition import PartitionedGraph
from repro_torch.runtime import tracing


def multi_source_state(pg: PartitionedGraph, sources: Sequence[int],
                       fill=np.inf, value=0.0, device=None):
    """[Q, P, v_max] float32 per-query state with ``value`` (a scalar or
    one per query) at each query's source.

    The shared multi-source constructor: one row per query, ``fill``
    elsewhere — BFS levels, SSSP distances, and BC's dist/sigma all start
    from this shape.  Host numpy, or with ``device`` a tensor made there
    (only the sources' ids and values cross).
    """
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    q = len(sources)
    ids = (np.arange(q), pg.assignment.part_of[sources],
           pg.assignment.local_id[sources])
    if device is None:
        out = np.full((q, pg.num_parts, pg.v_max), fill, dtype=np.float32)
        out[ids] = value
        return out
    out = torch.full((q, pg.num_parts, pg.v_max), float(fill),
                     dtype=torch.float32, device=device)
    vals = np.broadcast_to(np.asarray(value, np.float32), (q,))
    out[tuple(torch.as_tensor(i, device=device) for i in ids)] = (
        torch.as_tensor(vals.copy(), device=device))
    return out


def gather_batch(pg: PartitionedGraph, per_part) -> np.ndarray:
    """Collect a [Q, P, v_max] batched state into global [Q, n] order.  A
    tensor is gathered where it lies (``PartitionedGraph.flat_index``) and
    only the [Q, n] result is copied to the host."""
    if isinstance(per_part, torch.Tensor):
        with tracing.span("entry.result_copy"):
            flat = per_part.reshape(per_part.shape[0], -1)
            return flat[:, pg.flat_index(per_part.device)].cpu().numpy()
    return np.stack([pg.gather_global(row) for row in np.asarray(per_part)])


def _edge_fn(state, src, weight, step):
    del weight
    level = gather_src(state["level"], src)
    # Only frontier vertices (level == step) send; others send identity.
    return torch.where(level == step, level + 1.0, math.inf)


def _edge_msg_fn(vals, weight, step, consts):
    del weight, consts
    level = vals["level"]
    return torch.where(level == step, level + 1.0, math.inf)


def _apply_fn(state, acc, step):
    del step
    level = state["level"]
    newly = torch.isinf(level) & torch.isfinite(acc)
    new_level = torch.where(newly, acc, level)
    return {"level": new_level}, ~newly.flatten(1).any(1)


# --- incremental (warm-start) form -----------------------------------------
# The level-synchronous program cannot lower a *finite* level (its frontier
# test is ``level == step`` and its apply only fills unvisited vertices), so
# warm starts run BFS's relaxation restatement instead: unit-weight
# Bellman-Ford over levels with an active set.  Its fixpoint is reachable by
# descent from any over-approximation (the previous solution after
# insert-only mutations), and levels are small exact f32 integers, so the
# warm fixpoint is bitwise a cold rerun's.

def _inc_edge_fn(state, src, weight, step):
    del weight, step
    level = gather_src(state["level"], src)
    active = gather_src(state["active"].float(), src) > 0
    return torch.where(active, level + 1.0, math.inf)


def _inc_edge_msg_fn(vals, weight, step, consts):
    del weight, step, consts
    return torch.where(vals["active"] > 0, vals["level"] + 1.0, math.inf)


def _inc_apply_fn(state, acc, step):
    del step
    level = state["level"]
    improved = acc < level
    new_level = torch.where(improved, acc, level)
    return ({"level": new_level, "active": improved},
            ~improved.flatten(1).any(1))


BFS_RELAX_PROGRAM = VertexProgram(
    combine=MIN, edge_fn=_inc_edge_fn, apply_fn=_inc_apply_fn,
    edge_msg=EdgeMessage(gather=("level", "active"), fn=_inc_edge_msg_fn,
                         kind="bfs_relax"))


def _inc_seed(prev_state, dirty):
    """Warm state: previous levels and the dirty frontier as the active
    set.  ``dirty`` is a [P, v_max] mask of vertices whose out-edges
    changed; only dirty vertices that are themselves reached can improve a
    neighbour."""
    level = prev_state["level"]
    return {"level": level,
            "active": dirty.to(torch.bool).expand_as(level)
            & torch.isfinite(level)}


BFS_PROGRAM = VertexProgram(combine=MIN, edge_fn=_edge_fn,
                            apply_fn=_apply_fn,
                            edge_msg=EdgeMessage(gather=("level",),
                                                 fn=_edge_msg_fn, kind="bfs",
                                                 frontier_uniform=True),
                            incremental=IncrementalForm(BFS_RELAX_PROGRAM,
                                                        _inc_seed))


def bfs_batched(engine: BSPEngine,
                sources: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Run a batch of Q BFS queries through one engine invocation.

    Returns (levels [Q, n], per-query supersteps [Q]).
    """
    with tracing.span("entry.bfs_batched"):
        pg = engine.pg
        with tracing.span("entry.upload"):
            level0 = multi_source_state(pg, sources, device=engine.device)
        state, steps = engine.execute(BFS_PROGRAM, {"level": level0})
        levels = gather_batch(pg, state["level"])
        with tracing.span("entry.steps_copy"):
            return levels, steps.cpu().numpy()


def bfs(engine: BSPEngine, source: int) -> Tuple[np.ndarray, int]:
    """Run BFS from global vertex ``source``; returns (levels [n], steps)."""
    levels, steps = bfs_batched(engine, [source])
    return levels[0], int(steps[0])


def warm_state(pg: PartitionedGraph, prev: np.ndarray, device):
    """[Q, n] (or [n]) global results as a [Q, P, v_max] float32 tensor on
    ``device`` (+inf in the padding): the previous fixpoint of a warm
    start, scattered where it lies (``PartitionedGraph.flat_index``), so
    only the [Q, n] rows cross to the device."""
    prev = torch.as_tensor(np.atleast_2d(np.asarray(prev, np.float32)),
                           device=device)
    q = prev.shape[0]
    out = torch.full((q, pg.num_parts * pg.v_max), math.inf,
                     dtype=torch.float32, device=device)
    out[:, pg.flat_index(device)] = prev
    return out.view(q, pg.num_parts, pg.v_max)


def bfs_incremental(engine: BSPEngine, prev_levels: np.ndarray,
                    dirty_global: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Warm-start a batch of BFS solutions after insert-only mutations.

    ``prev_levels`` is the [Q, n] (or [n]) result of an earlier run whose
    sources are being kept fresh; ``dirty_global`` the [n] mask of vertices
    with inserted out-edges since (``DynamicGraph.dirty_since``; the caller
    runs cold :func:`bfs_batched` when that window was not monotone).
    Returns (levels [Q, n], supersteps [Q]), bitwise a cold rerun's,
    typically in fewer supersteps.
    """
    pg = engine.pg
    state = {"level": warm_state(pg, prev_levels, engine.device)}
    st, steps = engine.execute(BFS_PROGRAM, state,
                               incremental=pg.scatter_dirty(dirty_global))
    return gather_batch(pg, st["level"]), steps.cpu().numpy()


def bfs_reference(g: CSRGraph, source: int) -> np.ndarray:
    """Pure-numpy frontier BFS oracle."""
    n = g.num_vertices
    level = np.full(n, np.inf, dtype=np.float32)
    level[source] = 0.0
    frontier = np.array([source], dtype=np.int64)
    d = 0
    while len(frontier):
        nbrs = np.concatenate([
            g.col[g.row_ptr[v]: g.row_ptr[v + 1]] for v in frontier
        ]) if len(frontier) else np.empty(0, dtype=np.int64)
        nbrs = np.unique(nbrs)
        newly = nbrs[np.isinf(level[nbrs])]
        level[newly] = d + 1
        frontier = newly
        d += 1
    return level


def teps(g: CSRGraph, levels: np.ndarray, seconds: float) -> float:
    """Graph500-style TEPS: the summed out-degrees of the visited vertices
    over ``seconds``."""
    visited = np.isfinite(levels)
    traversed = int(g.out_degrees()[visited].sum())
    return traversed / max(seconds, 1e-12)
