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

from repro_torch.core.bsp import (MIN, BSPEngine, EdgeMessage, VertexProgram,
                                  gather_src)
from repro_torch.core.graph import CSRGraph
from repro_torch.core.partition import PartitionedGraph


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


BFS_PROGRAM = VertexProgram(combine=MIN, edge_fn=_edge_fn,
                            apply_fn=_apply_fn,
                            edge_msg=EdgeMessage(gather=("level",),
                                                 fn=_edge_msg_fn, kind="bfs",
                                                 frontier_uniform=True))


def bfs_batched(engine: BSPEngine,
                sources: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Run a batch of Q BFS queries through one engine invocation.

    Returns (levels [Q, n], per-query supersteps [Q]).
    """
    pg = engine.pg
    level0 = multi_source_state(pg, sources, device=engine.device)
    state, steps = engine.execute(BFS_PROGRAM, {"level": level0})
    return gather_batch(pg, state["level"]), steps.cpu().numpy()


def bfs(engine: BSPEngine, source: int) -> Tuple[np.ndarray, int]:
    """Run BFS from global vertex ``source``; returns (levels [n], steps)."""
    levels, steps = bfs_batched(engine, [source])
    return levels[0], int(steps[0])


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
