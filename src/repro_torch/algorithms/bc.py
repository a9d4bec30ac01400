"""Betweenness Centrality — Brandes (paper §7.2, Fig. 18).

Two BSP cycles:

- **Forward** (over out-edges): level-synchronous BFS that also accumulates
  shortest-path counts: frontier vertices push ``sigma`` (sum-reduced);
  undiscovered receivers adopt ``dist = level + 1`` and ``sigma = acc``.
- **Backward** (over *reverse* edges): vertices at ``dist == level+1`` send
  ``(1 + delta) / sigma`` to their predecessors; vertices at ``dist ==
  level`` set ``delta = sigma * acc`` and fold it into the bc score, for
  levels ``max_level-1 .. 1``.  Each query's ``max_level`` rides the state
  as a per-query per-partition scalar.

Port of ``repro.algorithms.bc`` (single-source and batched forms).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.algorithms.bfs import gather_batch, multi_source_state
from repro_torch.core.bsp import (SUM, BSPEngine, EdgeMessage, VertexProgram,
                                  gather_src)
from repro_torch.core.graph import CSRGraph


# --------------------------- forward cycle ---------------------------------

def _fwd_edge(state, src, weight, step):
    del weight
    dist = gather_src(state["dist"], src)
    sigma = gather_src(state["sigma"], src)
    return torch.where(dist == step, sigma, 0.0)


def _fwd_apply(state, acc, step):
    dist, sigma = state["dist"], state["sigma"]
    newly = torch.isinf(dist) & (acc > 0)
    new_dist = torch.where(newly, step + 1.0, dist)
    new_sigma = torch.where(newly, acc, sigma)
    state = dict(state, dist=new_dist, sigma=new_sigma)
    return state, ~newly.flatten(1).any(1)


def _fwd_edge_msg(vals, weight, step, consts):
    del weight, consts
    return torch.where(vals["dist"] == step, vals["sigma"], 0.0)


FORWARD_PROGRAM = VertexProgram(combine=SUM, edge_fn=_fwd_edge,
                                apply_fn=_fwd_apply,
                                edge_msg=EdgeMessage(
                                    gather=("dist", "sigma"),
                                    fn=_fwd_edge_msg, kind="bc_fwd"))


# --------------------------- backward cycle --------------------------------

def _bwd_edge(state, src, weight, step):
    del weight
    # level being processed: max_level - 1 - step (per-partition scalar).
    level = (state["max_level"] - 1.0 - step)[:, :, None]
    dist = gather_src(state["dist"], src)
    sigma = gather_src(state["sigma"], src)
    delta = gather_src(state["delta"], src)
    sending = (dist == level + 1.0) & (sigma > 0)
    return torch.where(sending, (1.0 + delta) / torch.clamp(sigma, min=1.0),
                       0.0)


def _bwd_apply(state, acc, step):
    level = (state["max_level"] - 1.0 - step)[:, :, None]
    at_level = state["dist"] == level
    new_delta = torch.where(at_level, state["sigma"] * acc, state["delta"])
    # Exclude the source (level 0) from its own score, per Brandes.
    add = torch.where(at_level & (level > 0), new_delta, 0.0)
    state = dict(state, delta=new_delta, bc=state["bc"] + add)
    next_level = state["max_level"][:, 0] - 2.0 - step
    return state, next_level < 1.0


def _bwd_edge_msg(vals, weight, step, consts):
    del weight
    level = consts["max_level"] - 1.0 - step
    sending = (vals["dist"] == level + 1.0) & (vals["sigma"] > 0)
    return torch.where(sending,
                       (1.0 + vals["delta"]) / torch.clamp(vals["sigma"],
                                                           min=1.0),
                       0.0)


BACKWARD_PROGRAM = VertexProgram(combine=SUM, edge_fn=_bwd_edge,
                                 apply_fn=_bwd_apply, use_reverse=True,
                                 edge_msg=EdgeMessage(
                                     gather=("dist", "sigma", "delta"),
                                     fn=_bwd_edge_msg, kind="bc_bwd",
                                     consts=("max_level",)))


def betweenness_centrality_batched(engine: BSPEngine,
                                   sources: Sequence[int], *,
                                   dtype: torch.dtype = torch.float32
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-source BC contributions for a batch of Q sources.

    One forward and one backward engine invocation cover the whole batch;
    each query walks its own levels in the shared backward loop.  ``dtype``
    is the state's precision (float64 on the reference backend gives a
    yardstick; the fused backend takes float32 only).  Returns
    (bc [Q, n], per-query total supersteps [Q]).
    """
    pg = engine.pg
    if pg.rev is None and not engine.provides_reverse(BACKWARD_PROGRAM):
        raise ValueError("BC needs reverse edges "
                         "(partition with include_reverse=True)")
    q = len(np.asarray(sources).reshape(-1))
    dist0 = torch.as_tensor(multi_source_state(pg, sources), dtype=dtype)
    sigma0 = torch.as_tensor(
        multi_source_state(pg, sources, fill=0.0, value=1.0), dtype=dtype)

    fwd_state, fwd_steps = engine.execute(FORWARD_PROGRAM, {
        "dist": dist0, "sigma": sigma0})

    dist = fwd_state["dist"]                                # [Q, P, V]
    finite = torch.where(torch.isfinite(dist), dist, -torch.inf)
    max_level = torch.clamp(finite.flatten(1).amax(1), min=0.0)   # [Q]

    bwd_state = {
        "dist": fwd_state["dist"], "sigma": fwd_state["sigma"],
        "delta": torch.zeros_like(dist), "bc": torch.zeros_like(dist),
        "max_level": max_level[:, None].expand(q, pg.num_parts).contiguous(),
    }
    bwd_steps = torch.zeros_like(fwd_steps)
    if float(max_level.max()) >= 2.0:
        bwd_state, bwd_steps = engine.execute(BACKWARD_PROGRAM, bwd_state)
    bc = gather_batch(pg, bwd_state["bc"])
    return bc, (fwd_steps + bwd_steps).cpu().numpy()


def betweenness_centrality(engine: BSPEngine, source: int, *,
                           dtype: torch.dtype = torch.float32
                           ) -> Tuple[np.ndarray, int]:
    """Single-source BC contribution; returns (bc [n], total supersteps)."""
    bc, steps = betweenness_centrality_batched(engine, [source], dtype=dtype)
    return bc[0], int(steps[0])


def bc_reference(g: CSRGraph, source: int) -> np.ndarray:
    """Pure-numpy Brandes oracle (single source, unweighted)."""
    n = g.num_vertices
    dist = np.full(n, np.inf)
    sigma = np.zeros(n)
    dist[source], sigma[source] = 0.0, 1.0
    frontier = [source]
    levels = [frontier]
    d = 0
    while frontier:
        nxt = {}
        for v in frontier:
            for w in g.col[g.row_ptr[v]: g.row_ptr[v + 1]]:
                w = int(w)
                if np.isinf(dist[w]):
                    nxt[w] = True
                    dist[w] = d + 1
        for v in frontier:
            for w in g.col[g.row_ptr[v]: g.row_ptr[v + 1]]:
                w = int(w)
                if dist[w] == d + 1:
                    sigma[w] += sigma[v]
        frontier = list(nxt)
        if frontier:
            levels.append(frontier)
        d += 1
    delta = np.zeros(n)
    bc = np.zeros(n)
    for lvl in reversed(range(1, len(levels))):
        for v in levels[lvl - 1]:
            acc = 0.0
            for w in g.col[g.row_ptr[v]: g.row_ptr[v + 1]]:
                w = int(w)
                if dist[w] == lvl and sigma[w] > 0:
                    acc += (1.0 + delta[w]) / sigma[w]
            delta[v] = sigma[v] * acc
            if lvl - 1 > 0:
                bc[v] += delta[v]
    return bc.astype(np.float32)
