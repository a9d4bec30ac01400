"""PageRank (paper Fig. 14) as a TOTEM vertex program.

Push form: each vertex pushes ``rank / out_degree`` along its out-edges and
the engine sum-reduces; a fixed number of rounds.  Per-vertex constants
(inverse out-degree, vertex mask) ride in the state so they follow the
partition layout.  Port of ``repro.algorithms.pagerank``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.algorithms.bfs import gather_batch
from repro_torch.core.bsp import (SUM, BSPEngine, EdgeMessage, VertexProgram,
                                  batch_state, gather_src, unbatch_state)
from repro_torch.runtime import tracing

DAMPING = 0.85


def _edge_fn(state, src, weight, step):
    del weight, step
    return gather_src(state["rank"] * state["inv_deg"], src)


def _edge_msg_fn(vals, weight, step, consts):
    del weight, step, consts
    return vals["rank"] * vals["inv_deg"]


_EDGE_MSG = EdgeMessage(gather=("rank", "inv_deg"), fn=_edge_msg_fn,
                        kind="pagerank")


def _all_finished(acc):
    return torch.ones(acc.shape[0], dtype=torch.bool, device=acc.device)


def make_pagerank_program(num_vertices: int, damping: float = DAMPING,
                          max_steps: int = 1 << 30) -> VertexProgram:
    delta = (1.0 - damping) / num_vertices

    def apply_fn(state, acc, step):
        # Eager PyTorch runs ``damping * acc`` and ``delta + ...`` as two
        # separate ops, each rounded: nothing can contract them into an FMA,
        # so the JAX package's optimization barrier has no counterpart here.
        rank = delta + damping * acc
        rank = torch.where(state["mask"], rank, 0.0)
        return dict(state, rank=rank), _all_finished(acc)

    return VertexProgram(combine=SUM, edge_fn=_edge_fn, apply_fn=apply_fn,
                         max_steps=max_steps, edge_msg=_EDGE_MSG)


def initial_state(pg, damping: float = DAMPING,
                  dtype: torch.dtype = torch.float32) -> dict:
    out_deg = pg.out_deg
    inv = np.where(out_deg > 0, 1.0 / np.maximum(out_deg, 1.0), 0.0)
    rank0 = np.where(pg.vertex_mask, 1.0 / pg.num_vertices, 0.0)
    return {"rank": torch.as_tensor(rank0, dtype=dtype),
            "inv_deg": torch.as_tensor(inv, dtype=dtype),
            "mask": torch.as_tensor(pg.vertex_mask)}


def pagerank(engine: BSPEngine, num_iterations: int = 20,
             damping: float = DAMPING, *,
             dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Global PageRank after ``num_iterations`` rounds.  ``dtype`` is the
    state's precision: float64 on the reference backend gives a yardstick
    for the float32 runs (the fused backend takes float32 only)."""
    with tracing.span("entry.pagerank"):
        pg = engine.pg
        program = make_pagerank_program(pg.num_vertices, damping)
        with tracing.span("entry.upload"):
            state0 = {k: v.to(engine.device) for k, v in batch_state(
                initial_state(pg, damping, dtype)).items()}
        state = unbatch_state(engine.execute(program, state0,
                                             num_steps=num_iterations))
        with tracing.span("entry.result_copy"):
            return pg.gather_global(state["rank"].cpu().numpy())


def pagerank_distributed(engine, num_iterations: int = 20,
                         damping: float = DAMPING) -> np.ndarray:
    """PageRank on a ``DistributedBSPEngine`` through its converge loop:
    the round count rides ``max_steps`` with a vote that never finishes, as
    the JAX package's ``pagerank_distributed`` runs it.  Every rank returns
    the global ranks."""
    pg = engine.pg
    program = make_pagerank_program(pg.num_vertices, damping,
                                    max_steps=num_iterations)
    program = dataclasses.replace(
        program, apply_fn=_never_finished(program.apply_fn))
    state, _ = engine.execute(program,
                              batch_state(initial_state(pg, damping)))
    return pg.gather_global(unbatch_state(state)["rank"].cpu().numpy())


def make_personalized_pagerank_program(damping: float = DAMPING,
                                       max_steps: int = 1 << 30
                                       ) -> VertexProgram:
    """PPR: the uniform teleport ``(1-d)/n`` becomes a per-query restart
    distribution carried in ``state["reset"]``."""
    def apply_fn(state, acc, step):
        rank = (1.0 - damping) * state["reset"] + damping * acc
        rank = torch.where(state["mask"], rank, 0.0)
        return dict(state, rank=rank), _all_finished(acc)

    return VertexProgram(combine=SUM, edge_fn=_edge_fn, apply_fn=apply_fn,
                         max_steps=max_steps, edge_msg=_EDGE_MSG)


def _never_finished(apply_fn):
    def wrapped(state, acc, step):
        new_state, fin = apply_fn(state, acc, step)
        return new_state, torch.zeros_like(fin)
    return wrapped


def personalized_pagerank(engine: BSPEngine, reset,
                          num_iterations: int = 20,
                          damping: float = DAMPING) -> np.ndarray:
    """Batched personalized PageRank: one run, Q restart distributions.

    ``reset`` is either [Q, n] per-query restart distributions or a
    length-Q sequence of seed vertex ids (one-hot teleport).  Ranks start at
    the reset distribution; the round count rides ``max_steps`` with a
    never-finished vote.  Returns ranks [Q, n].
    """
    pg = engine.pg
    reset = np.asarray(reset)
    if reset.ndim == 1:                      # seed vertex ids → one-hot
        seeds = reset.astype(np.int64)
        reset = np.zeros((len(seeds), pg.num_vertices), dtype=np.float32)
        reset[np.arange(len(seeds)), seeds] = 1.0
    q = reset.shape[0]
    base = initial_state(pg, damping)
    reset_p = torch.as_tensor(np.stack(
        [pg.scatter_global(row.astype(np.float32), 0.0) for row in reset]))
    state = {
        "rank": reset_p, "reset": reset_p,
        # query-independent constants, broadcast along the query axis
        "inv_deg": base["inv_deg"].expand((q,) + base["inv_deg"].shape),
        "mask": base["mask"].expand((q,) + base["mask"].shape),
    }
    program = make_personalized_pagerank_program(damping,
                                                 max_steps=num_iterations)
    program = dataclasses.replace(
        program, apply_fn=_never_finished(program.apply_fn))
    out, _ = engine.execute(program, state)
    return gather_batch(pg, out["rank"])


def personalized_pagerank_reference(g, reset, num_iterations: int = 20,
                                    damping: float = DAMPING) -> np.ndarray:
    """Pure-numpy batched PPR oracle (same push semantics as the engine)."""
    n = g.num_vertices
    reset = np.asarray(reset, dtype=np.float64)
    q = reset.shape[0]
    deg = g.out_degrees().astype(np.float64)
    src = g.edge_sources()
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    rank = reset.copy()
    rows = np.arange(q)[:, None]
    for _ in range(num_iterations):
        contrib = (rank * inv)[:, src]
        acc = np.zeros((q, n))
        np.add.at(acc, (rows, g.col[None, :]), contrib)
        rank = (1.0 - damping) * reset + damping * acc
    return rank.astype(np.float32)


def pagerank_reference(g, num_iterations: int = 20,
                       damping: float = DAMPING) -> np.ndarray:
    """Pure-numpy push PageRank oracle (same semantics, incl. dangling)."""
    n = g.num_vertices
    deg = g.out_degrees().astype(np.float64)
    src = g.edge_sources()
    rank = np.full(n, 1.0 / n)
    delta = (1.0 - damping) / n
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1.0), 0.0)
    for _ in range(num_iterations):
        contrib = rank * inv
        acc = np.zeros(n)
        np.add.at(acc, g.col, contrib[src])
        rank = delta + damping * acc
    return rank.astype(np.float32)
