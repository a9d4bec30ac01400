"""Connected components via label propagation (paper §9.4, Table 4).

Min-label propagation over *undirected* edges; callers partition the
symmetrized graph (``symmetrize``).  Port of ``repro.algorithms.cc``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.bsp import (MIN, BSPEngine, EdgeMessage,
                                  IncrementalForm, VertexProgram, batch_state,
                                  gather_src)
from repro_torch.core.graph import CSRGraph, from_edge_list


def symmetrize(g: CSRGraph) -> CSRGraph:
    src = g.edge_sources()
    return from_edge_list(np.concatenate([src, g.col]),
                          np.concatenate([g.col, src]),
                          g.num_vertices, dedup=True)


def _edge_fn(state, src, weight, step):
    del weight, step
    label = gather_src(state["label"], src)
    active = gather_src(state["active"].float(), src) > 0
    return torch.where(active, label, math.inf)


def _apply_fn(state, acc, step):
    del step
    label = state["label"]
    improved = acc < label
    new_label = torch.where(improved, acc, label)
    return ({"label": new_label, "active": improved},
            ~improved.flatten(1).any(1))


def _edge_msg_fn(vals, weight, step, consts):
    del weight, step, consts
    return torch.where(vals["active"] > 0, vals["label"], math.inf)


CC_PROGRAM = VertexProgram(combine=MIN, edge_fn=_edge_fn,
                           apply_fn=_apply_fn,
                           edge_msg=EdgeMessage(gather=("label", "active"),
                                                fn=_edge_msg_fn, kind="cc"))


def _inc_seed(prev_state, dirty):
    """Warm state after insert-only mutations: label propagation is already
    an active-set min-relaxation, so re-seed it from the previous fixpoint
    with the dirty frontier active.  Mutations must keep the graph
    symmetric (insert both (u, v) and (v, u)): CC's contract."""
    label = prev_state["label"]
    return {"label": label,
            "active": dirty.to(torch.bool).expand_as(label)
            & torch.isfinite(label)}


CC_PROGRAM = dataclasses.replace(
    CC_PROGRAM, incremental=IncrementalForm(CC_PROGRAM, _inc_seed))


def connected_components(engine: BSPEngine) -> Tuple[np.ndarray, int]:
    """Returns (labels [n] — min global vertex id per component, steps)."""
    pg = engine.pg
    # Initial label = global vertex id, so components get their min-id label.
    gids = np.arange(pg.num_vertices, dtype=np.float32)
    label0 = pg.scatter_global(gids, np.inf)
    state, steps = engine.execute(CC_PROGRAM, batch_state({
        "label": torch.as_tensor(label0, dtype=torch.float32),
        "active": torch.as_tensor(pg.vertex_mask.copy())}))
    return (pg.gather_global(state["label"][0].cpu().numpy()),
            int(steps[0]))


def cc_incremental(engine: BSPEngine, prev_labels: np.ndarray,
                   dirty_global: np.ndarray) -> Tuple[np.ndarray, int]:
    """Warm-start component labels after insert-only *symmetric* mutations
    (see :func:`repro_torch.algorithms.bfs.bfs_incremental` for the
    contract).  Returns (labels [n], supersteps)."""
    pg = engine.pg
    prev = np.asarray(prev_labels, dtype=np.float32)
    state = {"label": torch.as_tensor(pg.scatter_global(prev, np.inf),
                                      device=engine.device)[None]}
    st, steps = engine.execute(CC_PROGRAM, state,
                               incremental=pg.scatter_dirty(dirty_global))
    return (pg.gather_global(st["label"][0].cpu().numpy()),
            int(steps[0]))


def cc_reference(g: CSRGraph) -> np.ndarray:
    """Pure-numpy min-label propagation oracle (assumes symmetric graph)."""
    n = g.num_vertices
    src = g.edge_sources()
    label = np.arange(n, dtype=np.float64)
    while True:
        new = label.copy()
        np.minimum.at(new, g.col, label[src])
        if np.array_equal(new, label):
            return label.astype(np.float32)
        label = new
