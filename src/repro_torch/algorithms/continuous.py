"""Per-query slot re-initialization for continuous batching.

A serving session refills a converged query's slot *mid-run*: the new
tenant joins the resident loop at some global superstep ``step0 > 0``, but
the vertex program only ever sees the loop's shared step counter.  So each
algorithm's fresh state is expressed **in the global step frame**, with no
per-slot counter threaded through the kernels:

- BFS is level-synchronous (its frontier test is ``level == step``), so a
  slot admitted at ``step0`` seeds its source at ``level = step0``: the
  source fires at exactly the right global step, and every level the
  traversal writes is the true level **+ step0**.  Levels are small exact
  f32 integers, so the harvest's subtraction is exact: a refilled slot's
  harvested result equals the same query's drain-batch result bit for
  bit.
- SSSP's Bellman-Ford relaxation never reads the step, so its slot state
  is the ordinary ``{dist, active}`` seed and the harvest is the identity.

Programs whose step dependence is not a pure translation (BC's backward
walk, fixed-iteration PageRank) have no continuous form: the serving layer
drain-batches them, and :func:`continuous_form` says so.

Slot states come from ``multi_source_state`` with a per-query ``value=``:
host numpy as in the JAX package, or made on a ``device`` (the serving
session's), so a refill copies no state rows from the host.  The harvest
takes the state's result leaf, a tensor (gathered where it lies) or numpy,
for the rows the caller picked.  Port of ``repro.algorithms.continuous``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.algorithms.bfs import (BFS_PROGRAM, gather_batch,
                                        multi_source_state)
from repro_torch.algorithms.sssp import SSSP_PROGRAM
from repro_torch.core.bsp import VertexProgram


@dataclasses.dataclass(frozen=True)
class ContinuousForm:
    """An algorithm's step-translated slot protocol.

    ``make_slot_state(pg, sources, step0, device=None)`` builds a batched
    state (``[Q, P, v_max]`` leaves: host numpy, or tensors on
    ``device``) whose row ``i`` is query ``sources[i]``'s fresh state
    translated to global superstep ``step0[i]``; ``harvest(pg, state,
    step0)`` collects a batched state into ``[Q, n]`` global results
    translated *back* to the step-0 frame.
    Non-admitted rows of either are junk by contract: the caller masks.
    """
    program: VertexProgram
    make_slot_state: Callable
    harvest: Callable


def _bfs_slot_state(pg, sources: Sequence[int], step0: np.ndarray,
                    device=None) -> dict:
    value = np.asarray(step0, np.float32).reshape(-1)
    return {"level": multi_source_state(pg, sources, value=value,
                                        device=device)}


def _bfs_harvest(pg, state, step0: np.ndarray) -> np.ndarray:
    levels = gather_batch(pg, state["level"])
    # inf - step0 == inf: unreached vertices survive the frame shift.  NaN
    # rows (quarantined slots frozen mid-poison) pass through unchanged.
    with np.errstate(invalid="ignore"):
        return (levels - np.asarray(step0, np.float32)[:, None]).astype(
            np.float32)


def _sssp_slot_state(pg, sources: Sequence[int], step0: np.ndarray,
                     device=None) -> dict:
    del step0                      # relaxation is step-invariant
    dist = multi_source_state(pg, sources, device=device)
    active = np.isfinite(dist) if device is None else torch.isfinite(dist)
    return {"dist": dist, "active": active}


def _sssp_harvest(pg, state, step0: np.ndarray) -> np.ndarray:
    del step0
    return gather_batch(pg, state["dist"])


CONTINUOUS_FORMS: Dict[str, ContinuousForm] = {
    "bfs": ContinuousForm(BFS_PROGRAM, _bfs_slot_state, _bfs_harvest),
    "sssp": ContinuousForm(SSSP_PROGRAM, _sssp_slot_state, _sssp_harvest),
}


def continuous_form(alg: str) -> ContinuousForm:
    """The continuous-batching form of ``alg``, or an actionable error."""
    form = CONTINUOUS_FORMS.get(alg)
    if form is None:
        raise ValueError(
            f"{alg!r} has no continuous form: slot refill needs a "
            f"step-translatable program (supported: "
            f"{sorted(CONTINUOUS_FORMS)}).  Serve {alg!r} through the "
            f"drain-batch driver (engine.execute / run_batched) instead.")
    return form


def result_key(alg: str) -> Tuple[str, ...]:
    """State leaves a continuous result is read from."""
    return ("level",) if alg == "bfs" else ("dist",)
