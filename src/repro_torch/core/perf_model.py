"""The push/pull crossover of direction-optimized traversal and the hybrid
backend's degree-split planner.

A copy of the JAX package's ``repro.core.perf_model`` (its direction and
degree-split parts), so an engine of the port votes for the same direction
and picks the same dense block |H| as the JAX package's on the same graph.

Every constant below is that package's model of its own accelerator, kept
under the package's names; none was fitted on a GPU.  ``DIRECTION_GAMMA``
is its per-backend cost of a bottom-up scan slot relative to a pushed edge.
The ``TPU_*`` rates and the fast-memory size behind ``K_DENSE_CAP`` are the
inputs of its split planner (``hybrid_makespan_tpu``); copying them keeps
``hybrid_k_dense=None`` on the JAX package's choice.  A model of the card's
own rates, fitted from measurement, is later work.
"""
from __future__ import annotations

import numpy as np

DIRECTION_GAMMA = {"hybrid": 1.0, "fused": 1.5, "reference": 2.0}

# The JAX package's accelerator model (see the module docstring).
TPU_PEAK_FLOPS = 197e12
TPU_HBM_BW = 819e9
TPU_VMEM_BYTES = 128 * 1024 * 1024


def fit_pull_threshold(avg_degree: float, kmax: int | None = None, *,
                       backend: str = "hybrid",
                       gamma: float | None = None) -> float:
    """Frontier density above which bottom-up (pull) wins.

    Push costs about ``d * V * deg`` (the edges out of a frontier of density
    ``d``), pull about ``V * min(1/d, kmax) * gamma`` (early-exit row
    scans).  They cross at ``d* = sqrt(gamma / deg)``, or at
    ``gamma * kmax / deg`` when scans hit the row width; the threshold is
    the smaller, clamped to ``[1e-4, 0.9]``.
    """
    if gamma is None:
        gamma = DIRECTION_GAMMA[backend]
    deg = max(float(avg_degree), 1e-9)
    thr = (gamma / deg) ** 0.5
    if kmax is not None:
        thr = min(thr, gamma * max(int(kmax), 1) / deg)
    return float(min(max(thr, 1e-4), 0.9))


def fit_shard_pull_thresholds(shard_avg_degrees, shard_kmaxes=None, *,
                              backend: str = "hybrid",
                              gamma: float | None = None) -> np.ndarray:
    """One threshold per partition, ``[P]`` float32."""
    degs = np.atleast_1d(np.asarray(shard_avg_degrees, dtype=np.float64))
    if shard_kmaxes is None:
        kmaxes = [None] * len(degs)
    else:
        kmaxes = list(np.atleast_1d(np.asarray(shard_kmaxes)))
    return np.array([fit_pull_threshold(d, k, backend=backend, gamma=gamma)
                     for d, k in zip(degs, kmaxes)], dtype=np.float32)


# ---------------------------------------------------------------------------
# Degree-split selection (the paper's Eq. 4 role: the model picks the split)
# ---------------------------------------------------------------------------

def dense_block_rate(density: float) -> float:
    """Useful edges per second of the dense path on a block of ``density``:
    a K x K block product costs ``2 K^2`` operations whatever its fill."""
    return TPU_PEAK_FLOPS / 2.0 * density


def hybrid_makespan_tpu(e_dense: float, dense_density: float,
                        e_sparse: float) -> dict:
    """Predicted makespan of the two-engine step (paper Eq. 2 recast): the
    dense and sparse stages run one after the other on one device.

      t_dense = e_dense / dense_block_rate(density)
      t_sparse = e_sparse / (memory rate / 8 bytes per remainder edge)

    The JAX package's version adds a boundary-exchange term for its
    sharded engine, which is 0 on one device.
    """
    t_dense = e_dense / dense_block_rate(max(dense_density, 1e-12))
    t_sparse = e_sparse / (TPU_HBM_BW / 8.0)
    return dict(t_dense=t_dense, t_sparse=t_sparse,
                makespan=t_dense + t_sparse)


# Largest dense block the planner considers: the f32 H x H block within a
# quarter of the modelled fast memory, in lane multiples.
K_DENSE_CAP = int((TPU_VMEM_BYTES / 4 / 4) ** 0.5) // 128 * 128


def k_dense_candidates(num_vertices: int, skewed: bool = True,
                       lane: int = 128) -> list:
    """Candidate dense-block sizes |H|: 0 (pure sparse), a power-of-two
    ladder of lane multiples, and the cap (``K_DENSE_CAP`` or the vertex
    count).  ``skewed=False`` (no high-degree concentration in the
    block-span histograms, ``BlockMetadata.degree_skew``) prunes the ladder
    to 0 and one lane tile."""
    if not skewed:
        return [0, min(lane, K_DENSE_CAP)] if num_vertices >= lane else [0]
    cap = min(K_DENSE_CAP, num_vertices)
    cands = [0]
    k = lane
    while k < cap:
        cands.append(k)
        k *= 2
    cands.append(cap)
    return cands


def rank_k_dense(edge_max_rank: np.ndarray, num_edges: int,
                 candidates) -> list:
    """One record per candidate |H|: the edges inside the H x H block
    (``e_dense(k) = #{e : edge_max_rank[e] < k}``), the rest, the block's
    density and the makespan terms of :func:`hybrid_makespan_tpu`.

    The JAX package sorts the ranks and searches them; counting them gives
    the same integers in one pass over the edges.
    """
    ranks = np.asarray(edge_max_rank)
    top = max([int(k) for k in candidates] + [0])
    below = np.concatenate([[0], np.cumsum(np.bincount(
        np.minimum(ranks, top), minlength=top + 1))])   # below[k] = #{r < k}
    table = []
    for k in candidates:
        e_dense = int(below[int(k)])
        e_sparse = int(num_edges) - e_dense
        density = e_dense / max(int(k) * int(k), 1)
        table.append(dict(k_dense=int(k), e_dense=e_dense, e_sparse=e_sparse,
                          density=density,
                          **hybrid_makespan_tpu(e_dense, density, e_sparse)))
    return table


def choose_k_dense(edge_max_rank: np.ndarray, num_edges: int, candidates):
    """Pick |H| = argmin of predicted makespan; returns (k, ranked table)."""
    table = rank_k_dense(edge_max_rank, num_edges, candidates)
    best = min(table, key=lambda rec: rec["makespan"])
    return best["k_dense"], table


def split_mode(k_dense: int, num_vertices: int, e_sparse: int) -> str:
    """Classify a chosen split: the engine runs dense, sparse, or both."""
    if k_dense == 0:
        return "sparse"
    if e_sparse == 0 or k_dense >= num_vertices:
        return "dense"
    return "hybrid"
