"""The push/pull crossover of direction-optimized traversal.

A copy of the direction part of ``repro.core.perf_model`` (the rest, the
paper's hybrid model and the degree split, waits for the hybrid slice), so
an engine of the port votes for the same direction as the JAX package's on
the same graph.  ``DIRECTION_GAMMA`` is that package's per-backend model of
the bottom-up scan's cost per slot relative to the push cost per edge; it
was not fitted on a GPU.
"""
from __future__ import annotations

import numpy as np

DIRECTION_GAMMA = {"hybrid": 1.0, "fused": 1.5, "reference": 2.0}


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
