"""The benchmark's arithmetic: peaks, kernel byte and operation bounds and
traversed edges.

Frozen copies, so that a change to the program cannot move the yardstick:

- the peaks and the bounds from ``chip_smoke.py`` (``HBM_BYTES_PER_S``,
  ``F32_OPS_PER_S``, ``dense_bound_ms``, ``scan_bound_ms``): each input
  read once and each output written once at the HBM rate, or the
  semiring's operations at the float32 rate outside the tensor cores,
  whichever is larger;
- traversed edges by Graph500's rule, from
  ``src/repro_torch/algorithms/bfs.py::teps``: the summed out-degrees of
  the vertices a search reached.
"""
from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and float32 rate outside the
# tensor cores, at the 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def scan_bound_s(semiring: str, v: int, nnz: int, q: int,
                 x_len: int) -> float:
    """Least seconds of one bottom-up scan launch that reads every slot (no
    early exit): ``row_ptr``, ``col`` (and ``val`` for min-plus) and ``x``
    read once, ``y`` and the scanned counts written once; or a compare (and
    an add) per slot and query at the float32 rate."""
    per_slot = 2 if semiring == "min_plus" else 1
    moved = 4 * (v + 1) + 4 * per_slot * nnz + 4 * q * x_len + 8 * q * v
    ops = per_slot * q * nnz
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def dense_bound_s(m: int, k: int, n: int) -> float:
    """Least seconds of one ``dense_spmv`` launch, ``[m, k] x [k, n]``:
    ``a``, ``x`` and ``y`` once, or ``2 m k n`` operations at the float32
    rate."""
    moved = 4 * (k * n + m * k + m * n)
    return max(moved / HBM_BYTES_PER_S, 2 * m * k * n / F32_OPS_PER_S)


def traversed_edges(results: np.ndarray, out_deg: np.ndarray,
                    rows: int = 8) -> int:
    """Traversed edges (Graph500's rule) of a ``[Q, n]`` batch of host results: the
    out-degrees (``out_deg``, ``[n]`` on the host) of every vertex each
    query reached (a finite level or distance), summed over the queries:
    how many queries reached each vertex, dotted with the degrees.  A few
    rows at a time, so the temporaries stay in cache."""
    q, n = results.shape
    reached = np.zeros(n, dtype=np.int32)
    mask = np.empty((min(rows, q), n), dtype=bool)
    for i in range(0, q, rows):
        part = results[i:i + rows]
        np.less(part, np.inf, out=mask[:len(part)])
        reached += mask[:len(part)].sum(0, dtype=np.int32)
    return int(reached.astype(np.int64) @ out_deg.astype(np.int64))
