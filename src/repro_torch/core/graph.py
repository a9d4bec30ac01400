"""Graph containers and synthetic workload generators.

The paper (§5.1) evaluates on real scale-free graphs (Twitter, UK-WEB) and
synthetic RMAT / uniform (Erdős–Rényi) graphs.  This module provides the CSR
container plus RMAT and uniform generators with the paper's parameters
((A,B,C) = (0.57, 0.19, 0.19), average degree 16).

Everything here is *preprocessing*: plain numpy, amortized cost, excluded from
timed regions — the same methodology as the paper (§5, "Time Measurements").

A copy of ``repro.core.graph`` (its static part), so the port imports no JAX:
the same seed gives array-equal graphs in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# The paper's RMAT parameters (Table 2).
RMAT_A, RMAT_B, RMAT_C = 0.57, 0.19, 0.19
DEFAULT_EDGE_FACTOR = 16


@dataclasses.dataclass
class CSRGraph:
    """Compressed Sparse Row graph (paper §4.3.1).

    ``row_ptr[v]:row_ptr[v+1]`` indexes ``col`` with the out-neighbours of
    ``v``.  ``weights`` is optional (SSSP).  Vertex ids are dense ``[0, n)``.
    """

    row_ptr: np.ndarray       # int64 [num_vertices + 1]
    col: np.ndarray           # int32/int64 [num_edges]
    weights: Optional[np.ndarray] = None  # float32 [num_edges] or None

    @property
    def num_vertices(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.col)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.row_ptr)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.col, minlength=self.num_vertices)

    def edge_sources(self) -> np.ndarray:
        """Expand row_ptr into a per-edge source-vertex array."""
        return np.repeat(
            np.arange(self.num_vertices, dtype=self.col.dtype),
            self.out_degrees(),
        )

    def reverse(self) -> "CSRGraph":
        """Transpose (in-edges become out-edges); weights carried along."""
        src = self.edge_sources()
        order = np.argsort(self.col, kind="stable")
        rcol = src[order]
        rrow = np.zeros(self.num_vertices + 1, dtype=np.int64)
        np.add.at(rrow, self.col + 1, 1)
        rrow = np.cumsum(rrow)
        rw = self.weights[order] if self.weights is not None else None
        return CSRGraph(rrow, rcol.astype(self.col.dtype), rw)

    def with_uniform_weights(self, lo: float = 1.0, hi: float = 64.0,
                             seed: int = 0) -> "CSRGraph":
        rng = np.random.default_rng(seed)
        w = rng.uniform(lo, hi, size=self.num_edges).astype(np.float32)
        return CSRGraph(self.row_ptr, self.col, w)


def _validate_edge_list(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                        weights: Optional[np.ndarray], what: str):
    """Actionable errors for malformed edge input — without this, bad ids
    fail deep inside partitioning with an opaque shape/index error."""
    if len(src) != len(dst):
        raise ValueError(
            f"{what}: src/dst length mismatch — len(src)={len(src)} vs "
            f"len(dst)={len(dst)}; each edge needs one entry in both")
    if weights is not None and len(weights) != len(src):
        raise ValueError(
            f"{what}: weights length {len(weights)} != num edges "
            f"{len(src)}; pass one weight per edge or None")
    if len(src):
        lo = int(min(src.min(), dst.min()))
        hi = int(max(src.max(), dst.max()))
        if lo < 0 or hi >= num_vertices:
            raise ValueError(
                f"{what}: vertex ids must lie in [0, num_vertices="
                f"{num_vertices}); got min={lo}, max={hi} — negative ids "
                f"or ids >= num_vertices corrupt the CSR row pointer")
    if weights is not None:
        w = np.asarray(weights, dtype=np.float64)
        bad = np.flatnonzero(~np.isfinite(w))
        if len(bad):
            i = int(bad[0])
            raise ValueError(
                f"{what}: weights must be finite — weights[{i}] = {w[i]} "
                f"({len(bad)} non-finite entries); NaN/inf weights poison "
                f"every shortest-path query touching the edge")


def from_edge_list(src: np.ndarray, dst: np.ndarray, num_vertices: int,
                   weights: Optional[np.ndarray] = None,
                   dedup: bool = False) -> CSRGraph:
    """Build CSR from a (src, dst) edge list.  Sorts by (src, dst)."""
    src, dst = np.asarray(src), np.asarray(dst)
    _validate_edge_list(src, dst, num_vertices, weights, "from_edge_list")
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if weights is not None:
        weights = weights[order]
    if dedup:
        keep = np.ones(len(src), dtype=bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst = src[keep], dst[keep]
        if weights is not None:
            weights = weights[keep]
    row_ptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.add.at(row_ptr, src + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    dtype = np.int32 if num_vertices < 2**31 else np.int64
    return CSRGraph(row_ptr, dst.astype(dtype), weights)


def rmat(scale: int, edge_factor: int = DEFAULT_EDGE_FACTOR,
         a: float = RMAT_A, b: float = RMAT_B, c: float = RMAT_C,
         seed: int = 1, dedup: bool = False) -> CSRGraph:
    """Recursive-MATrix generator [Chakrabarti et al. 2004], paper Table 2.

    Directed (the paper notes its graphs are directed, unlike Graph500).
    Vectorized bit-by-bit sampling: per edge, each of ``scale`` bits of
    (src, dst) picks one of the four quadrants with probs (a, b, c, d).
    """
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_frac = a / ab
    c_frac = c / (1.0 - ab)
    for _ in range(scale):
        src_bit = rng.random(m) > ab
        dst_thresh = np.where(src_bit, c_frac, a_frac)
        dst_bit = rng.random(m) > dst_thresh
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return from_edge_list(src, dst, n, dedup=dedup)


def uniform(scale: int, edge_factor: int = DEFAULT_EDGE_FACTOR,
            seed: int = 1) -> CSRGraph:
    """Erdős–Rényi-style uniform graph (paper's UNIFORM28 baseline)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    return from_edge_list(src, dst, n)


