"""The hybrid two-engine step: TOTEM's degree split (paper §6.2), single
device.

The paper hands the few high-degree vertices to one processor and the long
tail to the other.  Here both engines are kernels on one card: the
adjacency among the top-K vertices by degree (H) is dense enough to run as
a dense product of the query batch with an H x H block
(``kernels/dense_spmv.py``), and every other edge stays in a sparse
remainder of in-edge rows (``kernels/ell_spmv.py``).  ``degree_split``
plays the role of the paper's HIGH partitioning; ``plan_degree_split`` lets
the performance model pick |H| (``perf_model.choose_k_dense``, the role
Eq. 4 plays in the paper), which may be 0 (pure sparse) or the whole graph.

Semirings, one per TOTEM reduction class (§3.4), make the split a backend
for every vertex program: ``plus_times`` (PageRank, BC), ``min_plus``
(SSSP), ``min`` (BFS, CC).

The single-device half of ``repro.core.hybrid``.  The JAX package keeps
the remainder as an ELL block ``[V, kmax]`` padded to the widest row; on a
scale-free graph that row is a hub's in-degree (about 50k at RMAT20, where
the block would need hundreds of GB), so here the remainder is CSR rows
(``ell_row_ptr``/``ell_col``/``ell_val``) in the same slot order: padded to
``kmax`` with the sentinel ``V`` they equal the JAX block.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import perf_model
from repro_torch.core.graph import CSRGraph
from repro_torch.core.partition import build_block_metadata
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ops import (bottomup_scan_op, dense_spmv_minplus_op,
                                     dense_spmv_op, ell_spmv_op)
from repro_torch.kernels.ref import SEMIRINGS

PLUS_TIMES = "plus_times"
MIN_PLUS = "min_plus"
MIN_SR = "min"

__all__ = ["PLUS_TIMES", "MIN_PLUS", "MIN_SR", "SEMIRINGS", "add_identity",
           "HybridGraph", "SplitLayout", "degree_ranking", "edge_max_ranks",
           "split_layout", "degree_split", "plan_degree_split",
           "auto_degree_split", "SplitCache", "splits_of",
           "hybrid_spmv", "hybrid_spmv_scan", "hybrid_pagerank"]


def add_identity(semiring: str) -> float:
    """⊕-identity of a semiring (0 for sum, +inf for min)."""
    return SEMIRINGS[semiring][1]


@dataclasses.dataclass
class HybridGraph:
    """Degree-split graph: the dense H x H block and the remainder's in-edge
    rows (pull form), in the degree-ranked id space."""

    num_vertices: int
    num_edges: int
    k_dense: int                 # |H| (0 -> pure sparse)
    perm: np.ndarray             # new id -> old id (degree-descending)
    inv_perm: np.ndarray         # old id -> new id
    dense_block: np.ndarray      # [K, K] f32 ⊗ values, ⊕-identity off-edge
    ell_row_ptr: np.ndarray      # [V + 1] int32 remainder rows (in-edges)
    ell_col: np.ndarray          # [sparse_edges] int32 source ids
    ell_val: np.ndarray          # [sparse_edges] f32 ⊗ values
    kmax: int                    # widest remainder row (>= 1)
    out_deg: np.ndarray          # [V] f32 in new id space (true out-degree)
    dense_edges: int             # edges of the dense stage
    sparse_edges: int            # edges of the sparse stage
    semiring: str = PLUS_TIMES
    model_table: Optional[List[dict]] = None  # perf-model ranking (auto split)

    @property
    def mode(self) -> str:
        """Which engine(s) this split runs: dense, sparse, or hybrid."""
        return perf_model.split_mode(self.k_dense, self.num_vertices,
                                     self.sparse_edges)


def degree_ranking(g: CSRGraph) -> Tuple[np.ndarray, np.ndarray]:
    """Degree-descending vertex ranking (new -> old) and its inverse
    (``repro.core.hybrid._degree_perm``)."""
    total_deg = g.out_degrees() + g.in_degrees()
    perm = np.argsort(-total_deg, kind="stable")       # new -> old
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return perm, inv


def edge_max_ranks(g: CSRGraph, ranking=None) -> np.ndarray:
    """Per-edge ``max(rank(src), rank(dst))`` under the degree ranking
    (``degree_ranking(g)``, computed when not given): the planner's
    input, ``e_dense(k) = #{edges with max rank < k}``.  Symmetric under
    graph reversal, so one table serves both edge directions."""
    _, inv = ranking if ranking is not None else degree_ranking(g)
    return np.maximum(inv[g.edge_sources()], inv[g.col])


@dataclasses.dataclass
class SplitLayout:
    """Where each edge of ``g`` goes under a split at ``k_dense``: the part
    of ``degree_split`` that does not depend on the semiring, so the
    programs of one engine share it."""

    k_dense: int
    perm: np.ndarray        # new id -> old id
    inv_perm: np.ndarray    # old id -> new id
    src: np.ndarray         # [E] ranked source of each edge
    dst: np.ndarray         # [E] ranked destination
    in_h: np.ndarray        # [E] bool: the edge lies in the H x H block
    rest: np.ndarray        # [sparse_edges] edge ids in remainder-row order
    row_ptr: np.ndarray     # [V + 1] int32 remainder rows (by destination)
    kmax: int               # widest remainder row (>= 1)


def split_layout(g: CSRGraph, k_dense: int, ranking=None) -> SplitLayout:
    """Rank ``g``'s vertices by degree (or take ``ranking``, which the
    reverse graph shares: a vertex's total degree is the same in both) and
    assign each edge to the dense block or the remainder.

    Remainder rows are destinations; a row's slots run by source rank, ties
    in edge order.  That is the JAX package's order (its remainder goes
    through ``from_edge_list``, sorted by (source, destination), then
    ``csr_to_ell``'s stable transpose), reached with one sort.
    """
    perm, inv = ranking if ranking is not None else degree_ranking(g)
    src = inv[g.edge_sources()]
    dst = inv[g.col]
    in_h = (src < k_dense) & (dst < k_dense)
    rest = np.flatnonzero(~in_h)
    rest = rest[np.lexsort((src[rest], dst[rest]))]
    if len(rest) >= 2 ** 31:
        raise ValueError(f"{len(rest)} remainder edges overflow int32 rows")
    deg = np.bincount(dst[rest], minlength=g.num_vertices)
    row_ptr = np.zeros(g.num_vertices + 1, dtype=np.int32)
    np.cumsum(deg, out=row_ptr[1:])
    return SplitLayout(k_dense=int(k_dense), perm=perm, inv_perm=inv,
                       src=src, dst=dst, in_h=in_h, rest=rest,
                       row_ptr=row_ptr,
                       kmax=max(int(deg.max(initial=0)), 1))


def degree_split(g: CSRGraph, k_dense: int, semiring: str = PLUS_TIMES,
                 layout: Optional[SplitLayout] = None) -> HybridGraph:
    """Split ``g``: the top-``k_dense`` degree vertices form the dense block.

    Edge ⊗ values follow the semiring: weights where the graph has them,
    multiplicity counts (``plus_times``) or zero-cost hops (``min_plus``)
    otherwise, and 0 for ``min``.  Multi-edges accumulate with ⊕ in the
    dense block, in edge order, as the reference engine reduces them.
    ``layout`` (``split_layout(g, k_dense)``) is computed when not given.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if layout is None:
        layout = split_layout(g, k_dense)
    elif layout.k_dense != k_dense:
        raise ValueError(f"layout is for k_dense={layout.k_dense}, not "
                         f"{k_dense}")
    if semiring == PLUS_TIMES:
        w = (g.weights if g.weights is not None
             else np.ones(g.num_edges, dtype=np.float32))
    elif semiring == MIN_PLUS:
        w = (g.weights if g.weights is not None
             else np.zeros(g.num_edges, dtype=np.float32))
    else:  # pure min: edge values are irrelevant, hop cost 0
        w = np.zeros(g.num_edges, dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)

    in_h = layout.in_h
    dense = np.full((k_dense, k_dense), add_identity(semiring),
                    dtype=np.float32)
    if k_dense:
        at = (layout.src[in_h], layout.dst[in_h])
        if semiring == PLUS_TIMES:
            np.add.at(dense, at, w[in_h])
        else:
            np.minimum.at(dense, at, w[in_h])
    return HybridGraph(
        num_vertices=g.num_vertices, num_edges=g.num_edges, k_dense=k_dense,
        perm=layout.perm, inv_perm=layout.inv_perm, dense_block=dense,
        ell_row_ptr=layout.row_ptr,
        ell_col=layout.src[layout.rest].astype(np.int32),
        ell_val=w[layout.rest], kmax=layout.kmax,
        out_deg=g.out_degrees().astype(np.float32)[layout.perm],
        dense_edges=int(in_h.sum()), sparse_edges=len(layout.rest),
        semiring=semiring)


def plan_degree_split(g: CSRGraph, k_dense: Optional[int] = None, *,
                      candidates=None, skewed: bool = True,
                      ranking=None) -> dict:
    """The split decision (the role Eq. 4 plays in the paper): |H| is the
    candidate of least predicted makespan, or ``k_dense`` when given.

    ``candidates`` default to ``perf_model.k_dense_candidates`` (``skewed=
    False`` when the block-span histograms show no high-degree
    concentration); ``ranking`` is ``degree_ranking(g)``, computed when not
    given.  Returns ``k_dense``, ``candidates``, ``mode`` and the ranked
    ``table``, which also holds a given ``k_dense``.
    """
    if candidates is None:
        candidates = perf_model.k_dense_candidates(g.num_vertices,
                                                   skewed=skewed)
    ranks = edge_max_ranks(g, ranking)
    if k_dense is None:
        k_dense, table = perf_model.choose_k_dense(ranks, g.num_edges,
                                                   candidates)
    else:
        table = perf_model.rank_k_dense(ranks, g.num_edges,
                                        sorted(set(candidates) | {k_dense}))
    chosen = next(r for r in table if r["k_dense"] == k_dense)
    return dict(k_dense=k_dense, candidates=list(candidates),
                mode=perf_model.split_mode(k_dense, g.num_vertices,
                                           chosen["e_sparse"]),
                table=table)


def auto_degree_split(g: CSRGraph, semiring: str = PLUS_TIMES,
                      candidates=None, skewed: bool = True) -> HybridGraph:
    """Degree split at the |H| of ``plan_degree_split``; the planner's
    ranked table rides on the result."""
    ranking = degree_ranking(g)
    plan = plan_degree_split(g, candidates=candidates, skewed=skewed,
                             ranking=ranking)
    k = plan["k_dense"]
    hg = degree_split(g, k, semiring=semiring,
                      layout=split_layout(g, k, ranking))
    hg.model_table = plan["table"]
    return hg


class SplitCache:
    """The host work of the degree split over one partitioned graph, done
    once: the degree ranking, the planner's decisions, each direction's
    layout and each semiring's split.  Hybrid engines over the same graph
    differ in direction settings and device, not in these arrays, so they
    share one cache (``splits_of``)."""

    def __init__(self, pg):
        self.pg = pg
        self._memo: dict = {}

    def _once(self, key, build):
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    def ranking(self) -> Tuple[np.ndarray, np.ndarray]:
        """``degree_ranking(pg.source)``; the reverse graph shares it
        (reversal keeps each vertex's degree)."""
        return self._once("ranking", lambda: degree_ranking(self.pg.source))

    def skew(self, block_e: int) -> float:
        """The degree-skew signal of the forward blocks' span histograms."""
        return self._once(("skew", block_e), lambda: build_block_metadata(
            self.pg.fwd, block_e=block_e).degree_skew())

    def plan(self, k_dense: Optional[int], block_e: int) -> dict:
        """``plan_degree_split`` of ``pg.source`` with the candidates the
        skew signal allows; the plan also carries ``skew``."""
        def build():
            skew = self.skew(block_e)
            return dict(plan_degree_split(self.pg.source, k_dense,
                                          skewed=skew > 0.0,
                                          ranking=self.ranking()), skew=skew)
        return self._once(("plan", k_dense, block_e), build)

    def graph(self, reverse: bool) -> CSRGraph:
        return self._once(("graph", reverse), lambda: (
            self.pg.source.reverse() if reverse else self.pg.source))

    def layout(self, k_dense: int, reverse: bool) -> SplitLayout:
        return self._once(("layout", k_dense, reverse), lambda: split_layout(
            self.graph(reverse), k_dense, self.ranking()))

    def split(self, k_dense: int, reverse: bool, semiring: str,
              weighted: bool) -> HybridGraph:
        """``degree_split`` of one direction.  ``weighted=False`` (a program
        that ignores the weights) packs multiplicity counts or zero-cost
        hops even where the graph has weights."""
        def build():
            g = self.graph(reverse)
            if not weighted:
                g = CSRGraph(g.row_ptr, g.col, None)
            return degree_split(g, k_dense, semiring=semiring,
                                layout=self.layout(k_dense, reverse))
        return self._once(("split", k_dense, reverse, semiring, weighted),
                          build)


def splits_of(pg) -> SplitCache:
    """The ``SplitCache`` of a ``PartitionedGraph``, made at the first
    call and kept on the graph."""
    if pg.hybrid_splits is None:
        pg.hybrid_splits = SplitCache(pg)
    return pg.hybrid_splits


def hybrid_spmv(dense: torch.Tensor, row_ptr: torch.Tensor,
                col: torch.Tensor, val: Optional[torch.Tensor],
                x: torch.Tensor, *, semiring: str,
                k_dense: int) -> torch.Tensor:
    """One two-engine step: ``y[v] = ⊕`` over in-edges ``x[u] ⊗ w``.

    ``x`` is the per-source value vector ``[n]`` in the degree-ranked id
    space, or a ``[Q, n]`` query batch (the batch rides the dense product's
    M axis and the sparse kernel's query loop); returns the same shape.
    The sparse stage runs first, then ``y[:, :k] ⊕= dense``, the JAX
    package's stage order.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    y = ell_spmv_op(row_ptr, col, val, x, semiring=semiring)
    if k_dense:
        xd = x[:, :k_dense]
        if semiring == PLUS_TIMES:
            y[:, :k_dense] += dense_spmv_op(xd, dense)
        else:
            y[:, :k_dense] = torch.minimum(y[:, :k_dense],
                                           dense_spmv_minplus_op(xd, dense))
    return y[0] if squeeze else y


def hybrid_spmv_scan(dense: torch.Tensor, row_ptr: torch.Tensor,
                     col: torch.Tensor, val: Optional[torch.Tensor],
                     x: torch.Tensor, *, semiring: str, k_dense: int,
                     early_exit: bool = False,
                     skip: Optional[torch.Tensor] = None):
    """``hybrid_spmv`` with the bottom-up scan kernel on the sparse stage,
    for the min semirings.  The remainder's CSR rows are exactly the scan's
    input.  Returns ``(y, scanned)``: ``y`` equals ``hybrid_spmv``'s (a min
    is exact), ``scanned [Q]`` sums the per-row early-exit work model (the
    slots a sequential bottom-up scan examines).  ``skip [Q, n]`` marks
    rows whose value is already final under the uniform-frontier licence;
    they charge no scanned slots.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    y, scanned = bottomup_scan_op(
        row_ptr, col, val if semiring == MIN_PLUS else None, x,
        semiring=semiring, early_exit=early_exit, skip=skip)
    if k_dense:
        y[:, :k_dense] = torch.minimum(
            y[:, :k_dense], dense_spmv_minplus_op(x[:, :k_dense], dense))
    cnt = scanned.sum(1, dtype=torch.int64)
    return (y[0], cnt[0]) if squeeze else (y, cnt)


def hybrid_pagerank(hg: HybridGraph, num_iterations: int = 20,
                    damping: float = 0.85,
                    device: DeviceLike = None) -> np.ndarray:
    """PageRank through the two-engine step on ``device`` (``cuda`` unless
    named).  Returns ranks in the original vertex id order."""
    if hg.semiring != PLUS_TIMES:
        raise ValueError("hybrid_pagerank needs a plus_times split")
    dev = resolve_device(device)
    n = hg.num_vertices

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    dense = put(hg.dense_block, torch.float32)
    row_ptr = put(hg.ell_row_ptr, torch.int32)
    col = put(hg.ell_col, torch.int32)
    val = put(hg.ell_val, torch.float32)
    inv_deg = put(np.where(hg.out_deg > 0,
                           1.0 / np.maximum(hg.out_deg, 1.0), 0.0),
                  torch.float32)
    delta = (1.0 - damping) / n
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(num_iterations):
        y = hybrid_spmv(dense, row_ptr, col, val, rank * inv_deg,
                        semiring=PLUS_TIMES, k_dense=hg.k_dense)
        rank = delta + damping * y
    out = rank.cpu().numpy()
    result = np.empty_like(out)
    result[hg.perm] = out          # back to original id order
    return result
