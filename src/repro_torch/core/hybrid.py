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

The sharded engine runs one such split per shard over the shard's
intra-partition edges (``shard_degree_split``, ``ShardHybridData``) and
routes every boundary edge through the outbox slots instead
(``kernels/outbox_reduce.py``).

A port of ``repro.core.hybrid``.  The JAX package keeps the remainder as an
ELL block ``[V, kmax]`` padded to the widest row; on a scale-free graph
that row is a hub's in-degree (about 50k at RMAT20, where the block would
need hundreds of GB), so here the remainder is CSR rows
(``ell_row_ptr``/``ell_col``/``ell_val``) in the same slot order: padded to
``kmax`` with the sentinel ``V`` they equal the JAX block.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import perf_model
from repro_torch.core.graph import CSRGraph
from repro_torch.core.partition import (EdgeArrays, _round_up,
                                        boundary_edges, build_block_metadata)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ell_spmv import EllPlan, row_plan
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
           "ShardHybridData", "shard_plan_inputs", "shard_degree_split",
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
    ell_plan: EllPlan            # the sparse kernel's row plan of ell_row_ptr
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
    plan: EllPlan           # the sparse kernel's row plan of row_ptr


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
                       kmax=max(int(deg.max(initial=0)), 1),
                       plan=row_plan(row_ptr))


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
        semiring=semiring, ell_plan=layout.plan)


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


# ---------------------------------------------------------------------------
# Per-shard degree split of the sharded hybrid engine (paper §4.3, §6)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardHybridData:
    """One direction's per-shard degree split and outbox maps, stacked on a
    leading shard axis ``S``; each rank of the sharded engine puts its own
    row on its device.

    Shard ``s`` owns ``parts_per_shard`` consecutive partitions and runs the
    two-engine step over its *intra-partition* edges in a shard-local
    degree-ranked id space (``slot``/``hid`` translate to and from the
    engine's ``[pl, v_max]`` layout).  Every inter-partition edge goes
    through the outbox-slot space of ``partition.py`` instead: boundary
    messages are reduced into slots at the source (§3.4) and only the used
    slots of each (shard, peer shard) pair cross the wire.  ``send_idx``/
    ``recv_ids`` are the gather and scatter maps of that compact exchange,
    ``loc_idx``/``loc_ids`` the same-shard pairs that never reach it;
    ``recv_src``/``loc_src`` name each value's source partition, so the
    inbox scatter can run one pass per source partition in a fixed order.
    Shapes are uniform over shards (padded to the largest); pad slots read
    and write identity sinks.

    The JAX package's fields keep its names and values, with two changes.
    The remainder is CSR rows (``ell_row_ptr`` per shard, ``ell_col``/
    ``ell_val`` one array per shard), which padded to ``kmax`` with the
    sentinel ``n_max`` equal the JAX ``[S, n_max, kmax]`` block.  The
    boundary edges are flat slot ids (``b_flat``, what the outbox kernel
    reads: ``boundary(s)``), not the JAX package's per-block
    ``b_base``/``b_local``/``b_mask`` metadata, which its Pallas kernel
    needs and this port does not.
    """

    semiring: str
    num_shards: int
    parts_per_shard: int      # pl
    v_max: int
    num_parts: int            # P
    o_max: int
    k_dense: int              # largest shard |H|
    n_max: int                # padded per-shard hybrid vertex count
    num_slots: int            # pl * P * o_max flat outbox space per shard
    # --- per shard [S, ...] ---
    n_vert: np.ndarray        # [S] hybrid vertices of each shard
    dense: np.ndarray         # [S, K, K] ⊗ values (⊕-identity off-edge)
    ell_row_ptr: np.ndarray   # [S, n_max + 1] int32 remainder rows
    ell_col: List[np.ndarray]  # per shard [nnz_s] int32 source hybrid ids
    ell_val: List[np.ndarray]  # per shard [nnz_s] f32 ⊗ values
    kmax: int                 # widest remainder row over the shards (>= 1)
    slot: np.ndarray          # [S, n_max] hybrid id -> p_local*v_max + local
    hid: np.ndarray           # [S, pl, v_max] slot -> hybrid id (pad n_max)
    # --- boundary edges, sorted by flat outbox slot id ---
    b_src: np.ndarray         # [S, be_max] hybrid source id (pad -> n_max)
    b_weight: Optional[np.ndarray]   # [S, be_max] f32 or None
    b_flat: np.ndarray        # [S, be_max] flat slot id (pad -> num_slots)
    b_count: np.ndarray       # [S] real boundary edges (each row's prefix)
    # --- compact exchange maps ---
    send_idx: np.ndarray      # [S, S, w] flat outbox index (pad -> num_slots)
    recv_ids: np.ndarray      # [S, S, w] local scatter segment id
    recv_src: np.ndarray      # [S, S, w] source partition (pad -> -1)
    loc_idx: np.ndarray       # [S, L] same-shard flat outbox indices
    loc_ids: np.ndarray       # [S, L] same-shard scatter segment ids
    loc_src: np.ndarray       # [S, L] source partition (pad -> -1)
    wire_width: int           # w: packed slots per (shard, peer) pair
    has_boundary: bool
    has_remote: bool
    # --- push direction (min combines; None without the switch) ---
    push_src: Optional[np.ndarray]   # [S, ei_pad] hybrid ids (pad -> n_max)
    push_dst: Optional[np.ndarray]   # [S, ei_pad]
    push_w: Optional[np.ndarray]     # [S, ei_pad] (min_plus) or None
    n_intra: Optional[np.ndarray]    # [S] real push edges (row prefix)
    # --- the sparse kernel's row plan of each shard's ell_row_ptr ---
    ell_plan: List[EllPlan]

    def boundary(self, s: int):
        """Shard ``s``'s real boundary edges as the outbox kernel takes
        them: ``(hybrid src, flat slot id, weight or None)``, flat ids
        non-decreasing."""
        c = int(self.b_count[s])
        w = self.b_weight[s, :c] if self.b_weight is not None else None
        return self.b_src[s, :c], self.b_flat[s, :c], w


def _shard_intra(pg, num_shards: int, g: CSRGraph):
    """Per-shard intra-partition edges and degree-descending rankings.

    Ranks each shard's vertices by (in + out) degree over the intra edges
    only (the edges its two-engine step runs); the ranking is direction
    symmetric.  Returns per shard: (ranked global ids, global -> hybrid
    inverse, intra src, intra dst, intra weights or None).
    """
    asg = pg.assignment
    pl = pg.num_parts // num_shards
    src_g, dst_g = g.edge_sources(), g.col
    sp = asg.part_of[src_g]
    intra = sp == asg.part_of[dst_g]
    shard_of_edge = sp // pl
    n = pg.num_vertices
    deg = (np.bincount(src_g[intra], minlength=n)
           + np.bincount(dst_g[intra], minlength=n)).astype(np.int64)
    out = []
    for s in range(num_shards):
        verts = np.concatenate(
            [asg.l2g[p] for p in range(s * pl, (s + 1) * pl)])
        order = verts[np.argsort(-deg[verts], kind="stable")]
        inv = np.full(n, -1, dtype=np.int64)
        inv[order] = np.arange(len(order))
        em = intra & (shard_of_edge == s)
        w = g.weights[em] if g.weights is not None else None
        out.append((order, inv, src_g[em], dst_g[em], w))
    return out


def shard_plan_inputs(pg, num_shards: int, layouts=None):
    """Inputs of ``perf_model.plan_shards`` (Eq. 1 per shard):
    ``(ranks, edges, slots, nverts)`` per shard: the intra edges'
    ``max(rank(src), rank(dst))``, their count, the outbox slots the shard
    ships to *other* shards per superstep, and its vertex count.
    ``layouts`` reuses a forward ``_shard_intra`` result."""
    pl = pg.num_parts // num_shards
    om = pg.fwd.outbox_mask
    if layouts is None:
        layouts = _shard_intra(pg, num_shards, pg.source)
    ranks, edges, slots, nverts = [], [], [], []
    for s, (order, inv, es, ed, _) in enumerate(layouts):
        ranks.append(np.maximum(inv[es], inv[ed]))
        edges.append(len(es))
        rows = om[s * pl:(s + 1) * pl]
        slots.append(float(rows.sum() - rows[:, s * pl:(s + 1) * pl].sum()))
        nverts.append(len(order))
    return ranks, edges, slots, nverts


def _boundary_arrays(ea: EdgeArrays, asg, shard: int, pl: int, v_max: int,
                     inv: np.ndarray):
    """One shard's boundary edges as (hybrid src, flat slot id, weight),
    sorted by flat slot id (the edges are sorted by ``dst_ext`` and the
    flat id is p_local-major)."""
    P, o_max = ea.outbox_dst.shape[0], ea.o_max
    srcs, flats, ws = [], [], []
    for p_local in range(pl):
        p = shard * pl + p_local
        src, flat, w = boundary_edges(ea, p, v_max)
        srcs.append(inv[asg.l2g[p][src]])
        flats.append(p_local * (P * o_max) + flat)
        if w is not None:
            ws.append(w)
    return (np.concatenate(srcs), np.concatenate(flats),
            np.concatenate(ws) if ea.weight is not None else None)


def shard_degree_split(pg, num_shards: int, semiring: str,
                       per_shard_k: Sequence[int], *,
                       use_reverse: bool = False, use_weights: bool = True,
                       direction_switch: bool = False, layouts=None,
                       align: int = 8) -> ShardHybridData:
    """Build one direction's :class:`ShardHybridData` (numpy).

    ``per_shard_k`` is each shard's |H| (``perf_model.plan_shards``): shard
    ``s`` moves only its own top-``k_s`` edges to the dense block.  The
    JAX package pads every dense block to the largest |H| for its SPMD
    step; ``dense`` keeps that shape, and a rank needs only its
    ``[:k_s, :k_s]`` corner.  ``use_weights=False`` packs the semiring's
    defaults (multiplicity counts, zero-cost hops) even on a weighted graph.
    ``direction_switch`` adds the push edges of the min combines' vote.
    ``layouts`` reuses ``_shard_intra`` of this direction's graph.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if pg.source is None:
        raise ValueError("per-shard split needs PartitionedGraph.source")
    ea = pg.rev if use_reverse else pg.fwd
    if ea is None:
        raise ValueError(
            "the sharded hybrid needs reverse edge and outbox arrays for "
            "use_reverse programs; partition with include_reverse=True")
    asg = pg.assignment
    S, pl = num_shards, pg.num_parts // num_shards
    P, v_max, o_max = pg.num_parts, pg.v_max, ea.o_max
    ident = add_identity(semiring)
    if layouts is None:
        layouts = _shard_intra(
            pg, S, pg.source.reverse() if use_reverse else pg.source)

    k_list = [int(k) for k in per_shard_k]
    K = max(k_list) if k_list else 0
    n_max = max(_round_up(max(len(o) for o, *_ in layouts), align), align, K)
    n_vert = np.array([len(o) for o, *_ in layouts], dtype=np.int32)
    dense = np.full((S, K, K), ident, dtype=np.float32)
    slot = np.zeros((S, n_max), dtype=np.int32)
    hid = np.full((S, pl, v_max), n_max, dtype=np.int32)
    row_ptr = np.zeros((S, n_max + 1), dtype=np.int32)
    ell_col, ell_val = [], []
    push = ([], [], []) if direction_switch else None

    for s, (order, inv, es, ed, ws) in enumerate(layouts):
        n_s, k_s = len(order), k_list[s]
        slot[s, :n_s] = ((asg.part_of[order] - s * pl) * v_max
                         + asg.local_id[order]).astype(np.int32)
        for p_local in range(pl):
            l2g = asg.l2g[s * pl + p_local]
            hid[s, p_local, : len(l2g)] = inv[l2g]
        # per-semiring ⊗ values (degree_split's policy)
        hs, hd = inv[es], inv[ed]
        if not use_weights:
            ws = None
        if semiring == PLUS_TIMES:
            w = ws if ws is not None else np.ones(len(es), dtype=np.float32)
        elif semiring == MIN_PLUS:
            w = ws if ws is not None else np.zeros(len(es), dtype=np.float32)
        else:
            w = np.zeros(len(es), dtype=np.float32)
        w = np.asarray(w, dtype=np.float32)
        in_h = (hs < k_s) & (hd < k_s)
        if k_s:
            if semiring == PLUS_TIMES:
                np.add.at(dense[s], (hs[in_h], hd[in_h]), w[in_h])
            else:
                np.minimum.at(dense[s], (hs[in_h], hd[in_h]), w[in_h])
        # remainder rows: destination, then source id, ties in edge order
        # (the JAX from_edge_list sort and csr_to_ell's stable transpose)
        rest = np.flatnonzero(~in_h)
        rest = rest[np.lexsort((hs[rest], hd[rest]))]
        if len(rest) >= 2 ** 31:
            raise ValueError(f"{len(rest)} remainder edges overflow int32")
        np.cumsum(np.bincount(hd[rest], minlength=n_max), out=row_ptr[s, 1:])
        ell_col.append(hs[rest].astype(np.int32))
        ell_val.append(w[rest])
        if push is not None:
            push[0].append(hs.astype(np.int32))
            push[1].append(hd.astype(np.int32))
            push[2].append(w)
    kmax = max(int(np.diff(row_ptr, axis=1).max(initial=0)), 1)

    # ---- boundary edges -> outbox-slot segment space ----------------------
    num_slots = pl * P * o_max
    bnd = [_boundary_arrays(ea, asg, s, pl, v_max, layouts[s][1])
           for s in range(S)]
    be_req = max(len(b[0]) for b in bnd)
    be_max = max(_round_up(be_req, align), align)
    b_src = np.full((S, be_max), n_max, dtype=np.int32)
    b_flat = np.full((S, be_max), num_slots, dtype=np.int32)
    b_weight = (np.zeros((S, be_max), dtype=np.float32)
                if ea.weight is not None else None)
    counts = np.zeros(S, dtype=np.int64)
    for s, (bs, bf, bw) in enumerate(bnd):
        k = len(bs)
        b_src[s, :k] = bs
        b_flat[s, :k] = bf
        if b_weight is not None and k:
            b_weight[s, :k] = bw
        counts[s] = k

    # ---- compact exchange maps --------------------------------------------
    pair_counts = np.zeros((S, S), dtype=np.int64)
    for u in range(S):
        for t in range(S):
            if t != u:
                pair_counts[u, t] = int(ea.outbox_mask[
                    u * pl:(u + 1) * pl, t * pl:(t + 1) * pl].sum())
    w_req = int(pair_counts.max()) if S > 1 else 0
    w_pad = max(_round_up(w_req, align), align)
    seg_sink = pl * (v_max + 1)
    send_idx = np.full((S, S, w_pad), num_slots, dtype=np.int32)
    recv_ids = np.full((S, S, w_pad), seg_sink, dtype=np.int32)
    recv_src = np.full((S, S, w_pad), -1, dtype=np.int32)
    loc_lists = [([], [], []) for _ in range(S)]
    for u in range(S):
        for t in range(S):
            j = 0
            for p_local in range(pl):
                p = u * pl + p_local
                for q in range(t * pl, (t + 1) * pl):
                    k = int(ea.outbox_mask[p, q].sum())
                    if k == 0:
                        continue
                    idx = p_local * (P * o_max) + q * o_max + np.arange(k)
                    ids = ((q - t * pl) * (v_max + 1)
                           + ea.outbox_dst[p, q, :k])
                    if t == u:
                        loc_lists[u][0].append(idx)
                        loc_lists[u][1].append(ids)
                        loc_lists[u][2].append(np.full(k, p))
                    else:
                        send_idx[u, t, j: j + k] = idx
                        recv_ids[t, u, j: j + k] = ids
                        recv_src[t, u, j: j + k] = p
                        j += k
    l_req = max(sum(len(a) for a in ls[0]) for ls in loc_lists)
    l_pad = max(_round_up(l_req, align), align)
    loc_idx = np.full((S, l_pad), num_slots, dtype=np.int32)
    loc_ids = np.full((S, l_pad), seg_sink, dtype=np.int32)
    loc_src = np.full((S, l_pad), -1, dtype=np.int32)
    for s, lists in enumerate(loc_lists):
        for arr, out in zip(lists, (loc_idx, loc_ids, loc_src)):
            if arr:
                cat = np.concatenate(arr)
                out[s, : len(cat)] = cat

    push_src = push_dst = push_w = n_intra = None
    if push is not None:
        n_intra = np.array([len(a) for a in push[0]], dtype=np.int64)
        ei_max = max(_round_up(int(n_intra.max()), align), align)
        push_src = np.full((S, ei_max), n_max, dtype=np.int32)
        push_dst = np.full((S, ei_max), n_max, dtype=np.int32)
        for s in range(S):
            push_src[s, : n_intra[s]] = push[0][s]
            push_dst[s, : n_intra[s]] = push[1][s]
        if (semiring == MIN_PLUS and use_weights
                and pg.source.weights is not None):
            push_w = np.zeros((S, ei_max), dtype=np.float32)
            for s in range(S):
                push_w[s, : n_intra[s]] = push[2][s]

    return ShardHybridData(
        semiring=semiring, num_shards=S, parts_per_shard=pl, v_max=v_max,
        num_parts=P, o_max=o_max, k_dense=K, n_max=n_max,
        num_slots=num_slots, n_vert=n_vert, dense=dense,
        ell_row_ptr=row_ptr, ell_col=ell_col, ell_val=ell_val, kmax=kmax,
        slot=slot, hid=hid, b_src=b_src, b_weight=b_weight, b_flat=b_flat,
        b_count=counts,
        send_idx=send_idx, recv_ids=recv_ids, recv_src=recv_src,
        loc_idx=loc_idx, loc_ids=loc_ids, loc_src=loc_src,
        wire_width=w_pad, has_boundary=be_req > 0, has_remote=w_req > 0,
        push_src=push_src, push_dst=push_dst, push_w=push_w,
        n_intra=n_intra, ell_plan=[row_plan(rp) for rp in row_ptr])


class SplitCache:
    """The host work of the degree split over one partitioned graph, done
    once: the degree ranking, the planner's decisions, each direction's
    layout and each semiring's split, and the same per shard for the
    sharded engine.  Hybrid engines over the same graph
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

    # --- the sharded engine's per-shard splits -----------------------------

    def shard_intra(self, num_shards: int, reverse: bool):
        """``_shard_intra`` of one direction over ``num_shards`` shards."""
        return self._once(("shard_intra", num_shards, reverse),
                          lambda: _shard_intra(self.pg, num_shards,
                                               self.graph(reverse)))

    def shard_plan(self, num_shards: int, k_dense: Optional[int],
                   block_e: int) -> dict:
        """``perf_model.plan_shards`` over the forward intra edges, each
        shard with the candidates of its vertex count and the skew signal;
        each record also carries its ``mode``, the plan ``skew``,
        ``num_shards`` and ``candidates``."""
        def build():
            ranks, edges, slots, nverts = shard_plan_inputs(
                self.pg, num_shards, layouts=self.shard_intra(num_shards,
                                                              False))
            skew = self.skew(block_e)
            candidates = [perf_model.k_dense_candidates(n, skewed=skew > 0.0)
                          for n in nverts]
            plan = perf_model.plan_shards(ranks, edges, slots, candidates,
                                          k_dense=k_dense)
            for rec, n in zip(plan["per_shard"], nverts):
                rec["mode"] = perf_model.split_mode(rec["k_dense"], n,
                                                    rec["e_sparse"])
            plan.update(skew=skew, num_shards=num_shards,
                        candidates=candidates)
            return plan
        return self._once(("shard_plan", num_shards, k_dense, block_e), build)

    def shard_split(self, num_shards: int, per_shard_k: Sequence[int],
                    reverse: bool, semiring: str, weighted: bool,
                    direction_switch: bool) -> ShardHybridData:
        """``shard_degree_split`` of one direction and semiring."""
        ks = tuple(int(k) for k in per_shard_k)
        return self._once(
            ("shard_split", num_shards, ks, reverse, semiring, weighted,
             direction_switch),
            lambda: shard_degree_split(
                self.pg, num_shards, semiring, ks, use_reverse=reverse,
                use_weights=weighted, direction_switch=direction_switch,
                layouts=self.shard_intra(num_shards, reverse)))


def splits_of(pg) -> SplitCache:
    """The ``SplitCache`` of a ``PartitionedGraph``, made at the first
    call and kept on the graph."""
    if pg.hybrid_splits is None:
        pg.hybrid_splits = SplitCache(pg)
    return pg.hybrid_splits


def hybrid_spmv(dense: torch.Tensor, row_ptr: torch.Tensor,
                col: torch.Tensor, val: Optional[torch.Tensor],
                x: torch.Tensor, *, semiring: str, k_dense: int,
                plan: Optional[EllPlan] = None) -> torch.Tensor:
    """One two-engine step: ``y[v] = ⊕`` over in-edges ``x[u] ⊗ w``.

    ``x`` is the per-source value vector ``[n]`` in the degree-ranked id
    space, or a ``[Q, n]`` query batch (the batch rides the dense product's
    M axis and the sparse kernel's query loop); returns the same shape.
    ``plan`` is the split's row plan of ``row_ptr`` on ``x``'s device (the
    sparse kernel's blocks; built per call when None).  The sparse stage
    runs first, then ``y[:, :k] ⊕= dense``, the JAX package's stage order.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    y = ell_spmv_op(row_ptr, col, val, x, semiring=semiring, plan=plan)
    dense_stage(y, x, dense, semiring=semiring, k_dense=k_dense)
    return y[0] if squeeze else y


def dense_stage(y: torch.Tensor, x: torch.Tensor, dense: torch.Tensor, *,
                semiring: str, k_dense: int) -> torch.Tensor:
    """The dense stage of :func:`hybrid_spmv`, in place on the sparse
    stage's ``y [Q, n]``: ``y[:, :k] ⊕= x[:, :k] ⊗ dense``.  The tiered
    engine runs it after its streamed sparse stage, so both paths share
    the stage order."""
    if k_dense:
        xd = x[:, :k_dense]
        if semiring == PLUS_TIMES:
            y[:, :k_dense] += dense_spmv_op(xd, dense)
        else:
            y[:, :k_dense] = torch.minimum(y[:, :k_dense],
                                           dense_spmv_minplus_op(xd, dense))
    return y


def hybrid_spmv_scan(dense: torch.Tensor, row_ptr: torch.Tensor,
                     col: torch.Tensor, val: Optional[torch.Tensor],
                     x: torch.Tensor, *, semiring: str, k_dense: int,
                     plan: Optional[EllPlan] = None, early_exit: bool = False,
                     skip: Optional[torch.Tensor] = None):
    """``hybrid_spmv`` with the bottom-up scan kernel on the sparse stage,
    for the min semirings.  The remainder's CSR rows are exactly the scan's
    input, and ``plan`` their row plan, as for ``hybrid_spmv``.  Returns
    ``(y, scanned)``: ``y`` equals ``hybrid_spmv``'s (a min is exact),
    ``scanned [Q]`` sums the per-row early-exit work model (the slots a
    sequential bottom-up scan examines).  ``skip [Q, n]`` marks rows whose
    value is already final under the uniform-frontier licence; they charge
    no scanned slots.
    """
    squeeze = x.dim() == 1
    if squeeze:
        x = x[None]
    y, scanned = bottomup_scan_op(
        row_ptr, col, val if semiring == MIN_PLUS else None, x,
        semiring=semiring, early_exit=early_exit, skip=skip, plan=plan)
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
    plan = hg.ell_plan.to(dev)
    inv_deg = put(np.where(hg.out_deg > 0,
                           1.0 / np.maximum(hg.out_deg, 1.0), 0.0),
                  torch.float32)
    delta = (1.0 - damping) / n
    rank = torch.full((n,), 1.0 / n, dtype=torch.float32, device=dev)
    for _ in range(num_iterations):
        y = hybrid_spmv(dense, row_ptr, col, val, rank * inv_deg,
                        semiring=PLUS_TIMES, k_dense=hg.k_dense, plan=plan)
        rank = delta + damping * y
    out = rank.cpu().numpy()
    result = np.empty_like(out)
    result[hg.perm] = out          # back to original id order
    return result
