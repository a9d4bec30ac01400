"""Graph partitioning for hybrid/multi-shard processing (paper §4.3, §6).

Implements the paper's partition data layout in a fixed-shape form:

- Each vertex is assigned to exactly one partition; vertex ids are re-labelled
  into a per-partition local space (paper Fig. 6).
- Per-partition CSR edges are flattened to edge-parallel ``(src_local,
  dst_ext)`` pairs.  ``dst_ext`` is an *extended* destination index: local
  destinations map to ``[0, v_max)``; boundary (remote) destinations map to an
  **outbox slot** ``v_max + 1 + peer * o_max + slot`` — exactly the paper's
  trick of storing the outbox index in the edge array (§4.3.1).
- The outbox has one slot per *unique* (source-partition, remote-vertex) pair:
  source-side message reduction (§3.4) therefore happens for free inside a
  single ``segment_min`` / ``segment_sum`` over ``dst_ext``.
- Outboxes/inboxes are symmetric (paper Fig. 6): ``inbox_dst[p, q, s]`` is the
  local id on ``p`` of the vertex that receives ``outbox[q, p, s]``.

Partitioning strategies (paper §6): RAND, HIGH (high-degree vertices to
partition 0 — the "CPU" / dense-path analogue), LOW (low-degree to partition
0).  The strategy is O(|V| log |V|) via sorting, matching the paper's cost
analysis (§6.2).

All of this is numpy preprocessing; the engine moves the returned arrays to
the device.  A copy of ``repro.core.partition`` (its static part), so the
port imports no JAX: the same seed gives array-equal layouts.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.graph import CSRGraph
from repro_torch.runtime import tracing

RAND = "rand"
HIGH = "high"
LOW = "low"
STRATEGIES = (RAND, HIGH, LOW)

# Bin edges for BlockMetadata.span_histogram / degree_skew (one shared tuple
# so the skew signal can't drift from the histogram buckets).
SPAN_HIST_BINS = (1, 129, 513, 1025, 2049, 4097, 1 << 30)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class VertexAssignment:
    """Vertex → (partition, local id) mapping plus the inverse."""

    num_parts: int
    part_of: np.ndarray     # [n] int32, partition of each global vertex
    local_id: np.ndarray    # [n] int32, local id of each global vertex
    l2g: List[np.ndarray]   # per-partition local → global

    @property
    def part_sizes(self) -> np.ndarray:
        return np.array([len(x) for x in self.l2g])


@dataclasses.dataclass
class EdgeArrays:
    """Fixed-shape per-partition edge-parallel arrays (stacked on axis 0)."""

    src: np.ndarray         # [P, e_max] int32 local source vertex
    dst_ext: np.ndarray     # [P, e_max] int32 extended destination index
    weight: Optional[np.ndarray]  # [P, e_max] float32 or None
    edge_mask: np.ndarray   # [P, e_max] bool (False for padding)
    outbox_dst: np.ndarray  # [P, P, o_max] int32 local id on the *peer*
    outbox_mask: np.ndarray  # [P, P, o_max] bool
    inbox_dst: np.ndarray   # [P, P, o_max] = outbox_dst.transpose(1, 0, 2)
    num_edges: np.ndarray   # [P] true edge counts
    # Original edge index of each slot (-1 padding): the dynamic layer's
    # tombstone locator (``core/dynamic.py``).
    edge_id: Optional[np.ndarray] = None  # [P, e_max] int64

    @property
    def e_max(self) -> int:
        return self.src.shape[1]

    @property
    def o_max(self) -> int:
        return self.outbox_dst.shape[2]


@dataclasses.dataclass
class PartitionedGraph:
    """A partitioned graph ready for the BSP engine."""

    num_parts: int
    num_vertices: int
    num_edges: int
    v_max: int                       # padded vertices per partition
    assignment: VertexAssignment
    fwd: EdgeArrays                  # out-edges (push direction)
    rev: Optional[EdgeArrays]        # in-edges (pull / BC backward)
    out_deg: np.ndarray              # [P, v_max] float32 true global out-degree
    vertex_mask: np.ndarray          # [P, v_max] bool
    # --- partition quality statistics (paper Fig. 4) ---
    alpha: np.ndarray                # [P] share of edges per partition
    beta_no_reduction: float         # boundary edges / |E|
    beta_with_reduction: float       # outbox slots / |E|  (paper §3.4)
    # The un-partitioned graph, kept for backends that re-derive their own
    # layout from it (the hybrid degree-split engine).  None for
    # PartitionedGraphs built before this field existed.
    source: Optional[CSRGraph] = None
    # The hybrid backend's host work over this graph (core/hybrid.py::
    # SplitCache), made by the first hybrid engine and shared by the rest.
    hybrid_splits: Optional[object] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    # flat_index's tensors, one per device
    _flat_index: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def seg_count(self) -> int:
        """Extended segment space: v_max locals + 1 sink + P*o_max outbox."""
        return self.v_max + 1 + self.num_parts * self.fwd.o_max

    def flat_index(self, device) -> "torch.Tensor":
        """Each global vertex's position in a flattened ``[P * v_max]``
        state (``part_of * v_max + local_id``), an int64 tensor on
        ``device``, made once per device and kept."""
        import torch

        key = str(device)
        if key not in self._flat_index:
            asg = self.assignment
            self._flat_index[key] = torch.as_tensor(
                asg.part_of.astype(np.int64) * self.v_max + asg.local_id,
                device=device)
        return self._flat_index[key]

    def gather_global(self, per_part: np.ndarray) -> np.ndarray:
        """Collect a [P, v_max] per-partition state into global [n] order."""
        out = np.empty(self.num_vertices, dtype=per_part.dtype)
        for p, l2g in enumerate(self.assignment.l2g):
            out[l2g] = per_part[p, : len(l2g)]
        return out

    def scatter_global(self, global_vals: np.ndarray,
                       fill) -> np.ndarray:
        """Distribute a global [n] array into [P, v_max] partition layout."""
        out = np.full((self.num_parts, self.v_max), fill,
                      dtype=np.asarray(global_vals).dtype)
        for p, l2g in enumerate(self.assignment.l2g):
            out[p, : len(l2g)] = global_vals[l2g]
        return out

    def scatter_dirty(self, dirty_global: np.ndarray) -> np.ndarray:
        """Global [n] dirty-vertex mask (``DynamicGraph.dirty_since``) into
        [P, v_max] layout — the warm-start seed of
        ``BSPEngine.execute(incremental=)``."""
        return self.scatter_global(np.asarray(dirty_global, dtype=bool),
                                   False)


def assign_vertices(g: CSRGraph, num_parts: int, strategy: str = RAND,
                    cpu_edge_fraction: Optional[float] = None,
                    seed: int = 0) -> VertexAssignment:
    """Assign vertices to partitions (paper §6.2/§6.3.1).

    ``cpu_edge_fraction`` is the paper's α: the share of *edges* kept on
    partition 0 (the bottleneck / "CPU" partition).  The remaining edges are
    split evenly (by edge count) across partitions ``1..P-1``.  When ``None``,
    edges are split evenly across all partitions.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    n = g.num_vertices
    deg = g.out_degrees()
    rng = np.random.default_rng(seed)
    if strategy == RAND:
        order = rng.permutation(n)
    elif strategy == HIGH:
        # High-degree first → partition 0 (stable to keep determinism).
        order = np.argsort(-deg, kind="stable")
    else:  # LOW
        order = np.argsort(deg, kind="stable")

    cum = np.cumsum(deg[order])
    total = int(cum[-1]) if len(cum) else 0
    if cpu_edge_fraction is None:
        targets = [total * (p + 1) / num_parts for p in range(num_parts - 1)]
    else:
        rest = (1.0 - cpu_edge_fraction) / max(num_parts - 1, 1)
        fracs = [cpu_edge_fraction] + [rest] * (num_parts - 1)
        targets = list(np.cumsum(fracs)[:-1] * total)
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [n]]).astype(np.int64)

    part_of = np.empty(n, dtype=np.int32)
    local_id = np.empty(n, dtype=np.int32)
    l2g = []
    for p in range(num_parts):
        verts = order[bounds[p]: bounds[p + 1]]
        part_of[verts] = p
        local_id[verts] = np.arange(len(verts), dtype=np.int32)
        l2g.append(np.asarray(verts, dtype=np.int64))
    return VertexAssignment(num_parts, part_of, local_id, l2g)


def boundary_edges(ea: EdgeArrays, p: int, v_max: int):
    """One partition's boundary edges as (local src, flat outbox slot,
    weight-or-None), in ``dst_ext`` order (so flat slot ids ascend).

    The flat slot id is ``q * o_max + slot``, the edge's position in the
    partition's ``[P, o_max]`` outbox, recovered from the extended
    destination index the edge arrays already carry (§4.3.1).  The sharded
    hybrid engine reduces boundary messages into exactly this segment space
    before the exchange (§3.4 source-side aggregation).
    """
    em = ea.edge_mask[p] & (ea.dst_ext[p] > v_max)
    src = ea.src[p][em]
    flat = ea.dst_ext[p][em] - (v_max + 1)
    w = ea.weight[p][em] if ea.weight is not None else None
    return src, flat, w


def slice_parts(ea: EdgeArrays, lo: int, hi: int) -> EdgeArrays:
    """The rows of partitions ``[lo, hi)``: what one shard of the sharded
    engine holds.  Ids keep their global meaning (``dst_ext`` still spans
    every peer's outbox)."""
    def cut(x):
        return None if x is None else x[lo:hi]

    return EdgeArrays(src=ea.src[lo:hi], dst_ext=ea.dst_ext[lo:hi],
                      weight=cut(ea.weight), edge_mask=ea.edge_mask[lo:hi],
                      outbox_dst=ea.outbox_dst[lo:hi],
                      outbox_mask=ea.outbox_mask[lo:hi],
                      inbox_dst=ea.inbox_dst[lo:hi],
                      num_edges=ea.num_edges[lo:hi], edge_id=cut(ea.edge_id))


def _build_edge_arrays(g: CSRGraph, asg: VertexAssignment, v_max: int,
                       align: int, spare_outbox: int = 0) -> EdgeArrays:
    """Construct the edge-parallel arrays + outbox maps for one direction.

    ``spare_outbox`` reserves that many unassigned outbox slots per
    (partition, peer) pair — headroom the dynamic layer
    (``core/dynamic.py``) assigns to inserted boundary edges targeting
    previously-unmessaged remote vertices, without changing ``o_max``.
    """
    P = asg.num_parts
    src_g = g.edge_sources()
    dst_g = g.col
    sp = asg.part_of[src_g]       # partition of each edge's source
    dp = asg.part_of[dst_g]       # partition of each edge's destination

    # Unique remote destinations per (src_part, dst_part): the outbox slots.
    remote_sets: List[List[np.ndarray]] = [[None] * P for _ in range(P)]
    o_req = 0
    for p in range(P):
        for q in range(P):
            if p == q:
                remote_sets[p][q] = np.empty(0, dtype=np.int64)
                continue
            m = (sp == p) & (dp == q)
            uniq = np.unique(dst_g[m])
            remote_sets[p][q] = uniq
            o_req = max(o_req, len(uniq))
    o_max = max(_round_up(o_req + spare_outbox, align), align)

    e_req = int(np.bincount(sp, minlength=P).max()) if len(sp) else 0
    e_max = max(_round_up(e_req, align), align)

    src = np.zeros((P, e_max), dtype=np.int32)
    dst_ext = np.full((P, e_max), v_max, dtype=np.int32)  # default → sink
    weight = (np.zeros((P, e_max), dtype=np.float32)
              if g.weights is not None else None)
    edge_mask = np.zeros((P, e_max), dtype=bool)
    edge_id = np.full((P, e_max), -1, dtype=np.int64)
    outbox_dst = np.full((P, P, o_max), v_max, dtype=np.int32)  # pad → sink
    outbox_mask = np.zeros((P, P, o_max), dtype=bool)
    num_edges = np.zeros(P, dtype=np.int64)

    for p in range(P):
        em = sp == p
        e_ids = np.flatnonzero(em)
        e_src = asg.local_id[src_g[em]].astype(np.int32)
        e_dst_g = dst_g[em]
        e_dp = dp[em]
        ext = np.empty(len(e_src), dtype=np.int32)
        local = e_dp == p
        ext[local] = asg.local_id[e_dst_g[local]]
        for q in range(P):
            if q == p:
                continue
            mq = e_dp == q
            if not mq.any() and len(remote_sets[p][q]) == 0:
                continue
            uniq = remote_sets[p][q]          # sorted by *global* id
            # Order slots by the peer's local id (paper §4.3.4(i): inboxes
            # sorted by vertex id for prefetch/cache efficiency on scatter).
            loc = asg.local_id[uniq]
            by_local = np.argsort(loc, kind="stable")
            inv = np.empty_like(by_local)
            inv[by_local] = np.arange(len(by_local))
            # Slot of each remote edge destination within the (p,q) outbox.
            idx = np.searchsorted(uniq, e_dst_g[mq])
            ext[mq] = v_max + 1 + q * o_max + inv[idx].astype(np.int32)
            k = len(uniq)
            outbox_dst[p, q, :k] = loc[by_local]
            outbox_mask[p, q, :k] = True
        # Sort edges by extended destination: local edges first, then boundary
        # — the paper's locality ordering (§4.3.1), and it makes the segment
        # reduction access pattern monotonic.
        order = np.argsort(ext, kind="stable")
        k = len(e_src)
        src[p, :k] = e_src[order]
        dst_ext[p, :k] = ext[order]
        edge_mask[p, :k] = True
        edge_id[p, :k] = e_ids[order]
        if weight is not None:
            weight[p, :k] = g.weights[em][order]
        num_edges[p] = k

    return EdgeArrays(src=src, dst_ext=dst_ext, weight=weight,
                      edge_mask=edge_mask, outbox_dst=outbox_dst,
                      outbox_mask=outbox_mask,
                      inbox_dst=np.ascontiguousarray(
                          outbox_dst.transpose(1, 0, 2)),
                      num_edges=num_edges, edge_id=edge_id)


def partition(g: CSRGraph, num_parts: int, strategy: str = RAND,
              cpu_edge_fraction: Optional[float] = None, seed: int = 0,
              include_reverse: bool = False,
              align: int = 8, spare_outbox: int = 0) -> PartitionedGraph:
    """Partition ``g`` into ``num_parts`` fixed-shape partitions.

    ``spare_outbox`` reserves unassigned outbox slots per peer pair for the
    dynamic layer's in-place edge inserts (``core/dynamic.py``).
    ``partition.blocks`` spans the per-partition degree and mask blocks
    and the boundary counts."""
    with tracing.span("partition.partition"):
        with tracing.span("partition.assign"):
            asg = assign_vertices(g, num_parts, strategy, cpu_edge_fraction,
                                  seed)
        v_max = max(_round_up(int(asg.part_sizes.max()), align), align)

        with tracing.span("partition.edge_arrays"):
            fwd = _build_edge_arrays(g, asg, v_max, align, spare_outbox)
            rev = (_build_edge_arrays(g.reverse(), asg, v_max, align,
                                      spare_outbox)
                   if include_reverse else None)

        with tracing.span("partition.blocks"):
            deg = g.out_degrees().astype(np.float32)
            out_deg = np.zeros((num_parts, v_max), dtype=np.float32)
            vertex_mask = np.zeros((num_parts, v_max), dtype=bool)
            for p, l2g in enumerate(asg.l2g):
                out_deg[p, : len(l2g)] = deg[l2g]
                vertex_mask[p, : len(l2g)] = True

            total_e = max(g.num_edges, 1)
            boundary = int((asg.part_of[g.edge_sources()] !=
                            asg.part_of[g.col]).sum())
            slots = int(fwd.outbox_mask.sum())
        return PartitionedGraph(
            num_parts=num_parts, num_vertices=g.num_vertices,
            num_edges=g.num_edges, v_max=v_max, assignment=asg, fwd=fwd,
            rev=rev,
            out_deg=out_deg, vertex_mask=vertex_mask,
            alpha=fwd.num_edges / total_e,
            beta_no_reduction=boundary / total_e,
            beta_with_reduction=slots / total_e,
            source=g,
        )


# ---------------------------------------------------------------------------
# Fused-superstep block metadata (kernels/fused_superstep.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockMetadata:
    """Static per-edge-block metadata for the fused superstep kernel.

    ``partition`` sorts each partition's edges by extended destination, so a
    block of ``block_e`` consecutive edges touches a contiguous span of
    segment ids.  This precomputes, per 128-aligned block: the base (minimum)
    segment id, each edge's local offset within the block's span, and the
    measured span.  Padding edges (``mask`` False) are assigned the
    preceding real edge's segment id, so ``base + local`` is non-decreasing
    along each partition row; the kernel masks their messages to the
    combine identity.  The Hopper kernel reduces runs of equal ids and has
    no span bound: ``span``/``block_spans`` are kept for parity with the
    JAX layout and as the hybrid planner's degree-skew signal.
    """

    block_e: int
    span: int               # lane-aligned span bound the kernel compiles for
    span_req: int           # measured max over blocks (pre-alignment)
    base: np.ndarray        # [P, nb] int32: first segment id of each block
    local: np.ndarray       # [P, e_pad] int32: segment id − block base
    src: np.ndarray         # [P, e_pad] int32: src, zero-padded
    mask: np.ndarray        # [P, e_pad] int32: 1 for real edges
    weight: Optional[np.ndarray]  # [P, e_pad] f32 or None
    block_spans: np.ndarray  # [P, nb] int32: measured span of each block

    @property
    def num_blocks(self) -> int:
        return self.base.shape[1]

    @property
    def e_pad(self) -> int:
        return self.src.shape[1]

    def span_histogram(self, bins: Sequence[int] = SPAN_HIST_BINS
                       ) -> np.ndarray:
        """Per-partition histogram of block spans ``[P, len(bins) - 1]``."""
        edges = np.asarray(bins)
        return np.stack([np.histogram(row, bins=edges)[0]
                         for row in self.block_spans])

    def degree_skew(self, min_span: int = 513) -> float:
        """Fraction of span-histogram mass at spans >= ``min_span``.

        The hybrid planner's skew signal: blocks whose destinations span a
        wide segment range come from high-degree vertices concentrating many
        distinct neighbours, the graphs where a top-K dense split pays.
        ``min_span`` must be one of ``SPAN_HIST_BINS``.
        """
        if min_span not in SPAN_HIST_BINS:
            raise ValueError(f"min_span must be a bin edge, got {min_span}")
        hist = self.span_histogram(SPAN_HIST_BINS)
        total = max(int(hist.sum()), 1)
        return float(hist[:, SPAN_HIST_BINS.index(min_span):].sum()) / total


def build_block_metadata(ea: EdgeArrays, *, block_e: int = 1024,
                         lane: int = 128) -> BlockMetadata:
    """Preprocess one direction's edge arrays for the fused kernel.

    Numpy-only (runs once at partition time); the engine moves the returned
    arrays to the device alongside ``src``/``dst_ext``.
    """
    if block_e % lane:
        raise ValueError(f"block_e ({block_e}) must be a multiple of {lane}")
    P, e_max = ea.src.shape
    e_pad = max(_round_up(e_max, block_e), block_e)

    # Fill padding slots with the last real segment id (rows are sorted by
    # dst_ext, so a forward max-accumulate over masked ids is a fill-forward);
    # an empty partition collapses to segment 0.
    masked = np.where(ea.edge_mask, ea.dst_ext, -1)
    filled = np.maximum.accumulate(masked, axis=1)
    filled = np.maximum(filled, 0)
    filled = np.pad(filled, ((0, 0), (0, e_pad - e_max)), mode="edge")

    nb = e_pad // block_e
    blocks = filled.reshape(P, nb, block_e)
    base = blocks[:, :, 0].astype(np.int32)
    block_spans = (blocks.max(axis=2) - base + 1).astype(np.int32)
    span_req = int(block_spans.max()) if block_spans.size else 1
    span = max(_round_up(span_req, lane), lane)
    local = (blocks - base[:, :, None]).reshape(P, e_pad).astype(np.int32)

    src = np.pad(ea.src, ((0, 0), (0, e_pad - e_max))).astype(np.int32)
    mask = np.pad(ea.edge_mask, ((0, 0), (0, e_pad - e_max))
                  ).astype(np.int32)
    weight = (np.pad(ea.weight, ((0, 0), (0, e_pad - e_max))
                     ).astype(np.float32) if ea.weight is not None else None)
    return BlockMetadata(block_e=block_e, span=span, span_req=span_req,
                         base=base, local=local, src=src, mask=mask,
                         weight=weight, block_spans=block_spans)


# ---------------------------------------------------------------------------
# Transposed in-edge layout for bottom-up supersteps (kernels/bottomup.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TransposedCsc:
    """One direction's intra-partition edges, destination-major, for the
    bottom-up (pull) direction of min-combine programs.

    Rows are the flattened local vertices ``r = p * v_max + v``; row ``r``
    holds the in-neighbours of ``v`` inside partition ``p`` as flat source
    indices ``p * v_max + src`` (the index of the source's value in a
    ``[Q, P * v_max]`` message array).  Within a row the slots run by source
    out-degree descending, ties by source id then edge order, so the
    likeliest frontier parent comes first and an early-exit scan stops soon.

    The JAX package keeps the same rows in a dense ELL block
    (``TransposedEll``, ``[P, v_max, kmax]`` with sentinel padding).  There
    the widest row, a hub's in-degree, sets the width of every row: on a
    scale-free graph the block grows as ``P * v_max * kmax``.  Here a row
    holds its real slots only; padding row ``r`` to ``kmax`` slots with the
    sentinel ``v_max`` (local ids) gives the ELL block back.

    Boundary edges are not transposed: they keep their outbox-slot push
    path in both directions.  ``deg_out``/``deg_bnd`` are each vertex's real
    total and boundary out-degree, the per-superstep ``edges_examined``
    charges of the push direction and of the boundary leg.
    """

    row_ptr: np.ndarray           # [P * v_max + 1] int32 row starts
    col: np.ndarray               # [nnz] int32 flat source index
    val: Optional[np.ndarray]     # [nnz] f32 edge weights, or None
    kreal: np.ndarray             # [P, v_max] int32 slots per row
    deg_out: np.ndarray           # [P, v_max] int32 real out-degree
    deg_bnd: np.ndarray           # [P, v_max] int32 boundary out-degree
    kmax: int                     # widest row (>= 1)

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])


def build_transposed_csc(ea: EdgeArrays, v_max: int) -> TransposedCsc:
    """Transpose one direction's intra-partition edges into CSC rows.

    Numpy preprocessing, run once when an engine first needs the pull
    direction.  The rows, their slot order, ``kreal``, ``deg_out``,
    ``deg_bnd`` and ``kmax`` equal the JAX package's
    ``build_transposed_ell`` for the same edge arrays.
    """
    P = ea.src.shape[0]
    deg_out = np.zeros((P, v_max), dtype=np.int32)
    deg_bnd = np.zeros((P, v_max), dtype=np.int32)
    kreal = np.zeros((P, v_max), dtype=np.int32)
    cols, vals = [], []
    for p in range(P):
        em = ea.edge_mask[p]
        deg_out[p] = np.bincount(ea.src[p][em], minlength=v_max)
        bm = em & (ea.dst_ext[p] > v_max)
        deg_bnd[p] = np.bincount(ea.src[p][bm], minlength=v_max)
        im = em & (ea.dst_ext[p] < v_max)
        dst = ea.dst_ext[p][im]
        src = ea.src[p][im]
        # slot order: destination, then source out-degree descending, ties
        # by (source, arrival)
        order = np.lexsort((np.arange(len(dst)), src,
                            -deg_out[p][src].astype(np.int64), dst))
        kreal[p] = np.bincount(dst, minlength=v_max)
        cols.append((src[order] + p * v_max).astype(np.int32))
        if ea.weight is not None:
            vals.append(ea.weight[p][im][order].astype(np.float32))
    nnz = int(kreal.sum())
    if nnz >= 2 ** 31:
        raise ValueError(f"{nnz} intra-partition edges overflow int32 rows")
    row_ptr = np.zeros(P * v_max + 1, dtype=np.int32)
    np.cumsum(kreal.ravel(), out=row_ptr[1:])
    return TransposedCsc(
        row_ptr=row_ptr, col=np.concatenate(cols),
        val=np.concatenate(vals) if ea.weight is not None else None,
        kreal=kreal, deg_out=deg_out, deg_bnd=deg_bnd,
        kmax=max(1, int(kreal.max(initial=0))))



# ---------------------------------------------------------------------------
# Memory footprint (paper Table 5) and the tiered memory plan
# ---------------------------------------------------------------------------

def memory_footprint_bytes(pg: PartitionedGraph, state_bytes: int = 4,
                           vid_bytes: int = 4, eid_bytes: int = 4,
                           dynamic=None, tier_plan=None) -> dict:
    """Per-partition memory footprint, the analogue of paper Table 5.

    The actual-size formula of §4.3.3:
    ``eid*|Vp| + vid*|Ep| (+ w*|Ep|) + (vid+s)*|Vi| + (vid+s)*|Vo|``, kept
    equal to the JAX package's (it models the paper's layout, not the
    port's tensors).  Each record splits ``total`` by tier: ``tier``
    (``"hbm"``, or ``"host"`` for a cold partition of ``tier_plan``),
    ``hbm`` and ``host`` with ``hbm + host == total``.  A cold partition
    keeps its graph bytes on the host; its state and outbox/inbox slots
    stay on the device.

    ``dynamic`` (a ``core.dynamic.DynamicGraph`` over ``pg``, or any object
    with ``delta_slots``/``directions``/``weighted``) adds the delta-slot
    (``delta``) and tombstone (``tombstone``) bytes per direction, which a
    cold partition keeps on the host with its graph bytes.
    """
    P = pg.num_parts
    res = {}
    cold = set() if tier_plan is None else set(int(p)
                                               for p in tier_plan.cold)
    w_bytes = 4 if pg.fwd.weight is not None else 0
    for p in range(P):
        vp = int(pg.assignment.part_sizes[p])
        ep = int(pg.fwd.num_edges[p])
        vo = int(pg.fwd.outbox_mask[p].sum())          # remote vertices we msg
        vi = int(pg.fwd.outbox_mask[:, p].sum())       # local verts msg'd to
        res[p] = dict(
            graph=eid_bytes * vp + (vid_bytes + w_bytes) * ep,
            outbox=(vid_bytes + state_bytes) * vo,
            inbox=(vid_bytes + state_bytes) * vi,
            state=state_bytes * vp,
        )
        if dynamic is not None:
            ndir = int(dynamic.directions)
            dw = 4 if dynamic.weighted else 0
            # delta slots: src + dst_ext (+ weight) per direction
            res[p]["delta"] = ndir * int(dynamic.delta_slots) * (
                2 * vid_bytes + dw)
            # tombstone masks: one byte per base edge slot per direction
            res[p]["tombstone"] = pg.fwd.e_max + (
                pg.rev.e_max if pg.rev is not None else 0)
        res[p]["total"] = sum(res[p].values())
        host = 0
        if p in cold:
            host = (res[p]["graph"] + res[p].get("delta", 0)
                    + res[p].get("tombstone", 0))
        res[p]["tier"] = "host" if p in cold else "hbm"
        res[p]["hbm"] = res[p]["total"] - host
        res[p]["host"] = host
    return res


def memory_residency_bytes(pg: PartitionedGraph, tier_plan=None,
                           state_bytes: int = 4, dynamic=None) -> dict:
    """Device and host residency of a (possibly tiered) layout: the sums of
    :func:`memory_footprint_bytes`'s tiers, the device side with the two
    window buffers added.  ``hbm_bytes`` is what occupies device memory,
    ``host_bytes`` what lives in pinned host memory, ``total_bytes`` both.
    """
    per = memory_footprint_bytes(pg, state_bytes=state_bytes,
                                 dynamic=dynamic, tier_plan=tier_plan)
    hbm = sum(rec["hbm"] for rec in per.values())
    host = sum(rec["host"] for rec in per.values())
    if tier_plan is not None:
        hbm += int(tier_plan.stream_buffer_bytes)
    return dict(hbm_bytes=int(hbm), host_bytes=int(host),
                total_bytes=int(hbm + host))


@dataclasses.dataclass
class WindowSchedule:
    """One direction's clean-cut streaming windows over the cold partitions.

    Every window is a run of at most ``win_blocks`` edge blocks of one cold
    partition, cut only at block boundaries that no destination run
    straddles.  Edges are ``dst_ext``-sorted per partition, so each
    extended segment receives its real edges from exactly one window, and
    a window's segments form the range ``[dst_ext[start],
    dst_ext[start + count - 1]]``.  A window holds at most
    ``win_e = win_blocks * block_e`` edge slots.
    """

    block_e: int
    win_blocks: int
    part: np.ndarray     # [W] int32 partition id of each window
    start: np.ndarray    # [W] int64 first edge slot covered
    count: np.ndarray    # [W] int64 real edge slots covered (<= win_e)

    @property
    def win_e(self) -> int:
        return self.win_blocks * self.block_e

    @property
    def num_windows(self) -> int:
        return len(self.part)


class NoCleanCutError(ValueError):
    """A cold partition has a destination run longer than a window, so no
    window schedule cuts it cleanly."""


def _clean_cut_windows(ea: EdgeArrays, cold, block_e: int,
                       win_blocks: int) -> WindowSchedule:
    """Greedy clean-cut schedule: per cold partition, walk the blocks and
    cut each window at the latest clean boundary within ``win_blocks``."""
    part, start, count = [], [], []
    for p in cold:
        p = int(p)
        k = int(ea.num_edges[p])
        if k == 0:
            continue
        nb_used = -(-k // block_e)
        dst = ea.dst_ext[p]
        cur = 0
        while cur < nb_used:
            want = min(cur + win_blocks, nb_used)
            b = want
            while b > cur:
                i = b * block_e
                if i >= k or dst[i - 1] != dst[i]:
                    break                        # clean boundary
                b -= 1
            if b == cur:
                run = int(np.max(np.bincount(
                    dst[cur * block_e: min(k, want * block_e)])))
                raise NoCleanCutError(
                    f"partition {p}: a destination run of {run} edges "
                    f"spans more than win_blocks*block_e = "
                    f"{win_blocks * block_e} edge slots, so no clean "
                    f"window cut exists; raise win_blocks (or block_e) "
                    f"past the longest destination run")
            part.append(p)
            start.append(cur * block_e)
            count.append(min(k, b * block_e) - cur * block_e)
            cur = b
    return WindowSchedule(
        block_e=block_e, win_blocks=win_blocks,
        part=np.asarray(part, dtype=np.int32),
        start=np.asarray(start, dtype=np.int64),
        count=np.asarray(count, dtype=np.int64))


@dataclasses.dataclass
class TierPlan:
    """The device/host residency that ``perf_model.choose_tier_split``
    picked for one partitioned graph.

    ``hot`` partitions keep their edge arenas on the device; ``cold``
    partitions' arenas live in pinned host memory and stream through the
    superstep in the windows of ``fwd``/``rev``.  ``hbm_bytes`` (the hot
    arenas plus ``stream_buffer_bytes``, the two window buffers) is the
    device bytes the tiered engine's arenas take, counted in its own
    dtypes (:func:`_arena_bytes_per_edge`), and at most
    ``hbm_budget_bytes``.  ``host_bytes`` is the same measure of the cold
    arenas.
    """

    hbm_budget_bytes: int
    hot: np.ndarray                      # sorted int32, device-resident
    cold: np.ndarray                     # sorted int32, host-resident
    fwd: WindowSchedule
    rev: Optional[WindowSchedule]
    hbm_bytes: int                       # hot arenas + stream_buffer_bytes
    host_bytes: int                      # cold arenas (pinned host memory)
    streamed_bytes_per_superstep: int
    stream_buffer_bytes: int             # the two in-flight window buffers
    table: List[dict]                    # perf_model.rank_tier_split table

    @property
    def window_count(self) -> int:
        return self.fwd.num_windows + (self.rev.num_windows
                                       if self.rev is not None else 0)


def _arena_bytes_per_edge(weighted: bool, fused: bool) -> int:
    """Device bytes per edge slot of the tiered engine's arenas, the arrays
    its compute reads in their dtypes: the fused kernel's block arrays
    (``blk_src``/``blk_local``/``blk_mask`` int32, ``weight_blk`` f32), or
    the reference compute's ``src``/``dst_ext`` (int64, the index dtype of
    ``torch.gather`` and ``scatter_reduce``) and ``weight`` (f32).  The
    JAX package counts 4-byte ids and both flavors' arrays on the fused
    backend."""
    w = 4 if weighted else 0
    return 12 + w if fused else 16 + w


def _delta_slot_bytes(weighted: bool) -> int:
    """Device bytes per delta slot of a dynamic graph's overlay, in the
    payload's dtypes: ``d_src``/``d_dst_ext`` int64, ``d_weight`` f32."""
    return 16 + (4 if weighted else 0)


def build_tier_plan(pg: PartitionedGraph, hbm_budget_bytes: int, *,
                    block_e: int = 1024, win_blocks: int = 8,
                    fused: bool = True, dynamic=None) -> TierPlan:
    """The :class:`TierPlan` of ``pg`` under a device byte budget.

    ``perf_model.choose_tier_split`` picks the hot partitions (densest
    first); this adds the clean-cut window schedules of both directions
    and the byte accounting of the arenas the tiered engine puts on the
    card: ``fused=True`` the fused backend's block arrays (``[P, e_pad]``
    and a base per block), ``fused=False`` the reference compute's edge
    arrays (``[P, e_max]``).  ``dynamic`` (a ``DynamicGraph`` over ``pg``)
    adds its overlay: a partition gains a tombstone byte per base slot per
    direction and ``directions * delta_slots`` delta slots; a window buffer
    gains its ``win_e`` tombstone bytes and the ``delta_slots`` slots a
    cold partition's delta window streams in.  The hot/cold choice and the
    schedules equal the JAX package's for the same table row; the bytes
    differ by dtype.
    """
    from repro_torch.core import perf_model

    P = pg.num_parts
    weighted = pg.fwd.weight is not None
    per_edge = _arena_bytes_per_edge(weighted, fused)
    win_e = win_blocks * block_e

    def _dir_bytes(ea: EdgeArrays) -> int:
        b = ea.e_max if dynamic is not None else 0     # tombstones, 1 B
        if not fused:
            return b + per_edge * ea.e_max
        e_pad = max(_round_up(ea.e_max, block_e), block_e)
        return b + per_edge * e_pad + 4 * (e_pad // block_e)

    part_bytes = np.full(P, _dir_bytes(pg.fwd), dtype=np.int64)
    if pg.rev is not None:
        part_bytes += _dir_bytes(pg.rev)
    window_bytes = per_edge * win_e + (4 * win_blocks if fused else 0)
    if dynamic is not None:
        delta = int(dynamic.delta_slots) * _delta_slot_bytes(
            dynamic.weighted)
        part_bytes += int(dynamic.directions) * delta
        window_bytes += win_e + delta

    part_edges = np.asarray(pg.fwd.num_edges, dtype=np.int64).copy()
    if pg.rev is not None:
        part_edges += np.asarray(pg.rev.num_edges, dtype=np.int64)
    hot, table = perf_model.choose_tier_split(
        part_bytes, int(hbm_budget_bytes), part_edges=part_edges,
        window_bytes=window_bytes)
    hot = np.asarray(sorted(hot), dtype=np.int32)
    cold = np.asarray([p for p in range(P) if p not in set(hot.tolist())],
                      dtype=np.int32)

    fwd_sched = _clean_cut_windows(pg.fwd, cold, block_e, win_blocks)
    rev_sched = (_clean_cut_windows(pg.rev, cold, block_e, win_blocks)
                 if pg.rev is not None else None)
    buffers = 0 if len(cold) == 0 else 2 * window_bytes
    hot_bytes = int(part_bytes[hot].sum()) if len(hot) else 0
    host_bytes = int(part_bytes[cold].sum()) if len(cold) else 0
    return TierPlan(
        hbm_budget_bytes=int(hbm_budget_bytes), hot=hot, cold=cold,
        fwd=fwd_sched, rev=rev_sched,
        hbm_bytes=hot_bytes + buffers, host_bytes=host_bytes,
        streamed_bytes_per_superstep=host_bytes,
        stream_buffer_bytes=buffers, table=table)
