"""The paper's performance model (§3), the push/pull crossover of
direction-optimized traversal, the hybrid backend's degree-split planner
and the tiered-memory split.

Equations (paper §3.2):

  t(G_p)   = |E_p^b| / c + |E_p| / r_p                         (Eq. 1)
  makespan = max_p t(G_p)                                      (Eq. 2)
  speedup  = t_cpu(G) / makespan                               (Eq. 3)
           = c / (beta * r_cpu + alpha * c)                    (Eq. 4)

A copy of the JAX package's ``repro.core.perf_model``, so an engine of the
port votes for the same direction, picks the same dense block |H| and keeps the same
partitions on the device as the JAX package's on the same graph.

Every constant below is that package's model of its own accelerator, kept
under the package's names; none was fitted on a GPU.  ``DIRECTION_GAMMA``
is its per-backend cost of a bottom-up scan slot relative to a pushed edge.
The ``TPU_*`` rates and the fast-memory size behind ``K_DENSE_CAP`` are the
inputs of its split planner (``hybrid_makespan_tpu``), and its interconnect
rate (``TPU_ICI_LINK_BW`` x ``TPU_ICI_LINKS``) the boundary-exchange term
of the sharded planner (``plan_shards``); copying them keeps
``hybrid_k_dense=None`` on the JAX package's choice, per shard too.  A
model of the card's own rates, fitted from measurement, is later work.
"""
from __future__ import annotations

import dataclasses

import numpy as np

DIRECTION_GAMMA = {"hybrid": 1.0, "fused": 1.5, "reference": 2.0}

# The paper's Figure 1 values (2013 commodity parts).
PAPER_PCIE_GBPS = 12.0e9            # measured PCI-E gen3 bandwidth, B/s
PAPER_BYTES_PER_EDGE_MSG = 4.0      # 4-byte update per boundary edge
PAPER_C = PAPER_PCIE_GBPS / PAPER_BYTES_PER_EDGE_MSG   # 3 BE/s (paper)
PAPER_R_CPU = 1.0e9                 # ~1 BE/s (Nguyen et al. 2013 bests)
PAPER_R_GPU = 3.0e9

# The JAX package's accelerator model (see the module docstring).
TPU_PEAK_FLOPS = 197e12
TPU_HBM_BW = 819e9
TPU_ICI_LINK_BW = 50e9
TPU_ICI_LINKS = 4
TPU_VMEM_BYTES = 128 * 1024 * 1024
# Its pinned-host-to-device streaming rate, the host-link term of the tier
# split (:func:`host_stream_time`).  It sets only the predicted times:
# the split itself is the longest densest-first prefix that fits the
# budget, whatever the rates.
HOST_STREAM_BW = 16.0e9


@dataclasses.dataclass
class ModelParams:
    """Parameters of Eq. 1-4."""

    r_bottleneck: float   # edges/s of the bottleneck element ("CPU")
    r_fast: float         # edges/s of the offload target ("GPU")
    c: float              # boundary edges/s over the interconnect

    @classmethod
    def paper_defaults(cls) -> "ModelParams":
        return cls(r_bottleneck=PAPER_R_CPU, r_fast=PAPER_R_GPU, c=PAPER_C)

    @classmethod
    def tpu_defaults(cls, bytes_per_edge: float = 8.0,
                     msg_bytes: float = 4.0) -> "ModelParams":
        """The JAX package's accelerator rates from first principles: the
        gather path moves ``bytes_per_edge`` per edge from memory, a dense
        edge costs 2 operations at peak, and the interconnect carries
        ``msg_bytes`` per boundary edge over all links."""
        return cls(r_bottleneck=TPU_HBM_BW / bytes_per_edge,
                   r_fast=TPU_PEAK_FLOPS / 2.0,
                   c=TPU_ICI_LINK_BW * TPU_ICI_LINKS / msg_bytes)


def partition_time(num_edges: float, num_boundary: float, rate: float,
                   c: float) -> float:
    """Eq. 1: time to process one partition."""
    return num_boundary / c + num_edges / rate


def makespan(edge_counts, boundary_counts, rates, c: float) -> float:
    """Eq. 2: the slowest element bounds the system."""
    return max(partition_time(e, b, r, c)
               for e, b, r in zip(edge_counts, boundary_counts, rates))


def speedup(alpha: float, beta: float, r_cpu: float, c: float) -> float:
    """Eq. 4: predicted hybrid speedup over bottleneck-only processing."""
    return c / (beta * r_cpu + alpha * c)


def speedup_curve(alphas, beta: float, r_cpu: float, c: float) -> np.ndarray:
    return np.array([speedup(a, beta, r_cpu, c)
                     for a in np.atleast_1d(alphas)])


def mxu_crossover_density(bytes_per_edge: float = 8.0,
                          peak_flops: float = TPU_PEAK_FLOPS,
                          hbm_bw: float = TPU_HBM_BW) -> float:
    """Density above which the dense path beats the memory-bound gather
    path: gather rate ``hbm_bw / bytes_per_edge`` against dense rate
    ``peak / 2 * density`` cross at ``2 * hbm_bw / (bytes_per_edge *
    peak)``."""
    return 2.0 * hbm_bw / (bytes_per_edge * peak_flops)


def predicted_vs_measured(pred: np.ndarray, meas: np.ndarray) -> dict:
    """Pearson correlation and average error (paper Table 3's metrics)."""
    pred = np.asarray(pred, dtype=np.float64)
    meas = np.asarray(meas, dtype=np.float64)
    corr = float(np.corrcoef(pred, meas)[0, 1]) if len(pred) > 1 else 1.0
    avg_err = float(np.mean((pred - meas) / meas))
    return dict(correlation=corr, avg_error=avg_err)


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
                        e_sparse: float, boundary_slots: float = 0.0,
                        num_chips: int = 1, bytes_per_edge: float = 8.0,
                        msg_bytes: float = 4.0) -> dict:
    """Predicted makespan of the two-engine step (paper Eq. 2 recast): the
    dense and sparse stages run one after the other on a device, the
    ``num_chips`` shards side by side, and the boundary exchange before
    them (Eq. 1's ``|E_p^b| / c`` with the §3.4 reduced slots):

      t_dense = e_dense / dense_block_rate(density) / chips
      t_sparse = e_sparse / (memory rate / bytes_per_edge) / chips
      t_comm = boundary_slots * msg_bytes / (chips * link rate * links)

    One device ships no boundary slots, so ``t_comm`` is 0 there.
    """
    r_dense = dense_block_rate(max(dense_density, 1e-12))
    r_sparse = TPU_HBM_BW / bytes_per_edge
    t_dense = e_dense / r_dense / num_chips
    t_sparse = e_sparse / r_sparse / num_chips
    t_comm = boundary_slots * msg_bytes / (TPU_ICI_LINK_BW * TPU_ICI_LINKS
                                           * num_chips)
    return dict(t_dense=t_dense, t_sparse=t_sparse, t_comm=t_comm,
                makespan=t_comm + t_dense + t_sparse)


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
                 candidates, num_chips: int = 1, bytes_per_edge: float = 8.0,
                 msg_bytes: float = 4.0, boundary_slots: float = 0.0) -> list:
    """One record per candidate |H|: the edges inside the H x H block
    (``e_dense(k) = #{e : edge_max_rank[e] < k}``), the rest, the block's
    density, ``boundary_slots`` and the makespan terms of
    :func:`hybrid_makespan_tpu`.  ``boundary_slots`` (the outbox slots a
    shard ships per superstep) shifts every candidate by the same time; it
    differs between shards, which is what makes ``plan_shards``'s argmin
    per shard depend on the partitioning.

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
        pred = hybrid_makespan_tpu(e_dense, density, e_sparse,
                                   boundary_slots=boundary_slots,
                                   num_chips=num_chips,
                                   bytes_per_edge=bytes_per_edge,
                                   msg_bytes=msg_bytes)
        table.append(dict(k_dense=int(k), e_dense=e_dense, e_sparse=e_sparse,
                          density=density,
                          boundary_slots=float(boundary_slots), **pred))
    return table


def choose_k_dense(edge_max_rank: np.ndarray, num_edges: int, candidates,
                   **kwargs):
    """Pick |H| = argmin of predicted makespan; returns (k, ranked table)."""
    table = rank_k_dense(edge_max_rank, num_edges, candidates, **kwargs)
    best = min(table, key=lambda rec: rec["makespan"])
    return best["k_dense"], table


def plan_shards(shard_ranks, shard_edges, shard_slots, candidates,
                k_dense: "int | None" = None, **kwargs) -> dict:
    """Per-shard split decision of the sharded hybrid engine (Eq. 1-2).

    Shard ``p`` runs its own two-engine step over its intra-partition edges
    (``shard_ranks[p]``, ``shard_edges[p]``) and ships ``shard_slots[p]``
    aggregated outbox slots to other shards, so its predicted superstep is
    ``t_p = |slots_p| / c + t_dense + t_sparse`` and the system is bound
    by ``max_p t_p``.  Each shard's |H| is the argmin of its own makespan,
    or ``k_dense`` for all when given.  ``candidates`` is one ladder for
    every shard or one ladder per shard.

    Returns ``dict(per_shard=[{shard, num_edges, boundary_slots, table,
    k_dense, e_dense, e_sparse, density, t_dense, t_sparse, t_comm,
    makespan}], k_dense=the largest shard |H|, makespan=max_p t_p,
    bottleneck=argmax_p)``.
    """
    nested = (len(candidates) > 0
              and isinstance(candidates[0], (list, tuple, np.ndarray)))
    per_shard = []
    for s, (ranks, edges, slots) in enumerate(
            zip(shard_ranks, shard_edges, shard_slots)):
        cands = list(candidates[s]) if nested else list(candidates)
        cands = (sorted(set(cands) | {k_dense})
                 if k_dense is not None else cands)
        table = rank_k_dense(ranks, edges, cands,
                             boundary_slots=slots, **kwargs)
        if k_dense is None:
            best = min(table, key=lambda rec: rec["makespan"])
        else:
            best = next(r for r in table if r["k_dense"] == k_dense)
        per_shard.append(dict(shard=s, num_edges=int(edges),
                              boundary_slots=float(slots), table=table,
                              **{k: best[k] for k in
                                 ("k_dense", "e_dense", "e_sparse", "density",
                                  "t_dense", "t_sparse", "t_comm",
                                  "makespan")}))
    bottleneck = max(per_shard, key=lambda rec: rec["makespan"])
    return dict(per_shard=per_shard,
                k_dense=max((rec["k_dense"] for rec in per_shard), default=0),
                makespan=bottleneck["makespan"],
                bottleneck=bottleneck["shard"])


def should_resplit(edge_max_rank: np.ndarray, num_edges: int, candidates,
                   current_k: int, threshold: float = 0.10,
                   **kwargs) -> "tuple[bool, dict]":
    """Decide whether a drifted (mutated) graph warrants re-splitting.

    The dynamic layer keeps the degree split frozen between compactions (a
    stale split is a performance choice, never a correctness one), so the
    re-ranking should run only when it pays: this evaluates the current
    |H| on the drifted graph's ranks against the argmin over
    ``candidates`` and votes to resplit when the predicted makespan
    improves by more than ``threshold`` (relative).  Returns ``(resplit,
    info)``, ``info = dict(current_k, current_makespan, best_k,
    best_makespan, improvement, table)``.
    """
    cands = sorted(set(int(c) for c in candidates) | {int(current_k)})
    table = rank_k_dense(edge_max_rank, num_edges, cands, **kwargs)
    cur = next(r for r in table if r["k_dense"] == int(current_k))
    best = min(table, key=lambda rec: rec["makespan"])
    improvement = 1.0 - best["makespan"] / max(cur["makespan"], 1e-30)
    return improvement > threshold, dict(
        current_k=int(current_k), current_makespan=cur["makespan"],
        best_k=best["k_dense"], best_makespan=best["makespan"],
        improvement=improvement, table=table)


def split_mode(k_dense: int, num_vertices: int, e_sparse: int) -> str:
    """Classify a chosen split: the engine runs dense, sparse, or both."""
    if k_dense == 0:
        return "sparse"
    if e_sparse == 0 or k_dense >= num_vertices:
        return "dense"
    return "hybrid"


# ---------------------------------------------------------------------------
# Tiered-memory split selection (out-of-core, ``core/partition.py::
# build_tier_plan``)
# ---------------------------------------------------------------------------

def host_stream_time(streamed_bytes: float,
                     stream_bw: float = HOST_STREAM_BW) -> float:
    """The host-link term: seconds to stream ``streamed_bytes`` of cold
    edge arenas from pinned host memory per superstep.  It sits beside
    Eq. 1's ``|E_p^b| / c``: one more bandwidth term of the same shape."""
    return float(streamed_bytes) / max(stream_bw, 1e-30)


def rank_tier_split(part_bytes, hbm_budget_bytes: int, *,
                    part_edges=None, window_bytes: int = 0,
                    stream_bw: float = HOST_STREAM_BW,
                    bytes_per_edge: float = 8.0) -> list:
    """Predict the superstep time of every device/host cut (Eq. 1 + the
    stream).

    ``part_bytes[p]`` is partition ``p``'s device edge-arena bytes.
    Partitions rank densest-first (most real edges, ties by id) and the
    candidate ``h`` keeps the first ``h`` of that order on the device.  A
    cut is feasible when the hot arenas plus the two window buffers
    (``2 * window_bytes``; the all-resident cut needs none) fit the budget.
    One record per candidate: the compute term (``edges / gather rate``),
    the stream term (:func:`host_stream_time` of the cold bytes) and their
    sum, the makespan.
    """
    part_bytes = np.asarray(part_bytes, dtype=np.int64)
    P = len(part_bytes)
    if part_edges is None:
        part_edges = part_bytes / max(bytes_per_edge, 1e-30)
    part_edges = np.asarray(part_edges, dtype=np.float64)
    order = np.lexsort((np.arange(P), -part_edges))
    r_gather = TPU_HBM_BW / bytes_per_edge
    total_edges = float(part_edges.sum())
    table = []
    for h in range(P + 1):
        hot, cold = order[:h], order[h:]
        hot_bytes = int(part_bytes[hot].sum())
        host_bytes = int(part_bytes[cold].sum())
        buffers = 0 if h == P else 2 * int(window_bytes)
        t_stream = host_stream_time(host_bytes, stream_bw)
        t_compute = total_edges / r_gather
        table.append(dict(
            num_hot=h, hot=tuple(int(p) for p in np.sort(hot)),
            hbm_bytes=hot_bytes + buffers, host_bytes=host_bytes,
            streamed_bytes_per_superstep=host_bytes,
            t_stream=t_stream, t_compute=t_compute,
            makespan=t_compute + t_stream,
            feasible=hot_bytes + buffers <= hbm_budget_bytes))
    return table


def choose_tier_split(part_bytes, hbm_budget_bytes: int,
                      **kwargs) -> "tuple[tuple, list]":
    """Pick the device/host boundary: the feasible cut of least makespan.

    Streaming only adds time, so that is the longest densest-first prefix
    whose arenas fit, and a larger budget keeps a superset hot.  Returns
    ``(hot_ids, table)``; raises when even the all-cold cut (the two
    window buffers) does not fit.
    """
    table = rank_tier_split(part_bytes, hbm_budget_bytes, **kwargs)
    feasible = [rec for rec in table if rec["feasible"]]
    if not feasible:
        need = min(rec["hbm_bytes"] for rec in table)
        raise ValueError(
            f"hbm_budget_bytes={hbm_budget_bytes} cannot hold even the "
            f"streaming double-buffer (needs >= {need} bytes); raise the "
            f"budget or shrink the window (smaller win_blocks/block_e)")
    best = min(feasible, key=lambda rec: (rec["makespan"], -rec["num_hot"]))
    return best["hot"], table
