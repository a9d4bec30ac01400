"""Graph containers and synthetic workload generators.

The paper (§5.1) evaluates on real scale-free graphs (Twitter, UK-WEB) and
synthetic RMAT / uniform (Erdős–Rényi) graphs.  This module provides the CSR
container plus RMAT and uniform generators with the paper's parameters
((A,B,C) = (0.57, 0.19, 0.19), average degree 16).

Everything here is *preprocessing*: plain numpy, amortized cost, excluded from
timed regions — the same methodology as the paper (§5, "Time Measurements").

A copy of ``repro.core.graph``, so the port imports no JAX: the same seed
gives array-equal graphs in both packages, and the same mutation batches
the same edge multiset.  The edge ledger keeps the JAX package's FIFO rule
and instance ids but holds its base edges in arrays (see
:class:`EdgeLedger`).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime import tracing

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
    with tracing.span("graph.from_edge_list"):
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




# ---------------------------------------------------------------------------
# Edge mutations (the dynamic-graph layer, core/dynamic.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MutationBatch:
    """One batch of edge mutations, applied atomically between supersteps.

    ``insert[i]`` selects the operation for edge ``(src[i], dst[i])``: True
    inserts a new instance, False deletes one *existing* instance (FIFO over
    parallel edges — see :class:`EdgeLedger`; deleting an absent edge is an
    error).  ``weight`` carries insert weights on weighted graphs and is
    ignored for deletes.  Vertex ids must stay inside the graph's fixed
    ``[0, n)`` id space: mutation is an edge-set axis, not a vertex axis.
    """

    src: np.ndarray                    # int64 [m]
    dst: np.ndarray                    # int64 [m]
    insert: np.ndarray                 # bool [m]
    weight: Optional[np.ndarray] = None  # float32 [m] or None

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int64).reshape(-1)
        self.dst = np.asarray(self.dst, dtype=np.int64).reshape(-1)
        self.insert = np.asarray(self.insert, dtype=bool).reshape(-1)
        if self.weight is not None:
            self.weight = np.asarray(self.weight,
                                     dtype=np.float32).reshape(-1)
        m = len(self.src)
        for name in ("dst", "insert"):
            arr = getattr(self, name)
            if len(arr) != m:
                raise ValueError(
                    f"MutationBatch: len({name})={len(arr)} != len(src)="
                    f"{m}; every edge needs one src, dst, and insert entry")
        if self.weight is not None:
            if len(self.weight) != m:
                raise ValueError(
                    f"MutationBatch: len(weight)={len(self.weight)} != "
                    f"len(src)={m}; pass one weight per edge or None")
            bad = np.flatnonzero(~np.isfinite(self.weight))
            if len(bad):
                i = int(bad[0])
                raise ValueError(
                    f"MutationBatch: weight[{i}] = {self.weight[i]} is not "
                    f"finite ({len(bad)} such entries); NaN/inf insert "
                    f"weights poison shortest-path state")
        if m and (int(self.src.min()) < 0 or int(self.dst.min()) < 0):
            raise ValueError(
                "MutationBatch: negative vertex ids — ids must lie in the "
                "graph's fixed [0, n) id space")

    def validate(self, num_vertices: int):
        """Range-check ids against a concrete graph (called on apply)."""
        if len(self) == 0:
            return
        hi = int(max(self.src.max(), self.dst.max()))
        if hi >= num_vertices:
            raise ValueError(
                f"MutationBatch: vertex id {hi} out of range for a graph "
                f"with num_vertices={num_vertices}; mutation is an edge-set "
                f"axis, not a vertex axis — grow the graph by rebuilding")

    def __len__(self) -> int:
        return len(self.src)

    @property
    def num_inserts(self) -> int:
        return int(self.insert.sum())

    @property
    def num_deletes(self) -> int:
        return len(self) - self.num_inserts

    @property
    def monotone(self) -> bool:
        """Insert-only batches preserve min/min-plus monotonicity (adding
        edges can only lower a least fixpoint), so warm-starting from the
        previous solution stays exact; any delete breaks that."""
        return self.num_deletes == 0


class EdgeLedger:
    """The host-side multiset of live edge instances.

    The single source of truth for *which* instance a delete removes:
    parallel edges form a FIFO per ``(src, dst)`` pair (base instances in
    CSR order, inserts in arrival order), and a delete pops the oldest live
    instance.  Instance ids are the base edges' CSR indices, then inserts in
    arrival order.  The dynamic graph's planner, the edge-stream generator
    and the rebuild oracle (:func:`apply_mutation_batches`) share this rule,
    so a mutated graph has exactly one canonical CSR.

    The JAX package keeps a deque per pair and two lists of every edge; at
    RMAT20 that is tens of millions of Python objects.  Here the base edges
    stay arrays: one stable sort by the int64 key ``src * n + dst`` puts
    each pair's instances in one run, in id order, found by a binary
    search; a pair that deletes have touched keeps a count of its popped
    base instances, and only inserted instances live in deques.  The FIFO,
    the ids and :meth:`sample_alive`'s draws are the JAX ledger's.
    """

    def __init__(self, g: CSRGraph):
        n = g.num_vertices
        self._n = max(n, 1)
        vid = np.int32 if n < 2 ** 31 else np.int64
        src = g.edge_sources().astype(vid)
        dst = np.asarray(g.col).astype(vid)
        self.num_base = len(src)
        self._bsrc, self._bdst = src, dst
        self._bw = (np.asarray(g.weights, dtype=np.float32)
                    if g.weights is not None else None)
        keys = src.astype(np.int64) * self._n + dst
        order = np.argsort(keys, kind="stable")   # stable: ids stay FIFO
        self._order = order.astype(np.int32 if len(src) < 2 ** 31
                                   else np.int64)
        self._keys = keys[order]
        self._popped: Dict[int, int] = {}         # key -> base pops
        self._ins: Dict[int, collections.deque] = {}   # key -> live inserts
        self._isrc: List[int] = []
        self._idst: List[int] = []
        self._iw: Optional[List[float]] = [] if self._bw is not None else None
        self._alive = np.ones(self.num_base, dtype=bool)
        self._num_alive = self.num_base

    def __len__(self) -> int:
        return self._num_alive

    @property
    def _total(self) -> int:
        return self.num_base + len(self._isrc)

    def _key(self, u: int, v: int) -> int:
        return int(u) * self._n + int(v)

    def _run(self, key: int) -> Tuple[int, int]:
        """The pair's base instances: ``[lo, hi)`` in the sorted order."""
        return (int(np.searchsorted(self._keys, key, "left")),
                int(np.searchsorted(self._keys, key, "right")))

    def insert(self, u: int, v: int, w: Optional[float]) -> int:
        """Append a new instance; returns its instance id."""
        iid = self._total
        self._isrc.append(int(u))
        self._idst.append(int(v))
        if self._iw is not None:
            self._iw.append(float(w if w is not None else 1.0))
        if iid >= len(self._alive):
            self._alive = np.concatenate(
                [self._alive, np.ones(max(len(self._alive), 64), dtype=bool)])
        self._alive[iid] = True
        self._num_alive += 1
        self._ins.setdefault(self._key(u, v), collections.deque()).append(iid)
        return iid

    def delete(self, u: int, v: int) -> Tuple[int, Optional[float]]:
        """Remove the oldest live instance of ``(u, v)``; returns (iid, w)."""
        key = self._key(u, v)
        lo, hi = self._run(key)
        popped = self._popped.get(key, 0)
        if popped < hi - lo:
            iid = int(self._order[lo + popped])
            self._popped[key] = popped + 1
        else:
            q = self._ins.get(key)
            if not q:
                raise KeyError(f"delete of absent edge ({u}, {v})")
            iid = q.popleft()
        self._alive[iid] = False
        self._num_alive -= 1
        return iid, self._weight(iid)

    def _weight(self, iid: int) -> Optional[float]:
        if self._bw is None:
            return None
        if iid < self.num_base:
            return float(self._bw[iid])
        return self._iw[iid - self.num_base]

    def apply(self, batch: MutationBatch) -> None:
        """Replay one batch in order — the mutation-semantics loop, shared
        by the rebuild oracle and the stream generator (the dynamic graph
        interleaves the same calls with its layout planning)."""
        w = batch.weight
        for i in range(len(batch)):
            if batch.insert[i]:
                self.insert(batch.src[i], batch.dst[i],
                            w[i] if w is not None else None)
            else:
                self.delete(batch.src[i], batch.dst[i])

    def _alive_ids(self, u: int, v: int) -> List[int]:
        key = self._key(u, v)
        lo, hi = self._run(key)
        ids = self._order[lo + self._popped.get(key, 0):hi].tolist()
        return ids + list(self._ins.get(key, ()))

    def alive_weights(self, u: int, v: int) -> List[float]:
        """⊗-relevant weights of the live instances of ``(u, v)``, FIFO
        order (1.0 each on unweighted graphs)."""
        ids = self._alive_ids(u, v)
        if self._bw is None:
            return [1.0] * len(ids)
        return [self._weight(i) for i in ids]

    def alive_count(self, u: int, v: int) -> int:
        return len(self._alive_ids(u, v))

    def _endpoints(self, ids: np.ndarray):
        """``(src, dst, w)`` of instance ids (int64, int64, f32 or None)."""
        base = ids < self.num_base
        src = np.empty(len(ids), dtype=np.int64)
        dst = np.empty(len(ids), dtype=np.int64)
        src[base] = self._bsrc[ids[base]]
        dst[base] = self._bdst[ids[base]]
        ins = ids[~base] - self.num_base
        src[~base] = np.asarray(self._isrc, dtype=np.int64)[ins]
        dst[~base] = np.asarray(self._idst, dtype=np.int64)[ins]
        w = None
        if self._bw is not None:
            w = np.empty(len(ids), dtype=np.float32)
            w[base] = self._bw[ids[base]]
            w[~base] = np.asarray(self._iw, dtype=np.float32)[ins]
        return src, dst, w

    def edge_list(self):
        """Live instances as (src, dst, weights-or-None) arrays, instance-id
        (base-then-arrival) order."""
        return self._endpoints(np.flatnonzero(self._alive[:self._total]))

    def sample_alive(self, rng: np.random.Generator, k: int):
        """Sample ``k`` distinct live instances (for delete streams);
        returns (src, dst) arrays."""
        ids = np.flatnonzero(self._alive[:self._total])
        pick = rng.choice(ids, size=min(k, len(ids)), replace=False)
        src, dst, _ = self._endpoints(np.asarray(pick, dtype=np.int64))
        return src, dst

    def to_csr(self, num_vertices: int) -> CSRGraph:
        """Canonical CSR of the live multiset (``from_edge_list`` order)."""
        src, dst, w = self.edge_list()
        return from_edge_list(src, dst, num_vertices, weights=w)


def apply_mutation_batches(g: CSRGraph,
                           batches: Sequence[MutationBatch]) -> CSRGraph:
    """From-scratch rebuild oracle: replay ``batches`` over ``g`` through an
    :class:`EdgeLedger` and emit the canonical mutated CSR.  The dynamic
    graph's ``mutated_csr()`` must equal this for the same batches — the
    incremental contract's ground truth."""
    ledger = EdgeLedger(g)
    for batch in batches:
        ledger.apply(batch)
    return ledger.to_csr(g.num_vertices)


def to_dense(g: CSRGraph) -> np.ndarray:
    """Dense adjacency ``[n, n]`` f32 (tests only: small graphs); multi-edges
    add up."""
    a = np.zeros((g.num_vertices, g.num_vertices), dtype=np.float32)
    vals = g.weights if g.weights is not None else np.ones(g.num_edges,
                                                           dtype=np.float32)
    np.add.at(a, (g.edge_sources(), g.col), vals)
    return a
