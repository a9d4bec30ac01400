"""Graph workloads and edge-mutation streams (``repro.data.graphs``).

Determinism contract: every stochastic choice is keyed off the caller's
explicit ``seed`` through streams derived from it (the topology, the
weights and the mutations each their own), so the same workload, graph and
seed give the same graphs and streams in both packages, across processes
and machines.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.configs.totem_rmat import GraphWorkload
from repro_torch.core.graph import (CSRGraph, EdgeLedger, MutationBatch,
                                    rmat, uniform)

# The JAX package's stream labels, mixed into the derived seeds so the
# topology, the weights and the mutations never share a generator stream
# (adding weights must not perturb the topology).
_TOPOLOGY_STREAM = 0x70
_WEIGHT_STREAM = 0x7E
_MUTATION_STREAM = 0x4D


def derive_seed(seed: int, stream: int) -> int:
    """Deterministically derive an independent integer seed for a stream."""
    ss = np.random.SeedSequence([int(seed), int(stream)])
    return int(ss.generate_state(1, dtype=np.uint32)[0])


def load_workload(w: GraphWorkload, seed: int = 1,
                  weighted: bool = False) -> CSRGraph:
    """Materialize a workload: the same graph for the same ``(w, seed)``,
    array-equal to the JAX package's."""
    topo_seed = derive_seed(seed, _TOPOLOGY_STREAM)
    if w.kind == "rmat":
        g = rmat(w.scale, w.edge_factor, seed=topo_seed)
    elif w.kind == "uniform":
        g = uniform(w.scale, w.edge_factor, seed=topo_seed)
    else:
        raise ValueError(w.kind)
    if weighted:
        g = g.with_uniform_weights(seed=derive_seed(seed, _WEIGHT_STREAM))
    return g


def edge_stream(g: CSRGraph, num_batches: int, batch_size: int,
                churn: float = 0.7, skew: float = 0.5,
                symmetric: bool = False, seed: int = 1
                ) -> List[MutationBatch]:
    """Deterministic timestamped edge-mutation stream over ``g``.

    Each batch mixes ``churn``·``batch_size`` inserts with the remaining
    deletes.  Insert endpoints are degree-preferential — probability ∝
    ``(deg + 1)^skew`` (``skew=0`` uniform; higher values concentrate churn
    on hubs, drifting the degree ranking the hybrid split was planned
    against, which ``perf_model.should_resplit`` watches).  Deletes sample
    *live* instances of the evolving edge multiset (replaying batch ``i``
    needs batches ``0..i-1``), so every delete is valid by construction.
    Weighted graphs get insert weights from the paper's uniform(1, 64).
    ``symmetric=True`` emits each insert/delete in both orientations (the
    CC contract).  All randomness derives from ``(seed,
    _MUTATION_STREAM)``: the JAX package's stream, bit for bit.
    """
    rng = np.random.default_rng(derive_seed(seed, _MUTATION_STREAM))
    ledger = EdgeLedger(g)
    deg = g.out_degrees().astype(np.float64)
    p = (deg + 1.0) ** skew
    p /= p.sum()
    n = g.num_vertices
    weighted = g.weights is not None
    batches = []
    for _ in range(num_batches):
        n_ins = int(round(batch_size * churn))
        n_del = batch_size - n_ins
        src = rng.choice(n, size=n_ins, p=p)
        dst = rng.choice(n, size=n_ins, p=p)
        d_src, d_dst = ledger.sample_alive(rng, n_del)
        d_loop = np.empty(0, dtype=np.int64)
        if symmetric:
            # canonicalize each sampled pair to (lo, hi) — the mirror is
            # emitted below — deduplicating pairs whose two orientations
            # were both sampled, and setting self-loops aside (one
            # instance, no mirror to pop)
            lo = np.minimum(d_src, d_dst)
            hi = np.maximum(d_src, d_dst)
            pairs = np.unique(np.stack([lo, hi], axis=1), axis=0)
            loops = pairs[:, 0] == pairs[:, 1]
            d_loop = pairs[loops, 0]
            d_src, d_dst = pairs[~loops, 0], pairs[~loops, 1]
        s = np.concatenate([src, d_src])
        d = np.concatenate([dst, d_dst])
        ins = np.concatenate([np.ones(n_ins, bool),
                              np.zeros(len(d_src), bool)])
        w = None
        if weighted:
            w = np.ones(len(s), dtype=np.float32)
            w[:n_ins] = rng.uniform(1.0, 64.0, size=n_ins)
        if symmetric:
            s, d = np.concatenate([s, d, d_loop]), np.concatenate([d, s,
                                                                   d_loop])
            ins = np.concatenate([ins, ins, np.zeros(len(d_loop), bool)])
            if w is not None:
                w = np.concatenate([w, w, np.ones(len(d_loop), np.float32)])
        batch = MutationBatch(s, d, ins, w)
        ledger.apply(batch)    # keep later delete samples valid
        batches.append(batch)
    return batches
