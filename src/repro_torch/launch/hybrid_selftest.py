"""Sharded-hybrid parity self-test: every algorithm through
``DistributedBSPEngine(backend="hybrid")`` over a world of ranks, against
the port's single-device reference engine, for each partitioning strategy.

  python -m repro_torch.launch.hybrid_selftest --world 2 [--device cpu|cuda]
      [--scale 9] [--edge-factor 4] [--parts 4] [--seed 13]
      [--init file:///path/to/rendezvous] [--out results.npz]

``--world`` ranks are spawned (``launch/world.py``): NCCL with one card per
rank by default, gloo with ``--device cpu``.  Min combines (BFS, SSSP, CC)
are compared exactly, BFS and BC with equal steps; PageRank to
``rtol=1e-5, atol=1e-8`` and BC to ``rtol=1e-4, atol=1e-4`` (the JAX
package's self-test tolerances: the dense/remainder split and the outbox
aggregation reassociate the sums across shards).  A world of one also covers ``P=1``: no boundary edge, an
empty outbox, no exchange.  ``--out`` saves rank 0's results (the global
arrays, per strategy) as ``.npz``.  Prints ``HYBRID SELFTEST OK``.
"""
from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np

PR_ITERS = 10


def _run_rank(group, scale: int, edge_factor: int, parts: int,
              seed: int) -> dict:
    """One rank's share of the self-test; rank 0 returns the results."""
    from repro_torch.algorithms import (betweenness_centrality, bfs,
                                        connected_components, pagerank,
                                        pagerank_distributed, sssp,
                                        symmetrize)
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine

    lead = group.rank == 0
    dev = group.device
    g = G.rmat(scale, edge_factor, seed=seed).with_uniform_weights(seed=1)
    gs = symmetrize(G.rmat(scale, edge_factor, seed=seed))
    out = {}
    for strategy in PT.STRATEGIES:
        pg = PT.partition(g, parts, strategy, include_reverse=True)
        hyb = DistributedBSPEngine(pg, group, backend="hybrid")
        ks = [rec["k_dense"] for rec in hyb.hybrid_plan()["per_shard"]]
        lh, sh = bfs(hyb, 0)
        dh, _ = sssp(hyb, 0)
        ph = pagerank_distributed(hyb, PR_ITERS)
        bh, s2 = betweenness_centrality(hyb, 0)
        pgs = PT.partition(gs, parts, strategy)
        ch, _ = connected_components(
            DistributedBSPEngine(pgs, group, backend="hybrid"))
        if lead:
            ref = BSPEngine(pg, device=dev)
            lr, sr = bfs(ref, 0)
            np.testing.assert_array_equal(lr, lh)      # min combine: exact
            assert sr == sh, (sr, sh)
            np.testing.assert_array_equal(sssp(ref, 0)[0], dh)
            np.testing.assert_allclose(pagerank(ref, PR_ITERS), ph,
                                       rtol=1e-5, atol=1e-8)
            br, s1 = betweenness_centrality(ref, 0)
            assert s1 == s2, (s1, s2)
            np.testing.assert_allclose(br, bh, rtol=1e-4, atol=1e-4)
            cr, _ = connected_components(BSPEngine(pgs, device=dev))
            np.testing.assert_array_equal(cr, ch)
            out.update({f"{strategy}/bfs": lh, f"{strategy}/bfs_steps": sh,
                        f"{strategy}/sssp": dh, f"{strategy}/pagerank": ph,
                        f"{strategy}/bc": bh, f"{strategy}/bc_steps": s2,
                        f"{strategy}/cc": ch, f"{strategy}/k": np.array(ks)})
            print(f"{strategy:>4}: bfs/sssp/pagerank/bc/cc parity over "
                  f"{group.world_size} rank(s), per-shard k={ks}", flush=True)

    if group.world_size == 1:
        # P=1: no peers, no boundary edges, an empty outbox
        pg1 = PT.partition(g, 1, PT.RAND)
        assert float(pg1.beta_with_reduction) == 0.0
        for alg in (bfs, sssp):
            got, _ = alg(DistributedBSPEngine(pg1, group, backend="hybrid"),
                         0)
            np.testing.assert_array_equal(
                alg(BSPEngine(pg1, device=dev), 0)[0], got)
        print("P=1 empty-outbox edge case: parity", flush=True)
    return out if lead else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--scale", type=int, default=9)
    ap.add_argument("--edge-factor", type=int, default=4)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.parts % args.world:
        ap.error(f"--parts {args.parts} must divide over --world "
                 f"{args.world}")

    from repro_torch.launch.world import run_world

    # by module name, so the spawned ranks can import the target
    me = importlib.import_module("repro_torch.launch.hybrid_selftest")
    results = run_world(me._run_rank, args.world, device=args.device,
                        init=args.init, timeout=args.timeout,
                        args=(args.scale, args.edge_factor, args.parts,
                              args.seed))
    if args.out:
        np.savez(args.out, **results[0])
    print("HYBRID SELFTEST OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
