"""Batched-query parity self-test: multi-source BFS, SSSP and BC and
personalized PageRank through ``DistributedBSPEngine`` (fused and hybrid
backends) over a world of ranks, against the single-device engine, plus
the Q=1 no-regression and mixed-convergence cases.

  python -m repro_torch.launch.batched_selftest --world 2
      [--device cpu|cuda] [--scale 8] [--edge-factor 4] [--parts 4]
      [--seed 13] [--batch 4] [--init file:///path/to/rendezvous]
      [--out results.npz]

``--world`` ranks are spawned (``launch/world.py``): NCCL with one card per
rank by default, gloo with ``--device cpu``.  Min combines (BFS, SSSP) are
compared exactly, BFS with equal steps; BC to ``rtol=1e-4, atol=1e-4``
and PPR to ``rtol=1e-4, atol=1e-7`` of the numpy oracle (the JAX package's
self-test tolerances: the shard split and outbox aggregation reassociate
the sums).  ``--out`` saves rank 0's results per backend as ``.npz``.
Prints ``BATCHED SELFTEST OK``.
"""
from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np

PPR_ITERS = 8


def _run_rank(group, scale: int, edge_factor: int, parts: int, seed: int,
              batch: int) -> dict:
    """One rank's share of the self-test; rank 0 returns the results."""
    from repro_torch.algorithms import (betweenness_centrality,
                                        betweenness_centrality_batched, bfs,
                                        bfs_batched, personalized_pagerank,
                                        personalized_pagerank_reference, sssp,
                                        sssp_batched)
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine

    g = G.rmat(scale, edge_factor, seed=seed).with_uniform_weights(seed=1)
    pg = PT.partition(g, parts, PT.HIGH, include_reverse=True)
    ref = BSPEngine(pg, device=group.device)
    rng = np.random.default_rng(seed)
    # Mixed convergence by construction: the max-degree hub and a random
    # low-degree tail vertex have very different eccentricities, so some
    # queries vote finish supersteps before others.
    deg = g.out_degrees()
    sources = np.unique(np.concatenate([
        [int(np.argmax(deg)), int(np.argmin(deg))],
        rng.integers(0, g.num_vertices, size=batch)]))[:batch]
    reset = rng.random((batch, g.num_vertices)).astype(np.float32)
    reset /= reset.sum(axis=1, keepdims=True)
    ppr_want = personalized_pagerank_reference(g, reset, PPR_ITERS)

    out = {"sources": sources, "reset": reset}
    for name, backend in (("dist_fused", "fused"), ("dist_hybrid", "hybrid")):
        eng = DistributedBSPEngine(pg, group, backend=backend)
        lv, steps = bfs_batched(eng, sources)
        dv, _ = sssp_batched(eng, sources)
        bcv, _ = betweenness_centrality_batched(eng, sources)
        for i, s in enumerate(sources):
            want_l, want_steps = bfs(ref, int(s))
            np.testing.assert_array_equal(lv[i], want_l)   # min: exact
            assert int(steps[i]) == want_steps, (s, int(steps[i]),
                                                 want_steps)
            np.testing.assert_array_equal(dv[i], sssp(ref, int(s))[0])
            want_b, _ = betweenness_centrality(ref, int(s))
            np.testing.assert_allclose(bcv[i], want_b, rtol=1e-4, atol=1e-4)
        assert len(set(int(x) for x in steps)) > 1, (
            "sources were expected to converge at different supersteps "
            f"(got {steps}) — mixed convergence not exercised")
        ppr = personalized_pagerank(eng, reset, num_iterations=PPR_ITERS)
        np.testing.assert_allclose(ppr, ppr_want, rtol=1e-4, atol=1e-7)
        # Q=1 no-regression: the batched path with one query == bfs().
        lv1, st1 = bfs_batched(eng, [int(sources[0])])
        np.testing.assert_array_equal(lv1[0], lv[0])
        assert int(st1[0]) == int(steps[0])
        out.update({f"{name}/bfs": lv, f"{name}/bfs_steps": steps,
                    f"{name}/sssp": dv, f"{name}/bc": bcv,
                    f"{name}/ppr": ppr})
        if group.rank == 0:
            print(f"{name}: batched bfs/sssp/bc/ppr parity over "
                  f"{group.world_size} rank(s), Q={len(sources)}, "
                  f"steps={list(map(int, steps))}", flush=True)
    return out if group.rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--edge-factor", type=int, default=4)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.parts % args.world:
        ap.error(f"--parts {args.parts} must divide over --world "
                 f"{args.world}")

    from repro_torch.launch.world import run_world

    # by module name, so the spawned ranks can import the target
    me = importlib.import_module("repro_torch.launch.batched_selftest")
    results = run_world(me._run_rank, args.world, device=args.device,
                        init=args.init, timeout=args.timeout,
                        args=(args.scale, args.edge_factor, args.parts,
                              args.seed, args.batch))
    if args.out:
        np.savez(args.out, **results[0])
    print("BATCHED SELFTEST OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
