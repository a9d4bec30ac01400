"""Sharded-engine self-test: BFS and PageRank through
``DistributedBSPEngine`` on the reference and fused backends over a world
of ranks, against the single-device engine.

  python -m repro_torch.launch.selftest --world 2 [--device cpu|cuda]
      [--scale 10] [--init file:///path/to/rendezvous] [--out results.npz]

``--world`` ranks are spawned (``launch/world.py``): NCCL with one card per
rank by default, gloo with ``--device cpu``; the graph, ``rmat(scale, 8,
seed=7)`` under HIGH, has one partition per rank.  BFS levels and steps
are compared exactly, PageRank to ``rtol=1e-5, atol=1e-8`` (the sums
reassociate across shards).  ``--out`` saves rank 0's results per backend
as ``.npz``.  Prints ``SELFTEST OK``.
"""
from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np

PR_ITERS = 10


def _run_rank(group, scale: int) -> dict:
    """One rank's share of the self-test; rank 0 returns the results."""
    from repro_torch.algorithms import bfs, pagerank, pagerank_distributed
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine

    world = group.world_size
    pg = PT.partition(G.rmat(scale, 8, seed=7), world, PT.HIGH)
    local = BSPEngine(pg, device=group.device)
    lv_local, steps_local = bfs(local, 0)
    pr_local = pagerank(local, PR_ITERS)
    out = {}
    for backend in ("reference", "fused"):
        dist = DistributedBSPEngine(pg, group, backend=backend)
        lv, steps = bfs(dist, 0)
        np.testing.assert_array_equal(lv_local, lv)
        assert steps == steps_local, (steps, steps_local)
        pr = pagerank_distributed(dist, PR_ITERS)
        np.testing.assert_allclose(pr_local, pr, rtol=1e-5, atol=1e-8)
        out.update({f"{backend}/bfs": lv, f"{backend}/bfs_steps": steps,
                    f"{backend}/pagerank": pr})
        if group.rank == 0:
            print(f"{backend}: BFS ({steps} supersteps) and PageRank "
                  f"distributed == local over {world} ranks", flush=True)
    return out if group.rank == 0 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from repro_torch.launch.world import run_world

    # by module name, so the spawned ranks can import the target
    me = importlib.import_module("repro_torch.launch.selftest")
    results = run_world(me._run_rank, args.world, device=args.device,
                        init=args.init, timeout=args.timeout,
                        args=(args.scale,))
    if args.out:
        np.savez(args.out, **results[0])
    print("SELFTEST OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
