"""Dynamic-graph parity self-test over a world of ranks: the incremental
contract across the backend x strategy matrix.

For every backend {reference, fused, hybrid} x strategy {rand, high, low}:
apply a deterministic mutation stream (inserts and deletes,
``data/graphs.py::edge_stream``) to a resident ``DynamicGraph``, then check
that running on the layout mutated in place equals a fresh partition and
run of the canonically mutated graph: bitwise for BFS and SSSP, within
f32 for PageRank (its delta tail and dense-block writes reassociate).  An
insert-only window then checks warm starts bitwise against a cold run, in
no more supersteps, and ``cache_entries()`` must not grow across the
batches.  A compaction round trip closes each cell.

  python -m repro_torch.launch.dynamic_selftest --world 2
      [--device cpu|cuda] [--scale 8] [--edge-factor 4] [--parts 4]
      [--seed 13] [--batches 3] [--batch-size 24]
      [--strategies rand high low] [--init file:///path/to/rendezvous]

``--world`` ranks are spawned (``launch/world.py``): NCCL with one card per
rank by default, gloo with ``--device cpu``.  With more than one rank the
matrix runs through ``DistributedBSPEngine`` (each rank holds its own
``DynamicGraph`` and applies the same batches; the sharded hybrid consumes
them by compaction); a world of one runs ``BSPEngine``.  Prints ``DYNAMIC
SELFTEST OK``.
"""
from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np


def _run_rank(group, scale: int, edge_factor: int, parts: int, seed: int,
              batches: int, batch_size: int, strategies) -> list:
    """One rank's share: every cell of the matrix; returns its lines."""
    from repro_torch.algorithms.bfs import bfs_batched, bfs_incremental
    from repro_torch.algorithms.pagerank import pagerank, pagerank_distributed
    from repro_torch.algorithms.sssp import sssp_batched, sssp_incremental
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.data.graphs import edge_stream

    dev = group.device
    distributed = group.world_size > 1
    g = G.rmat(scale, edge_factor, seed=seed).with_uniform_weights(seed=1)
    stream = edge_stream(g, batches, batch_size, churn=0.7, seed=seed)
    g_mut = G.apply_mutation_batches(g, stream)
    sources = [0, 3, 17, 91]
    pr = pagerank_distributed if distributed else pagerank
    backends = {"reference": dict(), "fused": dict(fused=True, block_e=256),
                "hybrid": dict(backend="hybrid")}
    lines = []
    for strategy in strategies:
        ref = BSPEngine(PT.partition(g_mut, parts, strategy), device=dev)
        want_bfs, _ = bfs_batched(ref, sources)
        want_sssp, _ = sssp_batched(ref, sources)
        want_pr = pagerank(ref, num_iterations=8)
        for name, kw in backends.items():
            dg = DynamicGraph(g, parts, strategy, device=dev,
                              mutation_capacity=4 * batch_size)
            eng = (DistributedBSPEngine(dg, group, **kw) if distributed
                   else BSPEngine(dg, device=dev, **kw))
            # the first runs' builds happen before the stream starts
            bfs_batched(eng, sources)
            sssp_batched(eng, sources)
            entries0 = eng.cache_entries()
            for mb in stream:
                dg.apply_mutations(mb)
            got_bfs, _ = bfs_batched(eng, sources)
            np.testing.assert_array_equal(got_bfs, want_bfs,
                                          err_msg=f"bfs {name} {strategy}")
            got_sssp, _ = sssp_batched(eng, sources)
            np.testing.assert_array_equal(got_sssp, want_sssp,
                                          err_msg=f"sssp {name} {strategy}")
            if not eng.dynamic_rebinds and not eng.hybrid_dyn_rebuilds:
                grown = eng.cache_entries() - entries0
                assert grown == 0, (name, strategy, grown)
            got_pr = pr(eng, num_iterations=8)
            np.testing.assert_allclose(got_pr, want_pr, rtol=1e-5,
                                       atol=1e-8)

            # monotone warm start from the current fixpoint
            mark = dg.mark()
            ins = edge_stream(dg.mutated_csr(), 1, batch_size, churn=1.0,
                              seed=seed + 7)[0]
            dg.apply_mutations(ins)
            dirty, monotone = dg.dirty_since(mark)
            assert monotone
            warm_bfs, wsteps = bfs_incremental(eng, got_bfs, dirty)
            cold_bfs, csteps = bfs_batched(eng, sources)
            np.testing.assert_array_equal(warm_bfs, cold_bfs)
            assert int(wsteps.max()) <= int(csteps.max()), (wsteps, csteps)
            warm_sssp, _ = sssp_incremental(eng, got_sssp, dirty)
            cold_sssp, _ = sssp_batched(eng, sources)
            np.testing.assert_array_equal(warm_sssp, cold_sssp)

            # compaction round trip: fold everything, rerun, same answer
            dg.compact()
            post_bfs, _ = bfs_batched(eng, sources)
            np.testing.assert_array_equal(post_bfs, cold_bfs)
        lines.append(f"{strategy:>4}: bfs/sssp/pagerank mutate-rerun parity "
                     f"+ warm start + compaction over {group.world_size} "
                     f"rank(s)")
        if group.rank == 0:
            print(lines[-1], flush=True)
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--edge-factor", type=int, default=4)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=24)
    ap.add_argument("--strategies", nargs="+", default=["rand", "high", "low"],
                    choices=("rand", "high", "low"))
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.parts % args.world:
        ap.error(f"--parts {args.parts} must divide over --world "
                 f"{args.world}")

    from repro_torch.launch.world import run_world

    # by module name, so the spawned ranks can import the target
    me = importlib.import_module("repro_torch.launch.dynamic_selftest")
    run_world(me._run_rank, args.world, device=args.device, init=args.init,
              timeout=args.timeout,
              args=(args.scale, args.edge_factor, args.parts, args.seed,
                    args.batches, args.batch_size, tuple(args.strategies)))
    print("DYNAMIC SELFTEST OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
