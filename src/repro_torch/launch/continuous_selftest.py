"""Continuous-batching parity self-test on ``DistributedBSPEngine``.

One resident session per backend (fused and hybrid) serves a
mixed-convergence stream of 4x its slot count over a world of ranks:
converged slots are harvested at chunk boundaries (the finished votes are
the global AND) and refilled from the queue.  Every completed query must
be **bitwise** equal to the single-device drain-batch reference, with
zero retraces after warm-up and every slot refilled at least once.

  python -m repro_torch.launch.continuous_selftest --world 2
      [--device cpu|cuda] [--scale 8] [--edge-factor 4] [--parts 4]
      [--seed 13] [--batch 4] [--alg bfs sssp]
      [--init file:///path/to/rendezvous] [--out results.npz]

``--world`` ranks are spawned (``launch/world.py``): NCCL with one card per
rank by default, gloo with ``--device cpu``.  Every rank runs the same
session on the global state and checks it.  ``--out`` saves rank 0's
results (the stream and, per backend and algorithm, the completions in
submit order) as ``.npz``.  Prints ``CONTINUOUS SELFTEST OK``.
"""
from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np


def _run_rank(group, scale: int, edge_factor: int, parts: int, seed: int,
              batch: int, algs) -> dict:
    """One rank's share of the self-test; rank 0 returns the results."""
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine
    from repro_torch.runtime import ServeSession, drain_reference

    g = G.rmat(scale, edge_factor, seed=seed).with_uniform_weights(seed=1)
    pg = PT.partition(g, parts, PT.HIGH)
    rng = np.random.default_rng(seed)
    deg = g.out_degrees()
    # mixed convergence by construction: hub + fringe + random sources
    # converge at very different supersteps, so slots free asymmetrically
    stream = np.concatenate([
        [int(np.argmax(deg)), int(np.argmin(deg))],
        rng.integers(0, g.num_vertices, size=4 * batch - 2)])
    ref = BSPEngine(pg, device=group.device)
    out = {"stream": stream}
    for name, backend in (("dist_fused", "fused"), ("dist_hybrid", "hybrid")):
        eng = DistributedBSPEngine(pg, group, backend=backend)
        for alg in algs:
            want = drain_reference(ref, alg, stream, batch)
            session = ServeSession(eng, alg, slots=batch, chunk=2)
            qids = session.submit(stream)
            rep = session.drain()
            results = {r["query"]: r["result"] for r in session.poll()}
            assert len(results) == len(stream), (len(results), len(stream))
            got = np.stack([results[q] for q in qids])
            np.testing.assert_array_equal(got, want)       # bitwise
            assert rep["refills"] == len(stream) - batch, rep
            assert rep["min_slot_refills"] >= 1, rep
            assert rep["retraces"] == 0, rep
            out[f"{name}/{alg}"] = got
            if group.rank == 0:
                print(f"{name} {alg}: {len(stream)} queries through {batch} "
                      f"resident slots over {group.world_size} rank(s) — "
                      f"refills={rep['refills']} "
                      f"(min/slot={rep['min_slot_refills']}), "
                      f"retraces={rep['retraces']}, bitwise parity",
                      flush=True)
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
    ap.add_argument("--alg", nargs="+", default=["bfs", "sssp"],
                    choices=("bfs", "sssp"))
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.parts % args.world:
        ap.error(f"--parts {args.parts} must divide over --world "
                 f"{args.world}")

    from repro_torch.launch.world import run_world

    # by module name, so the spawned ranks can import the target
    me = importlib.import_module("repro_torch.launch.continuous_selftest")
    results = run_world(me._run_rank, args.world, device=args.device,
                        init=args.init, timeout=args.timeout,
                        args=(args.scale, args.edge_factor, args.parts,
                              args.seed, args.batch, tuple(args.alg)))
    if args.out:
        np.savez(args.out, **results[0])
    print("CONTINUOUS SELFTEST OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
