"""Direction-optimized traversal parity self-test over a world of ranks:
BFS, SSSP and CC through ``DistributedBSPEngine`` on every backend with
``direction`` forced to ``"push"``, forced to ``"pull"`` and voted
(``"auto"``), each against single-device push, bit for bit.

Direction is a choice of work only for min combines (push and pull reduce
the same values per destination), so every cell must agree exactly; every
run must also report live ``last_direction_stats`` (edges examined > 0 for
every query) and no switches under a forced direction.

  python -m repro_torch.launch.direction_selftest --world 2
      [--device cpu|cuda] [--scale 8] [--edge-factor 4] [--parts 4]
      [--seed 13] [--init file:///path/to/rendezvous]

``--world`` ranks are spawned (``launch/world.py``): NCCL with one card per
rank by default, gloo with ``--device cpu``; a world of one runs the
sharded engine in one process.  Prints ``DIRECTION SELFTEST OK``.
"""
from __future__ import annotations

import argparse
import importlib
import sys

import numpy as np


def _run_rank(group, scale: int, edge_factor: int, parts: int,
              seed: int) -> list:
    """One rank's share: the backend x direction matrix; returns its
    lines."""
    from repro_torch.algorithms.bfs import bfs_batched
    from repro_torch.algorithms.cc import connected_components, symmetrize
    from repro_torch.algorithms.sssp import sssp_batched
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine

    dev = group.device
    g = G.rmat(scale, edge_factor, seed=seed).with_uniform_weights(seed=1)
    gs = symmetrize(G.rmat(scale, edge_factor, seed=seed))
    pg = PT.partition(g, parts, PT.HIGH)
    pgs = PT.partition(gs, parts, PT.HIGH)
    sources = [0, 3, 11]
    backends = {"reference": dict(), "fused": dict(fused=True, block_e=256),
                "hybrid": dict(backend="hybrid")}

    # single-device push baselines
    base = BSPEngine(pg, direction="push", device=dev)
    want_bfs, _ = bfs_batched(base, sources)
    want_sssp, _ = sssp_batched(base, sources)
    want_cc, _ = connected_components(BSPEngine(pgs, direction="push",
                                                device=dev))
    lines = []
    for bname, kw in backends.items():
        for direction in ("push", "pull", "auto"):
            eng = DistributedBSPEngine(pg, group, direction=direction, **kw)
            got_bfs, _ = bfs_batched(eng, sources)
            np.testing.assert_array_equal(want_bfs, got_bfs,
                                          err_msg=f"bfs {bname} {direction}")
            st = eng.last_direction_stats
            assert st is not None and (st["edges_examined"] > 0).all(), \
                (bname, direction, st)
            if direction != "auto":
                assert (st["switches"] == 0).all(), (bname, direction, st)
            got_sssp, _ = sssp_batched(eng, sources)
            np.testing.assert_array_equal(
                want_sssp, got_sssp, err_msg=f"sssp {bname} {direction}")
            ec = DistributedBSPEngine(pgs, group, direction=direction, **kw)
            got_cc, _ = connected_components(ec)
            np.testing.assert_array_equal(want_cc, got_cc,
                                          err_msg=f"cc {bname} {direction}")
        lines.append(f"{bname:>9}: bfs/sssp/cc push==pull==auto over "
                     f"{group.world_size} rank(s)")
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
    ap.add_argument("--init", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.parts % args.world:
        ap.error(f"--parts {args.parts} must divide over --world "
                 f"{args.world}")

    from repro_torch.launch.world import run_world

    # by module name, so the spawned ranks can import the target
    me = importlib.import_module("repro_torch.launch.direction_selftest")
    run_world(me._run_rank, args.world, device=args.device, init=args.init,
              timeout=args.timeout,
              args=(args.scale, args.edge_factor, args.parts, args.seed))
    print(f"DIRECTION SELFTEST OK ({args.world} rank(s))", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
