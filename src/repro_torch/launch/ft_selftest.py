"""Elastic checkpoint/restart self-test over worlds of ranks.

A chunked BFS carry snapshotted on a world of N ranks resumes on a world
of M ranks **bit for bit** (levels and per-query superstep counts),
because ``CheckpointManager`` stores every leaf whole and the sharded
engine takes the global state on every rank (``restore_resharded``).

  python -m repro_torch.launch.ft_selftest --world 4 --resume-world 2
      [--device cpu|cuda] [--ckpt DIR] [--scale 8] [--parts 4]
      [--queries 4] [--chunk 2] [--seed 0] [--timeout 600]

Three worlds run one after the other (``launch/world.py``: NCCL with one
card per rank by default, gloo with ``--device cpu``):

- the exchange world (``--world`` ranks) drills the checked exchange
  across the ranks: a chunked BFS window with ``exchange.payload`` armed
  raises ``ExchangeCorruption`` on every rank on the fused backend (the
  tagged partition exchange) and the hybrid one (the tagged compact
  exchange of the boundary slots), its count a multiple of the world size
  (every rank flips one element of what it sends), the caller's carry
  unchanged, and a clean rerun bit for bit the clean run;
- the snapshot world (``--world``) advances a BFS query batch by one
  chunk window on ``DistributedBSPEngine``, rank 0 saves the carry
  (``save_tree``), then every rank runs to the fixpoint and rank 0 saves
  the result as the reference;
- the resume world (``--resume-world``) restores the carry onto each
  rank's device, resumes the chunked run and checks the fixpoint and
  steps against the reference on every rank.

Prints ``FT SELFTEST OK``.  Port of ``repro.launch.ft_selftest``, whose two
modes are separate processes with forced host device counts; the exchange
world is the port's own.
"""
from __future__ import annotations

import argparse
import importlib
import re
import sys
import tempfile
from pathlib import Path

import numpy as np


def _build(group, scale: int, parts: int, queries: int, seed: int,
           backend: str = "fused"):
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import DistributedBSPEngine

    g = G.rmat(scale, 8, seed=seed)
    pg = PT.partition(g, parts, PT.HIGH)
    rng = np.random.default_rng(seed + 1)
    sources = rng.integers(0, g.num_vertices, size=(queries, 1))
    return pg, DistributedBSPEngine(pg, group, backend=backend), sources


def _exchange_rank(group, ckpt: str, scale: int, parts: int, queries: int,
                   chunk: int, seed: int) -> str:
    import torch

    from repro_torch.algorithms.bfs import BFS_PROGRAM, multi_source_state
    from repro_torch.runtime import ExchangeCorruption, FaultInjector, chaos

    tags = []
    for backend in ("fused", "hybrid"):
        pg, eng, sources = _build(group, scale, parts, queries, seed,
                                  backend)
        state = {"level": multi_source_state(pg, sources,
                                             device=eng.device)}
        before = state["level"].clone()
        clean, clean_steps, _ = eng.execute(BFS_PROGRAM, state, chunk=chunk)
        inj = FaultInjector(sites={"exchange.payload": [{"step": 0,
                                                         "flag": True}]})
        try:
            with chaos.active(inj):
                eng.execute(BFS_PROGRAM, state, chunk=chunk)
            raise RuntimeError(f"{backend}: a corrupted exchange escaped "
                               f"the tag check")
        except ExchangeCorruption as e:
            n = int(re.search(r"\((\d+) tag", str(e)).group(1))
        if n % group.world_size or not torch.equal(state["level"], before):
            raise RuntimeError(f"{backend}: {n} mismatched tags over a "
                               f"world of {group.world_size}, or the carry "
                               f"changed")
        again, steps, _ = eng.execute(BFS_PROGRAM, state, chunk=chunk)
        if not (torch.equal(again["level"], clean["level"])
                and torch.equal(steps, clean_steps)):
            raise RuntimeError(f"{backend}: the rerun after the corrupted "
                               f"window differs from the clean run")
        tags.append(f"{backend}={n}")
    return (f"FT EXCHANGE OK devices={group.world_size} "
            f"tags {' '.join(tags)}")


def _snapshot_rank(group, ckpt: str, scale: int, parts: int, queries: int,
                   chunk: int, seed: int) -> str:
    from repro_torch.algorithms.bfs import (BFS_PROGRAM, gather_batch,
                                            multi_source_state)
    from repro_torch.checkpoint import CheckpointManager

    pg, eng, sources = _build(group, scale, parts, queries, seed)
    state0 = {"level": multi_source_state(pg, sources, device=eng.device)}
    st, sq, info = eng.execute(BFS_PROGRAM, state0, chunk=chunk,
                               max_chunks=1)
    step = info["final_step"]
    if group.rank == 0:
        CheckpointManager(ckpt, keep=3).save_tree(
            step, {"state": st, "fin": info["finished"], "steps_q": sq},
            extra={"step": step, "devices": group.world_size},
            blocking=True)
    final, fsq, _ = eng.execute(BFS_PROGRAM, st, chunk=chunk,
                                start_step=step, fin=info["finished"],
                                steps_q=sq)
    if group.rank == 0:
        np.savez(Path(ckpt) / "final_reference.npz",
                 level=gather_batch(pg, final["level"]),
                 steps=fsq.cpu().numpy())
    return f"FT SNAPSHOT OK devices={group.world_size} step={step}"


def _resume_rank(group, ckpt: str, scale: int, parts: int, queries: int,
                 chunk: int, seed: int) -> str:
    from repro_torch.algorithms.bfs import BFS_PROGRAM, gather_batch
    from repro_torch.checkpoint import CheckpointManager, restore_resharded

    pg, eng, _ = _build(group, scale, parts, queries, seed)
    mgr = CheckpointManager(ckpt, keep=3)
    like = {"state": {"level": np.zeros((queries, parts, pg.v_max),
                                        np.float32)},
            "fin": np.zeros(queries, bool),
            "steps_q": np.zeros(queries, np.int32)}
    step, tree = restore_resharded(mgr, like, group)
    extra = mgr.manifest_extra(step)
    if step != extra["step"]:
        raise RuntimeError(f"snapshot step {step} != its manifest's "
                           f"{extra['step']}")
    final, sq, _ = eng.execute(BFS_PROGRAM, tree["state"], chunk=chunk,
                               start_step=step, fin=tree["fin"],
                               steps_q=tree["steps_q"])
    ref = np.load(Path(ckpt) / "final_reference.npz")
    if not np.array_equal(gather_batch(pg, final["level"]), ref["level"]):
        raise RuntimeError("resumed fixpoint differs from the reference of "
                           "the snapshot's world")
    if not np.array_equal(sq.cpu().numpy(), ref["steps"]):
        raise RuntimeError("per-query superstep counts differ after the "
                           "resume on another world")
    return (f"FT RESUME OK devices={extra['devices']}->{group.world_size} "
            f"step={step}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2,
                    help="ranks of the world that takes the snapshot")
    ap.add_argument("--resume-world", type=int, default=1,
                    help="ranks of the world that resumes it")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (a temporary one if unset)")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    for w in (args.world, args.resume_world):
        if args.parts % w:
            ap.error(f"--parts {args.parts} must divide over a world of {w}")

    from repro_torch.launch.world import run_world

    # by module name, so the spawned ranks can import the targets
    me = importlib.import_module("repro_torch.launch.ft_selftest")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = args.ckpt or tmp
        common = (ckpt, args.scale, args.parts, args.queries, args.chunk,
                  args.seed)
        for target, world in ((me._exchange_rank, args.world),
                              (me._snapshot_rank, args.world),
                              (me._resume_rank, args.resume_world)):
            lines = run_world(target, world, device=args.device,
                              timeout=args.timeout, args=common)
            print(lines[0], flush=True)
    print("FT SELFTEST OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
