#!/usr/bin/env python3
"""Trace the fused backend's supersteps on the card: how much of a call's
wall the device is busy, and with what.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 scripts/superstep_trace.py``.  At the main path's shapes (RMAT20,
P=2, HIGH, ``block_e=1024``) it runs each program once to warm up, then
under ``torch.profiler`` (CPU and CUDA activities): ``pagerank`` (20
supersteps, no convergence test) and ``bfs_batched`` (Q=8, push only, so
one fused launch per superstep).  For each it prints one JSON line: the
wall of a run without the profiler and of the traced run (host clock,
ending in ``torch.cuda.synchronize``; the profiler's own host cost is in
the second), the supersteps,
the device time summed over every kernel the trace holds, the device busy
share (that sum over the wall; kernels do not overlap on one stream), the
kernel launches, and the five kernels with the most device time (name,
launches, total ms).  Then the card's name and power limit.
"""
from __future__ import annotations

import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import BLOCK_E, PR_ITERS, Q, SEED  # noqa: E402
from repro_torch.configs.totem_rmat import RMAT_MEDIUM  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import partition as PT  # noqa: E402
from repro_torch.core.bsp import BSPEngine  # noqa: E402


def traced(name, run) -> dict:
    """One warm run of ``run`` under the profiler, summarised."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(ev.name, (0, 0.0))
            kernels[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    device_ms = sum(us for _, us in kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    return {"program": name, "wall_untraced_ms": untraced * 1e3,
            "wall_ms": wall * 1e3, "supersteps": steps,
            "device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "launches": sum(n for n, _ in kernels.values()),
            "top": [{"kernel": k[:80], "launches": n, "ms": us / 1e3}
                    for k, (n, us) in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 2
    algos = importlib.import_module("repro_torch.algorithms")
    g = G.rmat(RMAT_MEDIUM.scale, RMAT_MEDIUM.edge_factor, seed=SEED)
    pg = PT.partition(g, 2, PT.HIGH)
    eng = BSPEngine(pg, backend="fused", block_e=BLOCK_E,
                    direction_switch=False)
    sources = np.random.default_rng(SEED).choice(g.num_vertices, size=Q,
                                                 replace=False)

    def pagerank():
        algos.pagerank(eng, PR_ITERS)
        return PR_ITERS

    def bfs():
        _, steps = algos.bfs_batched(eng, sources)
        return int(np.max(steps))

    for name, run in (("pagerank", pagerank), ("bfs_batched", bfs)):
        print(json.dumps(traced(name, run)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
