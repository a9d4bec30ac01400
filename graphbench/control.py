#!/usr/bin/env python3
"""The precision control of a cell: the plain reference computed in TF32
(the precision below the configurations' float32 with TF32 off) put in the
program's place, judged by the cell's own comparison and limits.

    python3 graphbench/control.py --workload <cell> --seeds 1,2,3

For each seed it draws the cell's graph on the card and the roots of the
window's first calls that a run of that seed makes (as many as it keeps of
each slot), and prints one JSON
line: the numbers compared, each with its limit, and whether the control
came out correct (it should not).  The program is not run: the benchmark's
runs give its readings.  ``graphbench/tests/test_graphbench_reference.py``
holds the same control at scale 10 on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def control_reading(root: Path, workload: str, seed: int, device) -> dict:
    """The control's readings of one seed: ``{"correct", "checks"}``."""
    import torch

    from gblib import generators, reference, registry

    bench = registry.load_benchmark(root)
    cell = registry.find(bench["workloads"], workload, "cell")
    cfg = registry.config(root, bench, cell["config"])
    traffic = registry.traffic(root, cell["traffic"])
    driver = registry.driver(root, traffic["driver"])
    graph = generators.make_graph(cfg, cfg["graph_seed"], device)
    deg = torch.bincount(graph["src"], minlength=graph["n"]).cpu()
    host = {"n": graph["n"], "out_deg": deg.numpy(),
            "graph_seed": cfg["graph_seed"],
            "candidates": torch.nonzero(
                deg >= int(traffic["root_min_out_degree"])
            ).flatten().numpy()}
    client = driver.Client(traffic, seed, host)
    # the rows a run keeps when its window makes ``per_slot`` calls
    client.sample = [[(int(client.roots(i)[slot]), None)
                      for i in range(client.per_slot)]
                     for slot in range(client.q)]
    checks = client.check(reference, graph, control=True)
    return {"correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = control_reading(ROOT, args.workload, seed,
                              torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
