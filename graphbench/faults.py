#!/usr/bin/env python3
"""The contract's faults, planted in the program under a whole run of a cell.

    python3 graphbench/faults.py --workload <cell> --faults unchanged,half,altered \
        --seeds 1,2,3 --seconds 3

For each fault and seed it drives ``run.py``'s whole run of the cell in this
process, at the cell's own size on the card, with the timed path broken
underneath, and prints one JSON line: the fault, the seed, whether the run
came out correct (it should not) and the numbers compared, each with its
limit.  The faults:

- ``unchanged``: every hybrid superstep returns its state unchanged and
  votes every query finished;
- ``half``: the entry computes the first half of the batch only and hands
  back the other half's rows as they start (the root at 0, the rest
  unreached);
- ``altered``: one value of every answer moves by one float32 step as the
  entries' ``gather_batch`` hands it back.

One card runs no exchange between cards, so that fault has no place here.
``tests/test_graphbench_faults.py`` plants the same faults at scale 8 on the
CPU.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import io
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FAULTS = ("unchanged", "half", "altered")


def _unchanged(program, cfg, arrs, state, step):
    v = next(iter(state.values()))
    return state, v.new_ones(v.shape[0], dtype=bool)


def _half(real):
    def half(engine, roots):
        keep = len(roots) // 2
        res, steps = real(engine, roots[:keep])
        out = np.full((len(roots), res.shape[1]), np.inf, np.float32)
        out[:keep] = res
        out[np.arange(keep, len(roots)), roots[keep:]] = 0.0
        return out, np.concatenate([steps, steps])[:len(roots)]
    return half


def _altered(real):
    def gather(pg, per_part):
        out = real(pg, per_part).copy()
        for row in out:
            hit = np.flatnonzero(np.isfinite(row) & (row > 0))
            if len(hit):
                row[hit[0]] = np.nextafter(row[hit[0]], np.float32(4))
        return out
    return gather


@contextlib.contextmanager
def plant(fault: str, entry: str):
    """Plant ``fault`` in the program for the ``with`` block; ``entry`` is
    the traffic's entry (``sssp_batched`` or ``bfs_batched``)."""
    algos = importlib.import_module("repro_torch.algorithms")
    bsp = importlib.import_module("repro_torch.core.bsp")
    # the package re-exports functions named like these modules
    bfs, sssp = (importlib.import_module(f"repro_torch.algorithms.{m}")
                 for m in ("bfs", "sssp"))
    if fault == "unchanged":
        patches = [(bsp, "_superstep_hybrid", _unchanged)]
    elif fault == "half":
        patches = [(algos, entry, _half(getattr(algos, entry)))]
    elif fault == "altered":
        gather = _altered(bfs.gather_batch)
        patches = [(bfs, "gather_batch", gather),
                   (sssp, "gather_batch", gather)]
    else:
        raise KeyError(f"no fault named {fault!r}; the faults: {FAULTS}")
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    from gblib import registry

    bench = registry.load_benchmark(ROOT)
    cell = registry.find(bench["workloads"], args.workload, "cell")
    entry = registry.traffic(ROOT, cell["traffic"])["entry"]
    spec = importlib.util.spec_from_file_location("graphbench_run",
                                                  HERE / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            out = io.StringIO()
            t = time.perf_counter()
            with plant(fault, entry), contextlib.redirect_stdout(out):
                rc = run.main(["--workload", args.workload, "--seed",
                               str(seed), "--seconds", str(args.seconds),
                               "--trace", "0"], t_start=t)
            lines = out.getvalue().strip().splitlines()
            result = json.loads(lines[-1]) if rc == 0 and lines else {}
            print(json.dumps({"workload": args.workload, "fault": fault,
                              "seed": seed, "rc": rc,
                              "correct": result.get("correct"),
                              "checks": result.get("checks"),
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
