#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 graphbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA card(s) the cell
asks for.  The run draws its graph on the card from the configuration (and
its fixed graph seed), hands the same edge list to the program (``repro_torch``: CSR
build, partition, the engine and its split, through the public path) and
keeps a copy for the plain reference, warms the cell's own entry, then
drives the measured window as one closed-loop client for ``--seconds``, in
an order of the mix's work drawn from ``--seed``.
Once the window has closed and the program's state is freed, it compares a
sample of the window's answers (drawn from the seed) with the plain
reference (``gblib/reference.py``).  Earlier lines (standard error) give
the card, the set-up pieces, the hybrid plan, the peak memory, the
supersteps and the kernels' launches; the numbers compared, each beside its
limit, are the last lines on standard error; the last line on standard
output is the result as one JSON object.  With ``--trace 1`` the window runs
under ``torch.profiler`` and the result holds the per-layer metrics, the
device's busy seconds and a breakdown; with ``--trace 0`` the end-to-end
metrics.

Exit codes: 0 with a result; 2 without the card, the program or a cell;
3 when the JAX package or JAX is loaded in this process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that may not be loaded when the window closes: the
# JAX package (``src/repro``) and JAX itself.  Compared whole, so the port,
# ``repro_torch``, is not among them.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
CACHE_DIR = ".graphbench_cache"


def log(*parts) -> None:
    print("[graphbench]", *parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi: {out.stderr.strip()}"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def set_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    (The program's own kernels build under
    ``src/repro_torch/kernels/build/``, inside it too.)"""
    base = root / CACHE_DIR
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def main(argv=None, *, root: Path = ROOT, device=None,
         t_start: float = T_START) -> int:
    args = parse(argv)
    root = Path(root)
    set_caches(root)
    sys.path.insert(0, str(root / "graphbench"))
    from gblib import generators, reference, registry, trace

    try:
        bench = registry.load_benchmark(root)
        cell = registry.find(bench["workloads"], args.workload, "cell")
        cfg = registry.config(root, bench, cell["config"])
        traffic = registry.traffic(root, cell["traffic"])
        driver = registry.driver(root, traffic["driver"])
        section = "per_layer" if args.trace else "end_to_end"
        wanted = registry.cell_metrics(bench, section, cell["name"])
        readers = {m["name"]: registry.metric_reader(root, m["name"])
                   for m in wanted}
    except (OSError, KeyError, ValueError) as exc:
        log(f"FAIL: cannot find the cell's pieces: {exc}")
        return 2

    import torch

    if device is None:
        if not torch.cuda.is_available():
            log("FAIL: torch.cuda.is_available() is False; the benchmark "
                "runs on a CUDA card")
            return 2
        if torch.cuda.device_count() < int(cell["chips"]):
            log(f"FAIL: the cell asks for {cell['chips']} cards, "
                f"{torch.cuda.device_count()} present")
            return 2
        device = torch.device("cuda", 0)
    device = torch.device(device)
    on_card = device.type == "cuda"
    sys.path.insert(0, str(root / "src"))
    try:
        from repro_torch.core import graph as G
        from repro_torch.core import partition as PT
        from repro_torch.core.bsp import BSPEngine
        from repro_torch.kernels import (_build, bottomup, dense_spmv,
                                         ell_spmv, fused_superstep)
    except ImportError as exc:
        log(f"FAIL: the program (src/repro_torch) is not in this checkout: "
            f"{exc}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if on_card:
        log(f"card: {card_info()}; {torch.cuda.get_device_name(device)}; "
            f"torch {torch.__version__} cuda {torch.version.cuda}")
    eng = cfg["engine"]
    setup = {}

    # -- set-up: graph, program, split, warm-up ------------------------------
    t = time.perf_counter()
    graph = generators.make_graph(cfg, cfg["graph_seed"], device)
    n = graph["n"]

    def host_copy(x):
        return x.detach().to("cpu", copy=True)

    ref_host = {k: host_copy(graph[k]) for k in ("src", "dst", "weight")}
    src_h, dst_h = host_copy(graph["src"]).numpy(), host_copy(
        graph["dst"]).numpy()
    w_h = host_copy(graph["weight"]).numpy()
    out_deg = torch.bincount(graph["src"], minlength=n).cpu()
    min_deg = int(traffic["root_min_out_degree"])
    host = {"n": n, "out_deg": out_deg.numpy(), "graph_seed": cfg["graph_seed"],
            "candidates": torch.nonzero(out_deg >= min_deg).flatten().numpy()}
    del graph
    if on_card:
        torch.cuda.synchronize(device)
    setup["generate_s"] = time.perf_counter() - t

    t = time.perf_counter()
    g = G.from_edge_list(src_h, dst_h, n, weights=w_h)
    pg = PT.partition(g, int(eng["num_parts"]), eng["strategy"],
                      include_reverse=bool(eng["include_reverse"]))
    del src_h, dst_h, w_h
    setup["partition_s"] = time.perf_counter() - t

    t = time.perf_counter()
    engine = BSPEngine(pg, backend=eng["backend"],
                       hybrid_k_dense=eng["hybrid_k_dense"],
                       direction_switch=bool(eng["direction_switch"]),
                       device=device)
    splits = [engine.hybrid_for(p) for p in driver.programs(traffic, n)]
    if on_card:     # load the pull stages' libraries (nvcc at the first run)
        for lib in (bottomup, dense_spmv):
            _build.load(lib.SOURCE)
        torch.cuda.synchronize(device)
    setup["split_s"] = time.perf_counter() - t
    hcfg, arrs = splits[0]
    shapes = {"n": n, "e": int(g.num_edges),
              "rows": int(arrs["row_ptr"].numel()) - 1,
              "nnz": int(arrs["col"].numel()), "k_dense": int(hcfg.k_dense),
              "semiring": hcfg.semiring, "uniform": bool(hcfg.uniform),
              "q": int(traffic["roots_per_batch"])}
    plan = engine.hybrid_plan()
    chosen = next(r for r in plan["table"] if r["k_dense"] == plan["k_dense"])
    del splits, arrs

    client = driver.Client(traffic, args.seed, host)
    t = time.perf_counter()
    client.warmup(engine)
    if on_card:
        torch.cuda.synchronize(device)
    setup["warmup_s"] = time.perf_counter() - t
    setup["setup_s"] = time.perf_counter() - t_start
    log(f"set-up {setup['setup_s']:.3f} s: generate "
        f"{setup['generate_s']:.3f}, CSR + partition "
        f"{setup['partition_s']:.3f}, engine + split {setup['split_s']:.3f}, "
        f"warm-up {setup['warmup_s']:.3f}; V={n} E={shapes['e']}")
    log(f"hybrid plan: k_dense={plan['k_dense']} mode={plan['mode']} "
        f"e_dense={chosen['e_dense']} e_sparse={chosen['e_sparse']}; split "
        f"{shapes['semiring']} rows={shapes['rows']} nnz={shapes['nnz']}")

    # -- the measured window -------------------------------------------------
    counters = {"ell_spmv": ell_spmv.ell_spmv,
                "dense_spmv": dense_spmv.dense_spmv,
                "dense_spmv_minplus": dense_spmv.dense_spmv_minplus,
                "bottomup_scan": bottomup.bottomup_scan,
                "fused_superstep": fused_superstep.fused_superstep}
    for fn in counters.values():
        fn.launches = 0
    summary = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            rec = client.window(engine, args.seconds,
                                span=lambda: record_function(trace.CALL_MARK))
            if on_card:
                torch.cuda.synchronize(device)
        t = time.perf_counter()
        summary = trace.from_profiler(prof)
        del prof
        log(f"trace read in {time.perf_counter() - t:.3f} s")
    else:
        rec = client.window(engine, args.seconds)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    leaked = forbidden_modules()
    if leaked:
        log(f"FAIL: modules of JAX or the JAX package are loaded: {leaked}")
        return 3
    steps = rec["steps"]
    log(f"window {rec['seconds']:.3f} s: {rec['calls']} calls, "
        f"{rec['queries']} queries, {rec['supersteps']} supersteps "
        f"(per call {sorted(steps)[:1]}..{sorted(steps)[-1:]}), calls' walls "
        f"{sum(rec['walls']):.3f} s, client {rec['client_s']:.3f} s")
    walls_ms = [round(1e3 * w, 1) for w in rec["walls"]]
    log(f"calls' walls ms: first {walls_ms[:3]}, median "
        f"{sorted(walls_ms)[len(walls_ms) // 2]}, last {walls_ms[-1:]}")
    log(f"launches in the window: {launches}")
    log(f"peak device memory {peak} bytes")

    # -- free the program, then the plain reference --------------------------
    del engine, pg, g
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref_graph = {"n": n, **{k: v.to(device) for k, v in ref_host.items()}}
    checks = client.check(reference, ref_graph)
    log(f"reference check {time.perf_counter() - t:.3f} s")
    correct = all(value <= limit for value, limit in checks.values())

    # a CPU run's profile is no device metric's source
    run = {"cell": cell["name"], "config": cfg, "traffic": traffic,
           "setup": setup, "window": rec, "launches": launches,
           "shapes": shapes, "trace": summary if on_card else None}
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card
           else device.type, "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": rec["queries"], "failed": 0,
           "metrics": metrics, "device": dev}
    if args.trace:
        if summary is None or (on_card and summary["busy_s"] <= 0):
            log("FAIL: the trace holds no device operation in the window")
            return 2
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v} (limit {lim})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
