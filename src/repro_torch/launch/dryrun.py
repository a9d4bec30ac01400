"""Multi-pod dry run on DTensor: every (architecture × input shape) cell on
the production meshes, without the chips.

The counterpart of ``repro/launch/dryrun.py``.  Each cell makes a fake
process group of 256 (single pod, ``(16, 16)`` over ``("data",
"model")``) or 512 ranks (multi pod, ``(2, 16, 16)``), builds parameters,
AdamW state, the batch and a decode step's cache as fake DTensors laid out
by ``launch/sharding.py``'s specs (FakeTensorMode: nothing is allocated),
and runs one train step, prefill or decode step under
``activation_rules``, as rank 0 of the world.  ``collectives.LocalCounter``
counts what that rank runs below DTensor: operations, collective operand
bytes by kind and live bytes.  One JSON record a cell, with JAX's keys:
``memory_analysis`` (per-rank ``argument_bytes``, ``output_bytes``,
``alias_bytes`` (outputs written into the arguments: a decode step's
cache), ``temp_bytes`` (the peak of live bytes the step made) and
``peak_estimate_gib``), ``cost_analysis_raw`` (per-rank ``flops``, and
``bytes_accessed`` summed over the ops), ``collective_bytes`` and the
``roofline`` of ``launch/calculator.py``, given the step's collective
bytes summed over every rank (JAX's dry run passes its per-device count
divided by the chips, which ``analyze`` divides again).  ``lower_s`` and
``compile_s`` become ``trace_s``.

xlstm-125m's prefill replays its decode step token by token (the JAX
model's algorithm): one step is traced and its counts scaled by the tokens
(``replayed_steps``), as JAX's ``_depth_multipliers`` scale its ``ssm``
prefill.  ``--device`` (``cuda`` by default) is the type of the fake
tensors: the card's, or ``cpu`` on a machine without one (where DTensor's
collectives differ: a CPU group gathers in place of an all-to-all).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-67b \
      --shape train_4k --mesh single --out experiments/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] \
      [--jobs 8]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table

``--all`` runs each cell in a fresh subprocess (one failing cell cannot
kill the sweep) and skips cells whose record is already ``ok``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.launch import calculator
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.launch.collectives import LocalCounter
from repro_torch.models import api
from repro_torch.models.common import ArchConfig, opt_enabled, serving
from repro_torch.optim.adamw import AdamW, AdamWState

SHAPES = list(api.SHAPES)
MESHES = {"single": False, "multi": True}
_cache_specs = shd.cache_specs


def should_skip(cfg: ArchConfig, shape_name: str) -> str:
    """Spec-mandated skips, recorded (not silently dropped)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return ("skipped: long_500k needs sub-quadratic attention; "
                f"{cfg.name} is pure full-attention (DESIGN.md §4)")
    return ""


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks (this process is rank 0):
    collectives return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_tree(tree, specs, mesh, device):
    """A tree of uninitialised DTensors shaped like ``tree``'s leaves."""
    if isinstance(tree, dict):
        return {k: _fake_tree(tree[k], specs[k], mesh, device) for k in tree}
    return shd.empty_dtensor(tree.shape, tree.dtype, specs, mesh, device)


def _storages(tree) -> Dict[int, int]:
    """``{storage: bytes}`` of the local tensors in ``tree`` (nested dicts,
    tuples, modules' parameters, tensors, DTensors)."""
    out: Dict[int, int] = {}

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.nn.Module):
            for v in x.parameters():
                walk(v)
        elif isinstance(x, torch.Tensor):
            t = x.to_local() if isinstance(x, DTensor) else x
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()

    walk(tree)
    return out


def _memory(args, outs, counter: LocalCounter) -> dict:
    a, o = _storages(args), _storages(outs)
    return {"argument_bytes": sum(a.values()),
            "output_bytes": sum(o.values()),
            "alias_bytes": sum(n for k, n in o.items() if k in a),
            "temp_bytes": counter.peak}


def period(cfg: ArchConfig) -> int:
    """Layers in one repeat of the stack's pattern: a hybrid's group
    (``attn_every``), gemma3's local:global cycle, xLSTM's sLSTM cycle;
    else 1."""
    if cfg.family == "hybrid":
        return cfg.attn_every
    if cfg.local_global_ratio and cfg.local_window:
        return cfg.local_global_ratio + 1
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.slstm_every
    return 1


def traced_depths(cfg: ArchConfig) -> list:
    """The depths a cell is traced at: one and two periods, and one period
    plus the remainder when the depth is not a whole number of periods;
    the depth itself when it is at most two periods."""
    p, n = period(cfg), cfg.n_layers
    if n <= 2 * p:
        return [n]
    return [p, 2 * p] + ([p + n % p] if n % p else [])


def extrapolate(depths: list, values: list, n_layers: int) -> float:
    """``values`` traced at ``depths`` (``traced_depths``) carried to
    ``n_layers``: the first, plus the increment of a period for each
    further whole period, plus the remainder's increment.  Exact for
    counts that grow by the same amount each period."""
    if len(depths) == 1:
        return values[0]
    p = depths[0]
    out = values[0] + (n_layers // p - 1) * (values[1] - values[0])
    if len(depths) == 3:
        out += values[2] - values[0]
    return out


def _trace(cfg: ArchConfig, shape: api.ShapeSpec, mesh, device: str,
           whole: bool) -> dict:
    """One traced step of ``cfg`` (its depth as given): the counter's
    numbers, the memory record and the trace's seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    seq = opt_enabled("seq_shard")
    with FakeTensorMode(allow_non_fake_inputs=True):
        args, run, steps = _build_cell(cfg, shape, mesh, device, whole)
        counter = LocalCounter()
        t0 = time.time()
        with counter, shd.activation_rules(mesh, seq_sharded=seq):
            outs = run(counter)
        out = {"trace_s": time.time() - t0, "steps": steps,
               **_memory(args, outs, counter), **counter.summary()}
        del outs
    return out


def run_cell(arch_id: str, shape_name: str, mesh_name: str,
             device: str = "cuda", *, cfg: Optional[ArchConfig] = None,
             shape: Optional[api.ShapeSpec] = None,
             mesh_shape=None, whole: bool = False) -> dict:
    """One cell's record.  ``cfg``, ``shape`` and ``mesh_shape`` (a
    ``(data, model)`` pair) replace the registry's config, the shape and
    the production mesh (tests).  A deep stack is traced at
    ``traced_depths`` and carried to its depth by ``extrapolate``, and a
    train step at one microbatch (``B / microbatches`` rows) counted for
    all of them (``microbatch_scale``); ``whole`` traces the step as it
    is: every layer and microbatch."""
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "ok": False, "opts": os.environ.get("REPRO_OPTS", ""),
           "device": device}
    t0 = time.time()
    if arch_id == "totem-rmat":
        return run_graph_cell(shape_name, mesh_name, rec, device)

    base = cfg or configs.get(arch_id)
    cfg = base
    shape = shape or api.SHAPES[shape_name]
    if opt_enabled("serve_bf16") and shape.kind != "train":
        # serving stores bf16 weights: the norms kept in the parameter
        # dtype turn bf16 too (the port's serving weights are bf16 already)
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    skip = should_skip(cfg, shape_name)
    if skip:
        rec.update(ok=True, skipped=skip)
        return rec

    if mesh_shape is not None:
        chips = math.prod(mesh_shape)
    else:
        chips = 512 if MESHES[mesh_name] else 256
    rec["chips"] = chips
    depths = [cfg.n_layers] if whole else traced_depths(cfg)
    with fake_world(chips):
        if mesh_shape is not None:
            mesh = M.make_local_mesh(*mesh_shape, device=device)
        else:
            mesh = M.make_production_mesh(multi_pod=MESHES[mesh_name],
                                          device=device)
        traces = [_trace(dataclasses.replace(cfg, n_layers=d), shape, mesh,
                         device, whole) for d in depths]

    def total(get):
        return extrapolate(depths, [get(t) for t in traces], cfg.n_layers)

    mem = {k: int(round(total(lambda t: t[k])))
           for k in ("argument_bytes", "output_bytes", "alias_bytes",
                     "temp_bytes")}
    mem["peak_estimate_gib"] = round(
        (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30, 3)
    rec["memory_analysis"] = mem
    rec["trace_s"] = round(sum(t["trace_s"] for t in traces), 2)
    rec["cost_analysis_raw"] = {
        k: total(lambda t: t[k])
        for k in ("flops", "matmul_flops", "bytes_accessed")}
    cb = {k: total(lambda t: t["collective_bytes"][k])
          for k in traces[0]["collective_bytes"]}
    rec["collective_bytes"] = cb
    kinds = sorted({k for t in traces for k in t["collective_calls"]})
    rec["collective_calls"] = {
        k: int(round(total(lambda t: t["collective_calls"].get(k, 0))))
        for k in kinds}
    steps = traces[0]["steps"]
    rec["collective_by_depth"] = {"depth0": cb["total"]}
    rec["depth_multipliers"] = [steps]
    rec["layers"] = cfg.n_layers
    rec["traced_depths"] = depths
    if shape.kind == "train" and not whole:
        rec["microbatch_scale"] = cfg.microbatches
    if steps > 1:
        rec["replayed_steps"] = steps
    roof = calculator.analyze(base, shape, chips,
                              ici_bytes_measured=cb["total"] * chips
                              if cb["total"] else None)
    rec["roofline"] = roof.as_dict()
    rec["ok"] = True
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def _rows_spec(x, mesh) -> tuple:
    """A microbatch's rows over the data axes that divide them, the leading
    ones (pod first) dropped until they do: the layout
    ``dist.split_rows`` gives each microbatch of the whole batch."""
    axes = shd.fsdp_axes(mesh)
    sizes = shd.axis_sizes(mesh)
    while axes and x.shape[0] % math.prod(sizes[a] for a in axes):
        axes = axes[1:]
    first = (axes[0] if len(axes) == 1 else tuple(axes)) if axes else None
    return (first,) + (None,) * (len(x.shape) - 1)


def _build_cell(cfg: ArchConfig, shape: api.ShapeSpec, mesh, device,
                whole: bool = True):
    """The cell's arguments (fake DTensors), the function that runs its
    step given the counter, and the steps its counts stand for.  A train
    step not ``whole`` takes one microbatch's rows and counts its
    gradients ``cfg.microbatches`` times."""
    b, s = shape.batch, shape.seq
    if shape.kind == "train":
        n_mb = cfg.microbatches
        full = api.input_specs(cfg, shape)
        if not whole:
            shape = dataclasses.replace(shape, batch=b // n_mb)
        specs = api.input_specs(cfg, shape)
        model = api.build(cfg, "meta", serve=False)
        pshape = model.params_shape()
        pspecs = shd.param_specs(pshape, mesh)
        params = _fake_tree(pshape, pspecs, mesh, device)
        opt = AdamW()
        state = AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=_fake_tree(pshape, pspecs, mesh, device),
            nu=_fake_tree(pshape, pspecs, mesh, device))
        bspecs = (shd.batch_specs(specs, mesh) if whole
                  else shd.tree_map_specs(lambda x: _rows_spec(x, mesh),
                                          specs))
        batch = _fake_tree(specs, bspecs, mesh, device)
        if whole:
            step = api.make_train_step(model, opt)
            return ((params, state, batch),
                    lambda c: step(params, state, batch), 1)
        def run(counter):
            # one microbatch's gradient pass counted n_mb times, then AdamW
            counter.scale = n_mb
            grads, losses = api.accumulate_grads(model, params, batch, 1)
            counter.scale = 1
            return api.optimizer_step(opt, params, state, grads, losses)

        # the arguments hold the whole batch
        whole_batch = _fake_tree(full, shd.batch_specs(full, mesh), mesh,
                                 device)
        return (params, state, whole_batch), run, 1

    specs = api.input_specs(cfg, shape)
    model = api.build(cfg, "meta")
    shd.distribute_module(model.module, mesh)
    if shape.kind == "prefill":
        batch = _fake_tree(specs, shd.batch_specs(specs, mesh), mesh, device)
        if cfg.family != "ssm":
            return ((model.module, batch),
                    lambda c: model.prefill(batch), 1)
        return ((model.module, batch),
                lambda c: _replayed_prefill(model, batch, c), s)

    tok = specs["tokens"]
    tokens = shd.empty_dtensor(tok.shape, tok.dtype,
                               shd.batch_specs({"t": tok}, mesh)["t"],
                               mesh, device)
    with shd.activation_rules(mesh):
        cache = model.init_cache(b, s)
    cache["len"] = s - 1                 # the step reads every slot
    return ((model.module, cache, tokens),
            lambda c: model.decode_step(cache, tokens), 1)


@serving
def _replayed_prefill(model: api.Model, batch, counter: LocalCounter):
    """An xLSTM prefill with one token step traced and counted for all S
    (the steps are alike: one token through every layer)."""
    from repro_torch.models import xlstm as X
    from repro_torch.models.common import tied_logits

    cfg = model.cfg
    tokens = batch["tokens"]
    b, s = tokens.shape
    params = model.module.tree()
    cache = model.init_cache(b, s)
    layers = X._layers(params, cfg)
    counter.scale = s
    x = X._step(params, cfg, layers, tokens[:, 0], cache)
    counter.scale = 1
    return tied_logits(params, cfg, x)[:, 0], cache


# ---------------------------------------------------------------------------
# The paper's own workload: a BSP PageRank superstep over 256/512 parts
# ---------------------------------------------------------------------------

def run_graph_cell(shape_name: str, mesh_name: str, rec: dict,
                   device: str = "cuda") -> dict:
    """The port's ``_superstep`` for RMAT28-like partition shapes, one
    partition a rank, the outboxes exchanged by an all-to-all."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.core.bsp import _Dims, _superstep, gather_src, \
        VertexProgram

    t0 = time.time()
    n_dev = 512 if MESHES[mesh_name] else 256
    rec["chips"] = n_dev
    scale, ef = 28, 16
    v_total, e_total = 1 << scale, (1 << scale) * ef
    v_max = -(-v_total // n_dev)
    e_max = int(e_total / n_dev * 1.5)          # skew headroom
    o_max = min(v_max, e_max) // 4
    dims = _Dims(n_dev, v_max, e_max, o_max)
    msg_dtype = (torch.bfloat16 if opt_enabled("graph_bf16_msgs")
                 else torch.float32)

    def edge_fn(state, src, weight, step):
        return gather_src(state["rank"], src).to(msg_dtype)

    def apply_fn(state, acc, step):
        rank = 0.15 / v_total + 0.85 * acc.float()
        return {"rank": rank}, torch.ones(acc.shape[0], dtype=torch.bool,
                                          device=acc.device)

    program = VertexProgram(combine="sum", edge_fn=edge_fn,
                            apply_fn=apply_fn, max_steps=20)

    with fake_world(n_dev):
        group = dist.group.WORLD

        def exchange(outbox):                # [Q, 1, P, o_max]
            send = outbox.permute(2, 0, 1, 3).contiguous()
            recv = funcol.all_to_all_single(send, None, None, group)
            return funcol.wait_tensor(recv).permute(1, 2, 0, 3)

        def all_finished(finished):
            zero = torch.zeros((), dtype=torch.int32, device=device)
            total = funcol.wait_tensor(funcol.all_reduce(zero, "sum", group))
            return (total == 0) & finished

        with FakeTensorMode(allow_non_fake_inputs=True):
            state = {"rank": torch.empty((1, 1, v_max), device=device)}
            edges = {"src": torch.empty((1, e_max), dtype=torch.int64,
                                        device=device),
                     "dst_ext": torch.empty((1, e_max), dtype=torch.int64,
                                            device=device),
                     "inbox_dst": torch.empty((1, n_dev, o_max),
                                              dtype=torch.int64,
                                              device=device)}
            counter = LocalCounter()
            t1 = time.time()
            with counter:
                outs = _superstep(dims, program, edges, exchange,
                                  all_finished, None, state, 0)
            rec["trace_s"] = round(time.time() - t1, 2)
            mem = _memory((state, edges), outs, counter)
            del outs
    mem["peak_estimate_gib"] = round(
        (mem["argument_bytes"] + mem["temp_bytes"]) / 2**30, 3)
    rec["memory_analysis"] = mem
    summ = counter.summary()
    rec["cost_analysis_raw"] = {k: summ[k] for k in
                                ("flops", "matmul_flops", "bytes_accessed")}
    rec["collective_bytes"] = summ["collective_bytes"]
    rec["collective_calls"] = summ["collective_calls"]
    ici = rec["collective_bytes"]["total"]
    # analytic: one superstep ≈ memory-bound edge traffic (JAX's formula)
    hbm = e_max * 8 + v_max * 4 * 3 + n_dev * o_max * 4 * 2
    rec["roofline"] = {
        "flops": 2.0 * e_max, "hbm_bytes": float(hbm),
        "ici_bytes": float(ici),
        "model_flops": 2.0 * e_total,
        "compute_s": 2.0 * e_max / calculator.PEAK_FLOPS,
        "memory_s": hbm / calculator.HBM_BW,
        "collective_s": ici / calculator.LINK_BW,
        "dominant": "memory",
        "useful_ratio": 1.0,
    }
    rec["ok"] = True
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def all_cells():
    cells = [(a, s) for a in configs.all_ids() for s in SHAPES]
    cells.append(("totem-rmat", "pagerank_superstep"))
    return cells


def summary_line(rec: dict) -> str:
    """One cell's per-rank GiB, operations, collective bytes by kind and
    trace seconds."""
    if rec.get("skipped"):
        return f"{rec['arch']} × {rec['shape']} × {rec['mesh']}: skipped"
    ma, cb = rec["memory_analysis"], rec["collective_bytes"]
    kinds = " ".join(f"{k}={v / 2**30:.3f}GiB" for k, v in cb.items()
                     if k != "total" and v)
    return (f"{rec['arch']} × {rec['shape']} × {rec['mesh']}: "
            f"{ma['peak_estimate_gib']} GiB/rank (args "
            f"{ma['argument_bytes'] / 2**30:.3f}, temp "
            f"{ma['temp_bytes'] / 2**30:.3f}), "
            f"{rec['cost_analysis_raw']['flops']:.4e} flops/rank, "
            f"collectives {cb['total'] / 2**30:.3f} GiB/rank [{kinds}], "
            f"dominant {rec['roofline']['dominant']}, "
            f"trace {rec['trace_s']} s")


def table(out: Path) -> str:
    """The records in ``out`` as a markdown table, one row an architecture,
    one column a shape: per-rank peak GiB and collective GiB, each as
    ``single / multi`` pod, and the traces' seconds (the largest of the
    row)."""
    recs = {}
    for p in out.glob("*.json"):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r

    def entry(arch, shape):
        got, coll = [], []
        for mesh in ("single", "multi"):
            r = recs.get((arch, shape, mesh))
            if r is None or not r.get("ok"):
                return "missing" if r is None else "failed"
            if r.get("skipped"):
                return "skipped"
            got.append(f"{r['memory_analysis']['peak_estimate_gib']:.1f}")
            coll.append(f"{r['collective_bytes']['total'] / 2**30:.1f}")
        return f"{' / '.join(got)}; {' / '.join(coll)}"

    def slowest(arch, shapes):
        return max((recs[(arch, s, m)].get("trace_s", 0.0)
                    for s in shapes for m in ("single", "multi")
                    if (arch, s, m) in recs), default=0.0)

    rows = ["| arch | " + " | ".join(SHAPES) + " | trace s (max) |",
            "|---" * (len(SHAPES) + 2) + "|"]
    archs = list(dict.fromkeys(a for a, _ in all_cells()))
    for arch in archs:
        shapes = SHAPES if arch != "totem-rmat" else ["pagerank_superstep"]
        cells = [entry(arch, s) for s in shapes]
        if arch == "totem-rmat":
            cells = [f"pagerank_superstep: {cells[0]}"]
        cells += [""] * (len(SHAPES) - len(cells))
        rows.append(f"| {arch} | " + " | ".join(cells)
                    + f" | {slowest(arch, shapes):.0f} |")
    return "\n".join(rows)


def sweep(out: Path, mesh: str, device: str, jobs: int = 1) -> int:
    """Every cell not yet ``ok`` in ``out``, each in its own subprocess,
    ``jobs`` at a time; returns 1 when any failed."""
    meshes = ["single", "multi"] if mesh == "both" else [mesh]
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    todo = []
    for arch, shape in all_cells():
        for mesh_name in meshes:
            path = out / f"{arch}__{shape}__{mesh_name}.json"
            if path.exists() and json.loads(path.read_text()).get("ok"):
                continue
            todo.append((arch, shape, mesh_name, path))
    running, failures = [], 0

    def reap(block: bool) -> None:
        nonlocal failures
        for item in list(running):
            proc, (arch, shape, mesh_name, path), t0 = item
            if not block and proc.poll() is None:
                continue
            _, err = proc.communicate()
            running.remove(item)
            tag = f"[dryrun] {arch} × {shape} × {mesh_name}"
            if proc.returncode != 0:
                failures += 1
                if not path.exists() or json.loads(
                        path.read_text()).get("ok"):
                    path.write_text(json.dumps(
                        {"arch": arch, "shape": shape, "mesh": mesh_name,
                         "ok": False, "error": err[-4000:]}, indent=1))
                last = err.strip().splitlines()[-1][:200] if err else ""
                print(f"{tag} FAILED: {last}", flush=True)
            else:
                print(f"{tag} ok ({time.time() - t0:.1f} s)", flush=True)
            return

    for cell in todo:
        while len(running) >= max(jobs, 1):
            reap(block=False)
            if len(running) >= max(jobs, 1):
                time.sleep(0.2)
        arch, shape, mesh_name, _ = cell
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
               "--arch", arch, "--shape", shape, "--mesh", mesh_name,
               "--out", str(out), "--device", device]
        running.append((subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                         stderr=subprocess.PIPE, text=True,
                                         env=env), cell, time.time()))
    while running:
        reap(block=True)
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once under --all")
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a markdown table")
    args = ap.parse_args(argv)
    out = Path(args.out)
    if args.table:
        print(table(out))
        return 0
    out.mkdir(parents=True, exist_ok=True)

    if args.all:
        return sweep(out, args.mesh, args.device, args.jobs)

    rec = {}
    try:
        rec = run_cell(args.arch, args.shape, args.mesh, args.device)
    except (ValueError, TypeError, NotImplementedError, RuntimeError,
            AssertionError):
        # expected dry-run outcomes (a shape or layout the port refuses, an
        # op without a DTensor strategy) become a failed record; anything
        # else propagates with its traceback
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "ok": False, "error": traceback.format_exc()[-4000:]}
    path = out / f"{args.arch}__{args.shape}__{args.mesh}.json"
    path.write_text(json.dumps(rec, indent=1, default=float))
    if rec.get("ok"):
        print(json.dumps({k: rec[k] for k in
                          ("arch", "shape", "mesh", "ok") if k in rec}))
        if "memory_analysis" in rec or rec.get("skipped"):
            print(summary_line(rec))
        return 0
    print(rec.get("error", "")[-2000:], file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
