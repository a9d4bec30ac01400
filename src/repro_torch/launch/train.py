"""End-to-end training driver.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 50 --batch 8 --seq 2048 --microbatches 4 --ckpt-dir DIR
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

The counterpart of ``repro/launch/train.py`` on one device: the seekable
``TokenStream`` (a vision or encoder-decoder config's batches carry their
``patches`` or ``frames``, cut into microbatches with the tokens), the
model's ``make_train_step`` with AdamW, checkpoints
every ``--ckpt-every`` steps (``CheckpointManager``, written on a
background thread), the straggler watchdog, and restart from the latest
checkpoint on a failure (``run_with_restarts``).  The weights are random,
drawn from a generator seeded 0 (the JAX driver's ``key(0)``).  Runs on
``cuda`` unless ``--device`` names another device.

Beyond the JAX flags: ``--layers`` cuts the depth, ``--fail-at`` injects
one failure before each named step (the restart drill), and
``--deterministic`` runs under ``torch.use_deterministic_algorithms``, so
a restarted run reproduces the run without failures bit for bit on a card
too.  A hybrid config's ``--layers`` must be a multiple of its
``attn_every``.

``--production-mesh`` (JAX's ``build_everything(production=True)``) lays
the run out on ``launch/mesh.py``'s ``(16, 16)`` mesh over the world that
``torchrun`` started (NCCL on cards, gloo with ``--device cpu``; 256
ranks, else the mesh's error naming the world size): parameters and AdamW
state distributed by ``sharding.param_specs``, each batch by
``batch_specs``, the step under ``activation_rules``.  Checkpoints are
sharded (``CheckpointManager(sharded=True)``): one per step in
``--ckpt-dir``, each rank writing the shards of which it holds the first
replica and restoring its own.

  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
      --production-mesh --arch tinyllama-1.1b --batch 256 --seq 4096
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.models import api
from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves
from repro_torch.runtime import (FaultInjector, StepWatchdog,
                                 run_with_restarts)


def build_everything(arch: str, smoke: bool, batch: int, seq: int,
                     microbatches: int, lr: float, production: bool,
                     device: DeviceLike = None,
                     layers: Optional[int] = None):
    """``(cfg, model, optimizer, step function, token stream)``.  With
    ``production`` the step function carries the mesh (``step.mesh``):
    it runs under ``activation_rules`` and takes the parameters and
    optimizer state as ``step.distribute`` lays them out."""
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    model = api.build(cfg, device, serve=False)
    opt = AdamW(learning_rate=lr)
    step_fn = api.make_train_step(model, opt, microbatches=microbatches or 1)
    stream = TokenStream(cfg, batch, seq)
    if production:
        step_fn = _mesh_step(step_fn, model, M.make_production_mesh(
            device=model.device.type))
    return cfg, model, opt, step_fn, stream


def _mesh_step(step_fn, model: api.Model, mesh):
    """``step_fn`` on ``mesh``: the batch distributed by ``batch_specs``,
    the call under ``activation_rules``; ``.distribute(params,
    opt_state)`` lays the state out by ``param_specs``."""
    pspecs = shd.param_specs(model.params_shape(), mesh)

    def step(params, opt_state, batch):
        batch = shd.named(batch, shd.batch_specs(batch, mesh), mesh)
        with shd.activation_rules(mesh):
            return step_fn(params, opt_state, batch)

    def distribute(params, opt_state):
        return (shd.named(params, pspecs, mesh),
                AdamWState(step=opt_state.step,
                           mu=shd.named(opt_state.mu, pspecs, mesh),
                           nu=shd.named(opt_state.nu, pspecs, mesh)))

    step.mesh, step.distribute = mesh, distribute
    return step


def init_world(device: torch.device) -> None:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``PORT`` in the environment), NCCL
    on cards (rank ``LOCAL_RANK``'s card) or gloo on the CPU; nothing
    when the environment names no world or a group exists."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--fail-at", type=int, action="append", default=[],
                    help="inject one failure before this step (repeatable)")
    ap.add_argument("--deterministic", action="store_true",
                    help="torch.use_deterministic_algorithms for the run")
    return ap


def train(args) -> Dict:
    """Run the training loop of parsed ``args``; returns a report with
    each step's ``losses`` (the last value logged for a step that ran
    twice), the restart summary and the mean step time."""
    dev = resolve_device(args.device)
    if args.deterministic and dev.type == "cuda":
        # torch reads it at the process's first cuBLAS call
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(bool(args.deterministic) or prev)
    try:
        return _train(args, dev)
    finally:
        torch.use_deterministic_algorithms(prev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _train(args, dev: torch.device) -> Dict:
    if args.production_mesh:
        init_world(dev)
        if dev.type == "cuda" and dist.is_initialized():
            dev = torch.device("cuda", torch.cuda.current_device())
    cfg, model, opt, step_fn, stream = build_everything(
        args.arch, args.smoke, args.batch, args.seq, args.microbatches,
        args.lr, args.production_mesh, dev, args.layers)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params:,} "
          f"device={dev}", flush=True)
    opt_state = opt.init(params)
    sharded = hasattr(step_fn, "mesh")
    if sharded:
        params, opt_state = step_fn.distribute(params, opt_state)
    manager = CheckpointManager(args.ckpt_dir, sharded=sharded)
    injector = FaultInjector(fail_at_steps=set(args.fail_at))
    watchdog = StepWatchdog(
        on_straggler=lambda s, d, m: print(
            f"[watchdog] step {s} straggled: {d*1e3:.0f}ms vs "
            f"{m*1e3:.0f}ms", flush=True))

    def one_step(step, state):
        injector.maybe_fail(step)
        watchdog.start()
        batch = stream.batch_at(step)
        params, opt_state, metrics = step_fn(state["params"],
                                             state["opt_state"], batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        _sync(dev)
        watchdog.stop(step)
        return {"params": params, "opt_state": opt_state}, metrics

    t0 = time.perf_counter()
    losses: Dict[int, float] = {}

    def log(step, metrics):
        losses[step] = metrics["loss"]
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {metrics['loss']:.6f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)

    state = {"params": params, "opt_state": opt_state}
    state, summary = run_with_restarts(
        one_step, state, args.steps, manager,
        checkpoint_every=args.ckpt_every, on_metrics=log)
    ordered = [losses[s] for s in sorted(losses)]
    print(f"done: final loss {ordered[-1]:.6f} (start {ordered[0]:.6f}), "
          f"restarts={summary['failures']}, "
          f"mean step {watchdog.mean_step_s * 1e3:.0f}ms", flush=True)
    return dict(losses=ordered, params=n_params, state=state,
                mean_step_s=watchdog.mean_step_s,
                checkpoints=list(manager.save_log), **summary)


def main(argv=None) -> int:
    train(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
