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
too.  ``--production-mesh`` raises: the mesh and sharding rules
(``launch/{mesh,sharding}.py``) are not ported yet (``ROADMAP.md`` Queue 1
item 15b).  A hybrid config's ``--layers`` must be a multiple of its
``attn_every``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.tokens import TokenStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import api
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.runtime import (FaultInjector, StepWatchdog,
                                 run_with_restarts)


def build_everything(arch: str, smoke: bool, batch: int, seq: int,
                     microbatches: int, lr: float, production: bool,
                     device: DeviceLike = None,
                     layers: Optional[int] = None):
    """``(cfg, model, optimizer, step function, token stream)``."""
    if production:
        raise NotImplementedError(
            "--production-mesh is not ported yet: ROADMAP.md Queue 1 item "
            "15b brings launch/{mesh,sharding}.py; the port trains on one "
            "device")
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    model = api.build(cfg, device, serve=False)
    opt = AdamW(learning_rate=lr)
    step_fn = api.make_train_step(model, opt, microbatches=microbatches or 1)
    stream = TokenStream(cfg, batch, seq)
    return cfg, model, opt, step_fn, stream


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
    cfg, model, opt, step_fn, stream = build_everything(
        args.arch, args.smoke, args.batch, args.seq, args.microbatches,
        args.lr, args.production_mesh, dev, args.layers)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} layers={cfg.n_layers} params={n_params:,} "
          f"device={dev}", flush=True)
    opt_state = opt.init(params)
    manager = CheckpointManager(args.ckpt_dir)
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
