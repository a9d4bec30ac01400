"""The train step and the prefill under a ``(data, model)`` mesh against
the same calls on one device.

  PYTHONPATH=src python -m repro_torch.launch.mesh_selftest --world 4 \
      --device cpu [--arch tinyllama-1.1b --smoke]
  PYTHONPATH=src python -m repro_torch.launch.mesh_selftest --world 4 \
      --arch tinyllama-1.1b --layers 2 --batch 8 --seq 2048

Each rank builds the same parameters (seed 0) and batch, distributes them
by ``param_specs`` and ``batch_specs`` over a ``(2, world / 2)`` mesh and
runs one AdamW step and one prefill under ``activation_rules``; rank 0
runs the plain step and prefill on its own device too and prints the
differences (``compare``: the loss, the gradients, the updated parameters,
the last-token logits) and both step times.  Without ``--device`` the
ranks are NCCL ranks, one card each.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.models import api
from repro_torch.optim.adamw import AdamW, AdamWState, tree_leaves

# AdamW's learning rate and eps: a first update is -lr·g/(|g| + eps), so
# a gradient near 0 that two summation orders round apart moves by up to
# lr·δg/eps = δg
EPS = 1e-3


def _full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _np(x) -> np.ndarray:
    return _full(x).detach().float().cpu().numpy()


def mesh_case(cfg, dev: torch.device, batch: int, seq: int,
              mesh=None, prefill: bool = True,
              timed_repeat: bool = False) -> Dict:
    """One AdamW step (and a prefill) of ``cfg`` on ``dev``: plain when
    ``mesh`` is None, else with every input distributed over ``mesh`` by
    its specs and the calls under ``activation_rules``.  Returns numpy
    arrays: ``loss``, ``params`` and ``mu`` (the updated leaves and AdamW's
    first moments in ``tree_leaves`` order), ``logits`` and the step's
    seconds (of a second step on the same inputs with
    ``timed_repeat``)."""
    from repro_torch.launch import sharding as shd

    model = api.build(cfg, dev, serve=False)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    data = api.synth_batch(cfg, api.ShapeSpec("t", "train", seq, batch),
                           seed=1, device=dev)
    opt = AdamW(learning_rate=EPS, warmup_steps=1, eps=EPS)
    state = opt.init(params)
    step = api.make_train_step(model, opt)
    ctx = contextlib.nullcontext()
    if mesh is not None:
        pspecs = shd.param_specs(params, mesh)
        params = shd.named(params, pspecs, mesh)
        state = AdamWState(step=state.step,
                           mu=shd.named(state.mu, pspecs, mesh),
                           nu=shd.named(state.nu, pspecs, mesh))
        data = shd.named(data, shd.batch_specs(data, mesh), mesh)
        ctx = shd.activation_rules(mesh)
    out: Dict = {}
    with ctx:
        if timed_repeat:                 # a first step warms the caches
            step(params, state, data)
        _sync(dev)
        t0 = time.perf_counter()
        new, new_state, metrics = step(params, state, data)
        _sync(dev)
        out["step_s"] = time.perf_counter() - t0
    out["loss"] = _np(metrics["loss"])
    out["params"] = [_np(p) for p in tree_leaves(new)]
    out["mu"] = [_np(m) for m in tree_leaves(new_state.mu)]
    if prefill:
        out["logits"] = _prefill(cfg, dev, batch, seq, mesh)
    return out


def _prefill(cfg, dev, batch, seq, mesh) -> np.ndarray:
    from repro_torch.launch import sharding as shd

    model = api.build(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    prompt = api.synth_batch(cfg, api.ShapeSpec("p", "prefill", seq, batch),
                             seed=2, device=dev)
    if mesh is None:
        return _np(model.prefill(prompt)[0])
    shd.distribute_module(model.module, mesh)
    prompt = shd.named(prompt, shd.batch_specs(prompt, mesh), mesh)
    with shd.activation_rules(mesh):
        return _np(model.prefill(prompt)[0])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_main(group, arch: str, smoke: bool, layers: Optional[int],
              batch: int, seq: int, data: int, prefill: bool = True):
    """One rank: the mesh case over ``(data, world / data)``; rank 0 adds
    the plain case on its device and returns ``compare``'s differences,
    both losses and both step times (numbers only)."""
    from repro_torch.launch import mesh as M

    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    world = torch.distributed.get_world_size()
    mesh = M.make_local_mesh(data, world // data,
                             device=group.device.type)
    got = mesh_case(cfg, group.device, batch, seq, mesh, prefill,
                    timed_repeat=True)
    if torch.distributed.get_rank() != 0:
        return None
    plain = mesh_case(cfg, group.device, batch, seq, None, prefill,
                      timed_repeat=True)
    return {"compare": compare({"mesh": got, "plain": plain}),
            "loss": (float(got["loss"]), float(plain["loss"])),
            "step_s": (got["step_s"], plain["step_s"])}


def compare(res: Dict) -> Dict[str, float]:
    """Largest differences mesh vs plain: the loss (relative); the
    gradients, as AdamW's first moments (``mu = 0.1 g`` after a first
    step), relative to each leaf's largest; the updated parameters
    relative to the same leaf's largest gradient (with ``lr = eps`` an
    update moves by at most the gradient's difference); the logits."""
    a, b = res["mesh"], res["plain"]
    out = {"loss": float(abs(a["loss"] - b["loss"]) / abs(b["loss"])),
           "grads": max(float(np.abs(x - y).max() / max(np.abs(y).max(),
                                                        1e-30))
                        for x, y in zip(a["mu"], b["mu"])),
           "params": max(float(np.abs(x - y).max()
                               / max(10 * np.abs(m).max(), 1e-30))
                         for x, y, m in zip(a["params"], b["params"],
                                            b["mu"]))}
    if "logits" in a and "logits" in b:
        out["logits"] = float(np.abs(a["logits"] - b["logits"]).max())
    return out


def card_rank(group, arch: str, layers: int, batch: int, seq: int,
              prefill_batch: int, prefill_seq: int) -> Dict:
    """``chip_smoke.py``'s ``[mesh]`` on one rank of a ``(1, 1)`` mesh:
    one AdamW step of ``arch`` cut to ``layers`` under the mesh and plain,
    both on this rank's card (each step run twice, the second timed), the
    differences by ``compare`` and the bit-equal leaves; then a full-depth
    prefill under the mesh and plain, the flash launches of the mesh's
    (the counter zeroed just before it) and the logits' difference.
    Returns numbers only."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as shd

    dev = group.device
    mesh = M.make_local_mesh(1, 1, device=dev.type)
    cfg = dataclasses.replace(configs.get(arch), n_layers=int(layers))
    res = {"mesh": mesh_case(cfg, dev, batch, seq, mesh, prefill=False,
                             timed_repeat=True),
           "plain": mesh_case(cfg, dev, batch, seq, None, prefill=False,
                              timed_repeat=True)}
    out = {"compare": compare(res),
           "bit_equal": sum(int(np.array_equal(a, b)) for a, b in zip(
               res["mesh"]["params"] + res["mesh"]["mu"],
               res["plain"]["params"] + res["plain"]["mu"])),
           "leaves": len(res["plain"]["params"]) * 2,
           "loss": (float(res["mesh"]["loss"]), float(res["plain"]["loss"])),
           "step_s": (res["mesh"]["step_s"], res["plain"]["step_s"])}
    del res
    full = configs.get(arch)
    model = api.build(full, dev, torch.Generator(device=dev).manual_seed(0))
    prompt = api.synth_batch(full, api.ShapeSpec(
        "p", "prefill", prefill_seq, prefill_batch), seed=2, device=dev)
    want = model.prefill(prompt)[0]
    shd.distribute_module(model.module, mesh)
    dprompt = shd.named(prompt, shd.batch_specs(prompt, mesh), mesh)
    with shd.activation_rules(mesh):
        model.prefill(dprompt)                 # warm: DTensor's caches
        _sync(dev)
        kfa.flash_attention.launches = 0
        t0 = time.perf_counter()
        got = model.prefill(dprompt)[0]
        _sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        out["flash_launches"] = kfa.flash_attention.launches
    got = _full(got)
    out["logits_bit_equal"] = bool(torch.equal(got, want))
    out["logits_max_abs"] = float((got.float() - want.float()).abs().max())
    model_plain = api.build(full, dev, torch.Generator(device=dev)
                            .manual_seed(0))
    model_plain.prefill(prompt)
    _sync(dev)
    t0 = time.perf_counter()
    model_plain.prefill(prompt)
    _sync(dev)
    out["plain_prefill_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    from repro_torch.launch.world import run_world

    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    res = run_world(rank_main, args.world, device=args.device,
                    timeout=args.timeout,
                    args=(args.arch, args.smoke, args.layers, args.batch,
                          args.seq, args.data))[0]
    print(f"mesh ({args.data}, {args.world // args.data}) vs one device: "
          f"loss {res['loss'][0]} / {res['loss'][1]}, max diff "
          f"{res['compare']}, step s {res['step_s'][0]:.4f} / "
          f"{res['step_s'][1]:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
