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

With ``--resume`` the step's state is then saved as one sharded
checkpoint of the ``(2, world / 2)`` mesh and restored onto a ``(world,
1)`` mesh and onto rank 0's device alone (``resume_case``): each restore
bit for bit, its next step's loss bit for bit the same layout's step
from the saved state, and within ``RESUME_TOL`` of the next step on the
mesh that saved it.  The run fails when a check fails.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile
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
    step_fn, data, init = _train_state(cfg, dev, batch, seq)
    state, data = _laid_out(init, mesh), _batch_on(data, mesh)
    if timed_repeat:                     # a first step warms the caches
        _step_on(step_fn, state, data, mesh)
    _sync(dev)
    t0 = time.perf_counter()
    new, metrics = _step_on(step_fn, state, data, mesh)
    _sync(dev)
    out = dict(_result(new, metrics), step_s=time.perf_counter() - t0)
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
              batch: int, seq: int, data: int, prefill: bool = True,
              ckpt_dir: Optional[str] = None):
    """One rank: the mesh case over ``(data, world / data)``; rank 0 adds
    the plain case on its device and returns ``compare``'s differences,
    both losses and both step times (numbers only).  With ``ckpt_dir``,
    then ``resume_case`` from that mesh onto ``(world, 1)`` and rank 0's
    device alone (its result under ``resume``)."""
    from repro_torch.launch import mesh as M

    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=int(layers))
    world = torch.distributed.get_world_size()
    mesh = M.make_local_mesh(data, world // data,
                             device=group.device.type)
    got = mesh_case(cfg, group.device, batch, seq, mesh, prefill,
                    timed_repeat=True)
    resume = None
    if ckpt_dir is not None:
        resume = resume_case(cfg, group.device, batch, seq, ckpt_dir, mesh,
                             [M.make_local_mesh(world, 1,
                                                device=group.device.type),
                              None])
    if torch.distributed.get_rank() != 0:
        return None
    plain = mesh_case(cfg, group.device, batch, seq, None, prefill,
                      timed_repeat=True)
    return {"compare": compare({"mesh": got, "plain": plain}),
            "loss": (float(got["loss"]), float(plain["loss"])),
            "step_s": (got["step_s"], plain["step_s"]), "resume": resume}


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


# The next step after a restore on another layout against the step on the
# layout that saved: bf16 products summed in other orders (the four-card
# mesh's bounds against one card)
RESUME_TOL = {"loss": 2e-3, "grads": 5e-2, "params": 5e-2}
# card_rank's resumes (batch, seq): the checkpoint is the model's (full
# width), so shorter rows only make their eight steps cheaper; the batch
# keeps 2 rows a microbatch of tinyllama's 4 (DTensor refuses the reshape
# of a one-row microbatch's sharded batch dim)
RESUME_SHAPE = (8, 256)


def _train_state(cfg, dev, batch, seq):
    """The model's step function, a batch and the initial plain state
    ``{"params", "opt_state"}`` (seed 0; ``lr = eps = EPS``)."""
    model = api.build(cfg, dev, serve=False)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    data = api.synth_batch(cfg, api.ShapeSpec("t", "train", seq, batch),
                           seed=1, device=dev)
    opt = AdamW(learning_rate=EPS, warmup_steps=1, eps=EPS)
    return (api.make_train_step(model, opt), data,
            {"params": params, "opt_state": opt.init(params)})


def _state_specs(params, mesh):
    from repro_torch.launch import sharding as shd
    pspecs = shd.param_specs(params, mesh)
    return {"params": pspecs,
            "opt_state": AdamWState(step=(), mu=pspecs, nu=pspecs)}


def _laid_out(state, mesh):
    """A plain state laid out on ``mesh`` by its specs (None: as is)."""
    from repro_torch.launch import sharding as shd
    if mesh is None:
        return state
    specs = _state_specs(state["params"], mesh)
    opt = state["opt_state"]
    return {"params": shd.named(state["params"], specs["params"], mesh),
            "opt_state": AdamWState(
                step=opt.step,
                mu=shd.named(opt.mu, specs["params"], mesh),
                nu=shd.named(opt.nu, specs["params"], mesh))}


def _batch_on(data, mesh):
    """A batch laid out on ``mesh`` by its specs (None: as is)."""
    from repro_torch.launch import sharding as shd
    if mesh is None:
        return data
    return shd.named(data, shd.batch_specs(data, mesh), mesh)


def _step_on(step_fn, state, data, mesh):
    """One step of ``state`` and ``data`` laid out on ``mesh`` (None: one
    device): ``(the new state, metrics)``."""
    from repro_torch.launch import sharding as shd
    ctx = (contextlib.nullcontext() if mesh is None
           else shd.activation_rules(mesh))
    with ctx:
        new, new_state, metrics = step_fn(state["params"],
                                          state["opt_state"], data)
    return {"params": new, "opt_state": new_state}, metrics


def _result(state, metrics) -> Dict:
    """``compare``'s fields of a step: the loss, the new parameters and
    AdamW's first moments, as numpy arrays."""
    return {"loss": _np(metrics["loss"]),
            "params": [_np(p) for p in tree_leaves(state["params"])],
            "mu": [_np(m) for m in tree_leaves(state["opt_state"].mu)]}


def _plain(state, dev: torch.device):
    """A state's global values as plain tensors on ``dev``."""
    if isinstance(state, dict):
        return {k: _plain(v, dev) for k, v in state.items()}
    if isinstance(state, AdamWState):
        return AdamWState(*(_plain(v, dev) for v in state))
    return _full(state).detach().to(dev, copy=True)


def _state_leaves(state):
    opt = state["opt_state"]
    return ([_np(opt.step)] + [_np(x) for x in tree_leaves(state["params"])]
            + [_np(x) for x in tree_leaves(opt.mu)]
            + [_np(x) for x in tree_leaves(opt.nu)])


def resume_case(cfg, dev: torch.device, batch: int, seq: int, ckpt_dir,
                save_on, restore_on) -> Optional[Dict]:
    """One AdamW step laid out on ``save_on`` (a mesh, or None: one
    device), its state saved (a sharded checkpoint from a mesh, a whole one
    from one device) and restored by ``restore_resharded`` onto each
    layout of ``restore_on`` (meshes; None: rank 0's device alone), where
    the next step runs.  Every rank of the world takes part; rank 0
    returns, per target: the restored leaves bit for bit with the saved
    ones, the next step's loss against the same layout's step from the
    saved state (``same_loss``), and ``compare``'s differences against the
    next step on ``save_on`` (the unrestarted run), with each step's s."""
    from repro_torch.checkpoint import CheckpointManager, restore_resharded
    from repro_torch.distributed import ShardGroup

    if save_on is None and torch.distributed.is_initialized() and (
            torch.distributed.get_world_size() > 1):
        raise ValueError("a whole checkpoint is saved by a world of one")
    step_fn, batch_data, init = _train_state(cfg, dev, batch, seq)
    data = _batch_on(batch_data, save_on)
    saved, _ = _step_on(step_fn, _laid_out(init, save_on), data, save_on)
    rank0 = not torch.distributed.is_initialized() or (
        torch.distributed.get_rank() == 0)
    CheckpointManager(ckpt_dir, sharded=save_on is not None).save_tree(
        1, saved)
    want = _state_leaves(saved)
    _sync(dev)
    t0 = time.perf_counter()
    base = _result(*_step_on(step_fn, saved, data, save_on))
    _sync(dev)
    base["step_s"] = time.perf_counter() - t0
    plain = _plain(saved, dev)        # a collective: every rank, up front
    out = {}
    for target in restore_on:
        name = "one device" if target is None else str(
            tuple(target.mesh.shape))
        if target is None:
            if not rank0:
                continue
            _, got = restore_resharded(CheckpointManager(ckpt_dir), init,
                                       ShardGroup(None, dev))
        else:
            _, got = restore_resharded(
                CheckpointManager(ckpt_dir, sharded=True), init, target,
                _state_specs(init["params"], target))
        equal = sum(int(np.array_equal(a, b))
                    for a, b in zip(_state_leaves(got), want))
        data = _batch_on(batch_data, target)
        _sync(dev)
        t0 = time.perf_counter()
        nxt = _result(*_step_on(step_fn, got, data, target))
        _sync(dev)
        nxt["step_s"] = time.perf_counter() - t0
        del got
        direct = _result(*_step_on(step_fn, _laid_out(plain, target), data,
                                   target))
        out[name] = {"equal": equal, "leaves": len(want),
                     "same_loss": bool(np.array_equal(nxt["loss"],
                                                      direct["loss"])),
                     "loss": (float(nxt["loss"]), float(base["loss"])),
                     "compare": compare({"mesh": nxt, "plain": base}),
                     "step_s": (nxt["step_s"], base["step_s"])}
    return out if rank0 else None


def resume_ok(res: Dict) -> bool:
    """Every restore bit for bit, its next loss bit for bit its layout's
    from the saved state, and within ``RESUME_TOL`` of the unrestarted."""
    return all(r["equal"] == r["leaves"] and r["same_loss"]
               and all(r["compare"][k] <= tol
                       for k, tol in RESUME_TOL.items())
               for r in res.values())


def card_rank(group, arch: str, layers: int, batch: int, seq: int,
              prefill_batch: int, prefill_seq: int) -> Dict:
    """``chip_smoke.py``'s ``[mesh]`` on one rank of a ``(1, 1)`` mesh:
    one AdamW step of ``arch`` cut to ``layers`` under the mesh and plain,
    both on this rank's card (each step run twice, the second timed), the
    differences by ``compare`` and the bit-equal leaves; ``resume_case``
    both ways at ``RESUME_SHAPE``: the mesh's sharded checkpoint onto the
    card alone (``resume_to_plain``) and the card's whole checkpoint onto
    the mesh (``resume_to_mesh``); then a full-depth prefill under the
    mesh and plain, the flash launches of the mesh's (the counter zeroed
    just before it) and the logits' difference.  Returns numbers only."""
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
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        out["resume_to_plain"] = resume_case(cfg, dev, *RESUME_SHAPE,
                                             f"{ckpt}/sharded", mesh, [None])
        out["resume_to_mesh"] = resume_case(cfg, dev, *RESUME_SHAPE,
                                            f"{ckpt}/whole", None, [mesh])
        out["resume_s"] = time.perf_counter() - t0
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
    ap.add_argument("--resume", action="store_true",
                    help="also save the step sharded and restore it onto "
                         "(world, 1) and one device (resume_case)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt:
        res = run_world(rank_main, args.world, device=args.device,
                        timeout=args.timeout,
                        args=(args.arch, args.smoke, args.layers,
                              args.batch, args.seq, args.data, True,
                              ckpt if args.resume else None))[0]
    print(f"mesh ({args.data}, {args.world // args.data}) vs one device: "
          f"loss {res['loss'][0]} / {res['loss'][1]}, max diff "
          f"{res['compare']}, step s {res['step_s'][0]:.4f} / "
          f"{res['step_s'][1]:.4f}", flush=True)
    if res["resume"] is None:
        return 0
    for name, r in res["resume"].items():
        print(f"resume from the ({args.data}, {args.world // args.data}) "
              f"mesh's sharded checkpoint onto {name}: {r['equal']} of "
              f"{r['leaves']} leaves bit for bit, next loss bit for bit "
              f"the layout's unrestarted step: {r['same_loss']}; against "
              f"the next step on the saving mesh: loss {r['loss'][0]} / "
              f"{r['loss'][1]}, max diff {r['compare']} (bounds "
              f"{RESUME_TOL}); step s {r['step_s'][0]:.4f} / "
              f"{r['step_s'][1]:.4f}", flush=True)
    ok = resume_ok(res["resume"])
    print("RESUME OK" if ok else "RESUME FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
