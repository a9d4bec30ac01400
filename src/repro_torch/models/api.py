"""Model API: the serving and training entry points of one architecture.

The counterpart of ``repro/models/api.py``: ``build`` dispatches on
``cfg.family`` as JAX's does, to ``models/transformer.py`` (dense, MoE,
encoder-decoder (audio), vision-language), ``models/xlstm.py`` (ssm) or
``models/zamba.py`` (hybrid), and every family has the same entry points:

  build(cfg, device, generator) → Model (serving weights drawn from the
      generator; ``serve=False`` skips them for a trainer)
  model.init_params(generator) → params (the f32 master tree)
  model.loss(params, microbatch) → scalar
  model.prefill(batch, max_len) → (last logits, cache)
  model.decode_step(cache, tokens) → (logits, cache)
  model.init_cache(batch, max_len, enc_len=0) → cache
  make_train_step(model, optimizer, microbatches) → train_step
  accumulate_grads(model, params, batch, microbatches) → (grads, losses)

``input_specs``/``synth_batch`` make the train, prefill and decode
batches (the front ends' ``patches`` and ``frames``, a decode step's
cache) with the JAX package's numpy draws; ``model.params_shape()`` is the
master tree on the ``meta`` device.  Under a mesh (``launch/sharding.py``'s
``activation_rules``) the same entry points take DTensors.  Entry points
run on ``cuda`` unless the caller names another device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.models import zamba as Z
from repro_torch.models.dist import split_rows
from repro_torch.models.common import ArchConfig, opt_enabled
from repro_torch.optim.adamw import (AdamW, AdamWState, apply_updates,
                                     tree_leaves, tree_map)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def family(cfg: ArchConfig):
    """The module of ``cfg``'s family (``T``, ``X`` or ``Z``): its
    ``prefill``, ``decode_step``, ``init_cache``, ``init_train_params``
    and ``loss_fn``."""
    if cfg.family in T.FAMILIES:
        return T
    if cfg.family == "ssm":
        return X
    if cfg.family == "hybrid":
        return Z
    raise ValueError(f"unknown family {cfg.family!r}")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    module: Optional[nn.Module]
    device: torch.device

    def _serving(self) -> nn.Module:
        if self.module is None:
            raise ValueError("this model was built with serve=False: it has "
                             "no serving weights")
        return self.module

    def prefill(self, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        return family(self.cfg).prefill(self._serving(), batch, max_len)

    def decode_step(self, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        return family(self.cfg).decode_step(self._serving(), cache, tokens)

    def init_cache(self, batch: int, max_len: int, enc_len: int = 0) -> Dict:
        return family(self.cfg).init_cache(self.cfg, batch, max_len,
                                           self.device, enc_len)

    def init_params(self, generator: Optional[torch.Generator] = None
                    ) -> Dict[str, object]:
        """The master parameters (the family's ``init_train_params``),
        drawn from ``generator`` (default: one on the device seeded 0)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return family(self.cfg).init_train_params(self.cfg, generator,
                                                  self.device)

    def params_shape(self) -> Dict[str, object]:
        """The master parameters' tree on the ``meta`` device (shapes and
        dtypes, nothing allocated): JAX's ``params_shape``."""
        return family(self.cfg).init_train_params(self.cfg, None,
                                                  torch.device("meta"))

    def loss(self, params: Dict[str, object],
             batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return family(self.cfg).loss_fn(params, batch, cfg=self.cfg)


def build(cfg: ArchConfig, device: DeviceLike = None,
          generator: Optional[torch.Generator] = None, *,
          serve: bool = True) -> Model:
    """The model of ``cfg`` on ``device`` (``cuda`` by default; raises
    without a card), its serving weights drawn from ``generator``
    (default: one on the device seeded 0, as ``repro/launch/serve.py``'s
    ``key(0)``); ``serve=False`` makes none, for a trainer.  Raises
    ``ValueError`` for an unknown family, or a hybrid config whose depth
    is not a multiple of ``attn_every``.  On the ``meta`` device the
    weights have shapes and no values."""
    dev = resolve_device(device)
    fam = family(cfg)
    if fam is Z:
        Z.n_groups(cfg)
    module = None
    if serve:
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        if fam is T:
            module = T.Transformer(cfg, dev)
            if dev.type != "meta":
                T.init_params(module, generator)
        else:
            module = fam.build_module(cfg, dev, generator)
    return Model(cfg=cfg, module=module, device=dev)


# ---------------------------------------------------------------------------
# Input specs and synthetic batches
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """A batch input's shape and dtype (JAX's ``ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, object]:
    """The inputs of a train (tokens ``[B, S + 1]``) or prefill (``[B,
    S]``) batch: a vision config adds ``patches [B, frontend_len, d]``, an
    encoder-decoder config ``frames`` (``[B, min(S, 4096), d]`` to train,
    ``[B, 4096, d]`` to prefill), f32.  A decode step's: ``tokens [B]``
    and ``cache``, the model's ``init_cache(B, S)`` tree as specs (its
    ``len`` an int32 scalar, as in JAX), built on the ``meta`` device, so
    a 524,288-slot cache allocates nothing."""
    family(cfg)
    b, s, d = shape.batch, shape.seq, cfg.d_model
    if shape.kind in ("train", "prefill"):
        train = shape.kind == "train"
        specs = {"tokens": TensorSpec((b, s + 1 if train else s),
                                      torch.int32)}
        if cfg.frontend == "vision":
            specs["patches"] = TensorSpec((b, cfg.frontend_len, d),
                                          torch.float32)
        if cfg.enc_dec:
            specs["frames"] = TensorSpec((b, min(s, 4096) if train else 4096,
                                          d), torch.float32)
        return specs
    cache = family(cfg).init_cache(cfg, b, s, torch.device("meta"))
    return {"tokens": TensorSpec((b,), torch.int32),
            "cache": {k: (TensorSpec(tuple(v.shape), v.dtype)
                          if isinstance(v, torch.Tensor)
                          else TensorSpec((), torch.int32))
                      for k, v in cache.items()}}


def synth_batch(cfg: ArchConfig, shape: ShapeSpec, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, object]:
    """A random batch matching ``input_specs``: the JAX package's draws
    from ``default_rng(seed)`` (integers in ``[0, vocab)``, floats
    ``normal * 0.02``), in its order (sorted keys at every level:
    ``cache`` before ``tokens``, ``frames``, ``patches``, ``tokens``), on
    ``device``."""
    rng = np.random.default_rng(seed)
    dev = resolve_device(device)

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(spec[k]) for k in sorted(spec)}
        if spec.dtype.is_floating_point:
            a = (rng.normal(size=spec.shape) * 0.02).astype(np.float32)
        else:
            a = rng.integers(0, cfg.vocab, spec.shape)
        return torch.as_tensor(a, dtype=spec.dtype, device=dev)

    return make(input_specs(cfg, shape))


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------

def make_train_step(model: Model, optimizer: Optional[AdamW] = None,
                    microbatches: Optional[int] = None):
    """``(params, opt_state, batch) → (params, opt_state, metrics)``.

    The batch is cut into ``microbatches`` (default ``cfg.microbatches``)
    along its first axis; each one's gradients are accumulated in f32 and
    the sum divided by their count, then AdamW updates the parameters.
    Metrics: ``loss`` (the mean over microbatches) and ``grad_norm_sq``,
    as 0-dim tensors.  The step returns new parameter tensors; ``params``
    are read, not written, but under ``REPRO_OPTS=donate`` (JAX's dry
    run donates them): then AdamW writes the new values into ``params``
    and the moments in place (``AdamW.update_``) and returns them.
    """
    optimizer = optimizer or AdamW()
    n_mb = microbatches or model.cfg.microbatches

    def train_step(params, opt_state: AdamWState, batch):
        grads, losses = accumulate_grads(model, params, batch, n_mb)
        return optimizer_step(optimizer, params, opt_state, grads, losses)

    return train_step


def optimizer_step(optimizer: AdamW, params, opt_state: AdamWState, grads,
                   losses: torch.Tensor):
    """The train step after its gradients: AdamW's update (in place under
    ``REPRO_OPTS=donate``) and the metrics."""
    if opt_enabled("donate"):
        opt_state = optimizer.update_(grads, opt_state, params)
    else:
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
    metrics = {"loss": losses.mean(),
               "grad_norm_sq": sum(g.square().sum()
                                   for g in tree_leaves(grads))}
    return params, opt_state, metrics


def accumulate_grads(model: Model, params, batch: Dict[str, torch.Tensor],
                     microbatches: int):
    """The gradient of ``model.loss`` over ``batch`` cut into
    ``microbatches`` along its first axis (``dist.split_rows``: each
    rank cuts its own rows of a sharded batch): each microbatch's
    gradients summed in f32 (bf16 under ``REPRO_OPTS=grad_bf16``), then
    divided by their count.  Returns ``(grads, losses [microbatches])``;
    ``params`` are read, not written."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(live)
    mbs = {k: split_rows(v, microbatches) for k, v in batch.items()}
    acc_dtype = torch.bfloat16 if opt_enabled("grad_bf16") else torch.float32
    acc = [torch.zeros_like(p, dtype=acc_dtype) for p in leaves]
    losses = []
    for i in range(microbatches):
        loss = model.loss(live, {k: v[i] for k, v in mbs.items()})
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a += g.to(acc_dtype)
        losses.append(loss.detach())
    it = iter(a / microbatches for a in acc)
    return tree_map(lambda _: next(it), params), torch.stack(losses)
