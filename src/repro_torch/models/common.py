"""Shared model pieces: the architecture config, a promoting ``einsum``,
RMS norm, RoPE, the cross-entropy loss, and the weights of a model kept
as the JAX pytree (``TreeModule``, ``draw_tree``).

Copied from ``repro/models/common.py`` (which imports JAX), with its
sharding hint ``logical_constraint`` (resolved by ``launch/sharding.py``
under ``activation_rules``; the argument itself outside them) and its
optimization flags ``opt_enabled`` (``REPRO_OPTS``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import dist


def serving(fn: Callable) -> Callable:
    """Run ``fn`` under ``torch.inference_mode``, or ``torch.no_grad``
    under ``activation_rules`` (views of DTensor parameters cannot be made
    in inference mode)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        from repro_torch.launch import sharding as shd   # on use: no cycle
        with (torch.no_grad() if shd.active_mesh() is not None
              else torch.inference_mode()):
            return fn(*args, **kwargs)
    return run


def opt_enabled(flag: str) -> bool:
    """Beyond-paper optimization flags, selected by the environment
    (``REPRO_OPTS=bf16_stack,remat_dots,...``), as in the JAX package:
    ``bf16_stack`` (cast the layer stacks to the compute dtype before the
    layer loop, so FSDP gathers move bf16), ``remat_dots`` (the
    checkpoint saves product outputs instead of recomputing them),
    ``grad_bf16`` (a bf16 gradient accumulator), ``moe_local`` (MoE
    capacity per data shard: dispatch stays shard-local), ``seq_shard``
    (a sequence-sharded residual stream); the dry run's own
    ``serve_bf16``, ``donate``, ``cache_seq_shard`` and
    ``graph_bf16_msgs``."""
    return flag in os.environ.get("REPRO_OPTS", "").split(",")


def logical_constraint(x: torch.Tensor, *names: Optional[str]):
    """Annotate an activation's layout with logical axis names, resolved
    to mesh axes by ``launch/sharding.py``'s rules; ``x`` itself when no
    rules are active or ``x`` is a plain tensor (one card)."""
    from repro_torch.launch import sharding as shd   # on use: no cycle
    return shd.constrain(x, names)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 → d_model // n_heads
    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    # --- attention pattern ---
    local_window: int = 0         # sliding-window size for local layers
    local_global_ratio: int = 0   # N local layers per 1 global (gemma3: 5)
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0           # zamba: shared attn block every N ssm layers
    slstm_every: int = 0          # xlstm: sLSTM block every N layers
    # --- structure ---
    enc_dec: bool = False         # seamless: encoder-decoder
    frontend: str = ""            # "audio" | "vision" | ""
    frontend_len: int = 256       # prepended embedding length (vision)
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    # --- training ---
    microbatches: int = 16        # grad-accumulation steps within a step
    remat: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- shapes this arch supports ---
    sub_quadratic: bool = False   # may run long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def reduced(self, **overrides) -> "ArchConfig":
        """A smoke-test sized config of the same family."""
        base = dict(
            n_layers=min(self.n_layers, 4) or 2,
            d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 2,
            d_ff=128 if self.d_ff else 0,
            vocab=256, head_dim=16,
            moe_experts=8 if self.moe_experts else 0,
            moe_top_k=2 if self.moe_top_k else 0,
            local_window=8 if self.local_window else 0,
            ssm_state=16 if self.ssm_state else 0,
            attn_every=2 if self.attn_every else 0,
            slstm_every=self.slstm_every and 2,
            frontend_len=8 if self.frontend else 256,
            microbatches=1,
            name=self.name + "-smoke",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


def dtype_of(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (the config's dtype strings)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def work_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype where the JAX model names float32: float32, but float64
    stays float64 (the card's yardstick runs)."""
    return torch.promote_types(dtype, torch.float32)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to one dtype first, as
    ``jnp.einsum`` promotes them (bf16 with f32 gives f32);
    ``torch.einsum`` refuses mixed dtypes."""
    dtype = operands[0].dtype
    for t in operands[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return torch.einsum(equation, *(t.to(dtype) for t in operands))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32 (float64 for
    float64 input), cast back to ``x``'s dtype.  ``scale`` is an offset
    (zeros at init), and ``1 + scale`` is formed in ``scale``'s own dtype,
    as in the JAX package."""
    dtype = x.dtype
    x = x.to(torch.promote_types(dtype, torch.float32))
    var = x.square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * (1.0 + scale)).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Split-half rotary embedding in f32, cast back to ``x``'s dtype.
    ``x [..., S, H?, D]`` with ``positions [..., S]``."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., None].float() * freqs         # [..., S, half]
    while angles.dim() < x.dim():                         # the head axis
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy: the logits in f32 (float64 stays float64),
    ``logsumexp`` minus the gold logit, averaged over the tokens (over
    ``mask``'s weight when given, at least 1).

    Vocab-sharded DTensor logits are gathered over the vocab (each rank
    keeping its batch rows), the loss summed on each rank's rows and the
    sums added over the data shards: DTensor has no working strategy for
    the gold logit's gather on a sharded vocab."""
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        local, pl = dist.batch_local(logits)
        lab = dist.batch_local(labels)[0]
        if mask is None:
            num = cross_entropy_sum(local, lab)
            den = float(math.prod(logits.shape[:-1]))
            return dist.partial_sum(num, pl, mesh) / den
        m = dist.batch_local(mask)[0]
        num = dist.partial_sum(cross_entropy_sum(local, lab, m), pl, mesh)
        den = dist.partial_sum(m.to(num.dtype).sum(), pl, mesh)
        return num / den.clamp_min(1.0)
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long()).squeeze(-1)
    nll = logz - gold
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The summed (masked) token losses of plain tensors."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long()).squeeze(-1)
    nll = logz - gold
    if mask is not None:
        nll = nll * mask.to(nll.dtype)
    return nll.sum()


def _save_dots(ctx, op, *args, **kwargs):
    """Keep the outputs of products without batch dims (JAX's
    ``dots_with_no_batch_dims_saveable``): ``x @ W`` lowers to ``mm``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def layer_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A layer's weight cast to ``dtype`` (a no-op when it is already)
    and, under a mesh, gathered over the data axes
    (``dist.fsdp_gather``)."""
    return dist.fsdp_gather(w.to(dtype))


def remat(fn: Callable, *args, save_dots: bool = False):
    """``fn(*args)`` checkpointed (JAX's ``jax.checkpoint``): nothing
    saved but the inputs (``nothing_saveable``), or with ``save_dots`` the
    outputs of the products too (``remat_dots``)."""
    if not save_dots:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: create_selective_checkpoint_contexts(
                          _save_dots))


# ---------------------------------------------------------------------------
# Weights as the JAX pytree (the SSM and hybrid families)
# ---------------------------------------------------------------------------

# A leaf's initial value: ("normal", fan_in) draws normal times
# 1/sqrt(fan_in) (the JAX ``dense_init``); ("const", v) fills with v.
Init = Tuple[str, float]
# (path, shape, init): path ("embed",) or ("layers", "wq")
LeafSpec = Tuple[Tuple[str, ...], Tuple[int, ...], Init]


def draw_tree(spec: Sequence[LeafSpec], generator: torch.Generator,
              device: torch.device,
              dtype: Callable[[Tuple[str, ...]], torch.dtype]
              ) -> Dict[str, object]:
    """The nested dict of ``spec``'s leaves, each drawn in f32 from
    ``generator`` (in ``spec``'s order) and cast to ``dtype(path)`` on
    ``device``.  The numbers are the generator's, not JAX's; on the
    ``meta`` device nothing is drawn (the shapes alone)."""
    tree: Dict[str, object] = {}
    for path, shape, (kind, value) in spec:
        if device.type == "meta":                  # shapes only
            w = torch.empty(shape, dtype=dtype(path), device=device)
        elif kind == "normal":
            w = torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=generator.device)
            w = w.mul_(1.0 / math.sqrt(max(value, 1))).to(device,
                                                          dtype(path))
        else:
            w = torch.full(shape, float(value), dtype=dtype(path),
                           device=device)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = w
    return tree


def embed_tokens(params: Dict[str, object], tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The rows of ``params["embed"]`` at ``tokens``, cast to ``dtype``
    (JAX's ``take(...).astype``; these families do not scale them), hinted
    ``(batch, seq, None)``: JAX gives no hint here, and DTensor would
    carry the table's layout (its model dim sharded over data) into the
    residual stream."""
    embed = params["embed"]
    x = dist.embed_lookup(embed, tokens.to(embed.device).long(), dtype)
    return logical_constraint(x, "batch", "seq", None)


def tied_logits(params: Dict[str, object], cfg: ArchConfig,
                x: torch.Tensor) -> torch.Tensor:
    """The final norm (its scale in the parameter dtype), then the
    embedding's transpose as the head, in ``x``'s dtype."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = dist.fsdp_gather(params["embed"].to(x.dtype)).t()
    return logical_constraint(x @ head, "batch", None, "vocab")


class TreeModule(nn.Module):
    """A model's weights held as its JAX pytree: each top-level leaf a
    parameter, each nested dict an ``nn.ParameterDict`` of stacked leaves,
    so the state dict's keys are the tree's paths joined by dots
    (``embed``, ``layers.wq``).  Serving only: nothing requires grad."""

    def __init__(self, cfg: ArchConfig, tree: Dict[str, object]):
        super().__init__()
        self.cfg = cfg
        for key, val in tree.items():
            if isinstance(val, dict):
                setattr(self, key, nn.ParameterDict({
                    k: nn.Parameter(v, requires_grad=False)
                    for k, v in val.items()}))
            else:
                setattr(self, key, nn.Parameter(val, requires_grad=False))
        self._keys = tuple(tree)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def tree(self) -> Dict[str, Union[torch.Tensor, Dict]]:
        """The weights as the nested dict the model functions take."""
        out = {}
        for key in self._keys:
            val = getattr(self, key)
            out[key] = (dict(val.items()) if isinstance(val, nn.ParameterDict)
                        else val)
        return out
