"""Mixture-of-Experts FFN: top-k routing, capacity-bucketed dispatch.

The counterpart of ``repro/models/moe.py`` (``moe_layer_params``,
``capacity``, ``moe_ffn``, ``load_balance_loss``, ``expert_load_stats``).
Tokens are written into an ``[E, C, D]`` expert buffer at their position in
their expert, the expert FFNs run as batched products over E, and the
results are gathered back weighted by their gates.  Dispatch and combine
are the TOTEM outbox/inbox exchange in another form, expert load skew the
analogue of vertex-degree skew.  The JAX package computes all of it outside
any Pallas kernel, and so does the port: plain PyTorch on tensors.

Kept as JAX defines it:

* routing logits and softmax in f32 (float64 stays float64, as the port's
  ``rms_norm`` keeps it);
* top-k breaks exact ties toward the lower expert index, as
  ``jax.lax.top_k`` does (``torch.topk`` does not): a stable descending
  sort, then its first k;
* gates renormalised by ``max(sum, 1e-9)``;
* a choice's slot in its expert is an exclusive cumsum over the
  ``[T·k, E]`` one-hot in token-major order (earlier tokens first, then
  higher-rank choices); choices at or past the capacity go to slot ``c``,
  which is dropped, and their gate weight is 0.

The buffer is JAX's ``[Z, E, C, D]``: Z data shards, each with its own
capacity, under ``REPRO_OPTS=moe_local`` and a mesh (``data_shard_count``),
else one.  Each kept ``(shard, expert, slot)`` holds exactly one token, so
the buffer is written by indexed assignment, not by an accumulating
scatter: the same values as JAX's scatter-add into zeros, and two runs on
a card are bit-equal.  Gradients flow through the assignment, the gather
and the top-k values (to the gates), as through JAX's.

Under a mesh (DTensor activations) routing, dispatch and combine run on
each rank's local tokens: DTensor has no strategy for the sort, the
cumulative sum or the indexed assignment.  With ``moe_local`` each rank
routes its own data shard, as JAX's shard-local scatter does; with one
global capacity every rank gathers and routes every token (an explicit
replication, ``ROADMAP.md`` Queue 3).  The expert products run on the
DTensor buffer, laid out ``(expert_cap, experts)`` as in JAX.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import dist
from repro_torch.models.common import (ArchConfig, logical_constraint,
                                       opt_enabled)


def moe_layer_params(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """One MoE layer's FFN leaves: the router and the stacked experts
    (``moe_w1`` the fused gate and up projections)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {"moe_wg": (d, e), "moe_w1": (e, d, 2 * f), "moe_w2": (e, f, d)}


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for ``tokens`` tokens: ``tokens · k / E`` times the
    capacity factor, rounded up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.moe_top_k / cfg.moe_experts
            * cfg.moe_capacity_factor)
    return max(8, -(-c // 8) * 8)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order and their indices, exact ties to the lower index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """Where each token's k choices go: ``gates [T, k]`` (renormalised, in
    the logits' dtype), ``expert`` and ``slot [T, k]`` (int64; ``slot ==
    capacity`` for a dropped choice), ``keep [T, k]``, the capacity of a
    shard's expert and the number of data shards (token ``t`` in shard
    ``t // (T / shards)``)."""

    gates: torch.Tensor
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    capacity: int
    shards: int = 1


def router_logits(xt: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """``xt [T, D] @ wg [D, E]`` in f32 (float64 for float64 input)."""
    dt = torch.promote_types(xt.dtype, torch.float32)
    return xt.to(dt) @ wg.to(dt)


def route(logits: torch.Tensor, cfg: ArchConfig, shards: int = 1) -> Routing:
    """Top-k routing of ``logits [T, E]`` with capacity bucketing, each of
    ``shards`` consecutive blocks of tokens with its own capacity."""
    t, e, k = logits.shape[0], cfg.moe_experts, cfg.moe_top_k
    probs = torch.softmax(logits, dim=-1)
    gates, expert = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    c = capacity(t // shards, cfg)
    flat = expert.reshape(t * k, 1)
    onehot = torch.zeros(t * k, e, dtype=torch.int64,
                         device=logits.device).scatter_(1, flat, 1)
    # earlier tokens and higher-rank choices claim slots first, per shard
    blocks = onehot.reshape(shards, t * k // shards, e)
    pos = (blocks.cumsum(1) - blocks).reshape(t * k, e)
    pos = pos.gather(1, flat).reshape(t, k)
    keep = pos < c
    return Routing(gates, expert, pos.clamp_max(c), keep, c, shards)


def _shard_of(r: Routing) -> torch.Tensor:
    """Each (token, choice)'s data shard ``[T, k]``."""
    t, k = r.expert.shape
    z = torch.arange(t, device=r.expert.device) // (t // r.shards)
    return z[:, None].expand(t, k)


def dispatch(xt: torch.Tensor, r: Routing, experts: int) -> torch.Tensor:
    """The expert buffer ``[Z, E, c, D]``: token t's row at ``(shard,
    expert, slot)`` of each kept choice, zeros in the slots nobody
    claimed.  Dropped choices land in the overflow slot ``c``, cut off
    here."""
    t, d = xt.shape
    k = r.expert.shape[1]
    buf = xt.new_zeros(r.shards, experts, r.capacity + 1, d)
    rows = xt[:, None].expand(t, k, d).reshape(t * k, d)
    buf[_shard_of(r).reshape(-1), r.expert.reshape(-1),
        r.slot.reshape(-1)] = rows
    return buf[:, :, :r.capacity]


def expert_ffn(buf: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """Every expert's SwiGLU on its buffer rows, batched over Z and E, in
    the buffer's dtype: ``[Z, E, c, D] @ w1 [E, D, 2F]``, ``silu(gate) *
    up``, then ``@ w2 [E, F, D]`` (each product hinted ``(expert_cap,
    experts)``, not ``ffn``: the experts hold the model axis)."""
    h = torch.einsum("zecd,edf->zecf", buf, w1.to(buf.dtype))
    gate, up = h.chunk(2, dim=-1)
    h = logical_constraint(F.silu(gate) * up, "expert_cap", "experts", None,
                           None)
    y = torch.einsum("zecf,efd->zecd", h, w2.to(buf.dtype))
    return logical_constraint(y, "expert_cap", "experts", None, None)


def combine(y: torch.Tensor, r: Routing) -> torch.Tensor:
    """``[T, D]``: each token's k expert outputs (0 for a dropped choice)
    weighted by ``gates * keep`` in ``y``'s dtype and summed over k."""
    y = F.pad(y, (0, 0, 0, 1))                       # overflow slot = 0
    out_tk = y[_shard_of(r), r.expert, r.slot]       # [T, k, D]
    w = (r.gates * r.keep).to(out_tk.dtype)
    return (out_tk * w[..., None]).sum(1)


def moe_ffn(x: torch.Tensor, lp: Dict[str, torch.Tensor],
            cfg: ArchConfig) -> torch.Tensor:
    """``x [B, S, D]`` → ``[B, S, D]`` with the layer's ``moe_wg``,
    ``moe_w1`` and ``moe_w2``."""
    from repro_torch.launch import sharding as shd   # on use: no cycle
    b, s, d = x.shape
    z = shd.data_shard_count() if opt_enabled("moe_local") else 1
    if (b * s) % z:
        z = 1
    mesh = getattr(x, "device_mesh", None)
    # each rank's tokens: its batch rows when every shard's capacity is
    # its own (moe_local), else all of them (a plain x: itself)
    xl, pl = dist.batch_local(x, (0,) if z > 1 else ())
    split = dist.shard_count(pl, mesh)
    if z % split:
        xl, pl = dist.batch_local(x, ())
        split = 1
    xt = xl.reshape(xl.shape[0] * s, d)
    r = route(router_logits(xt, dist.replicated_local(lp["moe_wg"], pl)),
              cfg, z // split)
    buf = dist.rebuild(dispatch(xt, r, cfg.moe_experts), pl, mesh)
    buf = logical_constraint(buf, "expert_cap", "experts", None, None)
    y = expert_ffn(buf, lp["moe_w1"], lp["moe_w2"])
    out = combine(dist.local_as(y, pl), r)
    return dist.rebuild(out.reshape(xl.shape[0], s, d), pl, mesh)


def load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Shazeer aux loss: ``E · Σ_e fraction_e · prob_e`` over the tokens'
    first choices."""
    dt = torch.promote_types(logits.dtype, torch.float32)
    probs = torch.softmax(logits.to(dt), dim=-1)
    frac = F.one_hot(expert_idx[..., 0].long(), num_experts).to(dt).mean(0)
    return num_experts * (frac * probs.mean(0)).sum()


def expert_load_stats(logits: torch.Tensor,
                      cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Expert token-load histogram, the 'degree distribution' of the MoE
    workload: ``counts [E]`` (choices per expert, f32) and
    ``max_over_mean``."""
    _, idx = top_k(torch.softmax(logits, dim=-1), cfg.moe_top_k)
    counts = F.one_hot(idx, cfg.moe_experts).sum((0, 1)).float()
    return {"counts": counts,
            "max_over_mean": counts.max() / counts.mean().clamp_min(1e-9)}
