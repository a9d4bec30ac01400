"""Zamba2-style hybrid: a Mamba2 backbone with one shared attention + MLP
block: the ``hybrid`` family (zamba2-2.7b).

The counterpart of ``repro/models/zamba.py`` (``n_groups``,
``init_params``, ``_shared_attn_block``, ``_forward``, ``loss_fn``,
``init_cache``, ``prefill``, ``decode_step``).  zamba2-2.7b: 54 mamba2
layers, and after every ``attn_every`` (6) of them the one
parameter-shared block (MHA, 32 heads of 80, and a SwiGLU MLP): 9
invocations, each with its own KV cache.  As in the JAX model: one shared
block, no LoRA, no re-injected embeddings.

The shared block is ``transformer.decoder_layer`` (its prefill attention
``attention.chunked_attention``, the flash kernel on the card, at head dim
80) and ``transformer.decode_layer`` in a decode step (``decode_attention``
over the live slots); ``loss_fn`` runs ``attention.training_attention``,
since the flash kernel has no backward.  The mamba layers are
``mamba2.mamba_block``: the chunked SSD in a prefill (its final state and
conv tail go to the cache), the one-step recurrence in a decode step.

Cache dtypes are JAX's: ``conv``, ``k``, ``v`` in the compute dtype;
``ssd`` in the compute dtype after the prefill and f32 after the first
decode step (``ssd_step`` promotes it), so the port upcasts the leaf at
the first step and keeps every state unrounded from then on.  Decode
steps write the cache in place (JAX returns a new one).  Serving weights
live in a ``common.TreeModule`` (``embed``, ``mamba.*`` stacked on L,
``shared_attn.*``, ``final_norm``), in the compute dtype but for
``final_norm``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import dist
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as mb
from repro_torch.models.common import (ArchConfig, LeafSpec, TreeModule,
                                       cross_entropy_loss, draw_tree,
                                       dtype_of, embed_tokens, layer_weight,
                                       serving,
                                       logical_constraint, tied_logits,
                                       work_dtype)
from repro_torch.models.transformer import decode_layer, decoder_layer

Params = Dict[str, object]
Cache = Dict[str, object]


def n_groups(cfg: ArchConfig) -> int:
    """Shared-block invocations: ``n_layers / attn_every``, which must
    divide (JAX asserts it)."""
    if cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_every {cfg.attn_every}")
    return cfg.n_layers // cfg.attn_every


def shared_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.hd
    h, g = cfg.n_heads, cfg.n_kv_heads
    return {"norm1": (d,), "norm2": (d,),
            "wq": (d, h * hd), "wk": (d, g * hd), "wv": (d, g * hd),
            "wo": (h * hd, d), "w_gate": (d, cfg.d_ff),
            "w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}


def param_spec(cfg: ArchConfig) -> List[LeafSpec]:
    """``init_params``'s leaves in order: the embedding, the mamba stack
    (``mamba2.mamba_stack_spec``), the shared block (norms 0, weights
    normal over their input width), the final norm."""
    n_groups(cfg)
    spec: List[LeafSpec] = [(("embed",), (cfg.vocab, cfg.d_model),
                             ("normal", cfg.d_model))]
    spec += mb.mamba_stack_spec(cfg, cfg.n_layers, "mamba")
    for name, shape in shared_param_shapes(cfg).items():
        init = ("const", 0.0) if name.startswith("norm") else (
            "normal", shape[-2])
        spec.append((("shared_attn", name), shape, init))
    spec.append((("final_norm",), (cfg.d_model,), ("const", 0.0)))
    return spec


def init_train_params(cfg: ArchConfig, generator: torch.Generator,
                      device: torch.device) -> Params:
    """The master parameters in ``cfg.param_dtype`` (the JAX tree)."""
    pdt = dtype_of(cfg.param_dtype)
    return draw_tree(param_spec(cfg), generator, device, lambda _: pdt)


def build_module(cfg: ArchConfig, device: torch.device,
                 generator: torch.Generator) -> TreeModule:
    """The serving weights: ``init_train_params``'s numbers, in the compute
    dtype but for ``final_norm``."""
    cdt, pdt = dtype_of(cfg.compute_dtype), dtype_of(cfg.param_dtype)
    return TreeModule(cfg, draw_tree(
        param_spec(cfg), generator, device,
        lambda path: pdt if path == ("final_norm",) else cdt))


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(shape) for _, shape, _ in param_spec(cfg))


def _mamba(params: Params, i: int, dtype: torch.dtype):
    """Mamba layer ``i``'s weights cast to ``dtype`` (a no-op for the
    serving module's)."""
    return {k: layer_weight(w[i], dtype) for k, w in params["mamba"].items()}


def _shared(params: Params, dtype: torch.dtype):
    return {k: layer_weight(w, dtype)
            for k, w in params["shared_attn"].items()}


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device, enc_len: int = 0) -> Cache:
    """``conv [L, B, K-1, C]``, ``ssd [L, B, H, P, N]`` and the shared
    block's ``k``, ``v [n_groups, B, max_len, G, hd]``, zeroed in the
    compute dtype, and ``len`` (a Python int)."""
    del enc_len
    cdt = dtype_of(cfg.compute_dtype)
    di = cfg.ssm_expand * cfg.d_model
    n = cfg.ssm_state
    kv = (n_groups(cfg), batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "conv": dist.cache_tensor((cfg.n_layers, batch, cfg.ssm_conv - 1,
                              di + 2 * n), cdt, device),
        "ssd": dist.cache_tensor((cfg.n_layers, batch, di // mb.HEAD_DIM,
                             mb.HEAD_DIM, n), cdt, device),
        "k": dist.cache_tensor(kv, cdt, device), "v": dist.cache_tensor(kv, cdt, device),
        "len": 0,
    }


@serving
def prefill(model: TreeModule, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """The prompt ``batch["tokens"] [B, S]`` in parallel: each mamba
    layer's chunked SSD with its final state and conv tail, each shared
    block through the flash kernel with its k and v; returns the last
    token's logits ``[B, vocab]`` and a cache of ``max(max_len, S)``
    slots."""
    cfg, params = model.cfg, model.tree()
    cdt = dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, max(max_len or s, s), model.device)
    x = embed_tokens(params, tokens, cdt)
    positions = torch.arange(s, device=model.device)[None]
    shared = _shared(params, cdt)
    for gi in range(n_groups(cfg)):
        for j in range(cfg.attn_every):
            i = gi * cfg.attn_every + j
            x, (conv_t, ssd_st) = mb.mamba_block(x, _mamba(params, i, cdt),
                                                 cfg, return_state=True)
            x = x.to(cdt)
            cache["conv"][i], cache["ssd"][i] = conv_t, ssd_st
        x, k, v = decoder_layer(cfg, shared, x, positions, 0,
                                attn.chunked_attention)
        x = logical_constraint(x, "batch", "seq", None)
        cache["k"][gi, :, :s], cache["v"][gi, :, :s] = k, v
    cache["len"] = s
    return tied_logits(params, cfg, x[:, -1:])[:, 0], cache


@serving
def decode_step(model: TreeModule, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step for ``tokens [B]``: (logits ``[B, vocab]``, the
    cache).  Each mamba layer's one-step recurrence from its conv tail
    and SSD state, the shared block's k and v into slot ``len``; the
    cache is written in place (its ``ssd`` leaf upcast at the first
    step)."""
    cfg, params = model.cfg, model.tree()
    cdt = dtype_of(cfg.compute_dtype)
    pos = int(cache["len"])
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache is full ({cache['k'].shape[2]} slots)")
    if cache["ssd"].dtype != work_dtype(cdt):
        cache["ssd"] = cache["ssd"].to(work_dtype(cdt))
    x = embed_tokens(params, tokens[:, None], cdt)
    positions = torch.full((1, 1), pos, device=model.device)
    shared = _shared(params, cdt)
    for gi in range(n_groups(cfg)):
        for j in range(cfg.attn_every):
            i = gi * cfg.attn_every + j
            x, (conv_t, ssd_st) = mb.mamba_block(
                x, _mamba(params, i, cdt), cfg,
                state=(cache["conv"][i], cache["ssd"][i]))
            x = x.to(cdt)
            cache["conv"][i], cache["ssd"][i] = conv_t, ssd_st
        x = decode_layer(cfg, shared, x, positions, cache["k"][gi],
                         cache["v"][gi], pos)
    cache["len"] = pos + 1
    return tied_logits(params, cfg, x)[:, 0], cache


def _train_mamba(cfg: ArchConfig, chunk: int, x: torch.Tensor,
                 *weights: torch.Tensor) -> torch.Tensor:
    lp = dict(zip(mb.mamba_param_shapes(cfg),
                  (layer_weight(w, x.dtype) for w in weights)))
    return mb.mamba_block(x, lp, cfg, chunk=chunk).to(x.dtype)


def _train_shared(cfg: ArchConfig, attention, x: torch.Tensor,
                  *weights: torch.Tensor) -> torch.Tensor:
    lp = dict(zip(shared_param_shapes(cfg),
                  (layer_weight(w, x.dtype) for w in weights)))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    return decoder_layer(cfg, lp, x, positions, 0, attention)[0]


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            ssd_chunk: int = 128, train: bool = False) -> torch.Tensor:
    """JAX's ``_forward`` without a cache: all positions in parallel;
    returns the logits ``[B, S, vocab]``.  ``train``: the shared block's
    attention is ``training_attention`` and, when ``cfg.remat``, each
    mamba layer and each shared block is checkpointed (as JAX remats
    both); else the serving attention (the flash kernel on the card)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = embed_tokens(params, tokens, cdt)
    attention = attn.training_attention if train else attn.chunked_attention
    remat = train and cfg.remat
    mnames, snames = list(mb.mamba_param_shapes(cfg)), list(
        shared_param_shapes(cfg))

    def run(fn, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))

    for gi in range(n_groups(cfg)):
        for j in range(cfg.attn_every):
            i = gi * cfg.attn_every + j
            x = run(_train_mamba, cfg, ssd_chunk, x,
                    *(params["mamba"][k][i] for k in mnames))
        x = run(_train_shared, cfg, attention, x,
                *(params["shared_attn"][k] for k in snames))
        x = logical_constraint(x, "batch", "seq", None)
    return tied_logits(params, cfg, x)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], *,
            cfg: ArchConfig) -> torch.Tensor:
    """One microbatch's token-mean cross entropy: ``batch["tokens"] [B, S
    + 1]``, the first S read and the last S predicted."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens[:, :-1], train=True)
    return cross_entropy_loss(logits, tokens[:, 1:].to(logits.device))
