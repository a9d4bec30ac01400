"""Decoder-only transformer with GQA, RoPE and SwiGLU or MoE feed-forwards:
the dense and MoE families.

The counterpart of ``repro/models/transformer.py`` (``_layer_param_shapes``,
``init_params``, ``layer_windows``, ``_qkv``, ``_ffn``, ``_embed_inputs``,
``_lm_logits``, ``loss_fn``, ``init_cache``, ``prefill``,
``decode_step``).  The JAX package stacks the layers on a leading L axis
and runs them under ``lax.scan``; here each layer runs in a Python loop,
so every layer's attention window is a Python int.

Serving: each layer is a ``DecoderLayer`` in an ``nn.ModuleList`` and the
prefill attention is the flash kernel (``attention.chunked_attention``).
Weights keep the JAX layout ``[in, out]`` (``x @ W``) and are stored in the
compute dtype, cast once when they are set: the JAX package casts the f32
parameters to the compute dtype per layer per call, which rounds them the
same way.  The final norm's scale stays in the parameter dtype, as it does
in the JAX ``_lm_logits``.

Training is functional, as in JAX: ``init_train_params`` gives the JAX
pytree (``embed``, ``layers`` stacked on a leading L axis, ``final_norm``,
``lm_head``) in the parameter dtype, and ``loss_fn(params, batch, cfg=)``
casts each layer's slice to the compute dtype per call, so gradients reach
the f32 leaves.  Its attention is ``attention.training_attention`` (the
flash kernel has no backward), and ``cfg.remat`` checkpoints each layer
(``torch.utils.checkpoint``, JAX's ``nothing_saveable``).

An MoE config (``cfg.is_moe``: olmoe, qwen3-moe) replaces each layer's
SwiGLU leaves by the router and the stacked experts and calls
``moe.moe_ffn`` in prefill, decode and ``loss_fn``, as the JAX layer does.

Not here yet (``ROADMAP.md`` Queue 1 item 15): the encoder-decoder, vision,
SSM and hybrid families.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.common import (ArchConfig, cross_entropy_loss,
                                       dtype_of, rms_norm, rope)
from repro_torch.models.moe import moe_ffn, moe_layer_params

Cache = Dict[str, object]

_NOT_PORTED = ("not ported yet: ROADMAP.md Queue 1 item 15 brings the "
               "encoder-decoder, vision, SSM and hybrid models")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    if cfg.family not in ("dense", "moe") or cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(f"{cfg.name} (family {cfg.family!r}) is "
                                  f"{_NOT_PORTED}")


def layer_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """One layer's parameters and shapes, in the JAX order: the MoE leaves
    in place of the SwiGLU ones when ``cfg.is_moe``."""
    d, hd = cfg.d_model, cfg.hd
    h, g, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shapes = {"norm1": (d,), "norm2": (d,),
              "wq": (d, h * hd), "wk": (d, g * hd), "wv": (d, g * hd),
              "wo": (h * hd, d)}
    if cfg.is_moe:
        shapes.update(moe_layer_params(cfg))
    else:
        shapes.update({"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)})
    return shapes


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (0 = full causal). gemma3: N local : 1
    global."""
    if cfg.local_global_ratio and cfg.local_window:
        period = cfg.local_global_ratio + 1
        idx = np.arange(cfg.n_layers)
        return np.where((idx + 1) % period == 0, 0,
                        cfg.local_window).astype(np.int32)
    return np.zeros(cfg.n_layers, dtype=np.int32)


def _qkv(cfg: ArchConfig, lp: Dict[str, torch.Tensor], h: torch.Tensor):
    """``_qkv``: q ``[B, S, G, R, hd]``, k and v ``[B, S, G, hd]``."""
    b, s, _ = h.shape
    g, hd = cfg.n_kv_heads, cfg.hd
    r = cfg.n_heads // g
    return ((h @ lp["wq"]).reshape(b, s, g, r, hd),
            (h @ lp["wk"]).reshape(b, s, g, hd),
            (h @ lp["wv"]).reshape(b, s, g, hd))


def _ffn(cfg: ArchConfig, lp: Dict[str, torch.Tensor],
         h: torch.Tensor) -> torch.Tensor:
    """The layer's feed-forward: ``moe_ffn`` for an MoE config, else
    ``_ffn`` (SwiGLU)."""
    if cfg.is_moe:
        return moe_ffn(h, lp, cfg)
    return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _decoder_layer(cfg: ArchConfig, lp: Dict[str, torch.Tensor],
                   x: torch.Tensor, positions: torch.Tensor, window: int,
                   attention) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """``_decoder_layer`` (one pre-norm block: attention, then the SwiGLU
    or MoE feed-forward) on ``x [B, S, d]`` with the weights ``lp`` and an
    ``attention`` function of the ``chunked_attention`` signature; returns
    ``x`` and the layer's k and v."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, window=window, causal=True,
                  q_chunk=attn.pick_chunk(s, 2048),
                  k_chunk=attn.pick_chunk(s, 1024))
    x = x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ lp["wo"]
    x = x + _ffn(cfg, lp, rms_norm(x, lp["norm2"], cfg.norm_eps))
    return x, k, v


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm block: attention, then the SwiGLU or MoE
    feed-forward."""

    def __init__(self, cfg: ArchConfig, window: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.window = int(window)
        for name, shape in layer_param_shapes(cfg).items():
            setattr(self, name, _weight(shape, dtype, device))

    @property
    def weights(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in layer_param_shapes(
            self.cfg)}

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Prefill: ``x [B, S, d]`` → (``x``, this layer's k and v), the
        attention through the flash kernel."""
        return _decoder_layer(self.cfg, self.weights, x, positions,
                              self.window, attn.chunked_attention)

    def decode(self, x: torch.Tensor, positions: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: int) -> torch.Tensor:
        """One token ``x [B, 1, d]`` at position ``pos``: writes its k and v
        into this layer's caches ``[B, max_len, G, hd]`` in place."""
        cfg, lp = self.cfg, self.weights
        b = x.shape[0]
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        o = attn.decode_attention(q, k_cache, v_cache, cache_len=pos + 1,
                                  window=self.window)
        x = x + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ lp["wo"]
        return x + _ffn(cfg, lp, rms_norm(x, lp["norm2"], cfg.norm_eps))


class Transformer(nn.Module):
    """The dense decoder: token embedding, the layers, the final norm and
    the LM head (the embedding's transpose when tied).  Parameter names
    follow the JAX pytree: ``embed``, ``layers.<i>.<name>``, ``final_norm``,
    ``lm_head``."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        cdt, pdt = self.compute_dtype, dtype_of(cfg.param_dtype)
        self.embed = _weight((cfg.vocab, cfg.d_model), cdt, device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, w, cdt, device) for w in layer_windows(cfg))
        self.final_norm = _weight((cfg.d_model,), pdt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((cfg.d_model, cfg.vocab), cdt, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """``_embed_inputs`` (tokens only): the compute-dtype embedding
        times ``sqrt(d_model)``, the factor rounded to the compute dtype
        first as JAX rounds a Python scalar.  The factor is a CPU scalar
        tensor: no copy to the card per call."""
        scale = torch.tensor(math.sqrt(self.cfg.d_model),
                             dtype=self.compute_dtype)
        return self.embed[tokens.to(self.device)] * scale

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``_lm_logits``: final norm, then the head, in ``x``'s dtype."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.t() if self.cfg.tie_embeddings else self.lm_head
        return x @ head


def init_params(model: Transformer, generator: torch.Generator) -> None:
    """Fill ``model`` with the JAX package's initial distribution: each
    weight normal times ``1/sqrt(fan_in)`` (fan_in ``d_model`` for the
    embedding, else the weight's input width ``shape[-2]``: D for the
    stacked experts ``[E, D, 2F]``), drawn in f32 from ``generator`` and
    cast to the weight's dtype; norms at zero.  Weights are drawn in
    parameter order; the numbers are the generator's, not JAX's."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith(("norm", "final_norm")):
                p.zero_()
                continue
            fan_in = model.cfg.d_model if name == "embed" else p.shape[-2]
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
            p.copy_(w.mul_(1.0 / math.sqrt(max(fan_in, 1))))


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device) -> Cache:
    """KV caches ``[L, B, max_len, G, hd]`` in the compute dtype, zeroed,
    and ``len`` (a Python int)."""
    cdt = dtype_of(cfg.compute_dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device), "len": 0}


@torch.inference_mode()
def prefill(model: Transformer, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Process the full prompt ``batch["tokens"] [B, S]``; returns
    (last-token logits ``[B, vocab]``, cache with ``max_len`` slots)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = model.embed_tokens(tokens)
    max_len = max(max_len or s, s)
    positions = torch.arange(s, device=model.device)[None]
    cache = init_cache(model.cfg, b, max_len, model.device)
    for i, layer in enumerate(model.layers):
        x, k, v = layer(x, positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["len"] = s
    return model.logits(x[:, -1:])[:, 0], cache


@torch.inference_mode()
def decode_step(model: Transformer, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step for ``tokens [B]``: returns (logits ``[B, vocab]``,
    the cache).  The cache is updated in place (the JAX function returns a
    new one): the token's k and v go to slot ``len``, and ``len`` grows by
    one."""
    pos = int(cache["len"])
    k_all, v_all = cache["k"], cache["v"]
    if pos >= k_all.shape[2]:
        raise ValueError(f"the cache is full ({k_all.shape[2]} slots)")
    x = model.embed_tokens(tokens[:, None])
    positions = torch.full((1, 1), pos, device=model.device)
    for i, layer in enumerate(model.layers):
        x = layer.decode(x, positions, k_all[i], v_all[i], pos)
    cache["len"] = pos + 1
    return model.logits(x)[:, 0], cache


# ---------------------------------------------------------------------------
# Training: the JAX pytree of parameter-dtype leaves, cast per layer per call
# ---------------------------------------------------------------------------

Params = Dict[str, object]


def init_train_params(cfg: ArchConfig, generator: torch.Generator,
                      device: torch.device) -> Params:
    """The master parameters in ``cfg.param_dtype``: ``embed``, ``layers``
    (each weight stacked ``[L, ...]``), ``final_norm`` and, untied,
    ``lm_head``.  Drawn as :func:`init_params` draws a module (the same
    order and numbers, before its cast to the compute dtype), so
    ``convert.lm_params`` loads them into a serving module."""
    check_supported(cfg)
    pdt = dtype_of(cfg.param_dtype)

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(device, pdt)

    # the module's parameter order: its own (embed, final_norm, lm_head),
    # then each layer's
    params: Params = {"embed": draw((cfg.vocab, cfg.d_model), cfg.d_model)}
    params["final_norm"] = torch.zeros(cfg.d_model, dtype=pdt,
                                       device=device)
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((cfg.d_model, cfg.vocab), cfg.d_model)
    shapes = layer_param_shapes(cfg)
    per_layer = {k: [] for k in shapes}
    for _ in range(cfg.n_layers):
        for name, shape in shapes.items():
            per_layer[name].append(
                torch.zeros(shape, dtype=pdt, device=device)
                if name.startswith("norm") else draw(shape, shape[-2]))
    params["layers"] = {k: torch.stack(v) for k, v in per_layer.items()}
    return params


def _train_layer(cfg: ArchConfig, window: int, x: torch.Tensor,
                 *weights: torch.Tensor) -> torch.Tensor:
    """``_decoder_layer`` on one layer's weights (in ``layer_param_shapes``
    order), each cast to ``x``'s dtype here, inside the checkpointed
    region, as JAX casts inside its scan body.  The positions are made
    from ``x`` on its device at every call, the recompute's included."""
    lp = dict(zip(layer_param_shapes(cfg), (w.to(x.dtype) for w in weights)))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    return _decoder_layer(cfg, lp, x, positions, window,
                          attn.training_attention)[0]


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], *,
            cfg: ArchConfig) -> torch.Tensor:
    """One microbatch forward and its token-mean cross entropy (the JAX
    ``loss_fn``).  ``batch["tokens"] [B, S + 1]``: the model reads the
    first S tokens and predicts the last S.  Runs on the parameters'
    device."""
    check_supported(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    embed = params["embed"]
    tokens = batch["tokens"].to(embed.device).long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    # the scale rounded to the compute dtype, as JAX rounds a Python scalar
    x = embed[inputs].to(cdt) * torch.tensor(math.sqrt(cfg.d_model),
                                             dtype=cdt)
    names = list(layer_param_shapes(cfg))
    stack = params["layers"]
    for i, window in enumerate(layer_windows(cfg)):
        weights = [stack[k][i] for k in names]
        if cfg.remat:
            x = checkpoint(_train_layer, cfg, int(window), x, *weights,
                           use_reentrant=False)
        else:
            x = _train_layer(cfg, int(window), x, *weights)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = embed.t() if cfg.tie_embeddings else params["lm_head"]
    return cross_entropy_loss(x @ head.to(x.dtype), labels)
