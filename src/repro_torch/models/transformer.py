"""Decoder-only transformer with GQA, RoPE and SwiGLU: the dense family.

The counterpart of ``repro/models/transformer.py`` (``_layer_param_shapes``,
``init_params``, ``layer_windows``, ``_qkv``, ``_ffn``, ``_embed_inputs``,
``_lm_logits``, ``init_cache``, ``prefill``, ``decode_step``) for the
serving path.  The JAX package stacks the layers on a leading L axis and
runs them under ``lax.scan``; here each layer is a ``DecoderLayer`` in an
``nn.ModuleList`` and runs in a Python loop, so every layer's attention
window is a Python int and the prefill attention is the flash kernel
(``attention.chunked_attention``).

Weights keep the JAX layout ``[in, out]`` (``x @ W``) and are stored in the
compute dtype, cast once when they are set: the JAX package casts the f32
parameters to the compute dtype per layer per call, which rounds them the
same way.  The final norm's scale stays in the parameter dtype, as it does
in the JAX ``_lm_logits``.

Not here yet (``ROADMAP.md`` Queue 1 item 15): MoE layers, the
encoder-decoder and vision front ends, ``loss_fn`` and training.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import ArchConfig, dtype_of, rms_norm, rope

Cache = Dict[str, object]

_NOT_PORTED = ("not ported yet: ROADMAP.md Queue 1 item 15 brings MoE, "
               "encoder-decoder, vision, SSM and hybrid models and training")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run."""
    if cfg.family != "dense" or cfg.is_moe or cfg.enc_dec or cfg.frontend:
        raise NotImplementedError(f"{cfg.name} (family {cfg.family!r}) is "
                                  f"{_NOT_PORTED}")


def layer_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """One dense layer's parameters and shapes, in the JAX order."""
    d, hd = cfg.d_model, cfg.hd
    h, g, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    return {"norm1": (d,), "norm2": (d,),
            "wq": (d, h * hd), "wk": (d, g * hd), "wv": (d, g * hd),
            "wo": (h * hd, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def layer_windows(cfg: ArchConfig) -> np.ndarray:
    """Per-layer attention window (0 = full causal). gemma3: N local : 1
    global."""
    if cfg.local_global_ratio and cfg.local_window:
        period = cfg.local_global_ratio + 1
        idx = np.arange(cfg.n_layers)
        return np.where((idx + 1) % period == 0, 0,
                        cfg.local_window).astype(np.int32)
    return np.zeros(cfg.n_layers, dtype=np.int32)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm block: attention, then the SwiGLU feed-forward."""

    def __init__(self, cfg: ArchConfig, window: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.window = int(window)
        for name, shape in layer_param_shapes(cfg).items():
            setattr(self, name, _weight(shape, dtype, device))

    def qkv(self, h: torch.Tensor):
        """``_qkv``: q ``[B, S, G, R, hd]``, k and v ``[B, S, G, hd]``."""
        b, s, _ = h.shape
        cfg = self.cfg
        g, hd = cfg.n_kv_heads, cfg.hd
        r = cfg.n_heads // g
        return ((h @ self.wq).reshape(b, s, g, r, hd),
                (h @ self.wk).reshape(b, s, g, hd),
                (h @ self.wv).reshape(b, s, g, hd))

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        """``_ffn``: SwiGLU."""
        return (F.silu(h @ self.w_gate) * (h @ self.w_up)) @ self.w_down

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """Prefill: ``x [B, S, d]`` → (``x``, this layer's k and v)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        q, k, v = self.qkv(h)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        o = attn.chunked_attention(q, k, v, window=self.window, causal=True,
                                   q_chunk=attn.pick_chunk(s, 2048),
                                   k_chunk=attn.pick_chunk(s, 1024))
        x = x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ self.wo
        x = x + self.ffn(rms_norm(x, self.norm2, cfg.norm_eps))
        return x, k, v

    def decode(self, x: torch.Tensor, positions: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: int) -> torch.Tensor:
        """One token ``x [B, 1, d]`` at position ``pos``: writes its k and v
        into this layer's caches ``[B, max_len, G, hd]`` in place."""
        cfg = self.cfg
        b = x.shape[0]
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        q, k, v = self.qkv(h)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        k_cache[:, pos] = k[:, 0]
        v_cache[:, pos] = v[:, 0]
        o = attn.decode_attention(q, k_cache, v_cache, cache_len=pos + 1,
                                  window=self.window)
        x = x + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ self.wo
        return x + self.ffn(rms_norm(x, self.norm2, cfg.norm_eps))


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
    embedding, else the weight's input width), drawn in f32 from
    ``generator`` and cast to the weight's dtype; norms at zero.  Weights
    are drawn in parameter order; the numbers are the generator's, not
    JAX's."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1].startswith(("norm", "final_norm")):
                p.zero_()
                continue
            fan_in = model.cfg.d_model if name == "embed" else p.shape[0]
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
            p.copy_(w * (1.0 / math.sqrt(max(fan_in, 1))))


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


def loss_fn(*_args, **_kwargs):
    raise NotImplementedError(f"training (loss_fn) is {_NOT_PORTED}")
