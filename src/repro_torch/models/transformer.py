"""Transformer with GQA, RoPE and SwiGLU or MoE feed-forwards: the dense,
MoE, encoder-decoder (audio) and vision-language families.

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

An encoder-decoder config (``cfg.enc_dec``: seamless) adds ``encoder``, a
stack of ``n_layers`` non-causal layers over the audio frames
(``frames @ frontend_proj``; their attention is the flash kernel in its
non-causal mode), ``enc_norm``, and to each decoder layer a cross block
(``norm_x``, ``wq_x``, ``wk_x``, ``wv_x``, ``wo_x``) after its
self-attention: ``attention.cross_attention`` against the encoder's
output, whose per-layer k and v the prefill keeps in the cache (``xk``,
``xv``) for the decode steps.  A vision config (``frontend="vision"``:
internvl2) prepends ``patches @ frontend_proj`` (not scaled by
``sqrt(d_model)``) to the scaled token embeddings; the patches take cache
slots and positions, and ``loss_fn`` drops their outputs before the head.

The SSM and hybrid families are ``xlstm.py`` and ``zamba.py``; zamba's
shared attention block is this module's ``decoder_layer`` and
``decode_layer``.

Under a mesh (``launch/sharding.py``'s ``activation_rules``, DTensor
parameters by ``param_specs``) the same functions run on DTensors: the
JAX model's ``logical_constraint`` hints, weights gathered over the data
axes where they are used (``fsdp_gather``), heads split and merged by
``split_last``/``merge_last``, the embedding by ``embed_lookup``; on one
device every hint returns its argument.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.dist import (cache_tensor, embed_lookup,
                                     fsdp_gather, merge_last, split_last)
from repro_torch.models import attention as attn
from repro_torch.models.common import (ArchConfig, cross_entropy_loss,
                                       dtype_of, logical_constraint,
                                       layer_weight, opt_enabled, remat,
                                       rms_norm, rope, serving)
from repro_torch.models.moe import moe_ffn, moe_layer_params

Cache = Dict[str, object]

FAMILIES = ("dense", "moe", "audio", "vlm")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a config of another family
    (``models.api.build`` picks each family's module)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name} (family {cfg.family!r}) is not a "
                         f"transformer family {FAMILIES}")


def layer_param_shapes(cfg: ArchConfig, cross: bool = False
                       ) -> Dict[str, Tuple[int, ...]]:
    """One layer's parameters and shapes, in the JAX order: the cross
    block's leaves after the self-attention's when ``cross``, the MoE
    leaves in place of the SwiGLU ones when ``cfg.is_moe``."""
    d, hd = cfg.d_model, cfg.hd
    h, g, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    shapes = {"norm1": (d,), "norm2": (d,),
              "wq": (d, h * hd), "wk": (d, g * hd), "wv": (d, g * hd),
              "wo": (h * hd, d)}
    if cross:
        shapes.update({"norm_x": (d,), "wq_x": (d, h * hd),
                       "wk_x": (d, g * hd), "wv_x": (d, g * hd),
                       "wo_x": (h * hd, d)})
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
    """``_qkv``: q ``[B, S, G, R, hd]``, k and v ``[B, S, G, hd]``, each
    product hinted ``(batch, None, heads)``."""
    b, s, _ = h.shape
    g, hd = cfg.n_kv_heads, cfg.hd
    r = cfg.n_heads // g
    q = logical_constraint(h @ lp["wq"], "batch", None, "heads")
    k = logical_constraint(h @ lp["wk"], "batch", None, "heads")
    v = logical_constraint(h @ lp["wv"], "batch", None, "heads")
    return (split_last(q, (b, s, g, r, hd)), split_last(k, (b, s, g, hd)),
            split_last(v, (b, s, g, hd)))


def _ffn(cfg: ArchConfig, lp: Dict[str, torch.Tensor],
         h: torch.Tensor) -> torch.Tensor:
    """The layer's feed-forward: ``moe_ffn`` for an MoE config, else
    ``_ffn`` (SwiGLU)."""
    if cfg.is_moe:
        return moe_ffn(h, lp, cfg)
    inter = F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])
    return logical_constraint(inter, "batch", None, "ffn") @ lp["w_down"]


def cross_kv(cfg: ArchConfig, lp: Dict[str, torch.Tensor],
             enc_out: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross k and v ``[B, Senc, G, hd]`` from the
    encoder's output ``[B, Senc, d]``."""
    b, se, _ = enc_out.shape
    g, hd = cfg.n_kv_heads, cfg.hd
    return (split_last(enc_out @ lp["wk_x"], (b, se, g, hd)),
            split_last(enc_out @ lp["wv_x"], (b, se, g, hd)))


def _cross(cfg: ArchConfig, lp: Dict[str, torch.Tensor], x: torch.Tensor,
           xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """The cross block: ``x`` plus its attention to the encoder's k and
    v."""
    b, s, _ = x.shape
    g = cfg.n_kv_heads
    h = rms_norm(x, lp["norm_x"], cfg.norm_eps)
    qx = split_last(h @ lp["wq_x"], (b, s, g, cfg.n_heads // g, cfg.hd))
    o = attn.cross_attention(qx, xk, xv)
    return x + merge_last(o, (b, s, cfg.n_heads * cfg.hd)) @ lp["wo_x"]


def decoder_layer(cfg: ArchConfig, lp: Dict[str, torch.Tensor],
                  x: torch.Tensor, positions: torch.Tensor, window: int,
                  attention, causal: bool = True,
                  enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_decoder_layer`` (one pre-norm block: attention, the cross block
    when given the encoder's k and v ``enc_kv``, then the SwiGLU or MoE
    feed-forward) on ``x [B, S, d]`` with the weights ``lp`` and an
    ``attention`` function of the ``chunked_attention`` signature; returns
    ``x`` and the layer's k and v.  The encoder's layers run it with
    ``causal=False``."""
    b, s, _ = x.shape
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, window=window, causal=causal,
                  q_chunk=attn.pick_chunk(s, 2048),
                  k_chunk=attn.pick_chunk(s, 1024))
    x = x + merge_last(o, (b, s, cfg.n_heads * cfg.hd)) @ lp["wo"]
    x = logical_constraint(x, "batch", "seq", None)
    if enc_kv is not None:
        x = _stream(_cross(cfg, lp, x, *enc_kv))
    x = x + _ffn(cfg, lp, rms_norm(x, lp["norm2"], cfg.norm_eps))
    return logical_constraint(x, "batch", "seq", None), k, v


def decode_layer(cfg: ArchConfig, lp: Dict[str, torch.Tensor],
                 x: torch.Tensor, positions: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
                 window: int = 0,
                 enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """``decoder_layer`` for one token ``x [B, 1, d]`` at position
    ``pos``: writes its k and v into the layer's caches ``[B, max_len, G,
    hd]`` in place and attends to the live slots; the cross block reads
    the cached ``enc_kv``."""
    b = x.shape[0]
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    o = attn.decode_attention(q, k_cache, v_cache, cache_len=pos + 1,
                              window=window)
    x = x + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ lp["wo"]
    if enc_kv is not None:
        x = _cross(cfg, lp, x, *enc_kv)
    return x + _ffn(cfg, lp, rms_norm(x, lp["norm2"], cfg.norm_eps))


def _stream(x: torch.Tensor) -> torch.Tensor:
    """The residual stream hinted ``(batch, seq, None)`` where JAX gives no
    hint (the embeddings, a front end's projection, the cross block's
    output): DTensor would carry a weight's layout into the stream, or
    shard it over S."""
    return logical_constraint(x, "batch", "seq", None)


def _weight(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm block: attention, the cross block (``cross``), then the
    SwiGLU or MoE feed-forward.  An encoder layer is one with ``causal``
    false (full attention) and no cross block."""

    def __init__(self, cfg: ArchConfig, window: int, dtype: torch.dtype,
                 device: torch.device, cross: bool = False,
                 causal: bool = True):
        super().__init__()
        self.cfg = cfg
        self.window = int(window)
        self.cross, self.causal = cross, causal
        for name, shape in layer_param_shapes(cfg, cross).items():
            setattr(self, name, _weight(shape, dtype, device))

    @property
    def weights(self) -> Dict[str, torch.Tensor]:
        return {name: fsdp_gather(getattr(self, name))
                for name in layer_param_shapes(self.cfg, self.cross)}

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """Prefill: ``x [B, S, d]`` → (``x``, this layer's k and v), the
        attention through the flash kernel; ``enc_kv`` the cross block's
        k and v (``cross_kv``)."""
        return decoder_layer(self.cfg, self.weights, x, positions,
                             self.window, attn.chunked_attention,
                             self.causal, enc_kv)

    def decode(self, x: torch.Tensor, positions: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor,
               pos: int, enc_kv: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None
               ) -> torch.Tensor:
        """One token ``x [B, 1, d]`` at position ``pos``
        (``decode_layer``)."""
        return decode_layer(self.cfg, self.weights, x, positions, k_cache,
                            v_cache, pos, self.window, enc_kv)


class Transformer(nn.Module):
    """The model: token embedding, the decoder layers, the final norm and
    the LM head (the embedding's transpose when tied); with a front end,
    ``frontend_proj``; encoder-decoder, the ``encoder`` layers and
    ``enc_norm``.  Parameter names follow the JAX pytree: ``embed``,
    ``layers.<i>.<name>``, ``final_norm``, ``lm_head``, ``encoder.<i>.
    <name>``, ``enc_norm``, ``frontend_proj``.  The norms outside the
    layers stay in the parameter dtype, as in JAX."""

    def __init__(self, cfg: ArchConfig, device: torch.device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        cdt, pdt = self.compute_dtype, dtype_of(cfg.param_dtype)
        d = cfg.d_model
        self.embed = _weight((cfg.vocab, d), cdt, device)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, w, cdt, device, cross=cfg.enc_dec)
            for w in layer_windows(cfg))
        self.final_norm = _weight((d,), pdt, device)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((d, cfg.vocab), cdt, device)
        if cfg.enc_dec:
            self.encoder = nn.ModuleList(
                DecoderLayer(cfg, 0, cdt, device, causal=False)
                for _ in range(cfg.n_layers))
            self.enc_norm = _weight((d,), pdt, device)
        if cfg.frontend:
            self.frontend_proj = _weight((d, d), cdt, device)

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
        return _stream(embed_lookup(self.embed, tokens.to(self.device),
                                    self.compute_dtype) * scale)

    def embed_inputs(self, batch: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, int]:
        """``_embed_inputs``: the scaled token embeddings, after a vision
        config's ``patches @ frontend_proj`` (unscaled) when the batch has
        patches; returns them and the number of front positions."""
        x = self.embed_tokens(batch["tokens"])
        if self.cfg.frontend != "vision" or "patches" not in batch:
            return x, 0
        front = _stream(batch["patches"].to(self.device, self.compute_dtype)
                        @ fsdp_gather(self.frontend_proj))
        return _stream(torch.cat([front, x], dim=1)), front.shape[1]

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """``_encode``: ``frames [B, Senc, d] @ frontend_proj``, the
        encoder's non-causal layers, then ``enc_norm``."""
        x = _stream(frames.to(self.device, self.compute_dtype)
                    @ fsdp_gather(self.frontend_proj))
        positions = torch.arange(x.shape[1], device=self.device)[None]
        for layer in self.encoder:
            x = layer(x, positions)[0]
        return rms_norm(x, self.enc_norm, self.cfg.norm_eps)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """``_lm_logits``: final norm, then the head, in ``x``'s dtype."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        head = self.embed.t() if self.cfg.tie_embeddings else self.lm_head
        return logical_constraint(x @ fsdp_gather(head), "batch", None,
                                  "vocab")


def _is_norm(name: str) -> bool:
    """A norm's scale (``norm1``, ``norm_x``, ``final_norm``,
    ``enc_norm``): zeros at init."""
    leaf = name.rsplit(".", 1)[-1]
    return leaf.startswith("norm") or leaf.endswith("_norm")


def init_params(model: Transformer, generator: torch.Generator) -> None:
    """Fill ``model`` with the JAX package's initial distribution: each
    weight normal times ``1/sqrt(fan_in)`` (fan_in ``d_model`` for the
    embedding, else the weight's input width ``shape[-2]``: D for the
    stacked experts ``[E, D, 2F]``), drawn in f32 from ``generator`` and
    cast to the weight's dtype; norms at zero.  Weights are drawn in
    parameter order; the numbers are the generator's, not JAX's."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if _is_norm(name):
                p.zero_()
                continue
            fan_in = model.cfg.d_model if name == "embed" else p.shape[-2]
            w = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32, device=generator.device)
            p.copy_(w.mul_(1.0 / math.sqrt(max(fan_in, 1))))


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device, enc_len: int = 0) -> Cache:
    """KV caches ``[L, B, max_len, G, hd]`` in the compute dtype, zeroed
    (DTensors by ``sharding.cache_specs`` under ``activation_rules``),
    and ``len`` (a Python int); an encoder-decoder config given
    ``enc_len`` adds the cross caches ``xk``, ``xv`` ``[L, B, enc_len, G,
    hd]``."""
    cdt = dtype_of(cfg.compute_dtype)
    g, hd = cfg.n_kv_heads, cfg.hd
    shape = (cfg.n_layers, batch, max_len, g, hd)
    cache = {"k": cache_tensor(shape, cdt, device),
             "v": cache_tensor(shape, cdt, device), "len": 0}
    if cfg.enc_dec and enc_len:
        shape = (cfg.n_layers, batch, enc_len, g, hd)
        cache["xk"] = cache_tensor(shape, cdt, device)
        cache["xv"] = cache_tensor(shape, cdt, device)
    return cache


@serving
def prefill(model: Transformer, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Process the full prompt ``batch["tokens"] [B, S]`` (after a vision
    config's ``patches``; an encoder-decoder config encodes
    ``batch["frames"]`` first); returns (last-token logits ``[B, vocab]``,
    cache with ``max(max_len, S + patches)`` slots, and the cross caches
    written here once)."""
    cfg = model.cfg
    b = batch["tokens"].shape[0]
    x, _ = model.embed_inputs(batch)
    stotal = x.shape[1]
    max_len = max(max_len or stotal, stotal)
    positions = torch.arange(stotal, device=model.device)[None]
    enc_out = model.encode(batch["frames"]) if cfg.enc_dec else None
    cache = init_cache(cfg, b, max_len, model.device,
                       0 if enc_out is None else enc_out.shape[1])
    for i, layer in enumerate(model.layers):
        enc_kv = None
        if enc_out is not None:
            enc_kv = cross_kv(cfg, layer.weights, enc_out)
            cache["xk"][i], cache["xv"][i] = enc_kv
        x, k, v = layer(x, positions, enc_kv)
        cache["k"][i, :, :stotal] = k
        cache["v"][i, :, :stotal] = v
    cache["len"] = stotal
    return model.logits(x[:, -1:])[:, 0], cache


@serving
def decode_step(model: Transformer, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step for ``tokens [B]``: returns (logits ``[B, vocab]``,
    the cache).  The cache is updated in place (the JAX function returns a
    new one): the token's k and v go to slot ``len``, and ``len`` grows by
    one; the cross caches are only read."""
    pos = int(cache["len"])
    k_all, v_all = cache["k"], cache["v"]
    if pos >= k_all.shape[2]:
        raise ValueError(f"the cache is full ({k_all.shape[2]} slots)")
    x = model.embed_tokens(tokens[:, None])
    positions = torch.full((1, 1), pos, device=model.device)
    cross = "xk" in cache
    for i, layer in enumerate(model.layers):
        x = layer.decode(x, positions, k_all[i], v_all[i], pos,
                         (cache["xk"][i], cache["xv"][i]) if cross else None)
    cache["len"] = pos + 1
    return model.logits(x)[:, 0], cache


# ---------------------------------------------------------------------------
# Training: the JAX pytree of parameter-dtype leaves, cast per layer per call
# ---------------------------------------------------------------------------

Params = Dict[str, object]


def init_train_params(cfg: ArchConfig, generator: torch.Generator,
                      device: torch.device) -> Params:
    """The master parameters in ``cfg.param_dtype``: ``embed``, ``layers``
    (each weight stacked ``[L, ...]``), ``final_norm``, untied
    ``lm_head``, and the front end's and encoder's (``frontend_proj``,
    ``encoder`` stacked as ``layers``, ``enc_norm``).  Drawn as
    :func:`init_params` draws a module (the same order and numbers, before
    its cast to the compute dtype), so ``convert.lm_params`` loads them
    into a serving module.  On the ``meta`` device nothing is drawn (the
    generator may be None): the shapes alone."""
    check_supported(cfg)
    pdt = dtype_of(cfg.param_dtype)
    d = cfg.d_model

    def draw(shape, fan_in):
        if device.type == "meta":                  # shapes only
            return torch.empty(shape, dtype=pdt, device=device)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(device, pdt)

    def zeros(shape):
        return torch.zeros(shape, dtype=pdt, device=device)

    def stack(cross):
        shapes = layer_param_shapes(cfg, cross)
        per_layer = {k: [] for k in shapes}
        for _ in range(cfg.n_layers):
            for name, shape in shapes.items():
                per_layer[name].append(zeros(shape) if _is_norm(name)
                                       else draw(shape, shape[-2]))
        return {k: torch.stack(v) for k, v in per_layer.items()}

    # the module's parameter order: its own (embed, final_norm, lm_head,
    # enc_norm, frontend_proj), then each decoder layer's, then each
    # encoder layer's
    params: Params = {"embed": draw((cfg.vocab, d), d),
                      "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((d, cfg.vocab), d)
    if cfg.enc_dec:
        params["enc_norm"] = zeros(d)
    if cfg.frontend:
        params["frontend_proj"] = draw((d, d), d)
    params["layers"] = stack(cfg.enc_dec)
    if cfg.enc_dec:
        params["encoder"] = stack(False)
    return params


def _train_layer(cfg: ArchConfig, window: int, causal: bool,
                 x: torch.Tensor, enc_out: Optional[torch.Tensor],
                 *weights: torch.Tensor) -> torch.Tensor:
    """``decoder_layer`` on one layer's weights (in ``layer_param_shapes``
    order, the cross leaves included when ``enc_out`` is given), each cast
    to ``x``'s dtype here, inside the checkpointed region, as JAX casts
    inside its scan body; the cross k and v are made from ``enc_out`` there
    too.  The positions are made from ``x`` on its device at every call,
    the recompute's included."""
    cross = enc_out is not None
    lp = dict(zip(layer_param_shapes(cfg, cross),
                  (layer_weight(w, x.dtype) for w in weights)))
    positions = torch.arange(x.shape[1], device=x.device)[None]
    enc_kv = cross_kv(cfg, lp, enc_out) if cross else None
    return decoder_layer(cfg, lp, x, positions, window,
                          attn.training_attention, causal, enc_kv)[0]


def _train_stack(cfg: ArchConfig, stack: Params, x: torch.Tensor,
                 windows, causal: bool,
                 enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``_run_stack``: the layers of ``stack`` (weights stacked ``[L,
    ...]``) over ``x``, each checkpointed when ``cfg.remat``."""
    names = list(layer_param_shapes(cfg, enc_out is not None))
    if opt_enabled("bf16_stack"):
        # cast before the loop: an FSDP gather then moves bf16
        cdt = dtype_of(cfg.compute_dtype)
        stack = {k: stack[k].to(cdt) for k in names}
    dots = opt_enabled("remat_dots")
    for i, window in enumerate(windows):
        args = (cfg, int(window), causal, x, enc_out,
                *(stack[k][i] for k in names))
        x = (remat(_train_layer, *args, save_dots=dots)
             if cfg.remat else _train_layer(*args))
    return x


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], *,
            cfg: ArchConfig) -> torch.Tensor:
    """One microbatch forward and its token-mean cross entropy (the JAX
    ``loss_fn``).  ``batch["tokens"] [B, S + 1]``: the model reads the
    first S tokens and predicts the last S; a vision config's ``patches``
    go first and their outputs are dropped before the head; an
    encoder-decoder config encodes ``batch["frames"]`` (non-causal,
    ``training_attention(causal=False)``) for the decoder's cross blocks.
    Runs on the parameters' device."""
    check_supported(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    embed = params["embed"]
    dev = embed.device
    tokens = batch["tokens"].to(dev).long()
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    # the scale rounded to the compute dtype, as JAX rounds a Python scalar
    x = embed_lookup(embed, inputs, cdt) * torch.tensor(
        math.sqrt(cfg.d_model), dtype=cdt)
    x = _stream(x)
    n_front = 0
    if cfg.frontend == "vision" and "patches" in batch:
        front = _stream(batch["patches"].to(dev, cdt)
                        @ layer_weight(params["frontend_proj"], cdt))
        x = _stream(torch.cat([front, x], dim=1))
        n_front = front.shape[1]
    enc_out = None
    if cfg.enc_dec:
        enc = _stream(batch["frames"].to(dev, cdt)
                      @ layer_weight(params["frontend_proj"], cdt))
        enc = _train_stack(cfg, params["encoder"], enc,
                           np.zeros(cfg.n_layers, np.int32), causal=False)
        enc_out = rms_norm(enc, params["enc_norm"], cfg.norm_eps)
    x = _train_stack(cfg, params["layers"], x, layer_windows(cfg),
                     causal=True, enc_out=enc_out)
    x = rms_norm(x[:, n_front:], params["final_norm"], cfg.norm_eps)
    head = embed.t() if cfg.tie_embeddings else params["lm_head"]
    logits = logical_constraint(x @ layer_weight(head, x.dtype), "batch",
                                None, "vocab")
    return cross_entropy_loss(logits, labels)
