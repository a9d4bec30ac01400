"""xLSTM (sLSTM + mLSTM blocks): the ``ssm`` family (xlstm-125m).

The counterpart of ``repro/models/xlstm.py`` (``GATE_CLIP``,
``layer_param_shapes``, ``init_params``, ``slstm_layers_mask``,
``_mlstm_parallel``, ``_mlstm_step``, ``_slstm_scan``,
``_gates_and_streams``, ``xlstm_block``, ``_forward``, ``loss_fn``,
``init_cache``, ``prefill``, ``decode_step``).

- **mLSTM**: matrix memory ``C_t = f_t·C_{t-1} + i_t·v_t k_tᵀ``, read
  ``h_t = C_t q_t / max(|n_t·q_t|, 1)``: mamba2's SSD dual with decay
  ``logσ(f)`` and input scale ``exp(i)`` (clipped), ``B = k``, ``C = q``,
  ``x = v``; the normalizer runs through the same SSD with ``x = 1``.  JAX
  vmaps ``ssd`` over the heads; here the heads are folded into the batch.
- **sLSTM** (every ``slstm_every``-th layer): scalar memory with
  exponential gating and the stabilizer ``m``, sequential (a loop over
  time where JAX has ``lax.scan``); its f32 carry meets the bf16
  recurrent weights as JAX promotes them, in f32.

The serving path is JAX's: ``prefill`` replays the one-token step over the
prompt (the parallel mLSTM serves only ``loss_fn``), so decode after
``prefill(t)`` equals ``prefill(t + 1)`` bit for bit; the logits are
computed only at the last prompt token (JAX computes them at every token
and keeps the last).  The cache is f32, O(1) in the sequence
(``promote_types(compute, float32)``: a float64 run keeps float64).  The
per-layer ``lax.cond`` on the sLSTM mask is a Python ``if``.  Only the
value half of ``up_proj`` is multiplied (JAX computes the gate half and
drops it; its gradient is zero in both).

Serving weights live in a ``common.TreeModule`` (``embed``, ``layers.*``
stacked on L, ``final_norm``), in the compute dtype but for
``final_norm``, which JAX reads in the parameter dtype.  Training is
functional on the f32 tree, each layer cast per call and checkpointed
when ``cfg.remat``, as ``transformer.loss_fn`` does.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import dist
from repro_torch.models.common import (ArchConfig, LeafSpec, TreeModule,
                                       cross_entropy_loss, draw_tree,
                                       dtype_of, embed_tokens, layer_weight,
                                       logical_constraint,
                                       rms_norm, serving, tied_logits,
                                       work_dtype)
from repro_torch.models.mamba2 import ssd

Params = Dict[str, object]
Cache = Dict[str, object]
GATE_CLIP = 8.0   # exp input-gate clip


def _proj_dim(cfg: ArchConfig) -> int:
    return 2 * cfg.d_model  # projection factor 2


def layer_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    di = _proj_dim(cfg)
    h = cfg.n_heads
    dh = di // h
    return {
        "norm": (d,),
        "up_proj": (d, 2 * di),          # value stream + gate stream
        "wq": (d, di), "wk": (d, di),
        "w_igate": (d, h), "w_fgate": (d, h),
        "b_igate": (h,), "b_fgate": (h,),
        # sLSTM recurrent gate weights (block-diagonal per head)
        "r_igate": (h, dh), "r_fgate": (h, dh), "r_zgate": (h, dh),
        "w_ogate": (d, di),
        "mix_norm": (di,),
        "down_proj": (di, d),
    }


def param_spec(cfg: ArchConfig) -> List[LeafSpec]:
    """``init_params``'s leaves in order: the embedding (normal over
    d_model), each layer leaf stacked on L (norms 0, ``b_fgate`` 3, the
    other biases 0, weights normal over their input width), the final
    norm (0)."""
    spec: List[LeafSpec] = [(("embed",), (cfg.vocab, cfg.d_model),
                             ("normal", cfg.d_model))]
    for name, shape in layer_param_shapes(cfg).items():
        if "norm" in name:
            init = ("const", 0.0)
        elif name == "b_fgate":
            init = ("const", 3.0)              # forget-bias init
        elif name.startswith("b_"):
            init = ("const", 0.0)
        else:
            init = ("normal", shape[-2] if len(shape) >= 2 else shape[-1])
        spec.append((("layers", name), (cfg.n_layers,) + shape, init))
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


def slstm_layers_mask(cfg: ArchConfig) -> np.ndarray:
    if not cfg.slstm_every:
        return np.zeros(cfg.n_layers, bool)
    idx = np.arange(cfg.n_layers)
    return (idx + 1) % cfg.slstm_every == 0


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def _mlstm_parallel(v, q, k, igate, fgate, cfg: ArchConfig):
    """Chunk-parallel mLSTM via the SSD dual.  v, q, k: ``[B, S, H, Dh]``;
    gates ``[B, S, H]``.  Returns (h ``[B, S, H, Dh]``, final state
    ``{"C": [B, H, Dh, Dh], "n": [B, H, Dh]}``)."""
    b, s, h, dh = v.shape
    wd = work_dtype(v.dtype)
    a_log = F.logsigmoid(fgate.to(wd))
    iscale = torch.exp(igate.to(wd).clamp(-GATE_CLIP, GATE_CLIP)).to(v.dtype)
    x = v * iscale[..., None]
    ones = torch.ones((b, s, h, 1), dtype=v.dtype, device=v.device) \
        * iscale[..., None]

    def heads_in_batch(t):                  # [B, S, H, X] -> [B*H, S, X]
        return t.transpose(1, 2).reshape(b * h, s, t.shape[-1])

    a_bh = a_log.transpose(1, 2).reshape(b * h, s, 1)
    k_bh, q_bh = heads_in_batch(k), heads_in_batch(q)
    num, st_c = ssd(heads_in_batch(x)[:, :, None], a_bh, k_bh, q_bh,
                    chunk=128)
    den, st_n = ssd(heads_in_batch(ones)[:, :, None], a_bh, k_bh, q_bh,
                    chunk=128)
    num = num[:, :, 0].reshape(b, h, s, dh).transpose(1, 2)
    den = den[:, :, 0].reshape(b, h, s, 1).transpose(1, 2)
    hval = num / den.abs().clamp_min(1.0)
    state = {"C": st_c[:, 0].reshape(b, h, dh, dh),
             "n": st_n[:, 0, 0].reshape(b, h, dh)}
    return hval.to(v.dtype), state


def _mlstm_step(v, q, k, igate, fgate, state):
    """One-step mLSTM.  v, q, k: ``[B, H, Dh]``; gates ``[B, H]``; the
    state's ``C [B, H, Dh, Dh]`` and ``n [B, H, Dh]`` come back in their
    own dtypes."""
    wd = work_dtype(v.dtype)
    a_log = F.logsigmoid(fgate.to(wd))
    iscale = torch.exp(igate.to(wd).clamp(-GATE_CLIP, GATE_CLIP))
    decay = torch.exp(a_log)
    k, q = k.to(wd), q.to(wd)[..., None]
    # the products as matmuls (JAX's einsums; the outer product is exact)
    vi = (v * iscale[..., None]).to(wd)
    C = state["C"] * decay[..., None, None] + vi[..., :, None] * k[..., None, :]
    n = state["n"] * decay[..., None] + iscale[..., None] * k
    num = (C @ q)[..., 0]
    den = (n[..., None, :] @ q)[..., 0, 0]
    hval = num / den.abs().clamp_min(1.0)[..., None]
    return hval.to(v.dtype), {"C": C.to(state["C"].dtype),
                              "n": n.to(state["n"].dtype)}


def _slstm_scan(z_pre, igate, fgate, lp, init=None):
    """Sequential sLSTM with its stabilizer.  z_pre: ``[B, S, H·Dh]`` (the
    value stream), gate pre-activations ``[B, S, H]`` (the recurrent terms
    are added inside).  Returns (h ``[B, S, H, Dh]`` in f32, the carry
    ``(c, n, m, h)``)."""
    b, s, h = igate.shape
    dh = z_pre.shape[-1] // h
    wd = work_dtype(z_pre.dtype)
    zs = z_pre.reshape(b, s, h, dh).to(wd)
    if init is None:
        c = torch.zeros((b, h, dh), dtype=wd, device=zs.device)
        n = torch.zeros_like(c)
        m = torch.full((b, h), -1e30, dtype=wd, device=zs.device)
        hprev = torch.zeros_like(c)
    else:
        c, n, m, hprev = init
    # the recurrent gate weights in the carry's dtype, as JAX promotes the
    # bf16 weights with the f32 carry; input and forget side by side
    r_if = torch.stack([lp["r_igate"], lp["r_fgate"]], 1).to(wd)  # [H, 2, Dh]
    r_z = lp["r_zgate"].to(wd)
    hs = []
    for t in range(s):
        # recurrent contributions (block-diagonal per head)
        rec = (hprev[:, :, None, :] * r_if).sum(-1)           # [B, H, 2]
        i_t = igate[:, t] + rec[..., 0]
        f_t = fgate[:, t] + rec[..., 1]
        z_t = torch.tanh(zs[:, t] + hprev * r_z)
        log_f = F.logsigmoid(f_t.to(wd))
        log_i = i_t.to(wd).clamp(-GATE_CLIP, GATE_CLIP)
        m_new = torch.maximum(log_f + m, log_i)
        i_s = torch.exp(log_i - m_new)[..., None]
        f_s = torch.exp(log_f + m - m_new)[..., None]
        c = f_s * c + i_s * z_t
        n = f_s * n + i_s
        hprev = c / n.clamp_min(1.0)
        m = m_new
        hs.append(hprev)
    return torch.stack(hs, 1), (c, n, m, hprev)


# ---------------------------------------------------------------------------
# Block + model
# ---------------------------------------------------------------------------

def _gates_and_streams(x, lp, cfg: ArchConfig):
    """The value stream ``[B, S, H, Dh]`` (``up_proj``'s first half), q,
    k (scaled by 1/sqrt(Dh)) and the input and forget gates."""
    di = _proj_dim(cfg)
    h = cfg.n_heads
    dh = di // h
    b, s, _ = x.shape
    val = x @ lp["up_proj"][:, :di]
    q = (x @ lp["wq"]).reshape(b, s, h, dh)
    # JAX rounds the Python scalar to x's dtype before it divides
    k = (x @ lp["wk"]).reshape(b, s, h, dh) / torch.tensor(math.sqrt(dh),
                                                           dtype=x.dtype)
    ig = x @ lp["w_igate"] + lp["b_igate"]
    fg = x @ lp["w_fgate"] + lp["b_fgate"]
    return val.reshape(b, s, h, dh), q, k, ig, fg


# the weights the cell reads (the rest act on the DTensor stream)
_CELL = ("up_proj", "wq", "wk", "w_igate", "w_fgate", "b_igate", "b_fgate",
         "r_igate", "r_fgate", "r_zgate")


def xlstm_block(x, lp, cfg: ArchConfig, is_slstm: bool, state=None):
    """One xLSTM block; state-carrying when ``state`` is given (a step:
    the sLSTM carry, or the mLSTM ``{"C", "n"}``)."""
    b, s, _ = x.shape
    di = _proj_dim(cfg)
    hidden = rms_norm(x, lp["norm"], cfg.norm_eps)
    # under a mesh the cell runs on each rank's batch rows with its weights
    # whole (an explicit replication over the model axis, ROADMAP.md
    # Queue 3: DTensor cannot keep 4 heads apart over 16 ranks, nor fold
    # them into the batch)
    hl, pl = dist.batch_local(hidden)
    mesh = getattr(hidden, "device_mesh", None)
    if pl is not None:
        lp = dict(lp, **{k: dist.replicated_local(lp[k], pl) for k in _CELL})
        if state is not None:
            state = (tuple(dist.batch_local(t)[0] for t in state)
                     if is_slstm else {k: dist.batch_local(t)[0]
                                       for k, t in state.items()})
    b = hl.shape[0]
    v, q, k, ig, fg = _gates_and_streams(hl, lp, cfg)
    if is_slstm:
        hval, new_state = _slstm_scan(v.reshape(b, s, di), ig, fg, lp,
                                      init=state)
    elif state is None:
        hval, new_state = _mlstm_parallel(v, q, k, ig, fg, cfg)
    else:
        hval, new_state = _mlstm_step(v[:, 0], q[:, 0], k[:, 0], ig[:, 0],
                                      fg[:, 0], state)
        hval = hval[:, None]
    hval = dist.rebuild(hval.reshape(b, s, di).to(x.dtype), pl, mesh)
    if pl is not None:
        new_state = (tuple(dist.rebuild(t, pl, mesh) for t in new_state)
                     if is_slstm else {k: dist.rebuild(t, pl, mesh)
                                       for k, t in new_state.items()})
    o = torch.sigmoid(hidden @ lp["w_ogate"])
    # rows whole before the norm: DTensor would shard the norm over S
    y = rms_norm(logical_constraint(hval * o, "batch", "seq", None),
                 lp["mix_norm"], cfg.norm_eps)
    return (logical_constraint(x + y @ lp["down_proj"], "batch", "seq", None),
            new_state)


def _layer(params: Params, i: int, dtype: torch.dtype):
    """Layer ``i``'s weights, cast to ``dtype`` (a no-op for the serving
    module's, stored in it)."""
    return {k: layer_weight(w[i], dtype) for k, w in params["layers"].items()}


def _layers(params: Params, cfg: ArchConfig):
    """Each layer's weights in the compute dtype, and whether it is an
    sLSTM layer."""
    cdt = dtype_of(cfg.compute_dtype)
    return [(_layer(params, i, cdt), bool(is_s))
            for i, is_s in enumerate(slstm_layers_mask(cfg))]


def _step(params: Params, cfg: ArchConfig, layers, tokens: torch.Tensor,
          cache: Cache) -> torch.Tensor:
    """One token ``tokens [B]`` through every layer (``_layers``) in decode
    mode, the cache's states written in place and ``len`` advanced;
    returns the last hidden state ``[B, 1, d]``."""
    cdt = dtype_of(cfg.compute_dtype)
    x = embed_tokens(params, tokens[:, None], cdt)
    for i, (lp, is_s) in enumerate(layers):
        if is_s:
            x, (c, n, m, hl) = xlstm_block(
                x, lp, cfg, True, state=(cache["sc"][i], cache["sn"][i],
                                         cache["sm"][i], cache["sh"][i]))
            for key, val in zip(("sc", "sn", "sm", "sh"), (c, n, m, hl)):
                cache[key][i] = val
        else:
            x, st = xlstm_block(x, lp, cfg, False,
                                state={"C": cache["mC"][i],
                                       "n": cache["mn"][i]})
            cache["mC"][i], cache["mn"][i] = st["C"], st["n"]
        x = x.to(cdt)
    cache["len"] += 1
    return x


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device: torch.device, enc_len: int = 0) -> Cache:
    """Recurrent state, O(1) in the sequence: f32 (float64 for float64
    compute), ``sm`` at -1e30, ``len`` a Python int."""
    del max_len, enc_len
    di = _proj_dim(cfg)
    h = cfg.n_heads
    dh = di // h
    L = cfg.n_layers
    wd = work_dtype(dtype_of(cfg.compute_dtype))
    return {
        "mC": dist.cache_tensor((L, batch, h, dh, dh), wd, device),
        "mn": dist.cache_tensor((L, batch, h, dh), wd, device),
        "sc": dist.cache_tensor((L, batch, h, dh), wd, device),
        "sn": dist.cache_tensor((L, batch, h, dh), wd, device),
        "sm": dist.cache_tensor((L, batch, h), wd, device, -1e30),
        "sh": dist.cache_tensor((L, batch, h, dh), wd, device),
        "len": 0,
    }


@serving
def prefill(model: TreeModule, batch: Dict[str, torch.Tensor],
            max_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """The prompt ``batch["tokens"] [B, S]`` replayed token by token
    through the decode step (JAX's ``lax.scan`` of ``_forward``); returns
    the last token's logits ``[B, vocab]`` and the cache."""
    cfg, params = model.cfg, model.tree()
    tokens = batch["tokens"]
    cache = init_cache(cfg, tokens.shape[0], max_len or tokens.shape[1],
                       model.device)
    layers = _layers(params, cfg)
    for t in range(tokens.shape[1]):
        x = _step(params, cfg, layers, tokens[:, t], cache)
    return tied_logits(params, cfg, x)[:, 0], cache


@serving
def decode_step(model: TreeModule, cache: Cache,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """One decode step for ``tokens [B]``: (logits ``[B, vocab]``, the
    cache, updated in place)."""
    params = model.tree()
    x = _step(params, model.cfg, _layers(params, model.cfg), tokens, cache)
    return tied_logits(params, model.cfg, x)[:, 0], cache


def _train_layer(cfg: ArchConfig, is_slstm: bool, x: torch.Tensor,
                 *weights: torch.Tensor) -> torch.Tensor:
    """One block in the parallel form on one layer's weights (in
    ``layer_param_shapes`` order), each cast to ``x``'s dtype inside the
    checkpointed region."""
    lp = dict(zip(layer_param_shapes(cfg),
                  (layer_weight(w, x.dtype) for w in weights)))
    return xlstm_block(x, lp, cfg, is_slstm)[0].to(x.dtype)


def forward(params: Params, cfg: ArchConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """JAX's ``_forward`` without a cache: all positions in parallel (the
    mLSTM by the SSD dual, the sLSTM by its loop), each layer checkpointed
    when ``cfg.remat``; returns the logits ``[B, S, vocab]``."""
    x = embed_tokens(params, tokens, dtype_of(cfg.compute_dtype))
    names = list(layer_param_shapes(cfg))
    for i, is_s in enumerate(slstm_layers_mask(cfg)):
        args = (cfg, bool(is_s), x, *(params["layers"][k][i] for k in names))
        x = (checkpoint(_train_layer, *args, use_reentrant=False)
             if cfg.remat else _train_layer(*args))
    return tied_logits(params, cfg, x)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], *,
            cfg: ArchConfig) -> torch.Tensor:
    """One microbatch's token-mean cross entropy: ``batch["tokens"] [B, S
    + 1]``, the first S read and the last S predicted."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens[:, :-1])
    return cross_entropy_loss(logits, tokens[:, 1:].to(logits.device))


def param_count(cfg: ArchConfig) -> int:
    return sum(math.prod(shape) for _, shape, _ in param_spec(cfg))
