"""Attention: GQA prefill through the flash kernel, KV-cache decode, and
the training attention.

The counterpart of ``repro/models/attention.py``.  The JAX prefill runs its
layers under ``lax.scan`` with each layer's window a traced value, so it
uses the pure-jnp ``chunked_attention``; its Pallas flash kernel is "the
serving-path accelerator when the window is static".  Here the layers run
in a Python loop and every window is a Python int, so ``chunked_attention``
launches the Hopper flash kernel on a CUDA tensor (or raises); on a CPU
tensor it runs the kernel's plain version, the double-chunked online
softmax of the JAX function (``kernels/ref.py::flash_attention_ref``, whose
``attention_mask`` is the JAX ``_mask``).  For bf16 inputs both round P to
bf16 before P·V, as the Pallas kernel does; the JAX function keeps P in
f32.

The flash kernel has no backward (nor has the Pallas one), so training
runs ``training_attention``: the JAX model's ``chunked_attention`` in plain
PyTorch under autograd, P kept in f32.  ``chunked_attention`` refuses an
input that requires a gradient rather than return a result with no graph.

GQA keeps the grouped layout: q heads are ``[G, R]`` (KV groups × q heads
per group) and no KV head is repeated.

Under a mesh (DTensor inputs) the prefill attention is the flash kernel's
custom op (its sharding rule keeps batch or head shards; on a CPU mesh its
CPU kernel is ``flash_attention_ref``), and the others run on each rank's
batch or KV-group shards (``dist.local_heads``).  ``cross_attention`` (the decoder's
attention to the encoder's output, serving and training) is plain
PyTorch, as the JAX function is an einsum outside any Pallas kernel.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.models import dist


def pick_chunk(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is ≤ target (VLM prompts are
    seq+frontend_len, e.g. 4352 = 2^8·17, so chunks must divide exactly)."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int = 0, causal: bool = True,
                      q_chunk: int = 1024, k_chunk: int = 1024
                      ) -> torch.Tensor:
    """q: ``[B, S, G, R, D]``; k, v: ``[B, S, G, D]``.  Returns
    ``[B, S, G, R, D]``.

    Causal with an optional sliding window (``window > 0``; ignored when
    not causal, as in the JAX function).  ``q_chunk``/``k_chunk`` shape only
    the plain version; the kernel takes any S.  The JAX function's
    ``q_offset`` (queries placed after a prefix) has no caller there and is
    not ported.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "chunked_attention is the serving path (the flash kernel and "
            "its plain version) and has no backward; train through "
            "training_attention")
    window = int(window) if causal else 0
    if q.device.type == "cpu":
        if isinstance(q, DTensor):
            # the custom op's CPU kernel is flash_attention_ref; its
            # sharding rule keeps S and D whole
            return torch.ops.repro_torch.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), causal,
                window)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, k_chunk=k_chunk)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cache_len: int,
                     window: int = 0) -> torch.Tensor:
    """``_decode_attention``, on each rank's shards under a mesh
    (``dist.local_heads``)."""
    return dist.local_heads(_decode_attention, q, k_cache, v_cache,
                           cache_len=cache_len, window=window)


def _decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, *, cache_len: int,
                      window: int = 0) -> torch.Tensor:
    """Single-token decode.  q: ``[B, 1, G, R, D]``; caches ``[B, Smax, G,
    D]``.  Attends to positions ``[lo, cache_len)``, ``lo = cache_len -
    window`` for a positive window (gemma3 local layers), else 0.

    The JAX function masks the whole ``Smax`` cache with ``NEG_INF``; the
    masked keys' weights are exactly 0 there, so reading only the live
    positions is the same function.
    """
    d = q.shape[-1]
    scale = 1.0 / (d ** 0.5)
    lo = max(cache_len - window, 0) if window > 0 else 0
    work = torch.promote_types(q.dtype, torch.float32)
    kc = k_cache[:, lo:cache_len].to(work)
    vc = v_cache[:, lo:cache_len].to(work)
    s = q[:, 0].to(work)                                  # [B, G, R, D]
    logits = torch.einsum("bgrd,bkgd->bgrk", s, kc) * scale
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p, vc)
    return out[:, None].to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``_cross_attention``, on each rank's shards under a mesh."""
    return dist.local_heads(_cross_attention, q, k, v)


def _cross_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Full (non-causal) cross attention, the JAX ``cross_attention``.
    q: ``[B, Sq, G, R, D]``; k, v: ``[B, Skv, G, D]``.  Scores and softmax
    in f32 (float64 for float64 input); returns ``[B, Sq, G, R, D]`` in
    q's dtype.  The scores ``[B, G, R, Sq, Skv]`` live for the call."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    work = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.to(work), k.to(work)) * scale
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.to(work))
    return out.to(q.dtype)


NEG_INF = -1e30        # the JAX model's mask value


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                   window: int) -> torch.Tensor:
    """Causal, and within ``window`` positions when it is positive (the
    JAX ``_mask``): ``[qc, kc]`` bool."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def training_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window: int = 0, causal: bool = True,
                       q_chunk: int = 1024, k_chunk: int = 1024
                       ) -> torch.Tensor:
    """``_training_attention``, on each rank's shards under a mesh."""
    return dist.local_heads(_training_attention, q, k, v, window=window,
                           causal=causal, q_chunk=q_chunk, k_chunk=k_chunk)


def _training_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, causal: bool = True,
                        q_chunk: int = 1024, k_chunk: int = 1024
                        ) -> torch.Tensor:
    """The JAX model's ``chunked_attention`` (``repro/models/attention.py``)
    under autograd.  q: ``[B, Sq, G, R, D]``; k, v: ``[B, Skv, G, D]``;
    returns ``[B, Sq, G, R, D]`` in q's dtype.

    An online softmax over key chunks for each query chunk, all in f32
    (float64 for float64 inputs): the scores, P and the running max, sum
    and output, masked with ``NEG_INF`` (not -inf, as in JAX).  The chunks only bound the live scores
    ``[B, G, R, qc, kc]``; the layer's checkpoint recomputes them in the
    backward pass.
    """
    b, sq, g, r, d = q.shape
    skv = k.shape[1]
    q_chunk, k_chunk = min(q_chunk, sq), min(k_chunk, skv)
    if sq % q_chunk or skv % k_chunk:
        raise ValueError(f"chunks ({q_chunk}, {k_chunk}) must divide the "
                         f"lengths ({sq}, {skv})")
    scale = 1.0 / (d ** 0.5)
    work = dict(dtype=torch.promote_types(q.dtype, torch.float32),
                device=q.device)                     # float64 stays float64
    outs = []
    for q0 in range(0, sq, q_chunk):
        qi = q[:, q0:q0 + q_chunk].to(work["dtype"])       # [B, qc, G, R, D]
        q_pos = q0 + torch.arange(q_chunk, device=q.device)
        m_run = torch.full((b, g, r, q_chunk), NEG_INF, **work)
        l_run = torch.zeros((b, g, r, q_chunk), **work)
        acc = torch.zeros((b, g, r, q_chunk, d), **work)
        for k0 in range(0, skv, k_chunk):
            ki = k[:, k0:k0 + k_chunk].to(work["dtype"])   # [B, kc, G, D]
            vi = v[:, k0:k0 + k_chunk].to(work["dtype"])
            s = torch.einsum("bqgrd,bkgd->bgrqk", qi, ki) * scale
            if causal:
                k_pos = k0 + torch.arange(k_chunk, device=q.device)
                s = torch.where(attention_mask(q_pos, k_pos, int(window)),
                                s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("bgrqk,bkgd->bgrqd", p, vi))
            m_run = m_new
        out = acc / l_run.clamp_min(1e-30)[..., None]
        outs.append(out.to(q.dtype))                       # [B, G, R, qc, D]
    return torch.cat(outs, dim=3).permute(0, 3, 1, 2, 4)
