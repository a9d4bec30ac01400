"""Attention: GQA prefill through the flash kernel, KV-cache decode.

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

GQA keeps the grouped layout: q heads are ``[G, R]`` (KV groups × q heads
per group) and no KV head is repeated.  ``cross_attention`` waits for the
encoder-decoder family (``ROADMAP.md`` Queue 1 item 15).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels.ref import flash_attention_ref


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
    window = int(window) if causal else 0
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, k_chunk=k_chunk)
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
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
