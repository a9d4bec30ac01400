"""Shared model pieces: the architecture config, RMS norm and RoPE.

Copied from ``repro/models/common.py`` (which imports JAX).  The JAX
package's mesh and training knobs (``logical_constraint``, ``opt_enabled``)
have no counterpart: the port runs on one card and serves only.
"""
from __future__ import annotations

import dataclasses
import math

import torch


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
