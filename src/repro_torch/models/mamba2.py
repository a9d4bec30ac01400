"""Mamba2's block: the SSD (state-space dual), chunk-parallel.

The counterpart of ``repro/models/mamba2.py`` (``HEAD_DIM``, ``_segsum``,
``ssd``, ``ssd_step``, ``mamba_param_shapes``, ``init_mamba_stack``,
``_causal_conv``, ``mamba_block``).  The chunked SSD computes the
scalar-decay SSM

    h_t = exp(a_t) · h_{t-1} + B_t x_tᵀ ;   y_t = C_t · h_t

as products inside length-``l`` chunks and a short recurrence over the
chunk states.  None of it reaches a Pallas kernel in JAX: it is einsums,
and here ``torch.einsum`` (cuBLAS on the card).

Dtypes follow JAX's promotion: ``jnp.einsum`` promotes bf16 with f32 to
f32 where ``torch.einsum`` refuses, so each product casts its operands
first (``common.einsum``).  The intra-chunk term takes bf16 ``x``, ``b``,
``c`` with the f32 decay matrix, so it is computed in f32; the chunk
states and the recurrence are f32; ``y`` and the final state come back in
``x``'s dtype.  ``ssd_step`` multiplies the state by an f32 decay, so
after one step the state is f32 whatever it was.  Where JAX names
float32, the port computes in ``promote_types(dtype, float32)``, so a
float64 run stays float64 (the card's yardstick).

Beyond JAX (which asserts ``S % chunk == 0``): a ragged S is padded to a
whole chunk with zero inputs and zero log-decay, which leaves the outputs
and the final state as they are; so a prefill of any length runs.  The
inter-chunk ``lax.scan`` is a loop over the chunks.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import dist
from repro_torch.models.common import (ArchConfig, LeafSpec, einsum,
                                       logical_constraint, rms_norm,
                                       work_dtype)

HEAD_DIM = 64  # mamba2 P (headdim)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums.

    a: ``[..., l]`` → ``out[..., i, j] = Σ_{j < k ≤ i} a[k]`` (−inf above
    the diagonal, so its ``exp`` is exactly 0 there and passes no
    gradient)."""
    l = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(l, l, dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, diff, -torch.inf)


def ssd(x: torch.Tensor, a_log: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int = 128,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scalar-decay SSM.

    x: ``[B, S, H, P]`` (inputs, already dt-scaled), a_log: ``[B, S, H]``
    (log decay, ≤ 0), b, c: ``[B, S, N]`` (shared by the heads).  Returns
    (y ``[B, S, H, P]``, final_state ``[B, H, P, N]``), both in ``x``'s
    dtype.  A ragged last chunk is padded (see the module's note)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, s)
    pad = -s % chunk
    if pad:
        x, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                   for t in (x, b, c))
        a_log = F.pad(a_log, (0, 0, 0, pad))
    nc = (s + pad) // chunk
    wd = work_dtype(x.dtype)

    xc = x.reshape(bsz, nc, chunk, h, p).to(wd)
    ac = a_log.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n).to(wd)
    cc = c.reshape(bsz, nc, chunk, n).to(wd)

    # (i) intra-chunk (diagonal blocks): (C Bᵀ ∘ L) x, in f32
    L = torch.exp(_segsum(ac.transpose(2, 3))).to(wd)     # [B,nc,H,l,l]
    cb = torch.einsum("bzln,bzsn->bzls", cc, bc)
    y_diag = torch.einsum("bzhls,bzshp->bzlhp", cb[:, :, None] * L, xc)
    del L

    # chunk summaries: each chunk's contribution to the state
    cum = torch.cumsum(ac, dim=2).to(wd)                   # [B,nc,l,H]
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bzsn,bzshp->bzhpn", bc,
                          xc * decay_states[..., None])

    # (ii) inter-chunk recurrence over the nc chunk states
    chunk_decay = torch.exp(cum[:, :, -1, :])              # [B,nc,H]
    st = (torch.zeros((bsz, h, p, n), dtype=wd, device=x.device)
          if init_state is None else init_state.to(wd))
    prev: List[torch.Tensor] = []
    for z in range(nc):
        prev.append(st)                                    # the *previous*
        st = st * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, 1)                     # [B,nc,H,P,N]

    # state → output within each chunk
    y_off = (torch.einsum("bzln,bzhpn->bzlhp", cc, prev_states)
             * torch.exp(cum)[..., None])
    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :s]
    return y.to(x.dtype), st.to(x.dtype)


def ssd_step(state: torch.Tensor, x: torch.Tensor, a_log: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence.  state: ``[B, H, P, N]``; x: ``[B, H, P]``;
    a_log: ``[B, H]``; b, c: ``[B, N]``.  The new state is promoted with
    the decay's dtype (f32), as in JAX."""
    decay = torch.exp(a_log)[:, :, None, None]
    state = state * decay + einsum("bhp,bn->bhpn", x, b)
    y = einsum("bhpn,bn->bhp", state, c)
    return y, state


# ---------------------------------------------------------------------------
# Mamba2 block (in_proj → conv → SSD → gated norm → out_proj)
# ---------------------------------------------------------------------------

def mamba_param_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // HEAD_DIM
    conv_ch = di + 2 * n
    return {
        "norm": (d,),
        "in_proj": (d, 2 * di + 2 * n + h),   # z, x, B, C, dt
        "conv_w": (cfg.ssm_conv, conv_ch),
        "a_log": (h,),
        "d_skip": (h,),
        "dt_bias": (h,),
        "ssm_norm": (di,),
        "out_proj": (di, d),
    }


def mamba_stack_spec(cfg: ArchConfig, n_layers: int,
                     prefix: str) -> List[LeafSpec]:
    """``init_mamba_stack``'s leaves, stacked on a leading ``n_layers``
    axis under ``prefix``: norms and ``dt_bias`` zeros, ``a_log`` and
    ``d_skip`` ones (A = -e), ``conv_w`` normal over ``ssm_conv``, the
    projections normal over their input width."""
    out = []
    for name, shape in mamba_param_shapes(cfg).items():
        if name in ("norm", "ssm_norm", "dt_bias"):
            init = ("const", 0.0)
        elif name in ("a_log", "d_skip"):
            init = ("const", 1.0)
        elif name == "conv_w":
            init = ("normal", cfg.ssm_conv)
        else:
            init = ("normal", shape[-2])
        out.append(((prefix, name), (n_layers,) + shape, init))
    return out


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, ``x * sigmoid(x)``: in bf16 the sigmoid is rounded
    before the product, as JAX computes it (``F.silu`` rounds once)."""
    return x * torch.sigmoid(x)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: ``[B, S, C]``; w: ``[K, C]``; each tap's
    product and the running sum in ``x``'s dtype, as in JAX."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out


def mamba_block(x: torch.Tensor, lp: Dict[str, torch.Tensor],
                cfg: ArchConfig, chunk: int = 128,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                return_state: bool = False):
    """x: ``[B, S, D]`` → ``[B, S, D]``.  ``state = (conv_tail [B, K-1, C],
    ssd [B, H, P, N])`` for a one-token step (S = 1); with a state, or
    ``return_state``, also returns the new ``(conv_tail, ssd)``.  In a
    step everything after ``ssd_step`` is promoted to its f32 output, as
    in JAX (the caller casts the block's output back)."""
    hidden = rms_norm(x, lp["norm"], cfg.norm_eps)
    zxbcdt = hidden @ lp["in_proj"]
    # under a mesh the mixer runs on each rank's batch rows, whole
    # (DTensor folds the sharded head dims of the SSD's einsums into
    # layouts its products cannot take): an explicit replication over the
    # model axis, ROADMAP.md Queue 3
    zl, pl = dist.batch_local(zxbcdt)
    w = {k: dist.replicated_local(lp[k], pl)
         for k in ("conv_w", "dt_bias", "a_log", "d_skip", "ssm_norm")}
    st = None if state is None else tuple(dist.batch_local(t)[0]
                                          for t in state)
    y, new_state = _mixer(zl, w, cfg, chunk, st)
    mesh = getattr(zxbcdt, "device_mesh", None)
    y = dist.rebuild(y, pl, mesh)
    out = logical_constraint(x + y @ lp["out_proj"].to(y.dtype), "batch",
                             "seq", None)
    if return_state or state is not None:
        return out, tuple(dist.rebuild(t, pl, mesh) for t in new_state)
    return out


def _mixer(zxbcdt: torch.Tensor, lp: Dict[str, torch.Tensor],
           cfg: ArchConfig, chunk: int,
           state: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """The block between its projections on plain tensors: the causal
    conv, the SSD (chunked, or one step from ``state``), the skip and the
    gated norm.  Returns ``(y [B, S, di], (conv_tail, ssd state))``."""
    bsz, s = zxbcdt.shape[:2]
    n = cfg.ssm_state
    di = cfg.ssm_expand * cfg.d_model
    h = di // HEAD_DIM
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)

    if state is None:
        xbc_conv = silu(_causal_conv(xbc, lp["conv_w"]))
        new_conv_tail = xbc[:, -(cfg.ssm_conv - 1):]
    else:
        window = torch.cat([state[0], xbc], dim=1)
        xbc_conv = silu(einsum("bkc,kc->bc", window, lp["conv_w"]))[:, None]
        new_conv_tail = window[:, 1:]

    xs, b, c = torch.split(xbc_conv, [di, n, n], dim=-1)
    xs = xs.reshape(bsz, -1, h, HEAD_DIM)
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus switches to x past 20)
    dt = dt + lp["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))          # [B, S, H]
    wd = work_dtype(zxbcdt.dtype)
    a = -torch.exp(lp["a_log"].to(wd))                     # [H]
    a_log = dt.to(wd) * a                                  # [B, S, H] ≤ 0
    x_scaled = xs * dt[..., None].to(xs.dtype)

    if state is None:
        y, final = ssd(x_scaled, a_log, b, c, chunk=chunk)
    else:
        y, final = ssd_step(state[1], x_scaled[:, 0], a_log[:, 0], b[:, 0],
                            c[:, 0])
        y = y[:, None]

    y = y + xs * lp["d_skip"][None, None, :, None]
    y = y.reshape(bsz, -1, di)
    return (rms_norm(y * silu(z), lp["ssm_norm"], cfg.norm_eps),
            (new_conv_tail, final))
