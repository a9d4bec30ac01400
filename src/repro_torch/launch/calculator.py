"""First-principles roofline calculator for the H100 (napkin math, per
arch × shape).

The JAX-free copy of ``benchmarks/calculator.py``: ``count_params`` and
``analyze`` with the same formulas, the parameter count taken from the
port's ``meta`` parameters.  Only the constants differ: the NVIDIA H100
SXM data sheet's dense bf16 rate (989 TFLOP/s) and HBM3 rate (3.35 TB/s),
the rates ``chip_smoke.py`` uses for its bounds, and for ``collective_s``
the per-card rate of the network between NVLink domains.  They are data
sheet figures, not measurements.  An HGX/DGX H100 node joins 8 cards by
NVLink (900 GB/s per card, both directions together, H100 SXM data sheet),
so the 16-wide ``model`` axis of the production meshes spans two NVLink
domains and its rings cross the nodes' network: 400 Gb/s a card (one
ConnectX-7 NDR port per card, DGX H100 data sheet), 50 GB/s.  The JAX
package's constants are a TPU's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.models import api
from repro_torch.models.api import ShapeSpec
from repro_torch.models.common import ArchConfig

PEAK_FLOPS = 989e12        # dense bf16, H100 SXM data sheet
HBM_BW = 3.35e12           # HBM3, H100 SXM data sheet
LINK_BW = 50e9             # 400 Gb/s NDR a card, between NVLink domains
BF16 = 2
F32 = 4


def count_params(cfg: ArchConfig) -> Dict[str, float]:
    """Exact parameter count from the ``meta`` parameters; MoE active
    split."""
    shapes = api.build(cfg, "meta", serve=False).params_shape()
    total = 0
    moe = 0

    def walk(tree, path):
        nonlocal total, moe
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], path + (k,))
            return
        n = tree.numel()
        total += n
        if any("moe_w" in p for p in path):
            moe += n

    walk(shapes, ())
    active = total - moe + (moe * cfg.moe_top_k // max(cfg.moe_experts, 1)
                            if cfg.is_moe else 0)
    return {"total": total, "moe": moe, "active": active}


def _attn_flops_per_token(cfg: ArchConfig, s_att: float) -> float:
    d, hd, h, g = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    proj = 2 * d * (h + 2 * g) * hd + 2 * h * hd * d      # qkv + wo
    attn = 4 * s_att * h * hd                             # QKᵀ + PV
    return proj + attn


def _ffn_flops_per_token(cfg: ArchConfig) -> float:
    if cfg.is_moe:
        router = 2 * cfg.d_model * cfg.moe_experts
        expert = cfg.moe_top_k * 6 * cfg.d_model * cfg.d_ff
        return router + expert
    return 6 * cfg.d_model * cfg.d_ff


def _mamba_flops_per_token(cfg: ArchConfig, chunk: int = 128) -> float:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // 64
    proj = 2 * d * (2 * di + 2 * n + h) + 2 * di * d      # in_proj + out
    conv = 2 * cfg.ssm_conv * (di + 2 * n)
    # chunked SSD per token: intra-chunk quadratic + state in/out
    ssd = 2 * chunk * (n + di) + 4 * n * di
    return proj + conv + ssd


def _xlstm_flops_per_token(cfg: ArchConfig, chunk: int = 128) -> float:
    d = cfg.d_model
    di = 2 * d
    h = cfg.n_heads
    dh = di // h
    proj = 2 * d * (2 * di) + 2 * d * di * 3 + 2 * di * d  # up,q,k,ogate,down
    # mLSTM via SSD dual (matrix memory: n = p = dh) + normalizer (p=1)
    mlstm = 2 * chunk * h * (dh + dh * dh) + 4 * h * dh * dh * dh / chunk \
        + 2 * chunk * h * 2 * dh
    return proj + mlstm


def _layer_flops_per_token(cfg: ArchConfig, s_att: float) -> float:
    if cfg.family == "ssm":
        return _xlstm_flops_per_token(cfg)
    if cfg.family == "hybrid":
        f = _mamba_flops_per_token(cfg)
        # shared attention block every attn_every layers (amortized)
        attn = (_attn_flops_per_token(cfg, s_att)
                + _ffn_flops_per_token(cfg)) / cfg.attn_every
        return f + attn
    return _attn_flops_per_token(cfg, s_att) + _ffn_flops_per_token(cfg)


@dataclasses.dataclass
class Roofline:
    flops: float               # per device per step
    hbm_bytes: float           # per device per step
    ici_bytes: float           # per device per step (analytic or counted)
    model_flops: float         # 6·N(active)·D global (reference)
    compute_s: float
    memory_s: float
    collective_s: float
    num_chips: int = 1

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / total HLO-style FLOPs (global vs global) — the
        spec's remat/redundancy-waste metric."""
        total = self.flops * self.num_chips
        return self.model_flops / total if total else 0.0

    @property
    def attainment_bound(self) -> float:
        """Fraction of a perfectly-overlapped roofline step the dominant
        term would occupy if nothing overlapped (serial pessimistic)."""
        total = self.compute_s + self.memory_s + self.collective_s
        return max(self.compute_s, self.memory_s,
                   self.collective_s) / max(total, 1e-30)

    @property
    def mfu_bound(self) -> float:
        """Best-case MFU: model flops over peak during max(terms)."""
        step = max(self.compute_s, self.memory_s, self.collective_s)
        return self.model_flops / (self.num_chips * PEAK_FLOPS
                                   * max(step, 1e-30))

    def as_dict(self) -> dict:
        return {**dataclasses.asdict(self),
                "dominant": self.dominant,
                "useful_ratio": self.useful_ratio,
                "attainment_bound": self.attainment_bound,
                "mfu_bound": self.mfu_bound}


def analyze(cfg: ArchConfig, shape: ShapeSpec, num_chips: int,
            ici_bytes_measured: Optional[float] = None) -> Roofline:
    """Roofline terms for one (arch × shape) cell on ``num_chips``.
    ``ici_bytes_measured``: the collective bytes of the whole step summed
    over every chip (the dry run's per-rank count times the chips), which
    replace the analytic estimate; divided by the chips here."""
    b, s = shape.batch, shape.seq
    n_mb = cfg.microbatches if shape.kind == "train" else 1
    params = count_params(cfg)
    n_total, n_active = params["total"], params["active"]
    L = cfg.n_layers
    d, v = cfg.d_model, cfg.vocab

    if shape.kind == "train":
        tokens = b * s
        # causal attention averages S/2 keys; local layers see the window
        if cfg.local_global_ratio:
            r = cfg.local_global_ratio
            s_att = (r * min(cfg.local_window, s) + s / 2) / (r + 1)
        else:
            s_att = s / 2
        fwd_layer = _layer_flops_per_token(cfg, s_att) * tokens * L
        if cfg.enc_dec:
            fwd_layer *= 2  # encoder stack + decoder stack
        head = 2 * d * v * tokens
        # fwd + bwd(2×) + remat recompute(≈1× of layers) ; head has no remat
        flops = 4 * fwd_layer + 3 * head
        model_flops = 6 * n_active * tokens

        b_mb = b // n_mb
        act = b_mb * s * d * BF16
        hbm = (
            3 * 2 * n_total * n_mb            # weights: fwd+bwd+remat reads
            + 28 * n_total                    # optimizer: p,m,v r/w + grads
            + 12 * act * L * n_mb             # activation write/read traffic
            + 3 * b_mb * s * v * F32 * n_mb   # logits + softmax traffic
        )
        # FSDP all-gather (bf16 weights per mb) + grad reduce-scatter (f32)
        tp = 16
        ici = (2 * n_total / tp * n_mb        # param all-gather per mb
               + 4 * n_total / tp * n_mb      # grad reduce-scatter per mb
               + 4 * act * L * n_mb)          # TP activation all-reduces
    elif shape.kind == "prefill":
        tokens = b * s
        s_att = s / 2
        fwd_layer = _layer_flops_per_token(cfg, s_att) * tokens * L
        if cfg.enc_dec:
            enc_tokens = b * 4096
            fwd_layer += _layer_flops_per_token(cfg, 4096 / 2) \
                * enc_tokens * L
        head = 2 * d * v * b                  # last-token logits only
        flops = fwd_layer + head
        model_flops = 2 * n_active * tokens
        act = b * s * d * BF16
        cache = 2 * L * b * s * cfg.n_kv_heads * cfg.hd * BF16
        hbm = 2 * n_total + 6 * act * L + cache
        ici = 2 * n_total / 16 + 2 * act * L
    else:  # decode: one token against an s-long cache
        tokens = b
        if cfg.family == "ssm":
            s_att = 0.0
        elif cfg.family == "hybrid":
            s_att = s          # shared attn reads full cache
        elif cfg.local_global_ratio:
            r = cfg.local_global_ratio
            s_att = (r * min(cfg.local_window, s) + s) / (r + 1)
        else:
            s_att = s
        flops = _layer_flops_per_token(cfg, s_att) * tokens * L \
            + 2 * d * v * tokens
        model_flops = 2 * n_active * tokens
        # KV cache read dominates HBM traffic
        if cfg.family == "ssm":
            di = 2 * d
            dh = di // cfg.n_heads
            cache = L * b * cfg.n_heads * (dh * dh + 3 * dh) * F32 * 2
        elif cfg.family == "hybrid":
            di = cfg.ssm_expand * d
            ssm = L * b * (di * cfg.ssm_state / 64 * 64) * BF16 * 2
            ng = L // cfg.attn_every
            cache = ssm + 2 * ng * b * s * cfg.n_kv_heads * cfg.hd * BF16
        else:
            eff = s_att if cfg.local_global_ratio else s
            cache = 2 * L * b * eff * cfg.n_kv_heads * cfg.hd * BF16
        hbm = 2 * n_total + cache
        ici = 2 * n_total / 16 / 8  # per-step weight traffic amortizes; TP ar
        ici += 2 * b * d * L * BF16 * 2

    if ici_bytes_measured is not None:
        ici = ici_bytes_measured

    flops_dev = flops / num_chips
    hbm_dev = hbm / num_chips
    ici_dev = ici / num_chips
    return Roofline(
        flops=flops_dev, hbm_bytes=hbm_dev, ici_bytes=ici_dev,
        model_flops=model_flops,
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=hbm_dev / HBM_BW,
        collective_s=ici_dev / LINK_BW,
        num_chips=num_chips,
    )
