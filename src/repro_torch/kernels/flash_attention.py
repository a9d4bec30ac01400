"""Wrapper of the Hopper flash-attention kernels (``csrc/flash_attention.cu``).

The kernels replace ``repro/kernels/flash_attention.py::flash_attention``
(the Pallas kernel) and the head repeat of ``repro/kernels/ops.py::
flash_attention_op``.  They compute online-softmax attention, causal with
an optional sliding window or full (an encoder's), on the model's layout, ``q [B, S, G, R, D]`` and
``k, v [B, S, G, D]``, reading KV group ``h // R`` for query head ``h``:
f32 running max, denominator and accumulator, the output rounded to the
input type.  The input type picks the kernel: bf16 runs both products on
the tensor cores (``wgmma``, TMA loads, P rounded to bf16 before P·V as
the Pallas kernel does), f32 on the CUDA cores with P in f32.  Any S (a
ragged last tile is masked), D in ``HEAD_DIMS``; D = 80 (zamba2's) runs
the bf16 kernel on 128 columns, the last 48 zeros loaded by the TMA unit
and never stored.  At the prefill's shapes the work is bound by operations
(see the note in the source).

The launcher is the CUDA implementation of the custom op
``repro_torch::flash_attention(q, k, v, causal, window)``, so a DTensor, a
FakeTensor or a meta tensor reaches it too: its CPU implementation is
``ref.flash_attention_ref``; its fake implementation returns
``empty_like(q)`` and holds no ``[S, S]`` tensor; its flop formula
(``torch.utils.flop_counter``) counts the live (query, key) pairs' two
products, 4·D operations a pair a head (68.8 GFLOP at ``[4, 2048, 4, 8,
64]`` causal); its DTensor sharding rule lets the batch and head dims be
sharded and keeps S and D whole.

This module builds nothing when imported.  The library is built at the
first launch (or by ``_build.build_all``), and only CUDA tensors reach it:
the CPU path is ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

SOURCE = "flash_attention"
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = [_I] + [_P] * 4 + [_I] * 7 + [ctypes.c_float, _P]
    fn.restype = _I
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel (through the custom op); returns ``[B, S, G, R,
    D]`` in ``q``'s dtype.

    ``q [B, S, G, R, D]``, ``k, v [B, S, G, D]``, one dtype (f32 or bf16),
    contiguous, on one CUDA device (DTensors of such shards too).  Keys
    ``k <= q`` are live when ``causal``, and ``q - k < window`` when
    ``window > 0``.  Raises on anything the kernel does not take.
    """
    if q.device.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {q.device}")
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal),
                                                 int(window))


def attention_flops(b: int, s: int, g: int, r: int, d: int,
                    causal: bool = True, window: int = 0) -> int:
    """Operations of one launch: the live (query, key) pairs (all ``s *
    s`` when not causal; a positive window bounds each query's keys) times
    4·D (S = Q·Kᵀ and P·V) times the heads."""
    w = window if 0 < window < s else s
    pairs = (w * (w + 1) // 2 + (s - w) * w) if causal else s * s
    return 4 * d * pairs * b * g * r


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int) -> torch.Tensor:
    return _launch(q, k, v, causal, window)


@_flash_op.register_kernel("cpu")
def _flash_op_cpu(q, k, v, causal, window):
    return flash_attention_ref(q, k, v, causal=causal,
                               window=window).contiguous()


@_flash_op.register_fake
def _flash_op_fake(q, k, v, causal, window):
    return torch.empty_like(q)


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    @register_flop_formula(torch.ops.repro_torch.flash_attention)
    def _flops(q_shape, k_shape, v_shape, causal, window, *args,
               out_shape=None, **kwargs) -> int:
        return attention_flops(*q_shape, causal=causal, window=window)


def _register_sharding() -> None:
    """Batch (dim 0 of all three), KV group (dim 2 of all three) or the
    query heads of a group (dim 3 of q; k and v whole) may be sharded; S
    and D are replicated."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _rule(q, k, v, causal, window):
        rep = Replicate()
        out = [([rep], [rep, rep, rep, None, None])]
        for dim in (0, 2):
            out.append(([Shard(dim)], [Shard(dim)] * 3 + [None, None]))
        out.append(([Shard(3)], [Shard(3), rep, rep, None, None]))
        return out


_register_flops()
if torch.distributed.is_available():
    _register_sharding()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: int) -> torch.Tensor:
    """The launcher: checks the operands, launches, counts."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {dev}")
    if q.dim() != 5:
        raise ValueError(f"q must be [B, S, G, R, D], got shape "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    b, s, g, r, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_tensor(name, t, q.dtype, dev)
    if k.shape != (b, s, g, d) or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"[B, S, G, D] = {(b, s, g, d)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if b * g * r > 65535:
        raise ValueError(f"B * heads = {b * g * r} exceeds the grid (65535)")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.flash_attention_launch(
            int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, s, g, r, d, int(causal),
            int(window), 1.0 / (d ** 0.5), stream)
    if rc != 0:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error_string(rc).decode())
    flash_attention.launches += 1
    if not causal:
        flash_attention.noncausal_launches += 1
    return out


# Kernel launches since the caller last set this to 0, and of them the
# non-causal ones (an encoder's).
flash_attention.launches = 0
flash_attention.noncausal_launches = 0
