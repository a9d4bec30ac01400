"""Wrapper of the Hopper flash-attention kernels (``csrc/flash_attention.cu``).

The kernels replace ``repro/kernels/flash_attention.py::flash_attention``
(the Pallas kernel) and the head repeat of ``repro/kernels/ops.py::
flash_attention_op``.  They compute causal online-softmax attention with an
optional sliding window on the model's layout, ``q [B, S, G, R, D]`` and
``k, v [B, S, G, D]``, reading KV group ``h // R`` for query head ``h``:
f32 running max, denominator and accumulator, the output rounded to the
input type.  The input type picks the kernel: bf16 runs both products on
the tensor cores (``wgmma``, TMA loads, P rounded to bf16 before P·V as
the Pallas kernel does), f32 on the CUDA cores with P in f32.  Any S (a
ragged last tile is masked), D in ``HEAD_DIMS``.  At the prefill's shapes
the work is bound by operations (see the note in the source).

This module builds nothing when imported.  The library is built at the
first launch (or by ``_build.build_all``), and only CUDA tensors reach it:
the CPU path is ``ref.flash_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)
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
    """Launch the kernel; returns ``[B, S, G, R, D]`` in ``q``'s dtype.

    ``q [B, S, G, R, D]``, ``k, v [B, S, G, D]``, one dtype (f32 or bf16),
    contiguous, on one CUDA device.  Keys ``k <= q`` are live when
    ``causal``, and ``q - k < window`` when ``window > 0``.  Raises on
    anything the kernel does not take.
    """
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
    return out


# Kernel launches since the caller last set this to 0.
flash_attention.launches = 0
