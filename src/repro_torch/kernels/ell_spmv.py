"""Wrapper of the Hopper sparse-stage SpMV kernel (``csrc/ell_spmv.cu``).

The kernel replaces ``repro/kernels/ell_spmv.py::ell_spmv``: for each query
and row of a CSR in-edge layout (the hybrid split's remainder,
``core/hybrid.py``) it reduces ``x[q, col] ⊗ val`` over the row's slots
under one of three semirings.  The JAX kernel reads the same rows as an
ELL block padded to the widest row; CSR rows need no padding, no sentinel
column in ``x`` and no row blocking.  It is bound by bytes on the card
(see the note in the source).

This module builds nothing when imported; the library is built at the first
launch (or by ``_build.build_all``), and only CUDA tensors reach it: the CPU
path is ``ref.ell_spmv_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SEMIRINGS

SOURCE = "ell_spmv"

MODES = {"plus_times": 0, "min_plus": 1, "min": 2}

_P = ctypes.c_void_p


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ell_spmv_launch
    fn.argtypes = [ctypes.c_int] + [_P] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    lib.ell_spmv_warp_max.argtypes = []
    lib.ell_spmv_warp_max.restype = ctypes.c_int
    lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
    lib.ell_spmv_error_string.restype = ctypes.c_char_p
    return lib


def ell_spmv(row_ptr: torch.Tensor, col: torch.Tensor,
             val: Optional[torch.Tensor], x: torch.Tensor, *,
             semiring: str) -> torch.Tensor:
    """Launch the kernel; returns ``y [Q, V]`` f32.

    ``row_ptr`` int32 ``[V + 1]``, ``col`` int32 ``[nnz]`` indices into the
    last axis of ``x`` f32 ``[Q, x_len]``, ``val`` f32 ``[nnz]`` (not read
    by ``min``, which also takes None), all on one CUDA device and
    contiguous.  Raises on anything the kernel does not take.
    """
    mode = MODES.get(semiring)
    if mode is None:
        raise ValueError(f"unknown semiring {semiring!r}; the kernel has "
                         f"{sorted(MODES)}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"x must be [Q, x_len], got shape {tuple(x.shape)}")
    _build.check_tensor("x", x, torch.float32, dev)
    _build.check_tensor("row_ptr", row_ptr, torch.int32, dev)
    _build.check_tensor("col", col, torch.int32, dev)
    if semiring == "min":
        val = None
    elif val is None:
        raise ValueError(f"{semiring} needs val")
    else:
        _build.check_tensor("val", val, torch.float32, dev)
        if val.shape != col.shape:
            raise ValueError(f"val {tuple(val.shape)} and col "
                             f"{tuple(col.shape)} differ")
    q, x_len = x.shape
    v = row_ptr.shape[0] - 1
    y = torch.empty((q, v), dtype=torch.float32, device=dev)
    if v == 0 or q == 0:
        return y
    if col.shape[0] == 0:   # no slot at all: every row is the ⊕-identity
        return y.fill_(SEMIRINGS[semiring][1])
    lib = _library()
    # the hub list: at most nnz // (warp_max + 1) rows are longer than a
    # warp's share
    max_hubs = min(v, col.shape[0] // (lib.ell_spmv_warp_max() + 1))
    scratch = torch.zeros(1 + max_hubs, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ell_spmv_launch(
            mode, row_ptr.data_ptr(), col.data_ptr(),
            val.data_ptr() if val is not None else None, x.data_ptr(),
            y.data_ptr(), scratch.data_ptr(), max_hubs, q, v, x_len, stream)
    if rc != 0:
        raise RuntimeError("ell_spmv launch failed: "
                           + lib.ell_spmv_error_string(rc).decode())
    ell_spmv.launches += 1
    return y


# Kernel launches since the caller last set this to 0.
ell_spmv.launches = 0
