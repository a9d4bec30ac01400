"""Wrappers of the Hopper dense-stage kernels (``csrc/dense_spmv.cu``).

``dense_spmv`` replaces ``repro/kernels/dense_spmv.py::dense_spmv``
(``y = x @ a``, f32 accumulation) and ``dense_spmv_minplus`` replaces
``::dense_spmv_minplus`` (``y[m, n] = min_k x[m, k] + a[k, n]``): the
hybrid backend's stage over the H x H block of the top-degree vertices,
with the query batch on M.  One source holds both; they are two entry
points with two launch counters.  Both compute on CUDA cores in f32 with a
fixed summation order, and both are bound by bytes on the card (see the
note in the source).  The TPU padding of K and N to tiles has no
counterpart: the kernels take ragged shapes.

This module builds nothing when imported; the library is built at the first
launch (or by ``_build.build_all``), and only CUDA tensors reach it: the CPU
path is ``ref.dense_spmv_ref`` / ``ref.dense_spmv_minplus_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "dense_spmv"

_P = ctypes.c_void_p


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    for name in ("dense_spmv_launch", "dense_spmv_minplus_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 4 + [ctypes.c_int] * 3 + [_P]
        fn.restype = ctypes.c_int
    lib.dense_spmv_slices.argtypes = [ctypes.c_int]
    lib.dense_spmv_slices.restype = ctypes.c_int
    lib.dense_spmv_error_string.argtypes = [ctypes.c_int]
    lib.dense_spmv_error_string.restype = ctypes.c_char_p
    return lib


def _launch(wrapper, entry: str, x: torch.Tensor, a: torch.Tensor,
            identity: float) -> torch.Tensor:
    """Check, launch ``entry`` and count the launch on ``wrapper``."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {dev}")
    if x.dim() != 2 or a.dim() != 2 or x.shape[1] != a.shape[0]:
        raise ValueError(f"x [M, K] and a [K, N] do not match: "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    _build.check_tensor("x", x, torch.float32, dev)
    _build.check_tensor("a", a, torch.float32, dev)
    m, k = x.shape
    n = a.shape[1]
    if m == 0 or n == 0 or k == 0:   # an empty K leaves the ⊕-identity
        return torch.full((m, n), identity, dtype=torch.float32, device=dev)
    lib = _library()
    part = torch.empty((lib.dense_spmv_slices(k), m, n), dtype=torch.float32,
                       device=dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(x.data_ptr(), a.data_ptr(), part.data_ptr(),
                                 y.data_ptr(), m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.dense_spmv_error_string(rc).decode())
    wrapper.launches += 1
    return y


def dense_spmv(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Launch the plus-times kernel: ``x`` f32 ``[M, K]``, ``a`` f32
    ``[K, N]``, contiguous on one CUDA device; returns ``[M, N]`` f32."""
    return _launch(dense_spmv, "dense_spmv_launch", x, a, 0.0)


def dense_spmv_minplus(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Launch the min-plus kernel (``+inf`` for non-edges); same contract as
    :func:`dense_spmv`."""
    return _launch(dense_spmv_minplus, "dense_spmv_minplus_launch", x, a,
                   float("inf"))


# Kernel launches since the caller last set these to 0.
dense_spmv.launches = 0
dense_spmv_minplus.launches = 0
