"""Wrappers of the Hopper dense-stage kernels (``csrc/dense_spmv.cu``).

``dense_spmv`` replaces ``repro/kernels/dense_spmv.py::dense_spmv``
(``y = x @ a``, f32 accumulation) and ``dense_spmv_minplus`` replaces
``::dense_spmv_minplus`` (``y[m, n] = min_k x[m, k] + a[k, n]``): the
hybrid backend's stage over the H x H block of the top-degree vertices,
with the query batch on M.  One source holds both; they are two entry
points with two launch counters.  Both compute on CUDA cores in f32 with a
fixed summation order, and both are bound by bytes on the card (see the
note in the source).  ``dense_spmv`` is one launch: 16-byte loads of ``a``
straight to registers, K split over blocks, and the last block of each
column tile adds the slices' partials in order (an integer ticket per tile,
kept per device and stream in ``_TICKETS``).  The TPU padding of K and N to
tiles has no counterpart: the kernels take ragged shapes.

This module builds nothing when imported; the library is built at the first
launch (or by ``_build.build_all``), and only CUDA tensors reach it: the CPU
path is ``ref.dense_spmv_ref`` / ``ref.dense_spmv_minplus_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "dense_spmv"

_P = ctypes.c_void_p
_I = ctypes.c_int

# The tickets of dense_spmv's column tiles, by (device, stream): 0 between
# launches (the last block of a tile resets its own), so launches that
# share them run in stream order.
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    lib.dense_spmv_launch.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.dense_spmv_minplus_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    for name in ("dense_spmv_launch", "dense_spmv_minplus_launch",
                 "dense_spmv_tiles", "dense_spmv_minplus_slices"):
        getattr(lib, name).restype = _I
    lib.dense_spmv_tiles.argtypes = [_I]
    lib.dense_spmv_minplus_slices.argtypes = [_I]
    lib.dense_spmv_partials.argtypes = [_I] * 3
    lib.dense_spmv_partials.restype = ctypes.c_longlong
    lib.dense_spmv_error_string.argtypes = [_I]
    lib.dense_spmv_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, a: torch.Tensor) -> Tuple[int, int, int]:
    """Raise unless ``x [M, K]`` and ``a [K, N]`` are contiguous f32 on
    one CUDA device; returns ``(M, K, N)``."""
    if x.dim() != 2 or a.dim() != 2 or x.shape[1] != a.shape[0]:
        raise ValueError(f"x [M, K] and a [K, N] do not match: "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    for name, t in (("x", x), ("a", a)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    _build.check_tensor("a", a, torch.float32, x.device)
    _build.check_tensor("x", x, torch.float32, x.device)
    return x.shape[0], x.shape[1], a.shape[1]


def _tickets(lib: ctypes.CDLL, dev: torch.device, stream: int,
             n: int) -> torch.Tensor:
    need = lib.dense_spmv_tiles(n)
    held = _TICKETS.get((dev, stream))
    if held is None or held.numel() < need:
        held = torch.zeros(need, dtype=torch.int32, device=dev)
        _TICKETS[dev, stream] = held
    return held


def _raise(lib: ctypes.CDLL, entry: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} failed: "
                           + lib.dense_spmv_error_string(rc).decode())


def dense_spmv(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Launch the plus-times kernel: ``x`` f32 ``[M, K]``, ``a`` f32
    ``[K, N]``, contiguous on one CUDA device; returns ``[M, N]`` f32."""
    m, k, n = _check(x, a)
    dev = x.device
    if m == 0 or n == 0 or k == 0:   # an empty K leaves the ⊕-identity
        return torch.zeros((m, n), dtype=torch.float32, device=dev)
    lib = _library()
    part = torch.empty(lib.dense_spmv_partials(m, k, n), dtype=torch.float32,
                       device=dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        tickets = _tickets(lib, dev, stream, n)
        rc = lib.dense_spmv_launch(x.data_ptr(), a.data_ptr(),
                                   part.data_ptr(), tickets.data_ptr(),
                                   y.data_ptr(), m, k, n, stream)
    _raise(lib, "dense_spmv_launch", rc)
    dense_spmv.launches += 1
    return y


def dense_spmv_minplus(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Launch the min-plus kernel (``+inf`` for non-edges); same contract as
    :func:`dense_spmv`."""
    m, k, n = _check(x, a)
    dev = x.device
    if m == 0 or n == 0 or k == 0:   # an empty K leaves the ⊕-identity
        return torch.full((m, n), float("inf"), dtype=torch.float32,
                          device=dev)
    lib = _library()
    part = torch.empty((lib.dense_spmv_minplus_slices(k), m, n),
                       dtype=torch.float32, device=dev)
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dense_spmv_minplus_launch(x.data_ptr(), a.data_ptr(),
                                           part.data_ptr(), y.data_ptr(), m,
                                           k, n, stream)
    _raise(lib, "dense_spmv_minplus_launch", rc)
    dense_spmv_minplus.launches += 1
    return y


# Kernel launches since the caller last set these to 0.
dense_spmv.launches = 0
dense_spmv_minplus.launches = 0
