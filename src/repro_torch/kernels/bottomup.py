"""Wrapper of the Hopper bottom-up scan kernel (``csrc/bottomup.cu``).

The kernel replaces ``repro/kernels/bottomup.py::bottomup_scan``: for each
query and destination row of a CSR in-edge layout
(``partition.build_transposed_csc``) it takes the minimum of the sources'
messages (``min``; ``min_plus`` adds the edge value first) and counts the
slots a sequential scan examines.  With ``early_exit`` the scan of a row
stops at its first live (finite) message, which is the row minimum only
when every live message of the query holds the same value: the caller's
licence (``EdgeMessage.frontier_uniform``, BFS).  It is bound by bytes on
the card (see the note in the source).

This module builds nothing when imported; the library is built at the first
launch (or by ``_build.build_all``), and only CUDA tensors reach it: the CPU
path is ``ref.bottomup_scan_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = "bottomup"

# (semiring, early_exit) -> the kernel's mode
MODES = {("min", False): 0, ("min", True): 1, ("min_plus", False): 2}

_P = ctypes.c_void_p


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bottomup_scan_launch
    fn.argtypes = [ctypes.c_int] + [_P] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_longlong, _P]
    fn.restype = ctypes.c_int
    lib.bottomup_scan_error_string.argtypes = [ctypes.c_int]
    lib.bottomup_scan_error_string.restype = ctypes.c_char_p
    return lib


def bottomup_scan(row_ptr: torch.Tensor, col: torch.Tensor,
                  val: Optional[torch.Tensor], x: torch.Tensor, *,
                  semiring: str, early_exit: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(y [Q, V] f32, scanned [Q, V] int32)``.

    ``row_ptr`` int32 ``[V + 1]``, ``col`` int32 ``[nnz]`` indices into the
    last axis of ``x`` f32 ``[Q, x_len]``, ``val`` f32 ``[nnz]`` for
    ``min_plus`` (else None), all on one CUDA device and contiguous.  Raises
    on anything the kernel does not take.
    """
    mode = MODES.get((semiring, bool(early_exit)))
    if mode is None:
        raise ValueError(f"no kernel mode for semiring={semiring!r}, "
                         f"early_exit={early_exit}; it has {sorted(MODES)}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {dev}")
    if x.dim() != 2:
        raise ValueError(f"x must be [Q, x_len], got shape {tuple(x.shape)}")
    _build.check_tensor("x", x, torch.float32, dev)
    _build.check_tensor("row_ptr", row_ptr, torch.int32, dev)
    _build.check_tensor("col", col, torch.int32, dev)
    if (val is not None) != (semiring == "min_plus"):
        raise ValueError("val is needed for min_plus and only there")
    if val is not None:
        _build.check_tensor("val", val, torch.float32, dev)
        if val.shape != col.shape:
            raise ValueError(f"val {tuple(val.shape)} and col "
                             f"{tuple(col.shape)} differ")
    q, x_len = x.shape
    v = row_ptr.shape[0] - 1
    if not 0 < q <= 65535:
        raise ValueError(f"Q={q} must be in 1..65535 (the launch grid)")
    y = torch.empty((q, v), dtype=torch.float32, device=dev)
    scanned = torch.empty((q, v), dtype=torch.int32, device=dev)
    if v == 0:
        return y, scanned
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bottomup_scan_launch(
            mode, row_ptr.data_ptr(), col.data_ptr(),
            val.data_ptr() if val is not None else None, x.data_ptr(),
            y.data_ptr(), scanned.data_ptr(), q, v, x_len, stream)
    if rc != 0:
        raise RuntimeError("bottomup_scan launch failed: "
                           + lib.bottomup_scan_error_string(rc).decode())
    bottomup_scan.launches += 1
    return y, scanned


# Kernel launches since the caller last set this to 0.
bottomup_scan.launches = 0
