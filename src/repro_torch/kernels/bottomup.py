"""Wrapper of the Hopper bottom-up scan kernel (``csrc/bottomup.cu``).

The kernel replaces ``repro/kernels/bottomup.py::bottomup_scan``: for each
query and destination row of a CSR in-edge layout
(``partition.build_transposed_csc``) it takes the minimum of the sources'
messages (``min``; ``min_plus`` adds the edge value first) and counts the
slots a sequential scan examines.  With ``early_exit`` the scan of a row
stops once every query has a live (finite) message among the slots read,
which gives the row minimum only when every live message of a query holds
the same value: the caller's licence (``EdgeMessage.frontier_uniform``,
BFS).  It walks the sparse-stage kernel's row plan
(``ell_spmv.row_plan``) and reads ``x`` query-minor (``[x_len, Qp]``,
``ell_spmv.query_minor``), 8 queries per pass over the rows.  It is bound
by bytes on the card (see the note in the source).

This module builds nothing when imported; the library is built at the first
launch (or by ``_build.build_all``), and only CUDA tensors reach it: the CPU
path is ``ref.bottomup_scan_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ell_spmv as kell

SOURCE = "bottomup"

# (semiring, early_exit) -> the kernel's mode
MODES = {("min", False): 0, ("min", True): 1, ("min_plus", False): 2}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.bottomup_scan_launch
    fn.argtypes = [_I] + [_P] * 7 + [_I, _P, _I, _P, _P] + [_I] * 3 + [_P]
    fn.restype = _I
    names = ("bottomup_scan_budget", "bottomup_scan_run_rows",
             "bottomup_scan_threads")
    for name in names:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    got = tuple(getattr(lib, name)() for name in names)
    want = (kell.BUDGET, kell.RUN_ROWS, kell.THREADS)
    if got != want:
        raise RuntimeError(f"bottomup library geometry {got} differs from "
                           f"the row plan's {want}")
    lib.bottomup_scan_error_string.argtypes = [_I]
    lib.bottomup_scan_error_string.restype = ctypes.c_char_p
    return lib


def bottomup_scan(row_ptr: torch.Tensor, col: torch.Tensor,
                  val: Optional[torch.Tensor], xt: torch.Tensor,
                  plan: kell.EllPlan, *, semiring: str, num_queries: int,
                  early_exit: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(y [Q, V] f32, scanned [Q, V] int32)``,
    ``Q = num_queries``.

    ``row_ptr`` int32 ``[V + 1]``, ``col`` int32 ``[nnz]`` indices into the
    first axis of ``xt`` f32 ``[x_len, Qp]`` (query-minor,
    ``ell_spmv.query_minor``; Qp a multiple of 4, at least Q, 16-byte
    aligned), ``val`` f32 ``[nnz]`` for ``min_plus`` (else None), ``plan``
    the ``EllPlan`` of ``row_ptr`` (checked) as tensors on the same CUDA
    device; all contiguous.  Raises on anything the kernel does not take,
    before it launches: the shapes and types first, then the device.
    """
    mode = MODES.get((semiring, bool(early_exit)))
    if mode is None:
        raise ValueError(f"no kernel mode for semiring={semiring!r}, "
                         f"early_exit={early_exit}; it has {sorted(MODES)}")
    plan.check(row_ptr, col)
    dev = xt.device
    if xt.dim() != 2 or xt.shape[1] % kell.QUERY_ALIGN != 0 or not (
            0 < num_queries <= xt.shape[1]):
        raise ValueError(f"xt must be [x_len, Qp] with Qp a multiple of "
                         f"{kell.QUERY_ALIGN} holding {num_queries} >= 1 "
                         f"queries, got shape {tuple(xt.shape)}")
    _build.check_tensor("xt", xt, torch.float32, dev)
    _build.check_tensor("row_ptr", row_ptr, torch.int32, dev)
    _build.check_tensor("col", col, torch.int32, dev)
    _build.check_tensor("plan.blocks", plan.blocks, torch.int32, dev)
    _build.check_tensor("plan.long_rows", plan.long_rows, torch.int32, dev)
    if (val is not None) != (semiring == "min_plus"):
        raise ValueError("val is needed for min_plus and only there")
    if val is not None:
        _build.check_tensor("val", val, torch.float32, dev)
        if val.shape != col.shape:
            raise ValueError(f"val {tuple(val.shape)} and col "
                             f"{tuple(col.shape)} differ")
    if dev.type != "cuda":
        raise ValueError(f"xt must be a CUDA tensor, got {dev}")
    if xt.data_ptr() % 16:
        raise ValueError("xt must be 16-byte aligned (the kernel loads "
                         "float4)")
    qp = xt.shape[1]
    v = row_ptr.shape[0] - 1
    y = torch.empty((num_queries, v), dtype=torch.float32, device=dev)
    scanned = torch.empty((num_queries, v), dtype=torch.int32, device=dev)
    if v == 0:
        return y, scanned
    if col.shape[0] == 0:   # no slot at all: every row is empty
        return y.fill_(float("inf")), scanned.zero_()
    lib = _library()
    parts = max(plan.num_partials, 1) * qp
    part_y = torch.empty(parts, dtype=torch.float32, device=dev)
    part_first = torch.empty(parts, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bottomup_scan_launch(
            mode, row_ptr.data_ptr(), col.data_ptr(),
            val.data_ptr() if val is not None else None, xt.data_ptr(),
            y.data_ptr(), scanned.data_ptr(), plan.blocks.data_ptr(),
            plan.blocks.shape[0], plan.long_rows.data_ptr(),
            plan.long_rows.shape[0], part_y.data_ptr(),
            part_first.data_ptr(), num_queries, qp, v, stream)
    if rc != 0:
        raise RuntimeError("bottomup_scan launch failed: "
                           + lib.bottomup_scan_error_string(rc).decode())
    bottomup_scan.launches += 1
    return y, scanned


# Kernel launches since the caller last set this to 0.
bottomup_scan.launches = 0
