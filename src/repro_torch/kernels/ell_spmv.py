"""Wrapper of the Hopper sparse-stage SpMV kernel (``csrc/ell_spmv.cu``)
and its row plan.

The kernel replaces ``repro/kernels/ell_spmv.py::ell_spmv``: for each query
and row of a CSR in-edge layout (the hybrid split's remainder,
``core/hybrid.py``) it reduces ``x[q, col] ⊗ val`` over the row's slots
under one of three semirings.  The JAX kernel reads the same rows as an
ELL block padded to the widest row; CSR rows need no padding and no
sentinel column in ``x``.

The kernel's blocks follow a row plan (:func:`row_plan`), made once per
split from ``row_ptr`` and kept beside it: runs of consecutive rows that
fit ``BUDGET`` slots, staged whole into shared memory, and chunks of
``BUDGET`` slots of each longer row, whose partials a second pass adds in
order.  ``x`` is read query-minor (:func:`query_minor`), so one slot's
queries share one memory sector; the engines copy ``x`` there once per
superstep (:func:`query_minor_view`) for every kernel op that reads it.
The bottom-up scan (``kernels/bottomup.py``) walks the same plan.  It is
bound by bytes on the card (see the note in the source).

This module builds nothing when imported; the library is built at the first
launch (or by ``_build.build_all``), and only CUDA tensors reach it: the CPU
path is ``ref.ell_spmv_ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.kernels import _build

SOURCE = "ell_spmv"

MODES = {"plus_times": 0, "min_plus": 1, "min": 2}

# The plan's geometry; the library reports its own and the wrapper checks
# that they agree.
BUDGET = 2048       # slots of one run (staged in shared memory) or one chunk
RUN_ROWS = 512      # rows of one run
LANE_RUN = 64       # slots one lane adds in a run, at most
THREADS = 256       # threads of a block
QUERY_ALIGN = 4     # x's query axis is padded to a multiple of this

Array = Union[np.ndarray, torch.Tensor]

_P = ctypes.c_void_p
_I = ctypes.c_int


class EllPlan(NamedTuple):
    """The kernel's blocks over one ``row_ptr``.

    ``blocks [nb, 3]`` int32: a run ``(r0, r1, L)`` covers rows
    ``[r0, r1)`` with ``L`` lanes per row; a chunk ``(r, c, -1 - p)`` covers
    slots ``[c * BUDGET, (c + 1) * BUDGET)`` of row ``r`` and writes
    partial ``p``.  ``long_rows [nl, 2]`` int32: each chunked row and its
    first partial.  ``num_partials``: the chunks in all.  ``num_rows`` and
    ``num_slots``: V and nnz of the ``row_ptr`` it was made from, which
    :meth:`check` holds a launch's rows to.  Fields are numpy arrays on the
    host, tensors after :meth:`to`."""

    blocks: Array
    long_rows: Array
    num_partials: int
    num_rows: int
    num_slots: int

    def to(self, device) -> "EllPlan":
        """The plan as int32 tensors on ``device``."""
        return self._replace(**{
            k: torch.as_tensor(getattr(self, k), dtype=torch.int32,
                               device=device)
            for k in ("blocks", "long_rows")})

    def check(self, row_ptr: Array, col: Array) -> None:
        """Raise unless the plan was made from rows of this shape: the
        kernel sizes its shared-memory stages by the plan, so another
        split's plan would overrun them."""
        rows, slots = row_ptr.shape[0] - 1, col.shape[0]
        if (rows, slots) != (self.num_rows, self.num_slots):
            raise ValueError(
                f"plan of {self.num_rows} rows and {self.num_slots} slots "
                f"does not belong to row_ptr/col of {rows} rows and "
                f"{slots} slots; make it with row_plan(row_ptr)")


def _pow2_ceil(n: np.ndarray) -> np.ndarray:
    return np.left_shift(1, np.ceil(np.log2(np.maximum(n, 1))).astype(
        np.int64))


def row_plan(row_ptr: Array, lanes: Optional[np.ndarray] = None) -> EllPlan:
    """Cut CSR rows into the kernel's blocks, in row order.

    Consecutive rows form a run while their slots fit ``BUDGET`` and they
    number at most ``RUN_ROWS``; a row of more than ``BUDGET`` slots gets
    one chunk per ``BUDGET`` slots.  A run's lanes per row ``L`` is the
    larger of the power of two at or below its mean row length (at most
    32) and the least power of two that keeps every lane's share of its
    longest row within ``LANE_RUN`` slots.  Every row lies in exactly one
    run or in its chunks.

    ``lanes [V]`` (:func:`plan_lanes` of another plan, at these rows)
    prescribes each row's ``L`` instead: runs also end where it changes.
    A row's sum depends only on its slots, its ``L`` and whether it is
    chunked (its length), so rows cut out of a planned split and planned
    again this way reduce bit for bit as they did there."""
    rp = np.asarray(torch.as_tensor(row_ptr).cpu() if isinstance(
        row_ptr, torch.Tensor) else row_ptr, dtype=np.int64)
    v = len(rp) - 1
    lens = np.diff(rp)
    if lanes is not None:
        lanes = np.asarray(lanes, dtype=np.int64)
        if lanes.shape != (v,):
            raise ValueError(f"lanes must give each of the {v} rows its "
                             f"lane count, got shape {lanes.shape}")
        changes = np.flatnonzero(np.diff(lanes)) + 1
    runs, chunks, long_rows = [], [], []
    parts = 0
    r = 0
    while r < v:
        n = int(lens[r])
        if n > BUDGET:
            k = -(-n // BUDGET)
            chunks.extend((r, c, -1 - (parts + c)) for c in range(k))
            long_rows.append((r, parts))
            parts += k
            r += 1
            continue
        end = int(np.searchsorted(rp, rp[r] + BUDGET, side="right")) - 1
        end = min(end, r + RUN_ROWS, v)
        if lanes is not None:
            i = np.searchsorted(changes, r, side="right")
            if i < len(changes):
                end = min(end, int(changes[i]))
        runs.append((r, end))
        r = end
    blocks = np.zeros((len(runs) + len(chunks), 3), dtype=np.int32)
    if runs and lanes is not None:
        run = np.asarray(runs, dtype=np.int64)
        got = lanes[run[:, 0]]
        if not np.all((got >= 1) & (got <= 32) & ((got & (got - 1)) == 0)):
            raise ValueError("a run's prescribed lane count is not a power "
                             "of two in [1, 32]: the lanes belong to other "
                             "rows")
        blocks[:len(runs), :2] = run
        blocks[:len(runs), 2] = got
    elif runs:
        run = np.asarray(runs, dtype=np.int64)
        starts, ends = run[:, 0], run[:, 1]
        # only long rows lie between runs: zeroed, they leave each run's
        # maximum over [start, next start) its own
        longest = np.maximum.reduceat(np.where(lens > BUDGET, 0, lens),
                                      starts)
        mean = (rp[ends] - rp[starts]) / (ends - starts)
        by_mean = np.minimum(np.left_shift(1, np.floor(np.log2(
            np.maximum(mean, 1.0))).astype(np.int64)), 32)
        by_max = _pow2_ceil(-(-longest // LANE_RUN))
        blocks[:len(runs), :2] = run
        blocks[:len(runs), 2] = np.maximum(by_mean, by_max)
    if chunks:
        blocks[len(runs):] = np.asarray(chunks, dtype=np.int64)
    return EllPlan(blocks,
                   np.asarray(long_rows, dtype=np.int32).reshape(-1, 2),
                   parts, v, int(rp[-1]))


def plan_lanes(plan: EllPlan) -> np.ndarray:
    """Each row's lanes ``L`` in ``plan`` (a host plan), 0 for a chunked
    row: the ``lanes`` that make :func:`row_plan` give rows cut out of
    these the same reduction."""
    blocks = np.asarray(plan.blocks, dtype=np.int64).reshape(-1, 3)
    runs = blocks[blocks[:, 2] > 0]
    lens = runs[:, 1] - runs[:, 0]
    rows = np.repeat(runs[:, 0] - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                     lens) + np.arange(int(lens.sum()))
    out = np.zeros(plan.num_rows, dtype=np.int32)
    out[rows] = np.repeat(runs[:, 2], lens)
    return out


def query_minor_base(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The ``[x_len, Qp]`` f32 buffer behind ``x`` when ``x`` is the
    ``[Q, x_len]`` view :func:`query_minor_view` returns, else None."""
    q, n = x.shape
    qp = -(-q // QUERY_ALIGN) * QUERY_ALIGN
    if x.dtype != torch.float32 or q == 0 or x.stride() != (1, qp):
        return None
    if x.untyped_storage().nbytes() < (x.storage_offset() + n * qp) * 4:
        return None
    return x.as_strided((n, qp), (qp, 1))


def query_minor(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x [Q, x_len]`` as ``[x_len, Qp]``, Qp = Q rounded up to a multiple
    of ``QUERY_ALIGN``, the padding ``fill`` (the ⊕-identity): one copy, or
    none when ``x`` is already a view of such a buffer
    (:func:`query_minor_view`)."""
    base = query_minor_base(x)
    if base is not None:
        return base
    q, n = x.shape
    qp = -(-q // QUERY_ALIGN) * QUERY_ALIGN
    xt = torch.empty((n, qp), dtype=x.dtype, device=x.device)
    xt[:, :q] = x.t()
    if qp > q:
        xt[:, q:] = fill
    return xt


def query_minor_view(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x [Q, x_len]`` copied once into a query-minor f32 buffer
    ``[x_len, Qp]`` (padding ``fill``) and returned as the ``[Q, x_len]``
    view of it.  The kernel ops (``ell_spmv_op``, ``bottomup_scan_op``,
    ``outbox_reduce_op``) hand that buffer to their kernels without another
    copy, so a superstep whose ops read one ``x`` copies it once; the plain
    versions read the view like any tensor."""
    return query_minor(x.float(), fill)[:, :x.shape[0]].t()


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.ell_spmv_launch
    fn.argtypes = [_I] + [_P] * 6 + [_I, _P, _I, _P] + [_I] * 3 + [_P]
    fn.restype = _I
    for name in ("ell_spmv_budget", "ell_spmv_run_rows", "ell_spmv_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = _I
    got = (lib.ell_spmv_budget(), lib.ell_spmv_run_rows(),
           lib.ell_spmv_threads())
    if got != (BUDGET, RUN_ROWS, THREADS):
        raise RuntimeError(f"ell_spmv library geometry {got} differs from "
                           f"the plan's {(BUDGET, RUN_ROWS, THREADS)}")
    lib.ell_spmv_error_string.argtypes = [_I]
    lib.ell_spmv_error_string.restype = ctypes.c_char_p
    return lib


def ell_spmv(row_ptr: torch.Tensor, col: torch.Tensor,
             val: Optional[torch.Tensor], xt: torch.Tensor, plan: EllPlan, *,
             semiring: str, num_queries: int) -> torch.Tensor:
    """Launch the kernel; returns ``y [Q, V]`` f32, ``Q = num_queries``.

    ``row_ptr`` int32 ``[V + 1]``, ``col`` int32 ``[nnz]`` indices into the
    first axis of ``xt`` f32 ``[x_len, Qp]`` (query-minor, from
    :func:`query_minor`), ``val`` f32 ``[nnz]`` (not read by ``min``, which
    also takes None), ``plan`` the :class:`EllPlan` of ``row_ptr`` (checked)
    as tensors on the same CUDA device; all contiguous.  Raises on anything the
    kernel does not take.
    """
    mode = MODES.get(semiring)
    if mode is None:
        raise ValueError(f"unknown semiring {semiring!r}; the kernel has "
                         f"{sorted(MODES)}")
    plan.check(row_ptr, col)
    dev = xt.device
    if dev.type != "cuda":
        raise ValueError(f"xt must be a CUDA tensor, got {dev}")
    if xt.dim() != 2 or xt.shape[1] % QUERY_ALIGN != 0 or not (
            0 <= num_queries <= xt.shape[1]):
        raise ValueError(f"xt must be [x_len, Qp] with Qp a multiple of "
                         f"{QUERY_ALIGN} and >= {num_queries} queries, got "
                         f"shape {tuple(xt.shape)}")
    _build.check_tensor("xt", xt, torch.float32, dev)
    _build.check_tensor("row_ptr", row_ptr, torch.int32, dev)
    _build.check_tensor("col", col, torch.int32, dev)
    _build.check_tensor("plan.blocks", plan.blocks, torch.int32, dev)
    _build.check_tensor("plan.long_rows", plan.long_rows, torch.int32, dev)
    if semiring == "min":
        val = None
    elif val is None:
        raise ValueError(f"{semiring} needs val")
    else:
        _build.check_tensor("val", val, torch.float32, dev)
        if val.shape != col.shape:
            raise ValueError(f"val {tuple(val.shape)} and col "
                             f"{tuple(col.shape)} differ")
    qp = xt.shape[1]
    v = row_ptr.shape[0] - 1
    y = torch.empty((num_queries, v), dtype=torch.float32, device=dev)
    if v == 0 or num_queries == 0:
        return y
    if col.shape[0] == 0:   # no slot at all: every row is the ⊕-identity
        return y.fill_(0.0 if semiring == "plus_times" else float("inf"))
    lib = _library()
    partials = torch.empty(max(plan.num_partials, 1) * qp,
                           dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ell_spmv_launch(
            mode, row_ptr.data_ptr(), col.data_ptr(),
            val.data_ptr() if val is not None else None, xt.data_ptr(),
            y.data_ptr(), plan.blocks.data_ptr(), plan.blocks.shape[0],
            plan.long_rows.data_ptr(), plan.long_rows.shape[0],
            partials.data_ptr(), num_queries, qp, v, stream)
    if rc != 0:
        raise RuntimeError("ell_spmv launch failed: "
                           + lib.ell_spmv_error_string(rc).decode())
    ell_spmv.launches += 1
    return y


# Kernel launches since the caller last set this to 0.
ell_spmv.launches = 0
