"""Wrapper of the Hopper outbox aggregation kernel
(``csrc/outbox_reduce.cu``).

The kernel replaces ``repro/kernels/outbox_reduce.py::outbox_reduce_blocks``
and the phase-2 merge of its block partials in ``repro/kernels/ops.py::
outbox_reduce_op``: the boundary leg of the sharded hybrid superstep.  It
gathers ``x[q, src]`` for every boundary edge, applies the weight inline
(``add``, ``mul`` or none) and reduces the messages into the outbox slots
``out[q, flat]`` (sum or min), the edges sorted by flat slot id.  It
reduces runs of equal ids as the fused superstep kernel does, so it has no
span bound and no fallback.  It reads ``x`` query-minor (``[x_len, Qp]``,
``ell_spmv.query_minor``), so one edge's queries arrive in one or two
16-byte loads, and it carries groups of 8 queries through one pass over the
edges.  It is bound by bytes on the card (see the note in the source).

This module builds nothing when imported.  The library is built at the
first launch (or by ``_build.build_all``), and only CUDA tensors reach it:
the CPU path is ``ref.outbox_reduce_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmv import QUERY_ALIGN
from repro_torch.kernels.ref import MIN, SUM, identity

SOURCE = "outbox_reduce"

WEIGHT_OPS = {None: 0, "add": 1, "mul": 2}
# Edges per thread block (8 per thread): one block stages them once for all
# Q queries.  The sums' rounding depth depends on it (chip_smoke.py's
# outbox_sum_depth).
BLOCK_E = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.outbox_reduce_launch
    fn.argtypes = [_I, _I] + [_P] * 7 + [_I, _I, _L, _I, _I, _I, _P]
    fn.restype = _I
    lib.outbox_reduce_error_string.argtypes = [_I]
    lib.outbox_reduce_error_string.restype = ctypes.c_char_p
    return lib


def outbox_reduce(xt: torch.Tensor, src: torch.Tensor, flat: torch.Tensor,
                  weight: Optional[torch.Tensor], *, num_slots: int,
                  combine: str, num_queries: int,
                  weight_op: Optional[str] = None) -> torch.Tensor:
    """Launch the kernel; returns the outboxes ``[Q, num_slots]`` f32,
    ``Q = num_queries``, the combine identity in every slot no edge
    reaches.

    ``xt`` f32 ``[x_len, Qp]`` is the messages query-minor
    (``ell_spmv.query_minor``; Qp a multiple of 4, at least Q, 16-byte
    aligned); ``src`` int32 ``[E]`` indices into its first axis; ``flat``
    int32 ``[E]`` slot ids, non-decreasing and below ``num_slots``;
    ``weight`` f32 ``[E]`` (read only with a ``weight_op``); all on one
    CUDA device and contiguous.  Raises on anything the kernel does not
    take, before it launches: the shapes and types first, then the device.
    """
    if combine not in (SUM, MIN):
        raise ValueError(f"combine must be {SUM!r} or {MIN!r}, got "
                         f"{combine!r}")
    if weight_op not in WEIGHT_OPS:
        raise ValueError(f"weight_op must be None, 'add' or 'mul', got "
                         f"{weight_op!r}")
    dev = xt.device
    if xt.dim() != 2 or xt.shape[1] % QUERY_ALIGN != 0 or not (
            0 <= num_queries <= xt.shape[1]):
        raise ValueError(f"xt must be [x_len, Qp] with Qp a multiple of "
                         f"{QUERY_ALIGN} holding {num_queries} queries, got "
                         f"shape {tuple(xt.shape)}")
    _build.check_tensor("xt", xt, torch.float32, dev)
    _build.check_tensor("src", src, torch.int32, dev)
    _build.check_tensor("flat", flat, torch.int32, dev)
    e = src.shape[0]
    if src.dim() != 1 or flat.shape != src.shape:
        raise ValueError(f"src {tuple(src.shape)} and flat "
                         f"{tuple(flat.shape)} must be one [E] shape")
    if weight_op is not None:
        if weight is None:
            raise ValueError(f"weight_op {weight_op!r} needs weight")
        _build.check_tensor("weight", weight, torch.float32, dev)
        if weight.shape != src.shape:
            raise ValueError(f"weight {tuple(weight.shape)} and src "
                             f"{tuple(src.shape)} differ")
    if dev.type != "cuda":
        raise ValueError(f"xt must be a CUDA tensor, got {dev}")
    if xt.data_ptr() % 16:
        raise ValueError("xt must be 16-byte aligned (the kernel loads "
                         "float4)")
    q, qp = num_queries, xt.shape[1]
    out = torch.full((q, num_slots), identity(combine), dtype=torch.float32,
                     device=dev)
    if e == 0 or q == 0:
        return out
    nb = -(-e // BLOCK_E)
    part_id = torch.empty((nb, 2), dtype=torch.int32, device=dev)
    part_val = torch.empty((q, nb, 2), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.outbox_reduce_launch(
            int(combine == MIN), WEIGHT_OPS[weight_op], xt.data_ptr(),
            src.data_ptr(), flat.data_ptr(),
            weight.data_ptr() if weight_op is not None else None,
            out.data_ptr(), part_id.data_ptr(), part_val.data_ptr(), q, qp,
            e, nb, BLOCK_E, num_slots, stream)
    if rc != 0:
        raise RuntimeError("outbox_reduce launch failed: "
                           + lib.outbox_reduce_error_string(rc).decode())
    outbox_reduce.launches += 1
    return out


# Kernel launches since the caller last set this to 0.
outbox_reduce.launches = 0
