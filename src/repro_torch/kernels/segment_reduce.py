"""Wrapper of the Hopper sorted segment-reduce kernel
(``csrc/segment_reduce.cu``).

The kernel replaces ``repro/kernels/segment_reduce.py::
segment_reduce_blocks`` and the phase-2 merge of ``repro/kernels/ops.py::
segment_reduce_op``: it reduces messages ``msgs [Q, E]`` into
``[Q, num_segments]`` by sorted ids shared across the Q rows (sum or min).
It reduces runs of equal ids, so it has no span bound and no fallback.  A
thread loads its ids and messages straight to registers (16-byte loads
where aligned), and the run structure, which depends on the ids alone, is
found once for all Q rows; the block partials' ids are ``[nb, 2]`` and
their values ``[Q, nb, 2]``.  It is bound by bytes on the card (see the
note in the source).

This module builds nothing when imported.  The library is built at the
first launch (or by ``_build.build_all``), and only CUDA tensors reach it:
the CPU path is ``ref.segment_reduce_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import MIN, SUM, identity

SOURCE = "segment_reduce"

# Edges per thread block (8 per thread): one block loads its ids once for
# all Q rows.  The sums' rounding depth depends on it (chip_smoke.py's
# outbox_sum_depth); the library refuses any other value.
BLOCK_E = 1024

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.segment_reduce_launch
    fn.argtypes = [_I] + [_P] * 5 + [_I, _L, _I, _I, _I, _P]
    fn.restype = _I
    lib.segment_reduce_error_string.argtypes = [_I]
    lib.segment_reduce_error_string.restype = ctypes.c_char_p
    return lib


def partial_shapes(q: int, e: int):
    """The shapes of the block partials for ``q`` rows of ``e`` edges: ids
    ``[nb, 2]``, the same for every row, and values ``[q, nb, 2]``, with
    ``nb = ceil(e / BLOCK_E)`` blocks (slot 0 a block's first run, slot 1
    its last)."""
    nb = -(-e // BLOCK_E)
    return (nb, 2), (q, nb, 2)


def segment_reduce(msgs: torch.Tensor, ids: torch.Tensor, *,
                   num_segments: int, combine: str) -> torch.Tensor:
    """Launch the kernel; returns ``[Q, num_segments]`` f32, the combine
    identity in every segment no id names.

    ``msgs`` f32 ``[Q, E]``; ``ids`` int32 ``[E]``, non-decreasing and in
    ``[0, num_segments)`` (the caller's contract: the kernel writes
    ``out[q, ids[e]]``); both on one CUDA device and contiguous.  Raises on
    anything the kernel does not take.
    """
    if combine not in (SUM, MIN):
        raise ValueError(f"combine must be {SUM!r} or {MIN!r}, got "
                         f"{combine!r}")
    dev = msgs.device
    if dev.type != "cuda":
        raise ValueError(f"msgs must be a CUDA tensor, got {dev}")
    if msgs.dim() != 2:
        raise ValueError(f"msgs must be [Q, E], got shape "
                         f"{tuple(msgs.shape)}")
    _build.check_tensor("msgs", msgs, torch.float32, dev)
    _build.check_tensor("ids", ids, torch.int32, dev)
    q, e = msgs.shape
    if ids.shape != (e,):
        raise ValueError(f"ids {tuple(ids.shape)} must be [E] with E={e}")
    out = torch.full((q, num_segments), identity(combine),
                     dtype=torch.float32, device=dev)
    if e == 0 or q == 0:
        return out
    id_shape, val_shape = partial_shapes(q, e)
    part_id = torch.empty(id_shape, dtype=torch.int32, device=dev)
    part_val = torch.empty(val_shape, dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.segment_reduce_launch(
            int(combine == MIN), msgs.data_ptr(), ids.data_ptr(),
            out.data_ptr(), part_id.data_ptr(), part_val.data_ptr(), q, e,
            id_shape[0], BLOCK_E, num_segments, stream)
    if rc != 0:
        raise RuntimeError("segment_reduce launch failed: "
                           + lib.segment_reduce_error_string(rc).decode())
    segment_reduce.launches += 1
    return out


# Kernel launches since the caller last set this to 0.
segment_reduce.launches = 0
