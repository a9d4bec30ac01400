"""Wrapper of the Hopper fused-superstep kernel (``csrc/fused_superstep.cu``).

The kernel replaces ``repro/kernels/fused_superstep.py::
fused_superstep_blocks`` and the phase-2 merge of ``repro/kernels/ops.py::
fused_superstep_op``: it gathers each edge's source state, forms the edge
message of one of the device kinds below, and reduces the messages over the
extended destination ids into the accumulator ``[Q, Pl, seg]``.  It reduces
runs of equal ids within each destination-sorted edge block, so it has no
span bound.  It is bound by bytes on the card (see the note in the source).

This module builds nothing when imported.  The library is built at the
first launch (or by ``_build.build_all``), and only a CUDA tensor reaches
it: the CPU path is ``ref.fused_superstep_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import identity

SOURCE = "fused_superstep"


@dataclasses.dataclass(frozen=True)
class Kind:
    """One device message form: its code in the kernel, its combine, the
    number of gathered state arrays and of per-partition consts."""

    code: int
    combine: str
    num_gather: int
    num_consts: int = 0
    use_weight: bool = False


KINDS = {
    "bfs": Kind(0, "min", 1),                      # level==step ? level+1 : inf
    "sssp": Kind(1, "min", 2, use_weight=True),    # active>0 ? dist+w : inf
    "cc": Kind(2, "min", 2),                       # active>0 ? label : inf
    "pagerank": Kind(3, "sum", 2),                 # rank*inv_deg
    "bc_fwd": Kind(4, "sum", 2),                   # dist==step ? sigma : 0
    "bc_bwd": Kind(5, "sum", 3, num_consts=1),     # bc.py backward message
}

_P = ctypes.c_void_p
_I = ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.fused_superstep_launch
    fn.argtypes = [_I] + [_P] * 10 + [_I] * 9 + [_P]
    fn.restype = _I
    lib.fused_superstep_error_string.argtypes = [_I]
    lib.fused_superstep_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_superstep(kind: str, vstate: torch.Tensor, scal: torch.Tensor,
                    src: torch.Tensor, local: torch.Tensor,
                    mask: torch.Tensor, weight: Optional[torch.Tensor],
                    base: torch.Tensor, *, num_segments: int,
                    block_e: int) -> torch.Tensor:
    """Launch the kernel; returns the accumulator ``[Q, Pl, num_segments]``.

    ``vstate`` f32 ``[Q, Pl, K, V]``, ``scal`` f32 ``[Q, Pl, S]`` (step, then
    consts), ``src``/``local``/``mask`` int32 ``[Pl, e_pad]`` and ``weight``
    f32 ``[Pl, e_pad]`` (``sssp`` only), ``base`` int32 ``[Pl, nb]``, all on
    one CUDA device and contiguous; ``base + local`` must be non-decreasing
    along each row and below ``num_segments`` (``build_block_metadata``
    guarantees both).  Raises on anything the kernel does not take.
    """
    spec = KINDS.get(kind)
    if spec is None:
        raise ValueError(f"unknown message kind {kind!r}; the kernel has "
                         f"{sorted(KINDS)}")
    q, pl, k, v = vstate.shape
    e_pad = src.shape[1]
    if block_e <= 0 or block_e % 128 or e_pad % block_e:
        raise ValueError(f"block_e={block_e} must be a positive multiple of "
                         f"128 dividing e_pad={e_pad}")
    nb = e_pad // block_e
    if k != spec.num_gather or scal.shape[-1] != 1 + spec.num_consts:
        raise ValueError(f"kind {kind!r} takes {spec.num_gather} gathered "
                         f"arrays and {spec.num_consts} consts; got K={k}, "
                         f"S={scal.shape[-1]}")
    if q * pl > 65535:
        raise ValueError(f"Q*Pl={q * pl} exceeds the merge grid (65535)")
    _check("vstate", vstate, torch.float32, (q, pl, k, v))
    _check("scal", scal, torch.float32, (q, pl, 1 + spec.num_consts))
    for name, x in (("src", src), ("local", local), ("mask", mask)):
        _check(name, x, torch.int32, (pl, e_pad))
    _check("base", base, torch.int32, (pl, nb))
    if spec.use_weight:
        if weight is None:
            raise ValueError(f"kind {kind!r} needs edge weights")
        _check("weight", weight, torch.float32, (pl, e_pad))
    dev = vstate.device
    for name, x in (("scal", scal), ("src", src), ("local", local),
                    ("mask", mask), ("base", base), ("weight", weight)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, vstate on {dev}")

    acc = torch.full((q, pl, num_segments), identity(spec.combine),
                     dtype=torch.float32, device=dev)
    part_id = torch.empty((q, pl, nb, 2), dtype=torch.int32, device=dev)
    part_val = torch.empty((q, pl, nb, 2), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_superstep_launch(
            spec.code, vstate.data_ptr(), scal.data_ptr(), src.data_ptr(),
            local.data_ptr(), mask.data_ptr(),
            weight.data_ptr() if spec.use_weight else None,
            base.data_ptr(), acc.data_ptr(), part_id.data_ptr(),
            part_val.data_ptr(), q, pl, k, v, scal.shape[-1], e_pad, nb,
            block_e, num_segments, stream)
    if rc != 0:
        raise RuntimeError("fused_superstep launch failed: "
                           + lib.fused_superstep_error_string(rc).decode())
    fused_superstep.launches += 1
    return acc


# Kernel launches since the caller last set this to 0.
fused_superstep.launches = 0
