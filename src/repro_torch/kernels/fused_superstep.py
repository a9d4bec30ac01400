"""Wrapper of the Hopper fused-superstep kernel (``csrc/fused_superstep.cu``).

The kernel replaces ``repro/kernels/fused_superstep.py::
fused_superstep_blocks`` and the phase-2 merge of ``repro/kernels/ops.py::
fused_superstep_op``: it gathers each edge's source state, forms the edge
message of one of the device kinds below, and reduces the messages over the
extended destination ids into the accumulator ``[Q, Pl, seg]``.  It reduces
runs of equal ids within each destination-sorted edge block, so it has no
span bound.  It reads the state query-minor (``[Pl, K, V, Qp]``, made by
:func:`query_minor_state` or :func:`stack_query_minor`), so one edge's
queries arrive in one or two 16-byte loads, and it carries groups of 8
queries through one pass over the edges.  It is bound by bytes on the card
(see the note in the source).

This module builds nothing when imported.  The library is built at the
first launch (or by ``_build.build_all``), and only a CUDA tensor reaches
it: the CPU path is ``ref.fused_superstep_ref``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import identity

SOURCE = "fused_superstep"

QUERY_ALIGN = 4     # the state's query axis is padded to a multiple of this
PAD = 0.0           # state of the padded query lanes: read, never written out


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
    "bfs_relax": Kind(6, "min", 2),                # active>0 ? level+1 : inf
}

_P = ctypes.c_void_p
_I = ctypes.c_int


def padded_queries(q: int) -> int:
    """Qp: ``q`` rounded up to a multiple of ``QUERY_ALIGN``."""
    return -(-q // QUERY_ALIGN) * QUERY_ALIGN


def _query_minor_base(vstate: torch.Tensor) -> Optional[torch.Tensor]:
    """The ``[Pl, K, V, Qp]`` buffer behind ``vstate`` when ``vstate`` is
    the ``[Q, Pl, K, V]`` view :func:`stack_query_minor` returns, else
    None."""
    q, pl, k, v = vstate.shape
    qp = padded_queries(q)
    if vstate.dtype != torch.float32 or vstate.stride() != (
            1, k * v * qp, v * qp, qp):
        return None
    need = (vstate.storage_offset() + pl * k * v * qp) * 4
    if vstate.untyped_storage().nbytes() < need:
        return None
    return vstate.as_strided((pl, k, v, qp), (k * v * qp, v * qp, qp, 1))


def query_minor_state(vstate: torch.Tensor) -> torch.Tensor:
    """``vstate [Q, Pl, K, V]`` as the kernel's f32 ``[Pl, K, V, Qp]``,
    the padded lanes ``PAD``: one copy, or none when ``vstate`` is already
    a view of such a buffer (:func:`stack_query_minor`)."""
    base = _query_minor_base(vstate)
    if base is not None:
        return base
    q, pl, k, v = vstate.shape
    qp = padded_queries(q)
    vt = torch.empty((pl, k, v, qp), dtype=torch.float32,
                     device=vstate.device)
    vt[..., :q] = vstate.permute(1, 2, 3, 0)
    vt[..., q:] = PAD
    return vt


def stack_query_minor(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack the K gathered state arrays ``[Q, Pl, V]`` (any float dtype)
    straight into a query-minor f32 buffer ``[Pl, K, V, Qp]`` (one copy
    each) and return it as the ``[Q, Pl, K, V]`` view the op takes; the op
    hands the buffer to the kernel without another copy."""
    q, pl, v = cols[0].shape
    qp = padded_queries(q)
    vt = torch.empty((pl, len(cols), v, qp), dtype=torch.float32,
                     device=cols[0].device)
    for i, col in enumerate(cols):
        vt[:, i, :, :q] = col.permute(1, 2, 0)
    vt[..., q:] = PAD
    return vt[..., :q].permute(3, 0, 1, 2)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.fused_superstep_launch
    fn.argtypes = [_I] + [_P] * 10 + [_I] * 10 + [_P]
    fn.restype = _I
    lib.fused_superstep_error_string.argtypes = [_I]
    lib.fused_superstep_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_superstep(kind: str, vt: torch.Tensor, scal: torch.Tensor,
                    src: torch.Tensor, local: torch.Tensor,
                    mask: torch.Tensor, weight: Optional[torch.Tensor],
                    base: torch.Tensor, *, num_segments: int,
                    block_e: int) -> torch.Tensor:
    """Launch the kernel; returns the accumulator ``[Q, Pl, num_segments]``.

    ``vt`` f32 ``[Pl, K, V, Qp]`` is the state query-minor
    (:func:`query_minor_state`; Qp a multiple of ``QUERY_ALIGN``, at least
    Q, 16-byte aligned), ``scal`` f32 ``[Q, Pl, S]`` (step, then consts;
    its first axis sets Q), ``src``/``local``/``mask`` int32 ``[Pl, e_pad]``
    and ``weight`` f32 ``[Pl, e_pad]`` (``sssp`` only), ``base`` int32
    ``[Pl, nb]``, all on one CUDA device and contiguous; ``base + local``
    must be non-decreasing along each row and below ``num_segments``
    (``build_block_metadata`` guarantees both).  Raises on anything the
    kernel does not take, before it launches.
    """
    spec = KINDS.get(kind)
    if spec is None:
        raise ValueError(f"unknown message kind {kind!r}; the kernel has "
                         f"{sorted(KINDS)}")
    if vt.dim() != 4 or scal.dim() != 3 or src.dim() != 2:
        raise ValueError(f"vt [Pl, K, V, Qp], scal [Q, Pl, S] and src "
                         f"[Pl, e_pad] expected, got {tuple(vt.shape)}, "
                         f"{tuple(scal.shape)} and {tuple(src.shape)}")
    pl, k, v, qp = vt.shape
    q = scal.shape[0]
    e_pad = src.shape[1]
    if block_e <= 0 or block_e % 128 or e_pad % block_e:
        raise ValueError(f"block_e={block_e} must be a positive multiple of "
                         f"128 dividing e_pad={e_pad}")
    nb = e_pad // block_e
    if k != spec.num_gather or scal.shape[-1] != 1 + spec.num_consts:
        raise ValueError(f"kind {kind!r} takes {spec.num_gather} gathered "
                         f"arrays and {spec.num_consts} consts; got K={k}, "
                         f"S={scal.shape[-1]}")
    if q < 1 or qp < q or qp % QUERY_ALIGN:
        raise ValueError(f"vt's query axis Qp={qp} must be a multiple of "
                         f"{QUERY_ALIGN} holding the Q={q} queries of scal")
    if q * pl > 65535:
        raise ValueError(f"Q*Pl={q * pl} exceeds the merge grid (65535)")
    _check("scal", scal, torch.float32, (q, pl, 1 + spec.num_consts))
    for name, x in (("src", src), ("local", local), ("mask", mask)):
        _check(name, x, torch.int32, (pl, e_pad))
    _check("base", base, torch.int32, (pl, nb))
    if spec.use_weight:
        if weight is None:
            raise ValueError(f"kind {kind!r} needs edge weights")
        _check("weight", weight, torch.float32, (pl, e_pad))
    _check("vt", vt, torch.float32, (pl, k, v, qp))
    dev = vt.device
    if dev.type != "cuda":
        raise ValueError(f"vt must be a CUDA tensor, got {dev}")
    if vt.data_ptr() % 16:
        raise ValueError("vt must be 16-byte aligned (the kernel loads "
                         "float4)")
    for name, x in (("scal", scal), ("src", src), ("local", local),
                    ("mask", mask), ("base", base), ("weight", weight)):
        if x is None:
            continue
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, vt on {dev}")

    acc = torch.full((q, pl, num_segments), identity(spec.combine),
                     dtype=torch.float32, device=dev)
    part_id = torch.empty((pl, nb, 2), dtype=torch.int32, device=dev)
    part_val = torch.empty((q, pl, nb, 2), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_superstep_launch(
            spec.code, vt.data_ptr(), scal.data_ptr(), src.data_ptr(),
            local.data_ptr(), mask.data_ptr(),
            weight.data_ptr() if spec.use_weight else None,
            base.data_ptr(), acc.data_ptr(), part_id.data_ptr(),
            part_val.data_ptr(), q, qp, pl, k, v, scal.shape[-1], e_pad, nb,
            block_e, num_segments, stream)
    if rc != 0:
        raise RuntimeError("fused_superstep launch failed: "
                           + lib.fused_superstep_error_string(rc).decode())
    fused_superstep.launches += 1
    fused_superstep.kind_launches[kind] = (
        fused_superstep.kind_launches.get(kind, 0) + 1)
    return acc


# Kernel launches since the caller last set this to 0, and by kind since
# the caller last cleared the dict.
fused_superstep.launches = 0
fused_superstep.kind_launches = {}
