"""Public wrappers around the kernels: pick the kernel or its plain version
by where the tensors lie.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  There is no silent fallback on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.bottomup import bottomup_scan
from repro_torch.kernels.fused_superstep import KINDS, fused_superstep
from repro_torch.kernels.ref import bottomup_scan_ref, fused_superstep_ref


def fused_superstep_op(msg, vstate: torch.Tensor,
                       weight: Optional[torch.Tensor], scal: torch.Tensor,
                       src: torch.Tensor, local: torch.Tensor,
                       mask: torch.Tensor, base: torch.Tensor,
                       dst_ext: torch.Tensor, *, num_segments: int,
                       combine: str, block_e: int) -> torch.Tensor:
    """Fused compute phase: per-query accumulator ``[Q, Pl, num_segments]``.

    Inputs follow ``partition.build_block_metadata``: ``vstate`` is the
    stacked ``[Q, Pl, K, v_max]`` gathered-state matrix, ``scal [Q, Pl, S]``
    carries (step, *per-query per-partition consts), ``src``/``local``/
    ``mask``/``weight`` are the ``[Pl, e_pad]`` block arrays shared across
    the query batch, ``base [Pl, nb]`` the per-block segment bases and
    ``dst_ext [Pl, e_max]`` the extended destinations.  ``msg`` is the
    program's ``EdgeMessage``: its ``fn`` is the plain form, its ``kind``
    names the kernel's device form.

    The JAX contract's ``span``, ``max_span``, ``gather_chunk``, ``v_pad``
    and ``interpret`` are TPU geometry (a VMEM one-hot bound and interpret
    mode).  The Hopper kernel reduces runs of equal ids and has no span
    bound, so none of them exists here and nothing falls back.
    """
    if vstate.device.type == "cpu":
        return fused_superstep_ref(msg, vstate, weight, scal, src, mask,
                                   dst_ext, num_segments=num_segments,
                                   combine=combine)
    spec = KINDS.get(msg.kind)
    if spec is None:
        raise ValueError(
            f"EdgeMessage kind {msg.kind!r} has no device form; the fused "
            f"kernel knows {sorted(KINDS)} (use backend='reference' for "
            f"other programs)")
    if spec.combine != combine:
        raise ValueError(f"kind {msg.kind!r} combines by {spec.combine}, "
                         f"the program by {combine}")
    return fused_superstep(msg.kind, vstate.contiguous(), scal.contiguous(),
                           src, local, mask,
                           weight if spec.use_weight else None, base,
                           num_segments=num_segments, block_e=block_e)


def bottomup_scan_op(row_ptr: torch.Tensor, col: torch.Tensor,
                     val: Optional[torch.Tensor], x: torch.Tensor, *,
                     semiring: str, early_exit: bool = False,
                     skip: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bottom-up pull scan: ``(y [Q, V], scanned [Q, V] int32)``.

    ``row_ptr [V + 1]``/``col [nnz]`` (int32) are CSR in-edge rows
    (``partition.build_transposed_csc``) whose ids index the last axis of
    ``x [Q, x_len]``; ``val [nnz]`` is the ``min_plus`` edge value, else
    None.  ``y`` is each row's minimum over its slots, ``scanned`` the
    early-exit work model of ``repro/kernels/ops.py::bottomup_scan_op``:
    slots up to the first live parent with ``early_exit``, else the row
    length.  ``early_exit`` is the caller's licence that every live message
    of a query holds one value (``EdgeMessage.frontier_uniform``): the
    kernel then stops each row at its first live slot, whose value is the
    minimum.  It needs the ``min`` semiring.

    ``skip [Q, V]`` bool (with ``early_exit``) marks rows whose value is
    already final: a sequential bottom-up pass visits only unvisited rows,
    so they charge zero scanned slots.  ``y`` still covers them.

    The JAX contract's ELL ``col [V, kmax]``/``kreal``, its sink column in
    ``x`` and ``block_v``/``interpret`` are TPU layout; CSR rows need none
    of them.
    """
    if semiring not in ("min", "min_plus"):
        raise ValueError(f"bottom-up scan needs a min combine, got "
                         f"{semiring!r}")
    if early_exit and semiring != "min":
        raise ValueError("early exit is exact only under the min semiring "
                         "with frontier-uniform messages")
    if (val is not None) != (semiring == "min_plus"):
        raise ValueError("val is needed for min_plus and only there")
    if x.device.type == "cpu":
        y, scanned = bottomup_scan_ref(row_ptr, col, val, x,
                                       semiring=semiring,
                                       early_exit=early_exit)
    else:
        y, scanned = bottomup_scan(row_ptr, col, val, x.contiguous(),
                                   semiring=semiring, early_exit=early_exit)
    if skip is not None and early_exit:
        scanned = torch.where(skip, torch.zeros_like(scanned), scanned)
    return y, scanned
