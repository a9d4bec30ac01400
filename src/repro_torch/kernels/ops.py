"""Public wrappers around the kernels: pick the kernel or its plain version
by where the tensors lie.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  There is no silent fallback on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.kernels.bottomup import bottomup_scan
from repro_torch.kernels.dense_spmv import dense_spmv, dense_spmv_minplus
from repro_torch.kernels.ell_spmv import (EllPlan, ell_spmv, query_minor,
                                          row_plan)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_superstep import (KINDS, fused_superstep,
                                                 query_minor_state)
from repro_torch.kernels.outbox_reduce import WEIGHT_OPS, outbox_reduce
from repro_torch.kernels.ref import (MIN, SEMIRINGS, SUM, bottomup_scan_ref,
                                     dense_spmv_minplus_ref, dense_spmv_ref,
                                     ell_spmv_ref, flash_attention_ref,
                                     fused_superstep_ref, identity,
                                     outbox_reduce_ref, segment_reduce_ref)
from repro_torch.kernels.segment_reduce import segment_reduce

_COMBINE_ALIAS = {"sum": "plus_times", "min": "min_plus"}


def fused_superstep_op(msg, vstate: torch.Tensor,
                       weight: Optional[torch.Tensor], scal: torch.Tensor,
                       src: torch.Tensor, local: torch.Tensor,
                       mask: torch.Tensor, base: torch.Tensor,
                       dst_ext: Optional[torch.Tensor], *,
                       num_segments: int, combine: str,
                       block_e: int) -> torch.Tensor:
    """Fused compute phase: per-query accumulator ``[Q, Pl, num_segments]``.

    Inputs follow ``partition.build_block_metadata``: ``vstate`` is the
    stacked ``[Q, Pl, K, v_max]`` gathered-state matrix, ``scal [Q, Pl, S]``
    carries (step, *per-query per-partition consts), ``src``/``local``/
    ``mask``/``weight`` are the ``[Pl, e_pad]`` block arrays shared across
    the query batch, ``base [Pl, nb]`` the per-block segment bases and
    ``dst_ext [Pl, e_max]`` the extended destinations, read by the plain
    version only (the kernel reads ``base + local``); None makes the plain
    version take ``base + local`` too, as a tiered window, which carries
    no ``dst_ext``, does.  ``msg`` is the
    program's ``EdgeMessage``: its ``fn`` is the plain form, its ``kind``
    names the kernel's device form.

    The JAX contract's ``span``, ``max_span``, ``gather_chunk``, ``v_pad``
    and ``interpret`` are TPU geometry (a VMEM one-hot bound and interpret
    mode).  The Hopper kernel reduces runs of equal ids and has no span
    bound, so none of them exists here and nothing falls back.  It reads
    the state query-minor, so the op moves ``vstate`` there (one copy); a
    ``vstate`` made by ``fused_superstep.stack_query_minor``, as the engine
    makes it, is a view of that layout already and is not copied again.
    """
    if vstate.device.type == "cpu":
        if dst_ext is None:
            # masked slots carry the identity to the id of their block
            dst_ext = base.repeat_interleave(block_e, dim=1) + local
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
    return fused_superstep(msg.kind, query_minor_state(vstate),
                           scal.contiguous(), src, local, mask,
                           weight if spec.use_weight else None, base,
                           num_segments=num_segments, block_e=block_e)


def bottomup_scan_op(row_ptr: torch.Tensor, col: torch.Tensor,
                     val: Optional[torch.Tensor], x: torch.Tensor, *,
                     semiring: str, early_exit: bool = False,
                     skip: Optional[torch.Tensor] = None,
                     plan: Optional[EllPlan] = None
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
    kernel then stops each row once every query has a live slot among those
    read, whose value is the minimum.  It needs the ``min`` semiring.

    ``skip [Q, V]`` bool (with ``early_exit``) marks rows whose value is
    already final: a sequential bottom-up pass visits only unvisited rows,
    so they charge zero scanned slots.  ``y`` still covers them.

    ``plan`` is the kernel's row plan of ``row_ptr`` (``ell_spmv.row_plan``
    as tensors on ``x``'s device; a plan of other rows raises); the engines
    keep one, and a direct call without it has it built here.  The kernel
    reads ``x`` query-minor: the op copies it there, or passes the buffer
    on when ``x`` is an ``ell_spmv.query_minor_view``.

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
    if plan is not None:
        plan.check(row_ptr, col)
    if x.device.type == "cpu":
        y, scanned = bottomup_scan_ref(row_ptr, col, val, x,
                                       semiring=semiring,
                                       early_exit=early_exit)
    else:
        if plan is None:
            plan = row_plan(row_ptr).to(x.device)
        y, scanned = bottomup_scan(row_ptr, col, val,
                                   query_minor(x, math.inf), plan,
                                   semiring=semiring, num_queries=x.shape[0],
                                   early_exit=early_exit)
    if skip is not None and early_exit:
        scanned = torch.where(skip, torch.zeros_like(scanned), scanned)
    return y, scanned


def ell_spmv_op(row_ptr: torch.Tensor, col: torch.Tensor,
                val: Optional[torch.Tensor], x: torch.Tensor, *,
                semiring: str, plan: Optional[EllPlan] = None
                ) -> torch.Tensor:
    """Semiring SpMV over CSR rows: ``y [Q, V]`` with
    ``y[q, v] = ⊕_{slots s of row v} x[q, col[s]] ⊗ val[s]``.

    ``row_ptr [V + 1]``/``col [nnz]`` int32 (``csr_to_ell_rows``), ``val``
    f32 ``[nnz]`` (``min`` ignores it), ``x [Q, x_len]`` f32.  An empty row
    gives the ⊕-identity.  ``plan`` is the kernel's row plan of
    ``row_ptr`` (``ell_spmv.row_plan``, as tensors on ``x``'s device; a
    plan of other rows raises); the hybrid split keeps one, and a direct
    call without it has it built here (one read of ``row_ptr`` to the
    host).  The kernel reads ``x`` query-minor, so the op moves it there
    (a copy), or passes the buffer on when ``x`` is an
    ``ell_spmv.query_minor_view``.  The JAX contract's ELL block, its sink
    column in ``x``,
    ``block_v`` and ``interpret`` are TPU layout; CSR rows need none of
    them.
    """
    if semiring not in SEMIRINGS:
        raise ValueError(f"unknown semiring {semiring!r}")
    if plan is not None:
        plan.check(row_ptr, col)
    if x.device.type == "cpu":
        return ell_spmv_ref(row_ptr, col, val, x, semiring)
    if plan is None:
        plan = row_plan(row_ptr).to(x.device)
    xt = query_minor(x, SEMIRINGS[semiring][1])
    return ell_spmv(row_ptr, col, val, xt, plan, semiring=semiring,
                    num_queries=x.shape[0])


def dense_spmv_op(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``y = x @ a`` for ``x [M, K]``, ``a [K, N]`` in f32.  The JAX
    wrapper's tile padding and ``interpret`` have no counterpart."""
    if x.device.type == "cpu":
        return dense_spmv_ref(x, a)
    return dense_spmv(x.contiguous(), a.contiguous())


def dense_spmv_minplus_op(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``y[m, n] = min_k x[m, k] + a[k, n]``; non-edges of ``a`` hold
    +inf."""
    if x.device.type == "cpu":
        return dense_spmv_minplus_ref(x, a)
    return dense_spmv_minplus(x.contiguous(), a.contiguous())


def outbox_reduce_op(x: torch.Tensor, src: torch.Tensor, flat: torch.Tensor,
                     weight: Optional[torch.Tensor], *, num_slots: int,
                     combine: str = SUM,
                     weight_op: Optional[str] = None) -> torch.Tensor:
    """Reduce boundary messages into the flat outbox-slot space (the
    sharded hybrid's boundary leg, §3.4).

    ``x`` is one shard's per-query per-vertex message matrix ``[Q, x_len]``;
    ``src``/``flat``/``weight`` are its real
    boundary edges (``hybrid.ShardHybridData.boundary``): hybrid source
    ids, flat slot ids in non-decreasing order, and the edge weights,
    shared across the batch.  ``weight_op`` is the EdgeMessage's ⊗
    (``"add"``/``"mul"``/None; ``weight`` is not read without one).
    Returns the ``[Q, num_slots]`` outboxes, the ⊕-identity in unused
    slots.

    The kernel reads ``x`` query-minor: the op copies it there, or passes
    the buffer on when ``x`` is an ``ell_spmv.query_minor_view``.  The JAX
    contract's ``local``/``mask``/``base`` block arrays, ``span``,
    ``max_span``, ``block_e``, ``gather_chunk`` and ``interpret`` are TPU
    geometry: the Hopper kernel reads the flat ids and has no span bound,
    so none of them exists here and nothing falls back.
    """
    if combine not in (SUM, MIN):
        raise ValueError(f"combine must be {SUM!r} or {MIN!r}, got "
                         f"{combine!r}")
    if weight_op not in WEIGHT_OPS:
        raise ValueError(f"weight_op must be None, 'add' or 'mul', got "
                         f"{weight_op!r}")
    if weight_op is not None and weight is None:
        raise ValueError(f"weight_op {weight_op!r} needs weight")
    if x.device.type == "cpu":
        return outbox_reduce_ref(x, src, flat, weight, num_slots=num_slots,
                                 combine=combine, weight_op=weight_op)
    return outbox_reduce(query_minor(x, identity(combine)), src, flat,
                         weight if weight_op is not None else None,
                         num_slots=num_slots, combine=combine,
                         num_queries=x.shape[0], weight_op=weight_op)


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, window: int = 0) -> torch.Tensor:
    """``[B, H, S, D]`` attention with GQA (``k, v [B, KV, S, D]``, query
    head ``h`` reading KV head ``h // (H // KV)``); returns ``[B, H, S, D]``
    in ``q``'s dtype.  Keys ``k <= q`` are live when ``causal``, and
    ``q - k < window`` when ``window > 0``.

    The kernel takes the model's ``[B, S, G, R, D]`` layout, so the heads
    are moved there (a copy) and back; no KV head is repeated.  The JAX
    contract's ``block_q``, ``block_k`` and ``interpret`` are TPU tiling
    (its kernel needs S to be a multiple of the block): the Hopper kernel
    masks a ragged last tile, so none of them exists here.
    """
    b, h, s, d = q.shape
    kv = k.shape[1]
    if h % kv:
        raise ValueError(f"{h} query heads do not group over {kv} KV heads")
    qm = q.transpose(1, 2).reshape(b, s, kv, h // kv, d)
    km, vm = k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        out = flash_attention_ref(qm, km, vm, causal=causal, window=window)
    else:
        out = flash_attention(qm.contiguous(), km.contiguous(),
                              vm.contiguous(), causal=causal, window=window)
    return out.reshape(b, s, h, d).transpose(1, 2)


def segment_reduce_op(msgs: torch.Tensor, seg_ids, num_segments: int, *,
                      combine: str = SUM) -> torch.Tensor:
    """Sorted segment reduce: ``msgs [..., E]`` → ``[..., num_segments]``,
    the sum or minimum of the messages with each id, the identity (0 or
    +inf) where no id is the segment.

    ``seg_ids [E]`` (a tensor or a numpy array) is shared by every leading
    row; it must be non-decreasing and in ``[0, num_segments)``, which is
    checked here (on the host for numpy ids, with one device read for a
    CUDA tensor).  The JAX contract's ``block_e``, ``max_span`` and
    ``interpret``, and its fallback when a block's id span exceeds
    ``max_span``, are TPU geometry: the Hopper kernel reduces runs of equal
    ids and has no span bound, so none of them exists here and nothing
    falls back.
    """
    if combine not in (SUM, MIN):
        raise ValueError(f"combine must be {SUM!r} or {MIN!r}, got "
                         f"{combine!r}")
    ids = torch.as_tensor(seg_ids)
    e = msgs.shape[-1]
    if ids.shape != (e,):
        raise ValueError(f"seg_ids {tuple(ids.shape)} must be [E] with "
                         f"E={e}")
    if e:
        bad = torch.stack([(ids[1:] < ids[:-1]).any(), ids[0] < 0,
                           ids[-1] >= num_segments]).cpu()
        if bool(bad[0]):
            raise ValueError("seg_ids must be sorted ascending")
        if bool(bad[1] | bad[2]):
            raise ValueError(f"seg_ids must lie in [0, {num_segments})")
    if msgs.device.type == "cpu":
        return segment_reduce_ref(msgs, ids.long(), num_segments, combine)
    lead = msgs.shape[:-1]
    out = segment_reduce(msgs.reshape(math.prod(lead), e).contiguous(),
                         ids.to(msgs.device, torch.int32).contiguous(),
                         num_segments=num_segments, combine=combine)
    return out.reshape(lead + (num_segments,))


def csr_to_ell_rows(g: CSRGraph, combine: Optional[str] = None,
                    semiring: Optional[str] = None, transpose: bool = True
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """The rows and edge values of ``repro/kernels/ops.py::csr_to_ell``
    as CSR: ``(row_ptr [V + 1] int32, col [E] int32, val [E] f32, kmax)``.

    ``transpose=True`` packs in-edges per vertex (pull form).  Padding row
    ``v`` to ``kmax`` slots with the sentinel ``V`` and the semiring's
    ⊗-identity gives the JAX ELL block back.  Value policies:

    - legacy ``combine=``: ``"sum"`` -> 1.0 per edge (multiplicity counts,
      weights ignored), ``"min"`` -> weights (1.0 unweighted);
    - ``semiring=``: ``plus_times`` -> weight (1 unweighted), ``min_plus``
      -> weight (0 unweighted), ``min`` -> 0.
    """
    if semiring is not None:
        if semiring not in SEMIRINGS:
            raise ValueError(f"unknown semiring {semiring!r}")
        sr, legacy = semiring, False
    else:
        sr, legacy = _COMBINE_ALIAS[combine or "sum"], True
    gg = g.reverse() if transpose else g
    deg = gg.out_degrees()
    kmax = max(int(deg.max()) if len(deg) else 1, 1)
    if gg.num_edges >= 2 ** 31:
        raise ValueError(f"{gg.num_edges} edges overflow int32 rows")
    if sr == "plus_times" and legacy:
        val = np.ones(gg.num_edges, dtype=np.float32)
    elif sr == "min" and not legacy:
        val = np.zeros(gg.num_edges, dtype=np.float32)
    elif gg.weights is not None:
        val = np.asarray(gg.weights, dtype=np.float32)
    else:
        unweighted = 1.0 if sr == "plus_times" or legacy else 0.0
        val = np.full(gg.num_edges, unweighted, dtype=np.float32)
    return (gg.row_ptr.astype(np.int32), gg.col.astype(np.int32), val, kmax)
