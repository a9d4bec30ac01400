"""Plain PyTorch versions of the kernels (the CPU path and the card-side
yardstick of correctness).

``segment_reduce_ref`` is ``jax.ops.segment_sum``/``segment_min`` in
PyTorch: the output starts at the combine identity and ``scatter_reduce``
runs with ``include_self=True``, so an empty segment (the sink at ``v_max``,
an unused outbox slot) holds 0 or +inf exactly as in JAX.  On a CUDA tensor
the sum goes through atomics, so its order (and last bit) may vary from run
to run; the engine keeps the sums whose order matters off that path.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

SUM = "sum"
MIN = "min"
_REDUCE = {SUM: "sum", MIN: "amin"}


def identity(combine: str) -> float:
    return 0.0 if combine == SUM else math.inf


def segment_reduce_ref(msgs: torch.Tensor, ids: torch.Tensor,
                       num_segments: int, combine: str) -> torch.Tensor:
    """Reduce ``msgs [..., E]`` into ``[..., num_segments]`` by ``ids``.

    ``ids`` (int64) is broadcast against ``msgs``' leading axes: the
    engine's ``[Pl, E]`` topology serves every query of a ``[Q, Pl, E]``
    message batch.
    """
    out = torch.full(msgs.shape[:-1] + (num_segments,), identity(combine),
                     dtype=msgs.dtype, device=msgs.device)
    return out.scatter_reduce_(-1, ids.expand(msgs.shape), msgs,
                               _REDUCE[combine], include_self=True)


def fused_superstep_ref(msg, vstate: torch.Tensor,
                        weight: Optional[torch.Tensor], scal: torch.Tensor,
                        src: torch.Tensor, mask: torch.Tensor,
                        dst_ext: torch.Tensor, *, num_segments: int,
                        combine: str) -> torch.Tensor:
    """The fused compute phase as three plain passes: gather the source
    state of each edge, form ``msg.fn``'s messages (padding masked to the
    identity), scatter-reduce them over ``dst_ext``.

    ``vstate [Q, Pl, K, V]`` stacks the state named by ``msg.gather``;
    ``scal [Q, Pl, S]`` holds the superstep then ``msg.consts``;
    ``src``/``mask``/``weight`` are the ``[Pl, e_pad]`` block arrays and
    ``dst_ext [Pl, e_max]`` the extended destinations (``e_max <= e_pad``).
    Returns the accumulator ``[Q, Pl, num_segments]``.
    """
    q, pl = vstate.shape[:2]
    e_max = dst_ext.shape[1]
    idx = src[:, :e_max].long().expand(q, pl, e_max)
    vals = {k: torch.gather(vstate[:, :, i], 2, idx)
            for i, k in enumerate(msg.gather)}
    consts = {c: scal[:, :, 1 + j:2 + j] for j, c in enumerate(msg.consts)}
    w = weight[:, :e_max] if weight is not None else None
    msgs = msg.fn(vals, w, scal[:, :, 0:1], consts).to(vstate.dtype)
    msgs = torch.where(mask[:, :e_max] > 0, msgs,
                       torch.tensor(identity(combine), device=msgs.device))
    return segment_reduce_ref(msgs, dst_ext.long(), num_segments, combine)


def bottomup_scan_ref(row_ptr: torch.Tensor, col: torch.Tensor,
                      val: Optional[torch.Tensor], x: torch.Tensor, *,
                      semiring: str, early_exit: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bottom-up scan as plain passes over CSR rows: gather
    ``x[:, col]`` (plus ``val`` for ``min_plus``), segment-min it by row,
    and count per row the slots up to the first finite gathered value
    (``early_exit``) or all of them.  Every slot enters the minimum.
    Returns ``(y [Q, V] f32, scanned [Q, V] int32)``.
    """
    q = x.shape[0]
    v = row_ptr.shape[0] - 1
    starts = row_ptr[:-1].long()
    kreal = row_ptr[1:].long() - starts
    rows = torch.repeat_interleave(torch.arange(v, device=x.device), kreal)
    g = x[:, col.long()]                                  # [Q, nnz]
    msgs = g + val if semiring == "min_plus" else g
    y = segment_reduce_ref(msgs, rows, v, MIN)
    if not early_exit:
        return y, kreal.to(torch.int32).expand(q, v).contiguous()
    slot = torch.arange(rows.shape[0], device=x.device) - starts[rows]
    first = torch.where(g < math.inf, slot, kreal[rows])
    first = kreal.expand(q, v).clone().scatter_reduce_(
        1, rows.expand(q, -1), first, "amin", include_self=True)
    return y, torch.minimum(first + 1, kreal).to(torch.int32)


# The hybrid backend's semirings, one per TOTEM reduction class (paper
# §3.4): name -> (⊕ combine, ⊕-identity, ⊗-identity).
SEMIRINGS = {"plus_times": (SUM, 0.0, 1.0), "min_plus": (MIN, math.inf, 0.0),
             "min": (MIN, math.inf, 0.0)}


def ell_spmv_ref(row_ptr: torch.Tensor, col: torch.Tensor,
                 val: Optional[torch.Tensor], x: torch.Tensor,
                 semiring: str) -> torch.Tensor:
    """``y[q, v] = ⊕_{slots s of row v} x[q, col[s]] ⊗ val[s]`` over CSR
    rows, as gather, ⊗, and a scatter-reduce into a tensor that starts at
    the ⊕-identity (``include_self=True``): an empty row gives 0 or +inf,
    as the JAX kernel's sink slot does.  ``min`` ignores ``val``.
    Returns ``[Q, V]`` in ``x``'s dtype."""
    combine, ident, _ = SEMIRINGS[semiring]
    q = x.shape[0]
    v = row_ptr.shape[0] - 1
    kreal = row_ptr[1:].long() - row_ptr[:-1].long()
    rows = torch.repeat_interleave(torch.arange(v, device=x.device), kreal)
    g = x[:, col.long()]                                  # [Q, nnz]
    if semiring == "plus_times":
        g = g * val
    elif semiring == "min_plus":
        g = g + val
    out = torch.full((q, v), ident, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(1, rows.expand(q, -1), g, _REDUCE[combine],
                               include_self=True)


def dense_spmv_ref(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``y = x @ a`` as a broadcast multiply and a sum over K: ``x [M, K]``,
    ``a [K, N]`` -> ``[M, N]``."""
    return (x[:, :, None] * a[None]).sum(1)


def dense_spmv_minplus_ref(x: torch.Tensor, a: torch.Tensor, *,
                           chunk: int = 256) -> torch.Tensor:
    """``y[m, n] = min_k x[m, k] + a[k, n]``: broadcast add and ``amin``
    over K in chunks, so the ``[M, K, N]`` candidates are never whole.
    An empty K gives +inf."""
    m, k = x.shape
    y = torch.full((m, a.shape[1]), math.inf, dtype=x.dtype, device=x.device)
    for k0 in range(0, k, chunk):
        cand = x[:, k0:k0 + chunk, None] + a[None, k0:k0 + chunk]
        y = torch.minimum(y, cand.amin(1))
    return y


def outbox_reduce_ref(x: torch.Tensor, src: torch.Tensor, flat: torch.Tensor,
                      weight: Optional[torch.Tensor], *, num_slots: int,
                      combine: str, weight_op: Optional[str] = None
                      ) -> torch.Tensor:
    """The sharded hybrid's boundary leg as plain passes: gather
    ``x[:, src]``, apply the weight (``add``/``mul``/none), and
    scatter-reduce into ``[Q, num_slots]`` outbox slots by ``flat``, from
    the combine identity (an unused slot keeps it)."""
    msgs = x[:, src.long()]
    if weight_op == "add":
        msgs = msgs + weight
    elif weight_op == "mul":
        msgs = msgs * weight
    return segment_reduce_ref(msgs, flat.long(), num_slots, combine)
