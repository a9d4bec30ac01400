"""The models' DTensor helpers: what a layer does with its activations
and weights under a mesh, where DTensor has no strategy of its own.

Each takes plain tensors through unchanged (one card: the same
operations, nothing added), and DTensors as ``launch/sharding.py``'s
``activation_rules`` lay them out.  Most are places where the port
replicates what JAX's compiler shards (each listed in ``ROADMAP.md``
Queue 3): a layer gathers what it needs on each rank and rebuilds a
DTensor from the local results.  This module imports torch alone; what
resolves the logical names and the specs is ``launch/sharding.py``, which
builds on it.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


class GradLayout(torch.autograd.Function):
    """The identity, whose gradient is redistributed to ``want``."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def batch_local(x: torch.Tensor, keep: Sequence[int] = (0,)):
    """``x``'s local tensor after gathering every dim but those in
    ``keep`` (the batch dims: each rank keeps its own rows), and the
    placements to rebuild a result sharded like those rows.  For a plain
    tensor: ``(x, None)``.  The local tensor's gradient is taken as laid
    out like it: the rank's own rows, whole over the other axes (whose
    ranks all compute the same)."""
    if not isinstance(x, DTensor):
        return x, None
    want = tuple(p if isinstance(p, Shard) and p.dim in keep
                 else Replicate() for p in x.placements)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    return x.to_local(), want


def shard_count(like_placements, mesh) -> int:
    """Ranks among which ``like_placements`` (from ``batch_local``) split
    the rows: the product of the mesh dims that shard (1 for None)."""
    if like_placements is None:
        return 1
    return math.prod(mesh.size(i) for i, p in enumerate(like_placements)
                     if isinstance(p, Shard))


def local_as(x: torch.Tensor, like_placements) -> torch.Tensor:
    """``x`` redistributed to ``like_placements`` (from ``batch_local``:
    the same rows as the rank's tokens), as its local tensor; ``x`` for
    None."""
    if like_placements is None or not isinstance(x, DTensor):
        return x
    if tuple(x.placements) != tuple(like_placements):
        x = x.redistribute(x.device_mesh, like_placements)
    return x.to_local()


def rebuild(local: torch.Tensor, like_placements, mesh) -> torch.Tensor:
    """A DTensor of per-rank ``local`` tensors laid out as ``batch_local``
    gave them (a plain tensor when ``like_placements`` is None)."""
    if like_placements is None:
        return local
    return DTensor.from_local(local, mesh, like_placements, run_check=False)


def replicated_local(x: torch.Tensor, grad_like=None) -> torch.Tensor:
    """``x`` gathered whole on every rank, as its local tensor.  Its
    gradient is taken as partial over the mesh dims where ``grad_like``
    (the placements of the data it meets) shards, replicated elsewhere."""
    if not isinstance(x, DTensor):
        return x
    n = x.device_mesh.ndim
    full = x.redistribute(x.device_mesh, (Replicate(),) * n)
    grad = tuple(Partial() if grad_like is not None
                 and isinstance(grad_like[i], Shard) else Replicate()
                 for i in range(n))
    return full.to_local(grad_placements=grad)


def partial_sum(local: torch.Tensor, like_placements, mesh) -> torch.Tensor:
    """The sum over ranks of per-rank ``local`` partial sums (each data
    shard's), replicated: a plain tensor when ``like_placements`` is
    None."""
    if like_placements is None:
        return local
    pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
               for p in like_placements)
    return DTensor.from_local(local, mesh, pl, run_check=False).redistribute(
        mesh, (Replicate(),) * len(pl))


def cache_tensor(shape: Sequence[int], dtype: torch.dtype, device,
                 fill: float = 0.0) -> torch.Tensor:
    """A cache leaf filled with ``fill``: a plain tensor on ``device``, or
    under ``activation_rules`` a DTensor laid out by ``cache_specs``
    (each rank allocating only its shard)."""
    from repro_torch.launch import sharding as shd   # on use: no cycle
    mesh = shd.active_mesh()
    if mesh is None:
        return torch.full(tuple(shape), fill, dtype=dtype, device=device)
    from torch.distributed.tensor import full
    spec = shd.cache_specs(torch.Size(shape), mesh)
    return full(tuple(shape), fill, dtype=dtype, device_mesh=mesh,
                placements=shd.placements(spec, mesh))


def _register_pointwise(op, n_tensors: int, ndim_of=0) -> None:
    """A DTensor rule for an elementwise op whose first ``n_tensors``
    arguments share one shape: all replicated, or all sharded alike on any
    one dim."""
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(op)
    def _rule(*args, **kwargs):
        rep = Replicate()
        ndim = len(args[ndim_of].shape)
        extra = [None] * (len(args) - n_tensors)
        out = [([rep], [rep] * n_tensors + extra)]
        for d in range(ndim):
            out.append(([Shard(d)], [Shard(d)] * n_tensors + extra))
        return out


_registered = False


def register_strategies() -> None:
    """DTensor rules for the elementwise backward ops the models reach
    without a strategy (once per process; ``activation_rules`` calls it
    before a run on a mesh)."""
    global _registered
    if not _registered:
        _register_pointwise(torch.ops.aten.log_sigmoid_backward.default, 3)
        _registered = True


def split_rows(x: torch.Tensor, n: int):
    """``x`` cut into ``n`` microbatches along its first dim.  A plain
    tensor: contiguous blocks of rows (JAX's reshape).  A DTensor whose
    rows are sharded: each rank cuts its own rows, so every microbatch
    stays sharded like ``x``; when a rank's rows do not divide, the
    leading data axes (pod first) are gathered until they do."""
    if not isinstance(x, DTensor):
        return list(x.reshape(n, x.shape[0] // n, *x.shape[1:]))
    mesh = x.device_mesh
    pl = list(x.placements)
    while True:
        rows = x.shape[0] // math.prod(
            mesh.size(i) for i, p in enumerate(pl)
            if isinstance(p, Shard) and p.dim == 0)
        if rows % n == 0:
            break
        first = next(i for i, p in enumerate(pl)
                     if isinstance(p, Shard) and p.dim == 0)
        pl[first] = Replicate()
    if tuple(pl) != tuple(x.placements):
        x = x.redistribute(mesh, pl)
    local = x.to_local()
    return [DTensor.from_local(part, mesh, pl, run_check=False)
            for part in local.reshape(n, local.shape[0] // n,
                                      *local.shape[1:])]


def split_last(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)`` where ``shape`` splits ``x``'s last dim.  A
    DTensor sharded on that dim keeps its shard when the first new dim
    divides over the shard count; else it is gathered first (JAX's
    ``(batch, None, heads)`` hint on ``[B, S, G·R·D]`` shards heads that
    DTensor cannot keep apart once G does not divide: tinyllama's 4 KV
    groups over a 16-wide model axis)."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        on_last = [i for i, p in enumerate(x.placements)
                   if isinstance(p, Shard) and p.dim == last]
        n = math.prod(x.device_mesh.size(i) for i in on_last)
        if n > 1 and shape[last] % n:
            pl = [Replicate() if i in on_last else p
                  for i, p in enumerate(x.placements)]
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(tuple(shape))


def local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                **kwargs) -> torch.Tensor:
    """``fn(q, k, v, **kwargs)`` (an attention of the layout ``q [B, Sq,
    G, R, D]``, ``k, v [B, Skv, G, D]``) on each rank's local shards, when
    ``q`` is a DTensor: q, k and v laid out alike, each mesh dim sharding
    the batch (dim 0) or the KV groups (dim 2) as q does, or whole; the
    result laid out as q.  DTensor's einsums would otherwise fold a sharded
    head dim into strided layouts its products cannot take.  Autograd goes
    through (the gradients of whole inputs are whole: every rank computed
    them alike)."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kwargs)
    mesh = q.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in q.placements)

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False)
        if tuple(t.placements) != pl:
            t = t.redistribute(mesh, pl)
        return t.to_local()

    out = fn(local(q), local(k), local(v), **kwargs)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def fsdp_gather(w: torch.Tensor) -> torch.Tensor:
    """A weight gathered over the data(+pod) axes before its use (FSDP's
    all-gather: the model-axis shards stay); its gradient is
    reduce-scattered back.  JAX's compiler gathers the FSDP shards of a
    weight where it is used; DTensor would rather keep the weight sharded
    and move the activations (a reduce-scatter of a whole batch's
    activation gradients per product).  A plain tensor: itself."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if names[i] in ("pod", "data")
                 and isinstance(p, Shard) else p
                 for i, p in enumerate(w.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def merge_last(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)`` where ``shape`` merges ``x``'s trailing dims
    (the heads back into the model width).  A DTensor's gradient is held
    to the merged layout, which splits back: a row-parallel product's
    gradient would arrive sharded on the merged dim, which DTensor cannot
    split into heads that do not divide over its ranks."""
    y = x.reshape(tuple(shape))
    if isinstance(y, DTensor) and y.requires_grad and torch.is_grad_enabled():
        y = GradLayout.apply(y, tuple(y.placements))
    return y


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """``table[ids].to(dtype)`` (an embedding lookup).  A DTensor table
    (vocab over model, FSDP over data) is gathered whole on each rank, in
    its own dtype, and indexed by the rank's own ids, the rows keeping the
    ids' batch layout: an explicit replication (ROADMAP.md Queue 3), as
    DTensor's strategies for the gather and its backward on a sharded
    vocab are not stable across torch releases.  The table's gradient is
    summed over the data shards, in the table's dtype as on one device
    (a table cast before its gather would sum a bf16 gradient)."""
    if not isinstance(table, DTensor):
        return table[ids].to(dtype)
    mesh = table.device_mesh
    if isinstance(ids, DTensor):
        local, pl = batch_local(ids)
    else:
        local, pl = ids, (Replicate(),) * mesh.ndim
    rows = replicated_local(table, pl)[local].to(dtype)
    return DTensor.from_local(rows, mesh, pl, run_check=False)
