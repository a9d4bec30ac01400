"""Carry the JAX package's data across to the port.

Reads a JAX-side ``PartitionedGraph``, ``BlockMetadata``, ``HybridGraph``,
``ShardHybridData``, state dict or LM parameter pytree —
any object with the same attributes holding numpy arrays (or anything
``np.asarray`` takes) — without importing ``repro``, and returns the port's
objects and tensors.  Tests use it to feed both packages the same graph,
partition, block layout, query state and model weights.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.core.hybrid import HybridGraph, ShardHybridData
from repro_torch.core.partition import (BlockMetadata, EdgeArrays,
                                        PartitionedGraph, VertexAssignment)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.ell_spmv import row_plan
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import layer_param_shapes


def _opt(x) -> Optional[np.ndarray]:
    return None if x is None else np.asarray(x)


def csr_graph(g) -> CSRGraph:
    return CSRGraph(np.asarray(g.row_ptr), np.asarray(g.col),
                    _opt(g.weights))


def edge_arrays(ea) -> EdgeArrays:
    return EdgeArrays(
        src=np.asarray(ea.src), dst_ext=np.asarray(ea.dst_ext),
        weight=_opt(ea.weight), edge_mask=np.asarray(ea.edge_mask),
        outbox_dst=np.asarray(ea.outbox_dst),
        outbox_mask=np.asarray(ea.outbox_mask),
        inbox_dst=np.asarray(ea.inbox_dst),
        num_edges=np.asarray(ea.num_edges),
        edge_id=_opt(getattr(ea, "edge_id", None)))


def partitioned_graph(pg) -> PartitionedGraph:
    asg = pg.assignment
    source = getattr(pg, "source", None)
    return PartitionedGraph(
        num_parts=int(pg.num_parts), num_vertices=int(pg.num_vertices),
        num_edges=int(pg.num_edges), v_max=int(pg.v_max),
        assignment=VertexAssignment(
            int(asg.num_parts), np.asarray(asg.part_of),
            np.asarray(asg.local_id), [np.asarray(x) for x in asg.l2g]),
        fwd=edge_arrays(pg.fwd),
        rev=edge_arrays(pg.rev) if pg.rev is not None else None,
        out_deg=np.asarray(pg.out_deg), vertex_mask=np.asarray(pg.vertex_mask),
        alpha=np.asarray(pg.alpha),
        beta_no_reduction=float(pg.beta_no_reduction),
        beta_with_reduction=float(pg.beta_with_reduction),
        source=csr_graph(source) if source is not None else None)


def block_metadata(blk) -> BlockMetadata:
    return BlockMetadata(
        block_e=int(blk.block_e), span=int(blk.span),
        span_req=int(blk.span_req), base=np.asarray(blk.base),
        local=np.asarray(blk.local), src=np.asarray(blk.src),
        mask=np.asarray(blk.mask), weight=_opt(blk.weight),
        block_spans=np.asarray(blk.block_spans))


def _ell_rows(col: np.ndarray, val: np.ndarray, sentinel: int):
    """An ELL block ``[V, kmax]`` as CSR rows: the real slots (``col !=
    sentinel``) of each row, in order."""
    real = col != sentinel
    row_ptr = np.zeros(col.shape[0] + 1, dtype=np.int32)
    np.cumsum(real.sum(axis=1), out=row_ptr[1:])
    return row_ptr, col[real].astype(np.int32), val[real].astype(np.float32)


def hybrid_graph(hg) -> HybridGraph:
    """A JAX ``HybridGraph`` as the port's: the ELL remainder
    ``[V, kmax]`` becomes CSR rows by dropping the sentinel slots
    (``col == V``) row by row; the real slots keep their order."""
    col = np.asarray(hg.ell_col)
    n = int(hg.num_vertices)
    row_ptr, rcol, rval = _ell_rows(col, np.asarray(hg.ell_val), n)
    return HybridGraph(
        num_vertices=n, num_edges=int(hg.num_edges),
        k_dense=int(hg.k_dense), perm=np.asarray(hg.perm),
        inv_perm=np.asarray(hg.inv_perm),
        dense_block=np.asarray(hg.dense_block, dtype=np.float32),
        ell_row_ptr=row_ptr, ell_col=rcol, ell_val=rval,
        kmax=int(col.shape[1]), ell_plan=row_plan(row_ptr),
        out_deg=np.asarray(hg.out_deg), dense_edges=int(hg.dense_edges),
        sparse_edges=int(hg.sparse_edges), semiring=str(hg.semiring),
        model_table=hg.model_table)


def shard_hybrid_data(shd) -> ShardHybridData:
    """A JAX ``ShardHybridData`` as the port's: each shard's ELL remainder
    ``[n_max, kmax]`` becomes CSR rows, the boundary edges' flat slot ids
    come from the block metadata (``base + local``, the real edges being
    each row's masked prefix), and each exchanged value's source partition
    from the row of the outbox it is read from."""
    col, val = np.asarray(shd.ell_col), np.asarray(shd.ell_val)
    n_max, num_slots = int(shd.n_max), int(shd.num_slots)
    rows = [_ell_rows(col[s], val[s], n_max) for s in range(col.shape[0])]
    mask = np.asarray(shd.b_mask)
    count = mask.sum(axis=1).astype(np.int64)
    flat = (np.repeat(np.asarray(shd.b_base), int(shd.b_block), axis=1)
            + np.asarray(shd.b_local)).astype(np.int32)
    flat = np.where(np.arange(flat.shape[1]) < count[:, None], flat,
                    num_slots).astype(np.int32)
    pl, per_part = int(shd.parts_per_shard), int(shd.num_parts * shd.o_max)
    shard = np.arange(col.shape[0])
    send_idx, loc_idx = np.asarray(shd.send_idx), np.asarray(shd.loc_idx)
    recv_src = np.where(send_idx < num_slots,
                        shard[:, None, None] * pl + send_idx // per_part,
                        -1).transpose(1, 0, 2).astype(np.int32)
    loc_src = np.where(loc_idx < num_slots,
                       shard[:, None] * pl + loc_idx // per_part,
                       -1).astype(np.int32)
    push_src = _opt(shd.push_src)
    return ShardHybridData(
        semiring=str(shd.semiring), num_shards=int(shd.num_shards),
        parts_per_shard=pl, v_max=int(shd.v_max),
        num_parts=int(shd.num_parts), o_max=int(shd.o_max),
        k_dense=int(shd.k_dense), n_max=n_max, num_slots=num_slots,
        n_vert=np.asarray(shd.n_vert), dense=np.asarray(shd.dense),
        ell_row_ptr=np.stack([r[0] for r in rows]),
        ell_col=[r[1] for r in rows], ell_val=[r[2] for r in rows],
        kmax=int(col.shape[2]), slot=np.asarray(shd.slot),
        hid=np.asarray(shd.hid), b_src=np.asarray(shd.b_src),
        b_weight=_opt(shd.b_weight), b_flat=flat, b_count=count,
        send_idx=send_idx, recv_ids=np.asarray(shd.recv_ids),
        recv_src=recv_src, loc_idx=loc_idx, loc_ids=np.asarray(shd.loc_ids),
        loc_src=loc_src, wire_width=int(shd.wire_width),
        has_boundary=bool(shd.has_boundary),
        has_remote=bool(shd.has_remote), push_src=push_src,
        push_dst=_opt(shd.push_dst), push_w=_opt(shd.push_w),
        n_intra=(None if push_src is None
                 else (push_src != n_max).sum(axis=1).astype(np.int64)),
        ell_plan=[row_plan(r[0]) for r in rows])


def state(tree: Dict[str, object],
          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A state dict of arrays → tensors on ``device`` (default ``cuda``;
    raises without a card unless ``device`` names another one)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev)
            for k, v in tree.items()}


def to_numpy(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def lm_params(params, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The JAX transformer's parameter pytree (``init_params``: ``embed``,
    ``layers`` stacked on a leading L axis, ``final_norm``, ``lm_head`` when
    the head is untied) → the port's module state, f32 CPU tensors named
    ``embed``, ``layers.<i>.<name>``, ``final_norm``, ``lm_head``.  Weights
    keep the ``[in, out]`` layout of ``x @ W`` (no transpose).
    ``Transformer.load_state_dict`` casts them to the stored dtypes.
    Raises if a shape or the head does not match ``cfg``."""
    def put(name, x, shape):
        a = np.array(x, dtype=np.float32)          # a writable copy
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, {cfg.name} wants "
                             f"{tuple(shape)}")
        return torch.from_numpy(a)

    if ("lm_head" in params) == cfg.tie_embeddings:
        raise ValueError(f"lm_head {'given' if cfg.tie_embeddings else 'missing'}"
                         f" with tie_embeddings={cfg.tie_embeddings}")
    out = {"embed": put("embed", params["embed"], (cfg.vocab, cfg.d_model))}
    layers = params["layers"]
    for name, shape in layer_param_shapes(cfg).items():
        stack = put(f"layers.{name}", layers[name], (cfg.n_layers,) + shape)
        for i in range(cfg.n_layers):
            out[f"layers.{i}.{name}"] = stack[i]
    out["final_norm"] = put("final_norm", params["final_norm"],
                            (cfg.d_model,))
    if not cfg.tie_embeddings:
        out["lm_head"] = put("lm_head", params["lm_head"],
                             (cfg.d_model, cfg.vocab))
    return out
