"""Carry the JAX package's data across to the port.

Reads a JAX-side ``PartitionedGraph``, ``BlockMetadata``, ``HybridGraph``,
``ShardHybridData``, ``DynamicGraph`` payload, state dict, LM parameter
pytree or ``AdamWState`` —
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
from repro_torch.models import xlstm, zamba
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import layer_param_shapes
from repro_torch.optim.adamw import AdamWState


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


# The port's dtype of each array of a dynamic graph's payload: the engine
# indexes with int64.
_PAYLOAD_DTYPES = {"tomb": torch.bool, "d_src": torch.int64,
                   "d_dst_ext": torch.int64, "inbox_dst": torch.int64,
                   "d_weight": torch.float32}


def dynamic_payload(payload: Dict[str, object],
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A JAX ``DynamicGraph.payload()`` (``tomb``, ``d_src``,
    ``d_dst_ext``, ``inbox_dst`` and, weighted, ``d_weight``) → the port's
    payload tensors on ``device`` (default ``cuda``), in the dtypes of
    ``core.dynamic.DynamicGraph.payload``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), dtype=_PAYLOAD_DTYPES[k],
                               device=dev) for k, v in payload.items()}


def to_numpy(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}


def lm_params(params, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The JAX transformer's parameter pytree (``init_params``: ``embed``,
    ``layers`` stacked on a leading L axis, ``final_norm``, ``lm_head`` when
    the head is untied; ``encoder`` stacked as ``layers`` and ``enc_norm``
    for an encoder-decoder config, ``frontend_proj`` with a front end) →
    the port's module state, f32 CPU tensors named ``embed``,
    ``layers.<i>.<name>``, ``final_norm``, ``lm_head``, ``encoder.<i>.
    <name>``, ``enc_norm``, ``frontend_proj``.  Weights keep the ``[in,
    out]`` layout of ``x @ W`` (no transpose).
    ``Transformer.load_state_dict`` casts them to the stored dtypes.
    Raises if a shape, the set of layer leaves (an MoE config's
    ``moe_wg``, ``moe_w1 [L, E, D, 2F]`` and ``moe_w2 [L, E, F, D]`` in
    place of the SwiGLU leaves; the cross leaves ``norm_x``, ``wq_x``,
    ``wk_x``, ``wv_x``, ``wo_x`` of an encoder-decoder's decoder), the head,
    the encoder or the front end does not match ``cfg``.

    The SSM and hybrid families (``cfg.family`` ``ssm``, ``hybrid``) go to
    ``tree_params``."""
    if cfg.family in ("ssm", "hybrid"):
        return tree_params(params, cfg)

    def put(name, x, shape):
        a = np.array(x, dtype=np.float32)          # a writable copy
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, {cfg.name} wants "
                             f"{tuple(shape)}")
        return torch.from_numpy(a)

    def stack(prefix, layers, cross):
        shapes = layer_param_shapes(cfg, cross)
        if set(layers) != set(shapes):
            what = "layer" if prefix == "layers" else "encoder layer"
            raise ValueError(f"{what} leaves {sorted(layers)}, {cfg.name} "
                             f"wants {sorted(shapes)}")
        for name, shape in shapes.items():
            st = put(f"{prefix}.{name}", layers[name],
                     (cfg.n_layers,) + shape)
            for i in range(cfg.n_layers):
                out[f"{prefix}.{i}.{name}"] = st[i]

    if ("lm_head" in params) == cfg.tie_embeddings:
        raise ValueError(f"lm_head {'given' if cfg.tie_embeddings else 'missing'}"
                         f" with tie_embeddings={cfg.tie_embeddings}")
    for key, wanted in (("encoder", cfg.enc_dec), ("enc_norm", cfg.enc_dec),
                        ("frontend_proj", bool(cfg.frontend))):
        if (key in params) != wanted:
            raise ValueError(f"{key} {'missing' if wanted else 'given'} with "
                             f"enc_dec={cfg.enc_dec}, "
                             f"frontend={cfg.frontend!r}")
    d = cfg.d_model
    out = {"embed": put("embed", params["embed"], (cfg.vocab, d))}
    stack("layers", params["layers"], cfg.enc_dec)
    out["final_norm"] = put("final_norm", params["final_norm"], (d,))
    if not cfg.tie_embeddings:
        out["lm_head"] = put("lm_head", params["lm_head"], (d, cfg.vocab))
    if cfg.enc_dec:
        stack("encoder", params["encoder"], False)
        out["enc_norm"] = put("enc_norm", params["enc_norm"], (d,))
    if cfg.frontend:
        out["frontend_proj"] = put("frontend_proj", params["frontend_proj"],
                                   (d, d))
    return out


def tree_params(params, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The JAX xLSTM tree (``embed``, ``layers.{norm, up_proj, wq, wk,
    w_igate, w_fgate, b_igate, b_fgate, r_igate, r_fgate, r_zgate,
    w_ogate, mix_norm, down_proj}`` stacked on L, ``final_norm``) or Zamba
    tree (``embed``, ``mamba.*`` stacked on L, ``shared_attn.*``,
    ``final_norm``) → the ``TreeModule``'s state, f32 CPU tensors named by
    their paths (``layers.wq``).  Raises if the leaf set or a shape does
    not match ``cfg``'s ``param_spec``."""
    spec = (xlstm if cfg.family == "ssm" else zamba).param_spec(cfg)

    def flat(tree, prefix=""):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out.update(flat(val, f"{prefix}{key}."))
            else:
                out[prefix + key] = val
        return out

    given = flat(params)
    wanted = {".".join(path): shape for path, shape, _ in spec}
    if set(given) != set(wanted):
        raise ValueError(f"leaves {sorted(given)}, {cfg.name} wants "
                         f"{sorted(wanted)}")
    out = {}
    for name, shape in wanted.items():
        a = np.array(given[name], dtype=np.float32)      # a writable copy
        if a.shape != tuple(shape):
            raise ValueError(f"{name}: shape {a.shape}, {cfg.name} wants "
                             f"{tuple(shape)}")
        out[name] = torch.from_numpy(a)
    return out


def train_params(params, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
    """A JAX parameter pytree (nested dicts of arrays, e.g. the transformer's
    ``init_params``) → the same tree of tensors on ``device`` (default
    ``cuda``), each leaf in its own dtype or ``dtype``: the port's master
    parameters for ``loss_fn`` and ``make_train_step``."""
    dev = resolve_device(device)
    if isinstance(params, dict):
        return {k: train_params(v, dev, dtype) for k, v in params.items()}
    a = np.array(params)                           # a writable copy
    return torch.as_tensor(a, device=dev, dtype=dtype)


def adamw_state(state, device: DeviceLike = None) -> AdamWState:
    """A JAX ``AdamWState`` (``step``, ``mu``, ``nu``) → the port's, its
    moments f32 tensors on ``device`` (default ``cuda``) and its step an
    int32 scalar there."""
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=dev),
        mu=train_params(state.mu, dev, torch.float32),
        nu=train_params(state.nu, dev, torch.float32))
