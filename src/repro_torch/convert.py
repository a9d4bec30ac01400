"""Carry the JAX package's data across to the port.

Reads a JAX-side ``PartitionedGraph``, ``BlockMetadata``, ``HybridGraph``
or state dict —
any object with the same attributes holding numpy arrays (or anything
``np.asarray`` takes) — without importing ``repro``, and returns the port's
objects and tensors.  Tests use it to feed both packages the same graph,
partition, block layout and query state.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph
from repro_torch.core.hybrid import HybridGraph
from repro_torch.core.partition import (BlockMetadata, EdgeArrays,
                                        PartitionedGraph, VertexAssignment)
from repro_torch.device import DeviceLike, resolve_device


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


def hybrid_graph(hg) -> HybridGraph:
    """A JAX ``HybridGraph`` as the port's: the ELL remainder
    ``[V, kmax]`` becomes CSR rows by dropping the sentinel slots
    (``col == V``) row by row; the real slots keep their order."""
    col = np.asarray(hg.ell_col)
    val = np.asarray(hg.ell_val)
    n = int(hg.num_vertices)
    real = col != n
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(real.sum(axis=1), out=row_ptr[1:])
    return HybridGraph(
        num_vertices=n, num_edges=int(hg.num_edges),
        k_dense=int(hg.k_dense), perm=np.asarray(hg.perm),
        inv_perm=np.asarray(hg.inv_perm),
        dense_block=np.asarray(hg.dense_block, dtype=np.float32),
        ell_row_ptr=row_ptr, ell_col=col[real].astype(np.int32),
        ell_val=val[real].astype(np.float32), kmax=int(col.shape[1]),
        out_deg=np.asarray(hg.out_deg), dense_edges=int(hg.dense_edges),
        sparse_edges=int(hg.sparse_edges), semiring=str(hg.semiring),
        model_table=hg.model_table)


def state(tree: Dict[str, object],
          device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A state dict of arrays → tensors on ``device`` (default ``cuda``;
    raises without a card unless ``device`` names another one)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v), device=dev)
            for k, v in tree.items()}


def to_numpy(tree: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}
