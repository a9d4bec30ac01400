"""The TOTEM BSP engine in PyTorch (paper §4), single device.

Each BSP superstep is exactly the paper's cycle:

  1. **compute** — every partition runs the algorithm's edge kernel on its
     edges; messages to local destinations and to outbox slots are reduced
     in one segment min/sum over the extended destination index (source-side
     message reduction, §3.4, is implicit: local edges to the same remote
     vertex share one outbox slot).
  2. **communicate** — outboxes are exchanged with the symmetric inboxes of
     the peer partitions (paper Fig. 6); on one device, a transpose.
  3. **scatter** — inbox messages fold into the local accumulator.
  4. **apply + vote** — per-vertex update; each query votes to finish.

State is a dict of tensors whose leaves carry a leading query axis ``Q``:
vertex leaves ``[Q, Pl, v_max]``, per-partition scalars ``[Q, Pl]``.  The
graph topology is shared across the batch.  A converged query is frozen out
of the apply step while the rest continue, so a batch reproduces each
query's own trajectory, and per-query superstep counts are reported.

Min-combine programs run **direction optimized** by default, as in the JAX
package: each superstep every query votes for push (frontier vertices
scatter along out-edges) or pull (every destination row scans its
in-neighbours, ``kernels/bottomup.py``).  Both directions reduce the same
values per destination under a min, so results are bit-equal either way;
the vote only moves work.

The ``hybrid`` backend runs a superstep as a whole-graph semiring SpMV
through the degree split of ``core/hybrid.py`` (dense block of the top
degree vertices + sparse remainder), with no outbox: one device has no
partition boundary to cross.

``DistributedBSPEngine`` shards the partitions over the ranks of a
``torch.distributed`` group (``repro_torch/distributed.py``): each rank
holds ``P / world`` consecutive partitions, the exchange is an
``all_to_all`` and the vote a global AND.  Its hybrid backend runs each
shard's degree split over the shard's intra-partition edges and reduces
boundary messages into outbox slots at the source
(``kernels/outbox_reduce.py``), so only used slots cross the wire.  A world
of one (``group=None``) runs the same path in one process on one device.

This is the port of ``repro.core.bsp``'s engines with the ``reference``,
``fused`` and ``hybrid`` backends.  Program callbacks take batched state
directly (PyTorch has no ``vmap`` need here).  Python loops stand in for
``lax.while_loop``/``fori_loop`` and ``shard_map``; the converge loop reads
the vote on the host once per superstep, and a direction-optimized
superstep reads the direction votes.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import perf_model
from repro_torch.core.hybrid import (MIN_PLUS, PLUS_TIMES, add_identity,
                                     hybrid_spmv, hybrid_spmv_scan, splits_of)
from repro_torch.core.partition import (BlockMetadata, EdgeArrays,
                                        PartitionedGraph, build_block_metadata,
                                        build_transposed_csc, slice_parts)
from repro_torch.core.perf_model import fit_shard_pull_thresholds
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import ShardGroup
from repro_torch.kernels.ops import (bottomup_scan_op, fused_superstep_op,
                                     outbox_reduce_op)
from repro_torch.kernels.ref import MIN, SUM, segment_reduce_ref

State = Dict[str, torch.Tensor]  # batched: leaves [Q, Pl, ...]

REFERENCE = "reference"
FUSED = "fused"
HYBRID = "hybrid"
BACKENDS = (REFERENCE, FUSED, HYBRID)

__all__ = ["SUM", "MIN", "REFERENCE", "FUSED", "HYBRID", "BACKENDS",
           "EdgeMessage", "VertexProgram", "BSPEngine",
           "DistributedBSPEngine", "batch_state", "unbatch_state",
           "num_queries", "gather_src"]


def batch_state(state: State) -> State:
    """Add a Q=1 query axis to every leaf (single-query compatibility)."""
    return {k: torch.as_tensor(v)[None] for k, v in state.items()}


def unbatch_state(state: State) -> State:
    """Strip the query axis of a Q=1 batched state."""
    return {k: v[0] for k, v in state.items()}


def num_queries(state: State) -> int:
    return int(next(iter(state.values())).shape[0])


def _combine(combine: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b if combine == SUM else torch.minimum(a, b)


@dataclasses.dataclass(frozen=True)
class EdgeMessage:
    """Elementwise edge-message form of ``edge_fn``, which the fused backend
    runs without materialising per-edge messages.

    ``fn(vals, weight, step, consts) -> msgs``: ``vals`` maps each key in
    ``gather`` to that state's value at the edge's *source*, ``weight`` is
    the per-edge weight (present iff ``use_weight``), ``step`` the superstep
    as float32, ``consts`` maps each key in ``consts`` to a per-partition
    scalar.  Tensors broadcast (``[Q, Pl, E]`` values, ``[Q, Pl, 1]``
    scalars); it must compute exactly what ``edge_fn`` computes per edge.
    ``fn`` is the plain form (the CPU path and the kernel's yardstick);
    ``kind`` names the same message's device form in the CUDA kernel
    (``kernels/fused_superstep.py::KINDS``).  A fused engine on the card
    raises for a message without a known ``kind``.

    ``weight_op`` declares how the weight enters the message:
    ``fn(vals, w) == fn(vals, ident) ⊗ w`` with (⊗, ident) = ``("add", 0)``
    for min combines (the min_plus semiring) or ``("mul", 1)`` for sum
    combines (plus_times).  It lets the pull direction and the hybrid
    backend factor the weight out of the per-source part.
    ``frontier_uniform`` declares that every non-identity message of one
    superstep holds the same value (BFS sends ``step + 1``): the first live
    parent a pull scan meets is then the row minimum, and the scan stops
    there.
    """

    gather: Tuple[str, ...]
    fn: Callable[..., torch.Tensor]
    kind: Optional[str] = None
    consts: Tuple[str, ...] = ()
    use_weight: bool = False
    weight_op: Optional[str] = None   # None | "add" | "mul"
    frontier_uniform: bool = False


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """An algorithm in TOTEM's callback form (paper Fig. 5), on batched state.

    ``edge_fn(state, src, weight, step) -> msgs [Q, Pl, e_max]`` — the
    per-edge part of ``alg_compute`` (inactive sources send the combine
    identity).  ``apply_fn(state, acc, step) -> (new_state, finished [Q])``
    — the per-vertex update on the reduced ``[Q, Pl, v_max]`` accumulator and
    each query's vote to terminate.  ``edge_msg`` makes the program eligible
    for the fused backend.
    """

    combine: str
    edge_fn: Callable[[State, torch.Tensor, Optional[torch.Tensor], float],
                      torch.Tensor]
    apply_fn: Callable[[State, torch.Tensor, float],
                       Tuple[State, torch.Tensor]]
    max_steps: int = 1 << 30
    use_reverse: bool = False
    edge_msg: Optional[EdgeMessage] = None


def gather_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Per-edge source state: ``[Q, Pl, v_max]`` × ``[Pl, e_max]``."""
    return torch.gather(x, 2, src.expand(x.shape[0], -1, -1))


@dataclasses.dataclass(frozen=True)
class _Dims:
    num_parts: int       # global partition count P
    v_max: int
    e_max: int
    o_max: int

    @property
    def seg(self) -> int:  # extended segment space per partition
        return self.v_max + 1 + self.num_parts * self.o_max


def _compute_reference(dims: _Dims, program: VertexProgram, edges: dict,
                       state: State, step: int) -> torch.Tensor:
    """Reference compute: gather → [Q, Pl, e_max] messages → scatter-reduce."""
    msgs = program.edge_fn(state, edges["src"], edges.get("weight"),
                           float(step))
    return segment_reduce_ref(msgs, edges["dst_ext"], dims.seg,
                              program.combine)


def _require_f32(spec: EdgeMessage, state: State, backend: str) -> None:
    """The kernel backends compute in float32; other float state raises."""
    for k in spec.gather + spec.consts:
        if state[k].is_floating_point() and state[k].dtype != torch.float32:
            raise ValueError(
                f"the {backend} backend computes in float32; state {k!r} is "
                f"{state[k].dtype} (use backend='reference' for other "
                f"precisions)")


def _compute_fused(dims: _Dims, program: VertexProgram, edges: dict,
                   block_e: int, state: State, step: int) -> torch.Tensor:
    """Fused compute: one kernel launch per superstep on the card, no
    [Q, Pl, e_max] message array (kernels/fused_superstep.py)."""
    spec = program.edge_msg
    _require_f32(spec, state, FUSED)
    vstate = torch.stack([state[k].float() for k in spec.gather], dim=2)
    q, pl = vstate.shape[:2]
    cols = [torch.full((q, pl), float(step), dtype=torch.float32,
                       device=vstate.device)]
    cols += [state[c].float() for c in spec.consts]
    scal = torch.stack(cols, dim=2)                       # [Q, Pl, 1+consts]
    weight = edges.get("weight_blk") if spec.use_weight else None
    return fused_superstep_op(
        spec, vstate, weight, scal, edges["blk_src"], edges["blk_local"],
        edges["blk_mask"], edges["blk_base"], edges["dst_ext"],
        num_segments=dims.seg, combine=program.combine, block_e=block_e)


# ---------------------------------------------------------------------------
# Direction-optimized traversal
#
# For min-combine programs a superstep runs top-down (push: every frontier
# vertex scatters along its out-edges) or bottom-up (pull: every destination
# row scans its in-neighbours, stopping at the first live parent when the
# messages are uniform).  Both reduce the same values per destination under
# a min, so the direction is a choice of work only.  The decision state
# rides in the state dict as three [Q, P] leaves (direction, edges examined,
# switches), which the converge loop freezes with the rest of a finished
# query; ``execute`` adds them and strips them before the caller sees the
# state.  Counters go to column 0, as on one shard of the JAX package.
# ---------------------------------------------------------------------------

_DOPT_KEYS = ("_dopt_dir", "_dopt_edges", "_dopt_switch")
_DIR_PUSH = 0
_DIR_PULL = 1
_DIRECTIONS = {"auto": None, "push": _DIR_PUSH, "pull": _DIR_PULL}


@dataclasses.dataclass(frozen=True)
class _DoptCfg:
    """A program's direction settings."""

    semiring: str                 # "min" | "min_plus"
    uniform: bool                 # EdgeMessage.frontier_uniform
    forced: Optional[int] = None  # None = vote, else _DIR_PUSH/_DIR_PULL


@dataclasses.dataclass(frozen=True)
class _PullLayout:
    """What the pull direction needs beside the push edges, built once per
    engine: the transposed intra-partition rows, the vote's inputs, and the
    edges of the boundary leg, which pushes in both directions."""

    row_ptr: torch.Tensor          # [Pl * v_max + 1] int32
    col: torch.Tensor              # [nnz] int32 flat source index
    val: Optional[torch.Tensor]    # [nnz] f32 (min_plus) or None
    vmask: torch.Tensor            # [Pl, v_max] bool real vertices
    nreal: float                   # real vertices (>= 1)
    deg: torch.Tensor              # [Pl, v_max] int64 out-degree
    bnd: torch.Tensor              # [Pl, v_max] int64 boundary out-degree
    threshold: float               # the vote's frontier density crossover
    bnd_edges: Optional[dict]      # boundary-only push edges; None if none


def _dopt_strip(state: State):
    """Split the direction leaves out of the state before programs see it."""
    if _DOPT_KEYS[0] not in state:
        return state, None
    user = {k: v for k, v in state.items() if k not in _DOPT_KEYS}
    return user, {k: state[k] for k in _DOPT_KEYS}


def _dopt_fold(dopt: dict, want: torch.Tensor, cnt: torch.Tensor) -> dict:
    """Fold one superstep's directions ``want [Q]`` and examined edges
    ``cnt [Q]`` into the carried leaves."""
    prev = dopt["_dopt_dir"][:, 0]
    switched = (prev >= 0) & (prev != want)
    edges = dopt["_dopt_edges"].clone()
    edges[:, 0] += cnt
    switches = dopt["_dopt_switch"].clone()
    switches[:, 0] += switched.to(switches.dtype)
    return {"_dopt_dir": want[:, None].to(torch.int32).expand_as(
                dopt["_dopt_dir"]).clone(),
            "_dopt_edges": edges, "_dopt_switch": switches}


def _dopt_want(forced: Optional[int], density: torch.Tensor,
               unvisited: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-query direction vote (``repro.core.bsp._dopt_want``).

    Pull wins when the frontier is dense enough that row scans exit early
    (density at or above the fitted ``threshold``) and outweighs the
    unvisited mass, whose rows have no live parent and scan in full.
    """
    if forced is not None:
        return torch.full(density.shape, forced, dtype=torch.int32,
                          device=density.device)
    pull = (density >= threshold) & (density > unvisited)
    return torch.where(pull, _DIR_PULL, _DIR_PUSH).to(torch.int32)


def _compute_pull(dims: _Dims, cfg: _DoptCfg, pull: _PullLayout,
                  compute_push: Callable, state: State, xv: torch.Tensor,
                  first: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pull compute: the boundary leg pushes (its messages ride the outbox
    either way), the local region comes from the bottom-up scan.  Returns
    the accumulator and each query's scanned slots."""
    q, pl, v_max = xv.shape
    if pull.bnd_edges is not None:
        # intra edges masked out: outbox slots bit-equal to the full push's,
        # the local region the identity
        acc = compute_push(state, pull.bnd_edges)
    else:
        acc = torch.full((q, pl, dims.seg), math.inf, dtype=xv.dtype,
                         device=xv.device)
    # Under the uniform licence a visited row's value is final, so a
    # sequential bottom-up pass skips it: it charges no scanned slots.
    skip = (first != math.inf).reshape(q, pl * v_max) if cfg.uniform else None
    val = pull.val if cfg.semiring == "min_plus" else None
    y, scanned = bottomup_scan_op(
        pull.row_ptr, pull.col, val, xv.reshape(q, pl * v_max),
        semiring=cfg.semiring, early_exit=cfg.uniform, skip=skip)
    acc[:, :, :v_max] = torch.minimum(acc[:, :, :v_max],
                                      y.view(q, pl, v_max))
    return acc, scanned.sum(1, dtype=torch.int64)


def _compute_directed(dims: _Dims, program: VertexProgram, cfg: _DoptCfg,
                      pull: _PullLayout, compute_push: Callable,
                      state: State, step: int, dopt: dict
                      ) -> Tuple[torch.Tensor, dict]:
    """Vote per query, run push, pull or both (a mixed batch selects per
    query), and fold the decisions into the direction leaves."""
    spec = program.edge_msg
    vvals = {k: state[k].float() for k in spec.gather}
    vconsts = {c: state[c][:, :, None].float() for c in spec.consts}
    w_ident = 0.0 if spec.use_weight else None   # weight_op "add"
    # per-vertex messages: the push direction's per-edge messages are
    # gathers of these values
    xv = spec.fn(vvals, w_ident, float(step), vconsts).float()
    act = (xv != math.inf) & pull.vmask
    density = act.sum((1, 2)).float() / pull.nreal
    first = vvals[spec.gather[0]]
    unvisited = ((first == math.inf) & pull.vmask).sum((1, 2)).float() / (
        pull.nreal)
    want = _dopt_want(cfg.forced, density, unvisited, pull.threshold)
    cnt_push = (act * pull.deg).sum((1, 2))
    cnt_bnd = (act * pull.bnd).sum((1, 2))
    picked = set(want.tolist())
    if picked == {_DIR_PUSH}:
        acc, cnt = compute_push(state), cnt_push
    else:
        acc, scanned = _compute_pull(dims, cfg, pull, compute_push, state, xv,
                                     first)
        cnt = scanned + cnt_bnd
        if picked != {_DIR_PULL}:
            sel = want == _DIR_PULL
            acc = torch.where(sel[:, None, None], acc, compute_push(state))
            cnt = torch.where(sel, cnt, cnt_push)
    return acc, _dopt_fold(dopt, want, cnt)


def _superstep(dims: _Dims, program: VertexProgram, edges: dict,
               exchange: Callable[[torch.Tensor], torch.Tensor],
               all_finished: Callable[[torch.Tensor], torch.Tensor],
               fused_block_e: Optional[int], state: State, step: int,
               dopt_cfg: Optional[_DoptCfg] = None,
               pull: Optional[_PullLayout] = None
               ) -> Tuple[State, torch.Tensor]:
    """One BSP superstep of the whole query batch over the local partitions.

    ``exchange`` maps the outboxes ``[Q, pl, P, o_max]`` to the inboxes of
    the same shape (a transpose on one device, an ``all_to_all`` across
    shards); ``all_finished`` turns the local votes ``[Q]`` into global
    ones."""
    combine = program.combine
    state, dopt = _dopt_strip(state)

    def compute_push(st, e=edges):
        if fused_block_e is not None and program.edge_msg is not None:
            return _compute_fused(dims, program, e, fused_block_e, st, step)
        return _compute_reference(dims, program, e, st, step)

    if dopt is not None:
        acc, dopt = _compute_directed(dims, program, dopt_cfg, pull,
                                      compute_push, state, step, dopt)
    else:
        acc = compute_push(state)
    q, pl = acc.shape[:2]
    v_max = dims.v_max
    local_acc = acc[:, :, :v_max]
    outbox = acc[:, :, v_max + 1:].reshape(q, pl, dims.num_parts, dims.o_max)

    # -- communicate: outbox -> symmetric inbox (paper Fig. 6) --------------
    inbox = exchange(outbox)                  # [Q, pl, P, o_max]

    # -- scatter: one pass per peer; each local vertex has at most one slot
    # per peer, so no segment receives two values in a pass and the sum
    # order is fixed (the peer order) on every device.
    racc = None
    for r in range(dims.num_parts):
        part = segment_reduce_ref(inbox[:, :, r], edges["inbox_dst"][:, r],
                                  v_max + 1, combine)
        racc = part if racc is None else _combine(combine, racc, part)
    total = _combine(combine, local_acc, racc[:, :, :v_max])

    # -- apply + vote (per query) -------------------------------------------
    new_state, finished = program.apply_fn(state, total, float(step))
    if dopt is not None:
        new_state = dict(new_state, **dopt)
    return new_state, all_finished(finished)


# ---------------------------------------------------------------------------
# The hybrid degree-split backend (core/hybrid.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _HybridCfg:
    """Static geometry of one hybrid degree-split direction.  The tensors
    travel in a separate ``arrs`` dict: ``dense``, ``row_ptr``/``col``/
    ``val`` (the remainder rows) and ``plan`` (their row plan for the sparse
    kernel), ``slot``/``hid`` and, when the direction
    switch is on, ``push_src``/``push_dst`` (and ``push_w``)."""

    semiring: str
    k_dense: int
    num_vertices: int
    kmax: int                     # widest remainder row
    pull_threshold: float
    forced: Optional[int] = None  # None = vote, else _DIR_PUSH/_DIR_PULL
    uniform: bool = False         # EdgeMessage.frontier_uniform
    e_dense: int = 0              # a pull step's dense-stage charge, k^2


def _hybrid_messages(program: VertexProgram, arrs: dict, state: State,
                     step: int) -> Tuple[Dict[str, torch.Tensor],
                                         torch.Tensor]:
    """The program's per-vertex messages in the hybrid id space:
    ``(gathered values, x [Q, n])``.  ``slot`` translates from the
    ``[Q, Pl, v_max]`` layout; per-partition scalar consts are replicated
    across partitions, so the compute reads partition 0's copy, shaped
    ``[Q, 1]``.  The ⊗ weight is its identity here: the split's edge
    values carry it."""
    spec = program.edge_msg
    q = state[spec.gather[0]].shape[0]
    vals = {k: state[k].float().reshape(q, -1)[:, arrs["slot"]]
            for k in spec.gather}
    consts = {c: state[c][:, :1].float() for c in spec.consts}
    w_ident = None
    if spec.use_weight:
        w_ident = 0.0 if spec.weight_op == "add" else 1.0
    return vals, spec.fn(vals, w_ident, float(step), consts).float()


def _hybrid_directed(cfg: _HybridCfg, arrs: dict, x: torch.Tensor,
                     first: torch.Tensor, dopt: Optional[dict],
                     vmask: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """The two-engine step over ``x [Q, n]``: ``(y, want, cnt)``.

    Without direction leaves (``dopt`` None) it is the pull SpMV.  For min
    programs each query votes push (gather + segment min over the push
    edges: cheap when few vertices send) or pull (the two-engine step, its
    sparse stage through the bottom-up scan) on its frontier density over
    ``cfg.num_vertices`` real vertices (``vmask`` marks them where ``x``
    has padding, which must hold the identity); ``cnt`` is each query's
    work-model charge.
    """
    if dopt is None:
        return hybrid_spmv(arrs["dense"], arrs["row_ptr"], arrs["col"],
                           arrs["val"], x, semiring=cfg.semiring,
                           k_dense=cfg.k_dense, plan=arrs["plan"]), None, None
    ident = add_identity(cfg.semiring)
    nf = float(max(cfg.num_vertices, 1))
    density = (x != ident).sum(1, dtype=torch.float32) / nf
    unvisited = first == ident
    if vmask is not None:
        unvisited = unvisited & vmask
    unvisited = unvisited.sum(1, dtype=torch.float32) / nf
    want = _dopt_want(cfg.forced, density, unvisited, cfg.pull_threshold)
    picked = set(want.tolist())
    if picked != {_DIR_PULL}:
        msgs = x[:, arrs["push_src"]]                  # [Q, E]
        if "push_w" in arrs:
            msgs = msgs + arrs["push_w"]
        y_push = segment_reduce_ref(msgs, arrs["push_dst"], x.shape[1], MIN)
        cnt_push = (msgs != ident).sum(1)
        del msgs
    if picked != {_DIR_PUSH}:
        # Under the uniform licence a row already holding a value is
        # final: a sequential bottom-up pass skips it.
        skip = (first != ident) if cfg.uniform else None
        y_pull, scanned = hybrid_spmv_scan(
            arrs["dense"], arrs["row_ptr"], arrs["col"], arrs["val"], x,
            semiring=cfg.semiring, k_dense=cfg.k_dense,
            early_exit=cfg.uniform, skip=skip)
        cnt_pull = scanned + cfg.e_dense
    if picked == {_DIR_PUSH}:
        return y_push, want, cnt_push
    if picked == {_DIR_PULL}:
        return y_pull, want, cnt_pull
    sel = want == _DIR_PULL
    return (torch.where(sel[:, None], y_pull, y_push), want,
            torch.where(sel, cnt_pull, cnt_push))


def _superstep_hybrid(program: VertexProgram, cfg: _HybridCfg, arrs: dict,
                      state: State, step: int) -> Tuple[State, torch.Tensor]:
    """One BSP superstep through the degree-split two-engine backend.

    The compute phase is a semiring SpMV over the whole graph in the
    degree-ranked id space (``slot``/``hid`` translate from and to the
    ``[Q, Pl, v_max]`` layout, the sink ``n`` serving padding slots), with
    the per-query push/pull vote for min combines (``_hybrid_directed``),
    as the JAX engine runs it.
    """
    _require_f32(program.edge_msg, state, HYBRID)
    ident = add_identity(cfg.semiring)
    state, dopt = _dopt_strip(state)
    vals, x = _hybrid_messages(program, arrs, state, step)     # [Q, n]
    q = x.shape[0]
    y, want, cnt = _hybrid_directed(cfg, arrs, x,
                                    vals[program.edge_msg.gather[0]], dopt)
    y_ext = torch.cat([y, torch.full((q, 1), ident, dtype=y.dtype,
                                     device=y.device)], dim=1)
    acc = y_ext[:, arrs["hid"]]               # back to [Q, Pl, v_max]
    new_state, finished = program.apply_fn(state, acc, float(step))
    if dopt is not None:
        new_state = dict(new_state, **_dopt_fold(dopt, want, cnt))
    return new_state, finished


@dataclasses.dataclass(frozen=True)
class _ShardCfg(_HybridCfg):
    """One rank's slice of a sharded hybrid split
    (``hybrid.ShardHybridData``).  ``num_vertices`` is the shard's real
    hybrid vertices (its messages ``x`` have ``n_max`` columns).  Beside
    the split's tensors, ``arrs`` holds ``vmask``, the boundary edges
    (``b_src``/``b_flat``/``b_weight``), ``send_idx`` (remote slots) and
    ``in_parts``: per source partition, the positions of its values in
    ``[received wire | own outbox]`` and their scatter ids."""

    combine: str = SUM
    weight_op: Optional[str] = None   # the boundary leg's ⊗
    pl: int = 1
    v_max: int = 0
    num_slots: int = 0
    has_boundary: bool = False        # any shard has boundary edges
    has_remote: bool = False          # any slot crosses shards


def _superstep_hybrid_dist(program: VertexProgram, cfg: _ShardCfg,
                           arrs: dict, group: ShardGroup, state: State,
                           step: int) -> Tuple[State, torch.Tensor]:
    """One BSP superstep of the sharded degree-split backend, on one rank.

    ``state`` leaves are the rank's ``[Q, pl, v_max]`` slice.  The paper's
    cycle, per shard:

      1. evaluate the EdgeMessage once per local vertex (⊗-identity weight)
         and run the two-engine SpMV over the shard's intra-partition edges
         (with the push/pull vote for min combines);
      2. reduce boundary messages into outbox slots at the source
         (``ops.outbox_reduce_op``, §3.4), so the wire carries aggregated
         slots, never per-edge messages;
      3. exchange only the used (shard, peer) slot blocks in one
         ``all_to_all`` (Fig. 6's outbox-to-inbox copy); same-shard slots
         are read from the outbox directly;
      4. scatter the inbox values into the local accumulator, one pass per
         source partition (each sends a vertex at most one slot, so no
         pass writes an id twice and sums keep one order), combine with
         the SpMV result, apply and vote (a global AND).
    """
    spec = program.edge_msg
    _require_f32(spec, state, HYBRID)
    ident = add_identity(cfg.semiring)
    state, dopt = _dopt_strip(state)
    vals, x = _hybrid_messages(program, arrs, state, step)    # [Q, n_max]
    x = torch.where(arrs["vmask"], x, ident)    # pad ids never contribute
    q = x.shape[0]
    y, want, cnt = _hybrid_directed(cfg, arrs, x, vals[spec.gather[0]],
                                    dopt, vmask=arrs["vmask"])
    y_ext = torch.cat([y, torch.full((q, 1), ident, dtype=y.dtype,
                                     device=y.device)], dim=1)
    acc = y_ext[:, arrs["hid"]]                          # [Q, pl, v_max]

    if cfg.has_boundary:
        if "b_src" in arrs:
            if dopt is not None:
                # the boundary leg pushes whichever way the intra step
                # went: charge its live edges in both directions (each
                # live vertex's count of boundary out-edges)
                cnt = cnt + torch.where(x != ident, arrs["b_deg"], 0).sum(1)
            outbox = outbox_reduce_op(
                x, arrs["b_src"], arrs["b_flat"], arrs.get("b_weight"),
                num_slots=cfg.num_slots, combine=cfg.combine,
                weight_op=cfg.weight_op)                 # [Q, num_slots]
        else:   # this shard has no boundary edge
            outbox = torch.full((q, cfg.num_slots), ident,
                                dtype=torch.float32, device=x.device)
        inbound = outbox
        if cfg.has_remote:
            obox_ext = torch.cat([outbox, torch.full(
                (q, 1), ident, dtype=outbox.dtype, device=outbox.device)], 1)
            send = obox_ext[:, arrs["send_idx"]]         # [Q, S, w]
            recv = group.all_to_all(send.transpose(0, 1))    # [S, Q, w]
            inbound = torch.cat([recv.transpose(0, 1).reshape(q, -1),
                                 outbox], dim=1)
        racc = torch.full((q, cfg.pl * (cfg.v_max + 1)), ident,
                          dtype=torch.float32, device=x.device)
        for pos, ids in arrs["in_parts"]:
            racc[:, ids] = _combine(cfg.combine, racc[:, ids],
                                    inbound[:, pos])
        racc = racc.view(q, cfg.pl, cfg.v_max + 1)[:, :, :cfg.v_max]
        acc = _combine(cfg.combine, acc, racc)

    new_state, finished = program.apply_fn(state, acc, float(step))
    if dopt is not None:
        new_state = dict(new_state, **_dopt_fold(dopt, want, cnt))
    return new_state, group.all_true(finished)


def _edges_dict(ea: EdgeArrays, blk: Optional[BlockMetadata],
                device: torch.device) -> dict:
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    d = dict(src=put(ea.src, torch.int64), dst_ext=put(ea.dst_ext, torch.int64),
             inbox_dst=put(ea.inbox_dst, torch.int64))
    if ea.weight is not None:
        d["weight"] = put(ea.weight, torch.float32)
    if blk is not None:
        d["blk_src"] = put(blk.src, torch.int32)
        d["blk_local"] = put(blk.local, torch.int32)
        d["blk_mask"] = put(blk.mask, torch.int32)
        d["blk_base"] = put(blk.base, torch.int32)
        if blk.weight is not None:
            d["weight_blk"] = put(blk.weight, torch.float32)
    return d


def _run_batched_loop(step_fn: Callable, max_steps: int, state: State,
                      q: int) -> Tuple[State, torch.Tensor]:
    """Advance all Q queries together until every query votes finish.

    A converged query is masked out of the apply step — its state freezes
    bitwise — while unfinished queries continue.  Returns the final state
    and per-query executed superstep counts ``steps [Q]``.
    """
    dev = next(iter(state.values())).device
    fin = torch.zeros(q, dtype=torch.bool, device=dev)
    steps_q = torch.zeros(q, dtype=torch.int32, device=dev)
    step = 0
    while step < max_steps and not bool(fin.all()):
        new, vote = step_fn(state, step)
        state = {k: torch.where(fin.view((-1,) + (1,) * (v.dim() - 1)),
                                state[k], v) for k, v in new.items()}
        steps_q += (~fin).to(torch.int32)
        fin = fin | vote
        step += 1
    return state, steps_q


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; ROADMAP.md Queue 1 item {item} brings it")


class BSPEngine:
    """Single-device engine: all P partitions stacked on axis 0.

    ``backend="reference"`` — gather → [Q, Pl, e_max] messages → segment
    reduce (the correctness oracle).  ``backend="fused"`` — the fused
    superstep kernel for programs that carry an :class:`EdgeMessage`; a
    program without one runs the reference compute.  ``fused=True`` is the
    back-compat spelling.  The engine runs on ``cuda`` unless ``device``
    names another device, and raises when no card is present.

    Min-combine programs with an ``EdgeMessage`` (BFS, SSSP, CC) run
    direction optimized on both backends: ``direction="auto"`` votes per
    query and superstep with the perf model's fitted crossover
    (``pull_threshold`` overrides it), ``"push"``/``"pull"`` force one
    direction, and ``direction_switch=False`` runs plain push without the
    vote.  Programs on the reverse edges, and state that is not float32,
    run push only.  The transposed rows the pull direction scans are built
    with the engine, like the fused block metadata.  ``execute`` records
    per-query aggregates in ``last_direction_stats``: ``direction [Q, P]``
    (the last superstep's; -1 if none ran), ``edges_examined [Q]`` and
    ``switches [Q]``.

    ``backend="hybrid"`` runs each superstep as a whole-graph semiring SpMV
    through the degree split (``core/hybrid.py``; needs ``pg.source``):
    ``hybrid_k_dense=None`` lets the performance model pick |H|
    (``hybrid_plan()`` reports the decision), an int fixes it.  Min
    programs vote push or pull per query and superstep with the hybrid
    crossover; the degree split of each direction and semiring is built at
    a program's first run and kept on ``pg`` (``hybrid.splits_of``), so
    engines over one graph share it.  Programs without an eligible
    ``EdgeMessage`` run the reference compute; eligible ones take float32
    state only, as on the fused backend.

    Not ported yet (each raises ``NotImplementedError``): ``tiered=`` and
    dynamic graphs.
    """

    def __init__(self, pg: PartitionedGraph, *, backend: Optional[str] = None,
                 fused: bool = False, block_e: int = 1024,
                 device: DeviceLike = None, direction: str = "auto",
                 direction_switch: bool = True,
                 pull_threshold: Optional[float] = None,
                 hybrid_k_dense: Optional[int] = None, tiered=None):
        if backend is None:
            backend = FUSED if fused else REFERENCE
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; pick one of "
                             f"{BACKENDS}")
        if direction not in _DIRECTIONS:
            raise ValueError(f"direction must be one of {sorted(_DIRECTIONS)}"
                             f", got {direction!r}")
        if tiered is not None:
            raise _not_in_slice("tiered=", "12")
        if not isinstance(pg, PartitionedGraph):
            raise _not_in_slice(
                f"an engine over {type(pg).__name__} (dynamic graphs)", "11")
        self.backend = backend
        self.fused = backend == FUSED
        self.device = resolve_device(device)
        self._parts = self._shard_parts(pg)
        self.direction = direction
        self._direction_switch = direction_switch
        self._pull_threshold = pull_threshold
        self._pull: Optional[_PullLayout] = None
        self.last_direction_stats: Optional[dict] = None
        self._block_e = block_e
        self.pg = pg
        self.dims = _Dims(pg.num_parts, pg.v_max, pg.fwd.e_max, pg.fwd.o_max)
        # this engine's partitions (all of them on one device): the edge,
        # block and pull arrays it puts on its device
        local = [slice_parts(ea, *self._parts) if ea is not None else None
                 for ea in (pg.fwd, pg.rev)]
        blks = [build_block_metadata(ea, block_e=block_e)
                if self.fused and ea is not None else None for ea in local]
        self._fwd, self._rev = (
            _edges_dict(ea, blk, self.device) if ea is not None else None
            for ea, blk in zip(local, blks))
        self._hybrid_plan: Optional[dict] = None
        self._hybrid_cache: dict = {}
        self._hybrid_layouts: dict = {}
        if backend == HYBRID:
            if pg.source is None:
                raise ValueError(
                    "the hybrid backend needs PartitionedGraph.source; "
                    "partition with core.partition.partition()")
            self._splits = splits_of(pg)
            self._hybrid_plan = self._plan_hybrid(hybrid_k_dense, block_e)
        elif direction_switch:
            self._pull = self._build_pull_layout()

    def _shard_parts(self, pg: PartitionedGraph) -> Tuple[int, int]:
        """The partitions ``[lo, hi)`` this engine holds: all of them."""
        return 0, pg.num_parts

    def _plan_hybrid(self, k_dense: Optional[int], block_e: int) -> dict:
        """The split decision (``hybrid.SplitCache.plan``)."""
        return self._splits.plan(k_dense, block_e)

    def edges_for(self, program: VertexProgram) -> dict:
        if program.use_reverse:
            if self._rev is None:
                raise ValueError("program needs reverse edges; partition with "
                                 "include_reverse=True")
            return self._rev
        return self._fwd

    def dims_for(self, edges: dict) -> _Dims:
        return _Dims(self.dims.num_parts, self.dims.v_max,
                     edges["src"].shape[1], edges["inbox_dst"].shape[2])

    # ------------------ direction-optimized traversal ----------------------

    def _dopt_cfg_for(self, program: VertexProgram,
                      state: State) -> Optional[_DoptCfg]:
        """The program's direction settings, or None when it runs push
        only: the switch is off, the combine is not a min, the program has
        no EdgeMessage, runs on the reverse edges, weighs its messages other
        than by adding, or its gathered state is not float32 (the pull
        direction computes in float32)."""
        spec = program.edge_msg
        if (self._pull is None or program.combine != MIN
                or spec is None or program.use_reverse):
            return None
        semiring = "min"
        if spec.use_weight:
            if spec.weight_op != "add" or self.pg.fwd.weight is None:
                return None
            semiring = "min_plus"
        for k in spec.gather + spec.consts:
            if state[k].is_floating_point() and state[k].dtype != (
                    torch.float32):
                return None
        return _DoptCfg(semiring=semiring, uniform=spec.frontier_uniform,
                        forced=_DIRECTIONS[self.direction])

    def _build_pull_layout(self) -> _PullLayout:
        """The transposed rows of this engine's partitions and the vote's
        inputs.  The per-partition crossovers are fitted on the whole
        graph's rows (their ``kmax``), as the JAX package fits them before
        sharding."""
        pg, (lo, hi) = self.pg, self._parts
        v_max = pg.v_max
        tc = build_transposed_csc(pg.fwd, v_max)
        vmask_all = np.asarray(pg.vertex_mask, dtype=bool)
        nreal_p = np.maximum(vmask_all.sum(axis=1), 1).astype(np.float64)
        if self._pull_threshold is not None:
            thr = np.full(pg.num_parts, self._pull_threshold, np.float32)
        else:
            thr = fit_shard_pull_thresholds(
                tc.deg_out.sum(axis=1) / nreal_p, [tc.kmax] * pg.num_parts,
                backend=self.backend)
        # One direction serves every local partition, so the crossover is
        # the edge-mass blend of their fits, in float32 as the JAX engine
        # computes it (a shard blends its own partitions').
        deg, vmask = tc.deg_out[lo:hi], vmask_all[lo:hi]
        emass = deg.sum(axis=1).astype(np.float32)
        threshold = (np.sum(thr[lo:hi].astype(np.float32) * emass,
                            dtype=np.float32)
                     / np.maximum(np.sum(emass, dtype=np.float32),
                                  np.float32(1.0)))
        # the local rows; their sources lie in the same partition
        r0, r1 = lo * v_max, hi * v_max
        s0, s1 = int(tc.row_ptr[r0]), int(tc.row_ptr[r1])
        bnd_edges = None
        local = slice_parts(pg.fwd, lo, hi)
        if bool((local.edge_mask & (local.dst_ext > v_max)).any()):
            fwd = self._fwd
            bnd_edges = dict(fwd, dst_ext=torch.where(
                fwd["dst_ext"] < v_max, v_max, fwd["dst_ext"]))
            if "blk_mask" in fwd:
                ids = fwd["blk_base"].repeat_interleave(
                    self._block_e, dim=1) + fwd["blk_local"]
                bnd_edges["blk_mask"] = fwd["blk_mask"] * (ids > v_max).to(
                    torch.int32)

        put = self._put
        return _PullLayout(
            row_ptr=put(tc.row_ptr[r0:r1 + 1] - s0, torch.int32),
            col=put(tc.col[s0:s1] - r0, torch.int32),
            val=(put(tc.val[s0:s1], torch.float32) if tc.val is not None
                 else None),
            vmask=put(vmask, torch.bool),
            nreal=float(max(int(vmask.sum()), 1)),
            deg=put(deg, torch.int64), bnd=put(tc.deg_bnd[lo:hi], torch.int64),
            threshold=float(threshold), bnd_edges=bnd_edges)

    # ---------------------- hybrid backend ---------------------------------

    def hybrid_plan(self) -> Optional[dict]:
        """The perf-model split decision (k_dense, mode, ranked table), or
        None when the engine is not the hybrid backend."""
        return self._hybrid_plan

    def _hybrid_semiring(self, program: VertexProgram) -> Optional[str]:
        """Semiring the hybrid backend runs ``program`` under, or None when
        it is ineligible (no EdgeMessage, or a weight that does not enter
        the message as the combine's ⊗)."""
        spec = program.edge_msg
        if spec is None:
            return None
        if spec.use_weight:
            if program.combine == MIN and spec.weight_op == "add":
                return MIN_PLUS
            if program.combine == SUM and spec.weight_op == "mul":
                return PLUS_TIMES
            return None
        return PLUS_TIMES if program.combine == SUM else "min"

    def _uses_hybrid(self, program: VertexProgram) -> bool:
        return (self.backend == HYBRID
                and self._hybrid_semiring(program) is not None)

    def provides_reverse(self, program: VertexProgram) -> bool:
        """True when the engine serves a ``use_reverse`` program without
        ``pg.rev``: the hybrid backend degree-splits the reverse graph
        itself."""
        return self._uses_hybrid(program)

    def _hybrid_key(self, program: VertexProgram):
        # use_weight: a weighted and a weightless program can share a
        # semiring but need different ⊗ values; frontier_uniform: it is
        # baked into the static cfg (the scan's early-exit licence).
        return (self._hybrid_semiring(program), program.use_reverse,
                program.edge_msg.use_weight,
                program.edge_msg.frontier_uniform)

    def _put(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=self.device)

    def _hybrid_layout(self, reverse: bool):
        """One direction's split layout (``pg``'s ``SplitCache``) and its
        semiring-free tensors, put once and shared by the programs of that
        direction."""
        hit = self._hybrid_layouts.get(reverse)
        if hit is not None:
            return hit
        g = self._splits.graph(reverse)
        layout = self._splits.layout(self._hybrid_plan["k_dense"], reverse)
        asg = self.pg.assignment
        slot = (asg.part_of[layout.perm].astype(np.int64) * self.pg.v_max
                + asg.local_id[layout.perm])
        hid = np.full((self.pg.num_parts, self.pg.v_max), g.num_vertices,
                      dtype=np.int64)
        for p, l2g in enumerate(asg.l2g):
            hid[p, : len(l2g)] = layout.inv_perm[l2g]
        shared = dict(row_ptr=self._put(layout.row_ptr, torch.int32),
                      plan=layout.plan.to(self.device),
                      col=self._put(layout.src[layout.rest], torch.int32),
                      slot=self._put(slot, torch.int64),
                      hid=self._put(hid, torch.int64))
        self._hybrid_layouts[reverse] = (g, layout, shared)
        return g, layout, shared

    def _build_hybrid(self, program: VertexProgram) -> Tuple[_HybridCfg,
                                                             dict]:
        """One direction and semiring's degree split: the static cfg and
        the tensors ``_superstep_hybrid`` reads."""
        semiring = self._hybrid_semiring(program)
        g, layout, shared = self._hybrid_layout(program.use_reverse)
        hg = self._splits.split(layout.k_dense, program.use_reverse, semiring,
                                program.edge_msg.use_weight)
        arrs = dict(shared, dense=self._put(hg.dense_block, torch.float32),
                    val=self._put(hg.ell_val, torch.float32))
        if program.combine == MIN and self._direction_switch:
            arrs["push_src"] = self._put(layout.src, torch.int64)
            arrs["push_dst"] = self._put(layout.dst, torch.int64)
            if semiring == MIN_PLUS and g.weights is not None:
                arrs["push_w"] = self._put(g.weights, torch.float32)
        n = g.num_vertices
        thr = self._pull_threshold
        if thr is None:
            thr = perf_model.fit_pull_threshold(g.num_edges / max(n, 1),
                                                hg.kmax, backend=HYBRID)
        cfg = _HybridCfg(semiring=semiring, k_dense=hg.k_dense,
                         num_vertices=n, kmax=hg.kmax,
                         pull_threshold=float(thr),
                         forced=_DIRECTIONS[self.direction],
                         uniform=program.edge_msg.frontier_uniform,
                         e_dense=int(hg.k_dense) ** 2)
        return cfg, arrs

    def hybrid_for(self, program: VertexProgram) -> Tuple[_HybridCfg, dict]:
        """The split ``program`` runs on: its static cfg and device tensors
        (``_superstep_hybrid``), built at the first call and cached per
        direction, semiring, weight use and frontier uniformity.  A run
        calls it; calling it first moves the host work out of the run."""
        key = self._hybrid_key(program)
        if key not in self._hybrid_cache:
            self._hybrid_cache[key] = self._build_hybrid(program)
        return self._hybrid_cache[key]

    def _direction_enabled(self, program: VertexProgram,
                           state: State) -> bool:
        """Does ``execute`` carry the direction leaves through ``program``?
        On the hybrid backend every eligible min program votes (its push
        edges come with the split); elsewhere see ``_dopt_cfg_for``."""
        if self._uses_hybrid(program):
            return self._direction_switch and program.combine == MIN
        return self._dopt_cfg_for(program, state) is not None

    # Local exchange: outbox[q, p, r] -> inbox[q, r, p] is a transpose over
    # the partition axes (the query axis rides along).
    @staticmethod
    def _exchange(outbox: torch.Tensor) -> torch.Tensor:
        return outbox.transpose(1, 2)

    # One device: each query's apply vote is already its global vote.
    @staticmethod
    def _all_finished(fin: torch.Tensor) -> torch.Tensor:
        return fin

    def _hybrid_step_fn(self, program: VertexProgram) -> Callable:
        cfg, arrs = self.hybrid_for(program)
        return functools.partial(_superstep_hybrid, program, cfg, arrs)

    def _step_fn(self, program: VertexProgram,
                 dopt_cfg: Optional[_DoptCfg] = None) -> Callable:
        if self._uses_hybrid(program):
            return self._hybrid_step_fn(program)
        edges = self.edges_for(program)
        dims = self.dims_for(edges)
        block_e = self._block_e if self.fused else None
        pull = self._pull if dopt_cfg is not None else None

        def step_fn(state, step):
            return _superstep(dims, program, edges, self._exchange,
                              self._all_finished, block_e, state, step,
                              dopt_cfg, pull)
        return step_fn

    def _local(self, state: State) -> State:
        """The engine's part of a global ``[Q, P, ...]`` state: all of it."""
        return state

    def _global(self, state: State) -> State:
        """The global state back from the engine's part."""
        return state

    def execute(self, program: VertexProgram, state: State, *,
                num_steps: Optional[int] = None, chunk: Optional[int] = None,
                incremental=None):
        """Run ``program`` on a batched ``[Q, P, v_max]`` state dict.

        - ``execute(program, state)`` — run to convergence; returns
          ``(state, steps_q [Q])``.
        - ``execute(program, state, num_steps=n)`` — exactly ``n``
          supersteps (PageRank); returns the final state.

        Leaves are moved to the engine's device.  Eligible min-combine
        programs run direction optimized (see the class docstring).  The
        chunked and incremental modes are not ported yet and raise.
        """
        if chunk is not None:
            raise _not_in_slice("execute(chunk=)", "9")
        if incremental is not None:
            raise _not_in_slice("execute(incremental=)", "11")
        self.last_direction_stats = None
        state = {k: torch.as_tensor(v, device=self.device)
                 for k, v in state.items()}
        dopt_cfg = self._dopt_cfg_for(program, state)
        if self._direction_enabled(program, state):
            q, parts = num_queries(state), self.pg.num_parts
            state = dict(
                state,
                _dopt_dir=torch.full((q, parts), -1, dtype=torch.int32,
                                     device=self.device),
                _dopt_edges=torch.zeros((q, parts), dtype=torch.int64,
                                        device=self.device),
                _dopt_switch=torch.zeros((q, parts), dtype=torch.int64,
                                         device=self.device))
        state = self._local(state)
        step_fn = self._step_fn(program, dopt_cfg)
        if num_steps is not None:
            for i in range(num_steps):
                state, _ = step_fn(state, i)
            return self._dopt_finish(self._global(state))
        state, steps_q = _run_batched_loop(step_fn, program.max_steps, state,
                                           num_queries(state))
        return self._dopt_finish(self._global(state)), steps_q

    def _dopt_finish(self, state: State) -> State:
        """Strip the direction leaves and record per-query aggregates."""
        state, dopt = _dopt_strip(state)
        if dopt is not None:
            self.last_direction_stats = dict(
                direction=dopt["_dopt_dir"].cpu().numpy(),
                edges_examined=dopt["_dopt_edges"].sum(1).cpu().numpy(),
                switches=dopt["_dopt_switch"].sum(1).cpu().numpy())
        return state


class DistributedBSPEngine(BSPEngine):
    """Partitions sharded over the ranks of a ``torch.distributed`` group.

    Each rank holds ``P / world`` consecutive partitions on its device and
    puts only their edge, block, pull-row and hybrid arrays there.  The
    exchange phase is an ``all_to_all`` (the paper's PCI-E outbox/inbox
    copy, Fig. 6) and the termination vote a global AND.  ``group`` is a
    process group, a :class:`~repro_torch.distributed.ShardGroup`, or None
    for a world of one (one process, no process group); ``device`` is the
    rank's device, ``cuda`` unless named.  ``execute`` takes and returns
    the global ``[Q, P, v_max]`` state on every rank: it slices the rank's
    partitions on entry and all-gathers them on exit, so the algorithms'
    entry points run unchanged.

    The reference and fused backends vote per shard: the crossover is the
    edge-mass blend of the shard's own partitions' fits, and each shard
    counts its examined edges and switches in its first column of the
    ``[Q, P]`` direction leaves.  ``backend="hybrid"`` runs the paper's
    configuration: every shard runs its own degree split over its
    intra-partition edges (``hybrid.shard_degree_split``, |H| per shard
    from ``perf_model.plan_shards``, reported by ``hybrid_plan()``), while
    boundary messages are reduced into outbox slots at the source
    (``kernels/outbox_reduce.py``) and only the used slots cross the wire.
    Unlike the single-device hybrid, ``use_reverse`` programs (BC) need
    ``include_reverse=True`` partitioning: reverse boundary edges route
    through the reverse outbox maps.

    Not ported yet: ``tiered=`` raises (single-device only, as in the JAX
    package), dynamic graphs raise (Queue 1 item 11), and so do chunked
    windows and their checked exchange (items 9 and 13).
    """

    def __init__(self, pg: PartitionedGraph, group=None, *,
                 device: DeviceLike = None, tiered=None, **kwargs):
        if tiered is not None:
            raise ValueError(
                "tiered= is single-device only: the sharded superstep has "
                "no host-streaming seam; drop tiered= or use BSPEngine")
        if not isinstance(pg, PartitionedGraph):
            raise _not_in_slice(
                f"a sharded engine over {type(pg).__name__} (dynamic "
                f"graphs)", "11")
        self.group = (group if isinstance(group, ShardGroup)
                      else ShardGroup(group, device))
        if pg.num_parts % self.group.world_size:
            raise ValueError(
                f"num_parts ({pg.num_parts}) must divide over the world size "
                f"({self.group.world_size}): every rank holds the same number "
                f"of partitions")
        super().__init__(pg, device=self.group.device, **kwargs)

    def _shard_parts(self, pg: PartitionedGraph) -> Tuple[int, int]:
        pl = pg.num_parts // self.group.world_size
        return self.group.rank * pl, (self.group.rank + 1) * pl

    # ------------------------- state and votes -----------------------------

    def _validate_state(self, state: State) -> None:
        """Fail fast on mis-sharded inputs: every leaf must be a global
        ``[Q, num_parts, ...]`` array (the exchange mis-routes otherwise)."""
        for k, v in state.items():
            if v.dim() < 2 or v.shape[1] != self.pg.num_parts:
                raise ValueError(
                    f"state leaf {k!r} has shape {tuple(v.shape)}, expected "
                    f"[Q, num_parts={self.pg.num_parts}, ...]: every rank "
                    f"passes the global state and holds its own partitions")

    def _local(self, state: State) -> State:
        self._validate_state(state)
        lo, hi = self._parts
        return {k: v[:, lo:hi] for k, v in state.items()}

    def _global(self, state: State) -> State:
        return {k: self.group.all_gather(v, dim=1) for k, v in state.items()}

    def _exchange(self, outbox: torch.Tensor) -> torch.Tensor:
        """Outboxes ``[Q, pl, P, o_max]`` -> inboxes of the same shape (the
        JAX ``_dist_exchange``): the peer axis regroups as (rank, local
        partition), moves to the front for ``all_to_all``, and comes back."""
        q, pl, peers, o = outbox.shape
        world = self.group.world_size
        if peers != world * pl:
            raise ValueError(
                f"outbox shape {tuple(outbox.shape)} is inconsistent with the "
                f"group: the peer axis ({peers}) must equal the world size "
                f"({world}) x local partitions ({pl})")
        send = outbox.reshape(q, pl, world, pl, o).permute(2, 0, 1, 3, 4)
        recv = self.group.all_to_all(send)   # [world, Q, pl_src, pl_dst, o]
        return recv.permute(1, 3, 0, 2, 4).reshape(q, pl, peers, o)

    def _all_finished(self, fin: torch.Tensor) -> torch.Tensor:
        """Per-shard votes ``[Q]`` -> the global AND (JAX
        ``_dist_finished``)."""
        return self.group.all_true(fin)

    # ------------------------ sharded hybrid -------------------------------

    def provides_reverse(self, program: VertexProgram) -> bool:
        """False: the sharded hybrid routes reverse boundary edges through
        the reverse outbox maps, which only ``include_reverse=True``
        partitioning builds."""
        return False

    def _plan_hybrid(self, k_dense: Optional[int], block_e: int) -> dict:
        """Per-shard split decision (``hybrid.SplitCache.shard_plan``): each
        shard's |H| minimises its own exchange-inclusive makespan (Eq. 1),
        the system's is the max over shards (Eq. 2)."""
        return self._splits.shard_plan(self.group.world_size, k_dense,
                                       block_e)

    def hybrid_for(self, program: VertexProgram) -> Tuple[_ShardCfg, dict]:
        """This rank's slice of the per-shard split ``program`` runs on (the
        JAX ``_hybrid_dist_for``): its static cfg and device tensors, built
        at the first call (the split itself is kept on ``pg``) and cached
        per direction, semiring, weight use and frontier uniformity."""
        key = self._hybrid_key(program)
        if key not in self._hybrid_cache:
            self._hybrid_cache[key] = self._build_shard(program)
        return self._hybrid_cache[key]

    def _build_shard(self, program: VertexProgram) -> Tuple[_ShardCfg,
                                                             dict]:
        spec = program.edge_msg
        semiring = self._hybrid_semiring(program)
        world, s = self.group.world_size, self.group.rank
        ks = [rec["k_dense"] for rec in self._hybrid_plan["per_shard"]]
        shd = self._splits.shard_split(
            world, ks, program.use_reverse, semiring, spec.use_weight,
            program.combine == MIN and self._direction_switch)
        k, n_max, put = ks[s], shd.n_max, self._put
        arrs = dict(slot=put(shd.slot[s], torch.int64),
                    vmask=put(np.arange(n_max) < shd.n_vert[s], torch.bool),
                    hid=put(shd.hid[s], torch.int64),
                    dense=put(shd.dense[s, :k, :k], torch.float32),
                    row_ptr=put(shd.ell_row_ptr[s], torch.int32),
                    plan=shd.ell_plan[s].to(self.device),
                    col=put(shd.ell_col[s], torch.int32),
                    val=put(shd.ell_val[s], torch.float32))
        # An unweighted graph packs the ⊗ identity (zero-cost hops,
        # multiplicity one), so its boundary leg takes no weight either.
        b_src, b_flat, b_w = shd.boundary(s)
        weight_op = spec.weight_op if spec.use_weight and (
            b_w is not None) else None
        if len(b_src):
            arrs["b_src"] = put(b_src, torch.int32)
            arrs["b_flat"] = put(b_flat, torch.int32)
            # boundary out-edges per source: the vote's work count
            arrs["b_deg"] = put(np.bincount(b_src, minlength=n_max),
                                torch.int64)
            if weight_op is not None:
                arrs["b_weight"] = put(b_w, torch.float32)
        # Inbound values: [received wire (world * w) | own outbox]; per
        # source partition, the positions of its values and their ids.
        pos, src_p, ids = [], [], []
        width = 0
        if shd.has_remote:
            arrs["send_idx"] = put(shd.send_idx[s], torch.int64)
            width = world * shd.wire_width
            pos.append(np.arange(width))
            src_p.append(shd.recv_src[s].reshape(-1))
            ids.append(shd.recv_ids[s].reshape(-1))
        pos.append(width + shd.loc_idx[s])
        src_p.append(shd.loc_src[s])
        ids.append(shd.loc_ids[s])
        pos, src_p, ids = (np.concatenate(a) for a in (pos, src_p, ids))
        arrs["in_parts"] = [
            (put(pos[src_p == p], torch.int64),
             put(ids[src_p == p], torch.int64))
            for p in np.unique(src_p[src_p >= 0])]
        if shd.push_src is not None:
            n = int(shd.n_intra[s])
            arrs["push_src"] = put(shd.push_src[s, :n], torch.int64)
            arrs["push_dst"] = put(shd.push_dst[s, :n], torch.int64)
            if shd.push_w is not None:
                arrs["push_w"] = put(shd.push_w[s, :n], torch.float32)
        thr = self._pull_threshold
        if thr is None:
            # per shard: its intra slots (remainder + the dense charge)
            # per vertex, and the widest remainder row over the shards
            nv = np.maximum(shd.n_vert.astype(np.float64), 1.0)
            intra = (shd.ell_row_ptr[:, -1].astype(np.int64)
                     + np.asarray(ks, np.int64) ** 2)
            thr = perf_model.fit_shard_pull_thresholds(
                intra / nv, [shd.kmax] * world, backend=HYBRID)[s]
        rows = np.diff(shd.ell_row_ptr[s])
        cfg = _ShardCfg(
            semiring=semiring, k_dense=k, num_vertices=int(shd.n_vert[s]),
            kmax=max(int(rows.max(initial=0)), 1),
            pull_threshold=float(thr), forced=_DIRECTIONS[self.direction],
            uniform=spec.frontier_uniform, e_dense=k * k,
            combine=program.combine, weight_op=weight_op,
            pl=shd.parts_per_shard, v_max=shd.v_max,
            num_slots=shd.num_slots, has_boundary=shd.has_boundary,
            has_remote=shd.has_remote)
        return cfg, arrs

    def _hybrid_step_fn(self, program: VertexProgram) -> Callable:
        cfg, arrs = self.hybrid_for(program)
        return functools.partial(_superstep_hybrid_dist, program, cfg, arrs,
                                 self.group)
