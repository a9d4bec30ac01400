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
from repro_torch.core.graph import CSRGraph
from repro_torch.core.hybrid import (MIN_PLUS, PLUS_TIMES, add_identity,
                                     degree_split, dense_stage,
                                     edge_max_ranks, hybrid_spmv,
                                     hybrid_spmv_scan, split_layout,
                                     splits_of)
from repro_torch.core.partition import (BlockMetadata, EdgeArrays,
                                        NoCleanCutError, PartitionedGraph,
                                        TierPlan,
                                        build_block_metadata, build_tier_plan,
                                        build_transposed_csc,
                                        memory_residency_bytes, slice_parts)
from repro_torch.core.perf_model import fit_shard_pull_thresholds
from repro_torch.core.tiered import HostArena, OverlayArena, WindowStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import ShardGroup
from repro_torch.kernels.ell_spmv import (EllPlan, plan_lanes,
                                          query_minor_view, row_plan)
from repro_torch.kernels.fused_superstep import stack_query_minor
from repro_torch.kernels.ops import (bottomup_scan_op, ell_spmv_op,
                                     fused_superstep_op, outbox_reduce_op)
from repro_torch.kernels.ref import (MIN, SEMIRINGS, SUM, identity,
                                     segment_reduce_ref)
from repro_torch.runtime import chaos, tracing
from repro_torch.runtime.failures import ExchangeCorruption

State = Dict[str, torch.Tensor]  # batched: leaves [Q, Pl, ...]

REFERENCE = "reference"
FUSED = "fused"
HYBRID = "hybrid"
BACKENDS = (REFERENCE, FUSED, HYBRID)

__all__ = ["SUM", "MIN", "REFERENCE", "FUSED", "HYBRID", "BACKENDS",
           "EdgeMessage", "IncrementalForm", "VertexProgram", "BSPEngine",
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
class IncrementalForm:
    """A program's warm-start form for incremental recomputation.

    ``program`` is the *relaxation* restatement of the algorithm, whose
    fixpoint is reachable by descent from any over-approximation, not just
    from the cold initial state (BFS's level-synchronous frontier test
    becomes an active-set min-relaxation over levels).  ``seed(prev_state,
    dirty)`` builds the warm initial state from a previous *fixpoint* and a
    ``[P, v_max]`` dirty-vertex mask (the sources of edges inserted since
    that fixpoint was computed).

    Valid only while mutations stay **monotone** for the program's semiring
    (insert-only for min/min-plus: new edges can only lower the least
    fixpoint, so the old solution is a sound over-approximation and every
    old path survives, which makes the warm fixpoint bitwise the cold one).
    Deletions, and programs that are not monotone (PageRank, BC), take the
    cold path: ``execute(incremental=)`` returns None for a program without
    a form, and ``DynamicGraph.dirty_since`` reports whether a window was
    monotone.
    """

    program: "VertexProgram"
    seed: Callable[[State, torch.Tensor], State]


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """An algorithm in TOTEM's callback form (paper Fig. 5), on batched state.

    ``edge_fn(state, src, weight, step) -> msgs [Q, Pl, e_max]`` — the
    per-edge part of ``alg_compute`` (inactive sources send the combine
    identity).  ``apply_fn(state, acc, step) -> (new_state, finished [Q])``
    — the per-vertex update on the reduced ``[Q, Pl, v_max]`` accumulator and
    each query's vote to terminate.  ``edge_msg`` makes the program eligible
    for the fused backend; ``incremental`` (an :class:`IncrementalForm`)
    enables warm starts after monotone mutations
    (``execute(incremental=)``).
    """

    combine: str
    edge_fn: Callable[[State, torch.Tensor, Optional[torch.Tensor], float],
                      torch.Tensor]
    apply_fn: Callable[[State, torch.Tensor, float],
                       Tuple[State, torch.Tensor]]
    max_steps: int = 1 << 30
    use_reverse: bool = False
    edge_msg: Optional[EdgeMessage] = None
    incremental: Optional[IncrementalForm] = None


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


def _fused_inputs(spec: EdgeMessage, state: State,
                  step: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused kernel's state ``[Q, Pl, K, v_max]`` (a view of its
    query-minor buffer: one copy per superstep) and scalars
    ``[Q, Pl, 1 + consts]`` (the superstep, then the consts)."""
    _require_f32(spec, state, FUSED)
    vstate = stack_query_minor([state[k] for k in spec.gather])
    q, pl = vstate.shape[:2]
    cols = [torch.full((q, pl), float(step), dtype=torch.float32,
                       device=vstate.device)]
    cols += [state[c].float() for c in spec.consts]
    return vstate, torch.stack(cols, dim=2)


def _compute_fused(dims: _Dims, program: VertexProgram, edges: dict,
                   block_e: int, state: State, step: int) -> torch.Tensor:
    """Fused compute: one kernel launch per superstep on the card, no
    [Q, Pl, e_max] message array (kernels/fused_superstep.py)."""
    # fault site: a raise here surfaces to the dispatching host as a kernel
    # fault (the degradation ladder's retry point).  Visited at every call:
    # the JAX package visits it once per trace.
    chaos.visit("kernel.fused", block_e=block_e)
    spec = program.edge_msg
    vstate, scal = _fused_inputs(spec, state, step)
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
    plan: EllPlan                  # the scan kernel's row plan of row_ptr
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
    either way), the local region comes from the bottom-up scan, which
    reads the messages from one query-minor copy.  Returns the accumulator
    and each query's scanned slots."""
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
    xq = query_minor_view(xv.reshape(q, pl * v_max), math.inf)
    y, scanned = bottomup_scan_op(
        pull.row_ptr, pull.col, val, xq, semiring=cfg.semiring,
        early_exit=cfg.uniform, skip=skip, plan=pull.plan)
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
    with tracing.span("bsp.messages"):
        vvals = {k: state[k].float() for k in spec.gather}
        vconsts = {c: state[c][:, :, None].float() for c in spec.consts}
        w_ident = 0.0 if spec.use_weight else None   # weight_op "add"
        # per-vertex messages: the push direction's per-edge messages are
        # gathers of these values
        xv = spec.fn(vvals, w_ident, float(step), vconsts).float()
    with tracing.span("bsp.vote"):
        act = (xv != math.inf) & pull.vmask
        density = act.sum((1, 2)).float() / pull.nreal
        first = vvals[spec.gather[0]]
        unvisited = ((first == math.inf) & pull.vmask).sum((1, 2)).float() / (
            pull.nreal)
        want = _dopt_want(cfg.forced, density, unvisited, pull.threshold)
        cnt_push = (act * pull.deg).sum((1, 2))
        cnt_bnd = (act * pull.bnd).sum((1, 2))
    picked = _vote_read(want)
    if picked == {_DIR_PUSH}:
        with tracing.span("bsp.push"):
            acc, cnt = compute_push(state), cnt_push
    else:
        with tracing.span("bsp.pull"):
            acc, scanned = _compute_pull(dims, cfg, pull, compute_push, state,
                                         xv, first)
            cnt = scanned + cnt_bnd
        if picked != {_DIR_PULL}:
            sel = want == _DIR_PULL
            with tracing.span("bsp.push"):
                push = compute_push(state)
            acc = torch.where(sel[:, None, None], acc, push)
            cnt = torch.where(sel, cnt, cnt_push)
    return acc, _dopt_fold(dopt, want, cnt)


def _vote_read(want: torch.Tensor) -> set:
    """The directions a superstep's queries voted, read to the host (the
    vote's one read), counted as a push, pull or mixed superstep."""
    with tracing.span("bsp.vote_read"):
        picked = set(want.tolist())
    tracing.count("bsp.supersteps.push" if picked == {_DIR_PUSH} else
                  "bsp.supersteps.pull" if picked == {_DIR_PULL} else
                  "bsp.supersteps.mixed")
    return picked


def _superstep(dims: _Dims, program: VertexProgram, edges: dict,
               exchange: Callable[[torch.Tensor], torch.Tensor],
               all_finished: Callable[[torch.Tensor], torch.Tensor],
               fused_block_e: Optional[int], state: State, step: int,
               dopt_cfg: Optional[_DoptCfg] = None,
               pull: Optional[_PullLayout] = None,
               delta: Optional[dict] = None
               ) -> Tuple[State, torch.Tensor]:
    """One BSP superstep of the whole query batch over the local partitions.

    ``exchange`` maps the outboxes ``[Q, pl, P, o_max]`` to the inboxes of
    the same shape (a transpose on one device, an ``all_to_all`` across
    shards); ``all_finished`` turns the local votes ``[Q]`` into global
    ones.  On a dynamic graph ``edges`` carries the run's tombstones
    (``BSPEngine._dyn_edges``) and ``delta`` the inserted edges' slots
    (``src``/``dst_ext``/``weight [pl, d_max]``): one reference compute
    over the same extended segment space, combined into the accumulator,
    so its boundary messages share the outbox slots and the exchange."""
    state, dopt = _dopt_strip(state)

    def compute_push(st, e=edges):
        if fused_block_e is not None and program.edge_msg is not None:
            return _compute_fused(dims, program, e, fused_block_e, st, step)
        return _compute_reference(dims, program, e, st, step)

    if dopt is not None:
        acc, dopt = _compute_directed(dims, program, dopt_cfg, pull,
                                      compute_push, state, step, dopt)
    else:
        with tracing.span("bsp.push"):
            acc = compute_push(state)
    if delta is not None:
        acc = _combine(program.combine, acc,
                       _compute_reference(dims, program, delta, state, step))
    with tracing.span("bsp.finish"):
        return _finish_superstep(dims, program, edges["inbox_dst"], exchange,
                                 all_finished, acc, state, step, dopt)


def _finish_superstep(dims: _Dims, program: VertexProgram,
                      inbox_dst: torch.Tensor,
                      exchange: Callable[[torch.Tensor], torch.Tensor],
                      all_finished: Callable[[torch.Tensor], torch.Tensor],
                      acc: torch.Tensor, state: State, step: int,
                      dopt: Optional[dict]) -> Tuple[State, torch.Tensor]:
    """The superstep after its compute phase, on the accumulator
    ``acc [Q, pl, seg]``: exchange, inbox scatter, apply and vote.  The
    resident and the tiered superstep both end here."""
    combine = program.combine
    q, pl = acc.shape[:2]
    v_max = dims.v_max
    local_acc = acc[:, :, :v_max]
    outbox = acc[:, :, v_max + 1:].reshape(q, pl, dims.num_parts, dims.o_max)

    # -- communicate: outbox -> symmetric inbox (paper Fig. 6) --------------
    with tracing.span("bsp.exchange"):
        inbox = exchange(outbox)                  # [Q, pl, P, o_max]

    # -- scatter: one pass per peer; each local vertex has at most one slot
    # per peer, so no segment receives two values in a pass and the sum
    # order is fixed (the peer order) on every device.
    with tracing.span("bsp.scatter"):
        racc = None
        for r in range(dims.num_parts):
            part = segment_reduce_ref(inbox[:, :, r], inbox_dst[:, r],
                                      v_max + 1, combine)
            racc = part if racc is None else _combine(combine, racc, part)
        total = _combine(combine, local_acc, racc[:, :, :v_max])

    # -- apply + vote (per query) -------------------------------------------
    with tracing.span("bsp.apply"):
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
    # the dynamic split's spare slots and push slots read the sentinel
    # column n of x, which holds the ⊕-identity
    spare: bool = False


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
                     vmask: Optional[torch.Tensor] = None,
                     xq: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                Optional[torch.Tensor]]:
    """The two-engine step over ``x [Q, n]``: ``(y, want, cnt)``.  The
    kernel ops read ``xq``, the superstep's one query-minor copy of ``x``
    (``ell_spmv.query_minor_view``), made here when a kernel op runs and
    the caller has none; the vote and the push read ``x``.

    Without direction leaves (``dopt`` None) it is the pull SpMV.  For min
    programs each query votes push (gather + segment min over the push
    edges: cheap when few vertices send) or pull (the two-engine step, its
    sparse stage through the bottom-up scan) on its frontier density over
    ``cfg.num_vertices`` real vertices (``vmask`` marks them where ``x``
    has padding, which must hold the identity); ``cnt`` is each query's
    work-model charge.
    """
    ident = add_identity(cfg.semiring)
    if dopt is None:
        with tracing.span("bsp.pull"):
            if xq is None:
                xq = query_minor_view(x, ident)
            return hybrid_spmv(arrs["dense"], arrs["row_ptr"], arrs["col"],
                               arrs["val"], xq, semiring=cfg.semiring,
                               k_dense=cfg.k_dense,
                               plan=arrs["plan"]), None, None
    with tracing.span("bsp.vote"):
        nf = float(max(cfg.num_vertices, 1))
        density = (x != ident).sum(1, dtype=torch.float32) / nf
        unvisited = first == ident
        if vmask is not None:
            unvisited = unvisited & vmask
        unvisited = unvisited.sum(1, dtype=torch.float32) / nf
        want = _dopt_want(cfg.forced, density, unvisited, cfg.pull_threshold)
    picked = _vote_read(want)
    if picked != {_DIR_PULL}:
        with tracing.span("bsp.push"):
            msgs = x[:, arrs["push_src"]]                  # [Q, E]
            if "push_w" in arrs:
                msgs = msgs + arrs["push_w"]
            y_push = segment_reduce_ref(msgs, arrs["push_dst"], x.shape[1],
                                        MIN)
            if cfg.spare:                       # the sentinel's own segment
                y_push = y_push[:, :-1]
            cnt_push = (msgs != ident).sum(1)
            del msgs
    if picked != {_DIR_PUSH}:
        with tracing.span("bsp.pull"):
            # Under the uniform licence a row already holding a value is
            # final: a sequential bottom-up pass skips it.
            skip = (first != ident) if cfg.uniform else None
            if xq is None:
                xq = query_minor_view(x, ident)
            y_pull, scanned = hybrid_spmv_scan(
                arrs["dense"], arrs["row_ptr"], arrs["col"], arrs["val"], xq,
                semiring=cfg.semiring, k_dense=cfg.k_dense, plan=arrs["plan"],
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
    chaos.visit("kernel.hybrid", distributed=False)
    _require_f32(program.edge_msg, state, HYBRID)
    state, dopt = _dopt_strip(state)
    with tracing.span("bsp.messages"):
        vals, x = _hybrid_messages(program, arrs, state, step)     # [Q, n]
        if cfg.spare:    # the sentinel column n that spare slots read
            x = torch.cat([x, torch.full((x.shape[0], 1), add_identity(
                cfg.semiring), dtype=x.dtype, device=x.device)], dim=1)
    y, want, cnt = _hybrid_directed(cfg, arrs, x,
                                    vals[program.edge_msg.gather[0]], dopt)
    with tracing.span("bsp.finish"):
        return _hybrid_finish(program, cfg, arrs["hid"], state, y, step,
                              dopt, want, cnt)


def _hybrid_finish(program: VertexProgram, cfg: _HybridCfg,
                   hid: torch.Tensor, state: State, y: torch.Tensor,
                   step: int, dopt: Optional[dict],
                   want: Optional[torch.Tensor],
                   cnt: Optional[torch.Tensor]) -> Tuple[State, torch.Tensor]:
    """The hybrid superstep after its SpMV ``y [Q, n]``: back to the
    ``[Q, Pl, v_max]`` layout (the sink ``n`` serving padding slots), apply
    and vote.  The resident and the tiered hybrid both end here."""
    q = y.shape[0]
    y_ext = torch.cat([y, torch.full((q, 1), add_identity(cfg.semiring),
                                     dtype=y.dtype, device=y.device)], dim=1)
    acc = y_ext[:, hid]                       # back to [Q, Pl, v_max]
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
                           step: int, guard: Optional["_ExchangeGuard"] = None
                           ) -> Tuple[State, torch.Tensor]:
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

    With ``guard`` (a chunk window) the exchange is checked: one reduction
    tag per destination rank ships over its own ``all_to_all`` and the
    receiver re-tags what it got (the JAX package's tagged compact
    exchange).  Where no slot crosses ranks (a world of one) there is no
    wire and the guard is inert, as in the JAX package.
    """
    chaos.visit("kernel.hybrid", distributed=True)
    spec = program.edge_msg
    _require_f32(spec, state, HYBRID)
    ident = add_identity(cfg.semiring)
    state, dopt = _dopt_strip(state)
    vals, x = _hybrid_messages(program, arrs, state, step)    # [Q, n_max]
    x = torch.where(arrs["vmask"], x, ident)    # pad ids never contribute
    q = x.shape[0]
    xq = query_minor_view(x, ident)   # one copy for the SpMV and the outbox
    y, want, cnt = _hybrid_directed(cfg, arrs, x, vals[spec.gather[0]],
                                    dopt, vmask=arrs["vmask"], xq=xq)
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
                xq, arrs["b_src"], arrs["b_flat"], arrs.get("b_weight"),
                num_slots=cfg.num_slots, combine=cfg.combine,
                weight_op=cfg.weight_op)                 # [Q, num_slots]
        else:   # this shard has no boundary edge
            outbox = torch.full((q, cfg.num_slots), ident,
                                dtype=torch.float32, device=x.device)
        inbound = outbox
        if cfg.has_remote:
            obox_ext = torch.cat([outbox, torch.full(
                (q, 1), ident, dtype=outbox.dtype, device=outbox.device)], 1)
            send = obox_ext[:, arrs["send_idx"]].transpose(0, 1)  # [S, Q, w]
            if guard is not None:
                tags = _payload_tag(send, (1, 2))              # [S]
                send = _flip_wire(send) if guard.poison else send
                want = group.all_to_all(tags.reshape(-1, 1)).reshape(-1)
            recv = group.all_to_all(send)                      # [S, Q, w]
            if guard is not None:
                guard.add((_payload_tag(recv, (1, 2)) != want).sum())
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


def _run_chunked_loop(step_fn: Callable, chunk: int, max_steps: int,
                      state: State, step0: int, fin0: torch.Tensor,
                      steps_q0: torch.Tensor
                      ) -> Tuple[State, int, torch.Tensor, torch.Tensor]:
    """Advance the query batch from a mid-run carry ``(state, step0, fin0,
    steps_q0)`` until every query votes finish, ``max_steps`` or ``step0 +
    chunk``; returns the carry.

    A converged query is masked out of the apply step — its state freezes
    bitwise — while unfinished queries continue; ``steps_q [Q]`` counts
    each query's executed supersteps.  Windows chained end to end run the
    superstep sequence of one unbounded window, which is the resident loop
    (``_run_batched_loop``).

    A checked window's :class:`_ExchangeGuard` rides in ``step_fn``, so
    one loop serves both (the JAX package needs a second loop, since a
    traced carry cannot hold the guard).
    """
    step, fin, steps_q = int(step0), fin0, steps_q0
    stop = min(max_steps, step + chunk)
    while step < stop:
        with tracing.span("bsp.loop_read"):
            done = bool(fin.all())
        if done:
            break
        with tracing.span("bsp.superstep", step=step):
            new, vote = step_fn(state, step)
            state = {k: torch.where(fin.view((-1,) + (1,) * (v.dim() - 1)),
                                    state[k], v) for k, v in new.items()}
            steps_q = steps_q + (~fin).to(torch.int32)
            fin = fin | vote
        step += 1
    return state, step, fin, steps_q


# ---------------------------------------------------------------------------
# The checked exchange (the silent-corruption defense of the chunk windows)
# ---------------------------------------------------------------------------

def _payload_tag(x: torch.Tensor, dims) -> torch.Tensor:
    """Order-independent int32 tag of a payload over ``dims``: the bit
    patterns as int32 (``view``, no conversion) in a wrapping int32 sum,
    as in the JAX package.  Any single-element change moves the sum by a
    nonzero delta mod 2^32, so a one-bit wire flip always mismatches."""
    words = x.view(torch.int32) if x.element_size() == 4 else x.to(
        torch.int32)
    return torch.sum(words, dim=dims, dtype=torch.int32)


def _flip_wire(x: torch.Tensor) -> torch.Tensor:
    """A copy of a payload with one mantissa bit of its first element
    flipped (the ``exchange.payload`` drill's corruption).  Only the copy
    goes over the wire: the tensor the send tags were taken from, a view
    of the accumulator, stays as it was."""
    if x.element_size() != 4:
        return x
    wire = x.clone(memory_format=torch.contiguous_format)
    wire.view(torch.int32).view(-1)[0] ^= 1 << 20
    return wire


def _flip_state_bit(state: State, bit: int = 20) -> State:
    """The state with one bit of the first element of every float32 leaf
    flipped, in copies (the ``state.corrupt`` site): a memory or transfer
    bit flip between windows.  The carry the caller holds is unchanged."""
    def flip(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.dtype != torch.float32 or leaf.numel() == 0:
            return leaf
        out = leaf.clone(memory_format=torch.contiguous_format)
        out.view(torch.int32).view(-1)[0] ^= 1 << bit
        return out
    return {k: flip(v) for k, v in state.items()}


class _ExchangeGuard:
    """One window's exchange checks: whether the window is poisoned (the
    ``exchange.payload`` drill) and its count of tag mismatches, a tensor
    on the engine's device until the boundary reads it with the votes (no
    host sync of its own)."""

    def __init__(self, poison: bool = False):
        self.poison = bool(poison)
        self._bad: Optional[torch.Tensor] = None

    def add(self, n: torch.Tensor) -> None:
        self._bad = n if self._bad is None else self._bad + n

    def read(self) -> Optional[torch.Tensor]:
        """The window's mismatch count; None when no exchange ran."""
        return self._bad


def _checked_exchange(guard: _ExchangeGuard
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The single-device exchange with a reduction tag per (partition,
    peer) slot block: the send tags are taken from the outbox *before* the
    wire (where the ``exchange.payload`` drill corrupts a copy), the inbox
    side re-derives them, and each mismatch lands in ``guard``; the
    boundary turns a nonzero window count into an ``ExchangeCorruption``
    and the caller replays the window."""
    def exchange(outbox: torch.Tensor) -> torch.Tensor:
        send_tags = _payload_tag(outbox, (0, 3))            # [pl, P]
        wire = _flip_wire(outbox) if guard.poison else outbox
        inbox = wire.transpose(1, 2)                        # [Q, P, pl, o]
        recv_tags = _payload_tag(inbox, (0, 3))             # [P, pl]
        guard.add((recv_tags != send_tags.T).sum())
        return inbox
    return exchange


def _run_batched_loop(step_fn: Callable, max_steps: int, state: State,
                      q: int) -> Tuple[State, torch.Tensor]:
    """Advance all Q queries together until every query votes finish:
    one window from step 0 with no chunk bound.  Returns the final state
    and per-query executed superstep counts ``steps [Q]``."""
    dev = next(iter(state.values())).device
    state, _, _, steps_q = _run_chunked_loop(
        step_fn, max_steps, max_steps, state, 0,
        torch.zeros(q, dtype=torch.bool, device=dev),
        torch.zeros(q, dtype=torch.int32, device=dev))
    return state, steps_q


def _slot_swap(state: State, new_rows: State, admit: torch.Tensor,
               fin: torch.Tensor, steps_q: torch.Tensor
               ) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """Refill the slots of the ``[Q]`` bool mask ``admit`` for continuous
    batching: their state rows become ``new_rows``' (a full-Q state whose
    other rows are ignored), their votes clear and their superstep
    counters restart at 0.  Every other row passes through bitwise
    unchanged, and no shape changes."""
    def swap(k, old):
        new = torch.as_tensor(new_rows[k], dtype=old.dtype, device=old.device)
        return torch.where(admit.view((-1,) + (1,) * (old.dim() - 1)),
                           new, old)

    state = {k: swap(k, v) for k, v in state.items()}
    return (state, fin & ~admit,
            torch.where(admit, torch.zeros_like(steps_q), steps_q))


# ---------------------------------------------------------------------------
# Tiered (out-of-core) execution: cold partitions' edge arenas in pinned host
# memory, streamed through the superstep window by window (core/tiered.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _TierDir:
    """One direction of a tiered engine: the hot partitions' edge arrays
    on the device (None when every partition is cold), the cold windows'
    host arena (None when none is cold), each window's ``(partition,
    first segment, segments)`` and ``(partition, first slot, slots)``.

    On a dynamic graph ``ov`` holds the hot partitions' tombstones and
    delta slots on the device (None when none is hot), copied from the
    host payload at the first run after a batch (``ov_mark``, the batch
    count of the copy), and ``inbox_dst`` the live inbox map."""

    dims: _Dims
    inbox_dst: torch.Tensor                 # [P, P, o_max] int64
    hot: Optional[Dict[str, torch.Tensor]]
    arena: Optional[HostArena]
    meta: Tuple[Tuple[int, int, int], ...]
    spans: Tuple[Tuple[int, int, int], ...] = ()
    ov: Optional[Dict[str, torch.Tensor]] = None
    ov_mark: int = -1


@dataclasses.dataclass(frozen=True)
class _HybridTier:
    """One program's row-tiered degree split: ``arrs`` holds ``slot``,
    ``hid``, the resident ``dense`` block and the hot rows' compacted CSR
    (``row_ptr``/``col``/``val``/``plan`` and their ids ``rows``; absent
    when no row is hot); the cold rows stream as windows of ``arena``,
    each with ``(rows, slots, partials)`` in ``meta``."""

    cfg: _HybridCfg
    arrs: dict
    arena: Optional[HostArena]
    stream: Optional[WindowStream]
    meta: Tuple[Tuple[int, int, int], ...]


def _identity_acc(program: VertexProgram, state: State, dims: _Dims,
                  dtype: torch.dtype) -> torch.Tensor:
    """The ``[Q, P, seg]`` accumulator filled with the combine identity."""
    first = next(iter(state.values()))
    return torch.full((first.shape[0], dims.num_parts, dims.seg),
                      identity(program.combine), dtype=dtype,
                      device=first.device)


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

    ``tiered=<device byte budget>`` (or a prebuilt
    ``partition.TierPlan``) keeps only the densest partitions' edge arenas
    on the device (``partition.build_tier_plan``, ``tier_plan``); the cold
    partitions' arenas live in pinned host memory and stream through every
    superstep in clean-cut windows of at most ``win_blocks`` edge blocks,
    copied on a side stream into two device buffers
    (``core/tiered.py``).  On the reference and fused backends each window
    is one compute over the window's edges (one kernel launch on the fused
    backend), written into its own segment range of the accumulator; the
    hybrid backend tiers the degree split by rows: the hot rows stay on
    the device, the cold rows stream in windows of rows, each with a row
    plan that keeps every row's lane count, and the dense block stays
    resident.  A tiered run is push only on the reference and fused
    backends and pull only on the hybrid, and gives the resident engine's
    results bit for bit wherever the sums have a fixed order (everywhere
    but the reference backend's scatter on the card).  The engine makes
    its host arenas and window buffers before the first superstep and
    none after but at a dynamic graph's compaction
    (``tiered_stats()["buffers_made"]``).  ``residency_bytes``
    and ``tiered_stats`` report the split.

    ``execute(chunk=k)`` runs the converge loop in windows of ``k``
    supersteps; at each boundary ``on_chunk`` may kill, refill or stop
    queries, which is how ``runtime/session.py`` serves a query stream
    through static slots.

    A ``core.dynamic.DynamicGraph`` in place of ``pg`` gives a dynamic
    engine: every run reads the graph's mutation payload, so batches
    applied between runs rebuild nothing, and a compaction rebinds the
    engine at its next run (``dynamic_rebinds``).  The reference and fused
    backends fold the tombstones into the edges (to the sink, or out of
    the block mask) and run the delta slots as one reference compute per
    superstep; they push only, as in the JAX package.  The hybrid backend
    keeps its own split of the mutated graph whose remainder rows end in
    ``dynamic_ell_spare`` sentinel slots (``col = n``, the ⊗-identity):
    each batch's touched pairs are written in place into the dense block,
    the rows' slots and the push arrays, and a row without a free slot
    rebuilds the split (``hybrid_dyn_rebuilds``).  ``execute(
    incremental=dirty)`` warm-starts a program's :class:`IncrementalForm`.

    ``tiered=`` on a dynamic graph runs on the reference and fused
    backends (the hybrid refuses, as in the JAX package).  The graph's
    payload stays in host memory (``DynamicGraph(device="cpu")``, pinned
    with ``pin=True`` for a card): the hot partitions' tombstones and delta
    slots are copied to the device at the first run after a batch and
    folded into the hot compute as on a resident engine; each cold
    window streams its slice of the current tombstones beside its edges,
    and after the base windows each cold partition's delta slots stream
    as one reference-compute window, combined into the partition's
    accumulator row (base ⊕ delta).  ``build_tier_plan(dynamic=)`` counts
    the overlay, so ``tier_plan.hbm_bytes`` stays the engine's device
    bytes.  A compaction re-plans the tiers over the new layout at the
    same budget (doubling ``win_blocks`` if a destination run outgrew the
    windows) and rebuilds the arenas and buffers at the next run.
    """

    def __init__(self, pg, *, backend: Optional[str] = None,
                 fused: bool = False, block_e: int = 1024,
                 device: DeviceLike = None, direction: str = "auto",
                 direction_switch: bool = True,
                 pull_threshold: Optional[float] = None,
                 hybrid_k_dense: Optional[int] = None, tiered=None,
                 win_blocks: int = 8, dynamic_ell_spare: int = 8):
        from repro_torch.core.dynamic import DynamicGraph

        if backend is None:
            backend = FUSED if fused else REFERENCE
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}; pick one of "
                             f"{BACKENDS}")
        if direction not in _DIRECTIONS:
            raise ValueError(f"direction must be one of {sorted(_DIRECTIONS)}"
                             f", got {direction!r}")
        # A dynamic graph hands the engine a mutable layout: the engine
        # reads its payload at every run and rebinds after a compaction.
        self.dg: Optional[DynamicGraph] = None
        self.dynamic_rebinds = 0
        # dynamic-hybrid split rebuilds (a full row, or a batch log that
        # no longer reaches the split's cursor): rebuilds a serving
        # session counts as expected, like compaction rebinds
        self.hybrid_dyn_rebuilds = 0
        if isinstance(pg, DynamicGraph):
            if tiered is not None and backend == HYBRID:
                raise ValueError(
                    "tiered= with backend='hybrid' does not support dynamic "
                    "graphs: delta slots stream with their base edge "
                    "blocks, which the row-tiered ELL split has no blocks "
                    "for; use backend='reference' or 'fused' for tiered "
                    "dynamic runs")
            if tiered is not None and pg.device.type != "cpu":
                raise ValueError(
                    "a tiered engine streams the cold partitions' "
                    "tombstones and delta slots from host memory: build "
                    "the DynamicGraph with device='cpu' (and pin=True "
                    "for an engine on a card)")
            self.dg = pg
            self._dyn_version = pg.version
            pg = pg.pg
        if not isinstance(pg, PartitionedGraph):
            raise TypeError(f"an engine runs over a PartitionedGraph or a "
                            f"DynamicGraph, not {type(pg).__name__}")
        self.backend = backend
        self.fused = backend == FUSED
        self.device = resolve_device(device)
        self.direction = direction
        self._direction_switch = direction_switch
        self._pull_threshold = pull_threshold
        self.last_direction_stats: Optional[dict] = None
        self._block_e = block_e
        self._hybrid_k_dense = hybrid_k_dense
        self._dyn_ell_spare = int(dynamic_ell_spare)
        self.tier_plan: Optional[TierPlan] = None
        self.tiered_buffers_made = 0
        self._tiered_req, self._win_blocks = tiered, win_blocks
        with tracing.span("engine.bind"):
            self._bind(pg, tiered=tiered is not None)
        if tiered is not None:
            self._bind_tiered(tiered, win_blocks)

    @property
    def pg(self) -> PartitionedGraph:
        """The current partitioned layout.  On a dynamic engine this first
        syncs with the ``DynamicGraph`` (a rebind after a compaction; on
        the sharded hybrid, a compaction of pending batches), so state
        made from ``engine.pg`` matches the layout of the next run."""
        if self.dg is not None:
            self._sync_dynamic()
        return self._pg

    def _bind(self, pg: PartitionedGraph, tiered: bool = False) -> None:
        """Derive every structure of ``pg``: this engine's partitions (all
        of them on one device) and the edge, block, pull and hybrid
        arrays it puts on its device.  Construction and a rebind after a
        compaction land here."""
        self._pg = pg
        self._parts = self._shard_parts(pg)
        self.dims = _Dims(pg.num_parts, pg.v_max, pg.fwd.e_max, pg.fwd.o_max)
        self._pull: Optional[_PullLayout] = None
        self._fwd = self._rev = None
        if not tiered:
            local = [slice_parts(ea, *self._parts) if ea is not None
                     else None for ea in (pg.fwd, pg.rev)]
            blks = [build_block_metadata(ea, block_e=self._block_e)
                    if self.fused and ea is not None else None
                    for ea in local]
            self._fwd, self._rev = (
                _edges_dict(ea, blk, self.device) if ea is not None else None
                for ea, blk in zip(local, blks))
        self._hybrid_plan: Optional[dict] = None
        self._hybrid_cache: dict = {}
        self._hybrid_layouts: dict = {}
        self._hyb_tier_cache: dict = {}
        self._hybrid_dyn_cache: dict = {}
        if self.backend == HYBRID:
            if pg.source is None:
                raise ValueError(
                    "the hybrid backend needs PartitionedGraph.source; "
                    "partition with core.partition.partition()")
            self._splits = splits_of(pg)
            with tracing.span("engine.plan"):
                self._hybrid_plan = self._plan_hybrid(self._hybrid_k_dense,
                                                      self._block_e)
        elif self._direction_switch and not tiered and self.dg is None:
            # the transposed rows do not track mutations: dynamic graphs
            # push only on these backends, as in the JAX package
            self._pull = self._build_pull_layout()

    def _shard_parts(self, pg: PartitionedGraph) -> Tuple[int, int]:
        """The partitions ``[lo, hi)`` this engine holds: all of them."""
        return 0, pg.num_parts

    def _plan_hybrid(self, k_dense: Optional[int], block_e: int) -> dict:
        """The split decision (``hybrid.SplitCache.plan``)."""
        return self._splits.plan(k_dense, block_e)

    def edges_for(self, program: VertexProgram) -> dict:
        if self.tier_plan is not None:
            raise ValueError(
                "engine is tiered (out-of-core): cold partitions' edges "
                "live in host window arenas, not one resident edges dict; "
                "run through execute() (the streaming path) or rebuild the "
                "engine without tiered=")
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
        row_ptr = tc.row_ptr[r0:r1 + 1] - s0
        return _PullLayout(
            row_ptr=put(row_ptr, torch.int32),
            col=put(tc.col[s0:s1] - r0, torch.int32),
            val=(put(tc.val[s0:s1], torch.float32) if tc.val is not None
                 else None),
            plan=row_plan(row_ptr).to(self.device),
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
        with tracing.span("hybrid.split_layout"):
            layout = self._splits.layout(self._hybrid_plan["k_dense"],
                                         reverse)
            slot, hid = self._slot_hid(layout, g.num_vertices)
        with tracing.span("hybrid.upload"):
            shared = dict(row_ptr=self._put(layout.row_ptr, torch.int32),
                          plan=layout.plan.to(self.device),
                          col=self._put(layout.src[layout.rest], torch.int32),
                          slot=self._put(slot, torch.int64),
                          hid=self._put(hid, torch.int64))
        self._hybrid_layouts[reverse] = (g, layout, shared)
        return g, layout, shared

    def _slot_hid(self, layout, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """``slot [n]``: each hybrid id's flat ``[Pl * v_max]`` position;
        ``hid [P, v_max]``: each position's hybrid id (``n`` for padding)."""
        asg = self.pg.assignment
        slot = (asg.part_of[layout.perm].astype(np.int64) * self.pg.v_max
                + asg.local_id[layout.perm])
        hid = np.full((self.pg.num_parts, self.pg.v_max), n, dtype=np.int64)
        for p, l2g in enumerate(asg.l2g):
            hid[p, : len(l2g)] = layout.inv_perm[l2g]
        return slot, hid

    def _hybrid_cfg(self, program: VertexProgram, g, hg) -> _HybridCfg:
        n = g.num_vertices
        thr = self._pull_threshold
        if thr is None:
            thr = perf_model.fit_pull_threshold(g.num_edges / max(n, 1),
                                                hg.kmax, backend=HYBRID)
        return _HybridCfg(semiring=self._hybrid_semiring(program),
                          k_dense=hg.k_dense, num_vertices=n, kmax=hg.kmax,
                          pull_threshold=float(thr),
                          forced=_DIRECTIONS[self.direction],
                          uniform=program.edge_msg.frontier_uniform,
                          e_dense=int(hg.k_dense) ** 2)

    def _build_hybrid(self, program: VertexProgram) -> Tuple[_HybridCfg,
                                                             dict]:
        """One direction and semiring's degree split: the static cfg and
        the tensors ``_superstep_hybrid`` reads."""
        semiring = self._hybrid_semiring(program)
        g, layout, shared = self._hybrid_layout(program.use_reverse)
        with tracing.span("hybrid.degree_split"):
            hg = self._splits.split(layout.k_dense, program.use_reverse,
                                    semiring, program.edge_msg.use_weight)
        with tracing.span("hybrid.upload"):
            arrs = dict(shared, dense=self._put(hg.dense_block, torch.float32),
                        val=self._put(hg.ell_val, torch.float32))
            if program.combine == MIN and self._direction_switch:
                arrs["push_src"] = self._put(layout.src, torch.int64)
                arrs["push_dst"] = self._put(layout.dst, torch.int64)
                if semiring == MIN_PLUS and g.weights is not None:
                    arrs["push_w"] = self._put(g.weights, torch.float32)
        return self._hybrid_cfg(program, g, hg), arrs

    def hybrid_for(self, program: VertexProgram) -> Tuple[_HybridCfg, dict]:
        """The split ``program`` runs on: its static cfg and device tensors
        (``_superstep_hybrid``), built at the first call and cached per
        direction, semiring, weight use and frontier uniformity.  A run
        calls it; calling it first moves the host work out of the run.  On a
        dynamic graph it is the engine's own split of the mutated graph,
        brought up to the graph's last batch (:meth:`_hybrid_dyn_for`)."""
        if self.dg is not None:
            return self._hybrid_dyn_for(program)
        key = self._hybrid_key(program)
        if key not in self._hybrid_cache:
            with tracing.span("hybrid.split"):
                self._hybrid_cache[key] = self._build_hybrid(program)
        return self._hybrid_cache[key]

    def _direction_enabled(self, program: VertexProgram,
                           state: State) -> bool:
        """Does ``execute`` carry the direction leaves through ``program``?
        On the hybrid backend every eligible min program votes (its push
        edges come with the split); elsewhere see ``_dopt_cfg_for``.  A
        tiered engine runs one direction only."""
        if self.tier_plan is not None:
            return False
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

    def _guarded_exchange(self, guard: _ExchangeGuard) -> Callable:
        return _checked_exchange(guard)

    def _step_fn(self, program: VertexProgram,
                 dopt_cfg: Optional[_DoptCfg] = None,
                 guard: Optional[_ExchangeGuard] = None,
                 flip_tomb: bool = False) -> Callable:
        """One superstep ``(state, step) -> (state, votes)`` of ``program``
        on this engine.  With ``guard`` every exchange is checked (chunk
        windows on a static graph; one device's hybrid split has no
        partition boundary, so nothing to check); ``flip_tomb`` runs a
        dynamic graph with one tombstone flipped in a copy of the mask (the
        ``tombstone.flip`` site)."""
        if self.tier_plan is not None:
            if self._uses_hybrid(program):
                return self._tiered_hybrid_step_fn(program)
            return self._tiered_step_fn(program)
        if self._uses_hybrid(program):
            return self._hybrid_step_fn(program)
        edges, delta = self.edges_for(program), None
        if self.dg is not None:
            edges, delta = self._dyn_edges(program, edges, flip_tomb)
        dims = self.dims_for(edges)
        block_e = self._block_e if self.fused else None
        pull = self._pull if dopt_cfg is not None else None
        exchange = (self._exchange if guard is None
                    else self._guarded_exchange(guard))

        def step_fn(state, step):
            return _superstep(dims, program, edges, exchange,
                              self._all_finished, block_e, state, step,
                              dopt_cfg, pull, delta)
        return step_fn

    # ---------------------- dynamic graphs ---------------------------------

    def _sync_dynamic(self) -> None:
        """Rebind after a compaction (the one rebuild a dynamic engine
        pays); called at every dynamic run and by the ``pg`` property."""
        if self.dg.version != self._dyn_version:
            # version first: _bind reads self.pg, whose getter re-enters
            # this sync, and the new version makes that a no-op
            self._dyn_version = self.dg.version
            tiered = self._tiered_req is not None
            self._bind(self.dg.pg, tiered=tiered)
            if tiered:
                self._replan_tiered()
            self.dynamic_rebinds += 1

    def _replan_tiered(self) -> None:
        """The tiers of a compacted layout, planned at the request's budget
        (a prebuilt plan described the old layout).  A compaction can make
        a destination run longer than the windows; the windows then double
        until the new layout cuts cleanly (``tier_plan.fwd.win_blocks``)."""
        req = self._tiered_req
        budget = req.hbm_budget_bytes if isinstance(req, TierPlan) else req
        while True:
            try:
                return self._bind_tiered(budget, self._win_blocks)
            except NoCleanCutError:
                self._win_blocks *= 2

    def _dyn_edges(self, program: VertexProgram, edges: dict,
                   flip_tomb: bool = False) -> Tuple[dict, dict]:
        """This run's view of the dynamic graph for the reference and fused
        backends: ``edges`` with this engine's slice of the tombstones
        folded in (sent to the sink, and zeroed in the fused block mask)
        and the live ``inbox_dst``, and the delta slots' edges.

        ``flip_tomb`` flips one bit of a copy of the first partition's
        tombstones, preferring a tombstoned edge that is not a self-loop
        (a resurrected self-loop is inert under every program, which
        would make the drill vacuous); the graph's payload is unchanged."""
        lo, hi = self._parts
        pl = {k: v[lo:hi].to(self.device)
              for k, v in self.dg.payload(program.use_reverse).items()}
        tomb = pl["tomb"]
        if flip_tomb:
            cand = tomb[0] & (edges["src"][0] != edges["dst_ext"][0])
            j = int(cand.to(torch.int8).argmax())   # the first, else 0
            tomb = tomb.clone()
            tomb[0, j] = ~tomb[0, j]
        out = dict(edges, inbox_dst=pl["inbox_dst"],
                   dst_ext=torch.where(tomb, self.dims.v_max,
                                       edges["dst_ext"]))
        if "blk_mask" in edges:
            alive = torch.zeros(edges["blk_mask"].shape, dtype=torch.int32,
                                device=self.device)
            alive[:, :tomb.shape[1]] = (~tomb).to(torch.int32)
            out["blk_mask"] = edges["blk_mask"] * alive
        delta = dict(src=pl["d_src"], dst_ext=pl["d_dst_ext"])
        if "d_weight" in pl:
            delta["weight"] = pl["d_weight"]
        return out, delta

    def should_resplit_hybrid(self, threshold: float = 0.10) -> bool:
        """``perf_model.should_resplit`` on this engine's frozen dynamic
        split: evaluate the candidate ladder on the *mutated* graph's
        degree ranks and vote to re-rank only when the predicted makespan
        improves by more than ``threshold``.  The serving launcher takes a
        True vote as a compaction, whose rebind re-plans the split.  False
        on engines that are not dynamic hybrids."""
        if self.dg is None or self.backend != HYBRID:
            return False
        g = self.dg.mutated_csr()
        resplit, info = perf_model.should_resplit(
            edge_max_ranks(g), g.num_edges, self._hybrid_plan["candidates"],
            current_k=self._hybrid_plan["k_dense"], threshold=threshold)
        self.last_resplit_info = info
        return resplit

    def _hybrid_dyn_for(self, program: VertexProgram
                        ) -> Tuple[_HybridCfg, dict]:
        """The dynamic hybrid split, its device arrays brought up to the
        graph's last batch.

        Deletions write the ⊕-identity (or the combine of the surviving
        parallel edges) into the dense block and send a row's slot back to
        the sentinel; insertions land in the dense block or in a row's
        spare sentinel slots.  The degree *ranking* stays frozen between
        compactions (a stale split is a performance choice, never a
        correctness one).  A row without a free slot, or a batch log that
        no longer reaches the split's cursor, rebuilds the split from the
        mutated graph.  ``row_ptr`` and so the row plan stay fixed between
        rebuilds.
        """
        key = self._hybrid_key(program)
        ent = self._hybrid_dyn_cache.get(key)
        if ent is not None and ent["cursor"] < self.dg.log_floor:
            ent = None
            self.hybrid_dyn_rebuilds += 1
        if ent is None:
            ent = self._build_hybrid_dyn(program)
            self._hybrid_dyn_cache[key] = ent
        pairs = self.dg.pairs_since(ent["cursor"])
        if pairs:
            try:
                self._reconcile_hybrid(ent, key, pairs)
            except _EllOverflow:
                ent = self._build_hybrid_dyn(program)
                self._hybrid_dyn_cache[key] = ent
                self.hybrid_dyn_rebuilds += 1
            ent["cursor"] = self.dg.num_batches
        return ent["cfg"], ent["arrs"]

    def _build_hybrid_dyn(self, program: VertexProgram) -> dict:
        """The engine's own degree split of the mutated graph (never the
        split a static engine over the same ``pg`` shares), each remainder
        row followed by ``dynamic_ell_spare`` sentinel slots, and the push
        arrays followed by four batches' worth of spare sentinel slots.
        The JAX package rounds the push arrays up to a power of two so its
        jit caches see few shapes; here every sentinel slot scatters to the
        one segment ``n``, whose atomics serialise (a rounded RMAT20 split
        held 16.8M of them and ran BFS 8x slower on the card), and eager
        PyTorch has no shapes to reuse.  Beside the device arrays it keeps
        their host mirrors and, per (source, destination) pair, where its
        push slots lie."""
        spec = program.edge_msg
        semiring = self._hybrid_semiring(program)
        g = self.dg.mutated_csr()
        if program.use_reverse:
            g = g.reverse()
        if not spec.use_weight and g.weights is not None:
            g = CSRGraph(g.row_ptr, g.col, None)
        k = self._hybrid_plan["k_dense"]
        layout = split_layout(g, k)
        hg = degree_split(g, k, semiring=semiring, layout=layout)
        n = g.num_vertices
        lens = np.diff(hg.ell_row_ptr.astype(np.int64))
        row_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens + self._dyn_ell_spare, out=row_ptr[1:])
        pos = np.repeat(row_ptr[:-1] - hg.ell_row_ptr[:-1], lens) + (
            np.arange(len(hg.ell_col)))
        mul_ident = SEMIRINGS[semiring][2]
        col = np.full(int(row_ptr[-1]), n, dtype=np.int32)
        val = np.full(int(row_ptr[-1]), mul_ident, dtype=np.float32)
        col[pos], val[pos] = hg.ell_col, hg.ell_val
        slot, hid = self._slot_hid(layout, n)
        put = self._put
        arrs = dict(dense=put(hg.dense_block, torch.float32),
                    row_ptr=put(row_ptr, torch.int32),
                    plan=row_plan(row_ptr).to(self.device),
                    col=put(col, torch.int32), val=put(val, torch.float32),
                    slot=put(slot, torch.int64), hid=put(hid, torch.int64))
        cfg = dataclasses.replace(self._hybrid_cfg(program, g, hg),
                                  spare=True)
        ent = dict(cfg=cfg, arrs=arrs, dense=hg.dense_block.copy(),
                   row_ptr=row_ptr, col=col, val=val,
                   inv_perm=layout.inv_perm, mul_ident=float(mul_ident),
                   cursor=self.dg.num_batches, push=None)
        if program.combine == MIN and self._direction_switch:
            e = len(layout.src)
            cap = e + max(4 * self.dg.mutation_capacity, 64)
            p_src = np.full(cap, n, dtype=np.int64)
            p_dst = np.full(cap, n, dtype=np.int64)
            p_src[:e], p_dst[:e] = layout.src, layout.dst
            arrs["push_src"] = put(p_src, torch.int64)
            arrs["push_dst"] = put(p_dst, torch.int64)
            p_w = None
            if semiring == MIN_PLUS and g.weights is not None:
                p_w = np.zeros(cap, dtype=np.float32)
                p_w[:e] = g.weights
                arrs["push_w"] = put(p_w, torch.float32)
            keys = layout.src.astype(np.int64) * (n + 1) + layout.dst
            order = np.argsort(keys, kind="stable")
            ent["push"] = dict(src=p_src, dst=p_dst, w=p_w, width=n + 1,
                               keys=keys[order], order=order, slots={},
                               free=list(range(e, cap)))
        return ent

    def _reconcile_hybrid(self, ent: dict, key, pairs) -> None:
        """Match the split's ⊗ values for every touched (u, v) pair to the
        ledger's live multiset, then write the dense block, the remainder
        rows and the push arrays with one indexed write per array."""
        semiring, use_reverse, use_weight = key[:3]
        cfg = ent["cfg"]
        inv, k, n = ent["inv_perm"], cfg.k_dense, cfg.num_vertices
        ident = add_identity(semiring)
        writes = {m: {} for m in ("dense", "col", "val", "push_src",
                                  "push_dst", "push_w")}
        for u, v in pairs:
            a, b = (v, u) if use_reverse else (u, v)
            ha, hb = int(inv[a]), int(inv[b])
            weights = self.dg.ledger.alive_weights(u, v)
            if semiring == PLUS_TIMES:
                vals = [float(w) if use_weight else 1.0 for w in weights]
            elif semiring == MIN_PLUS:
                vals = [float(w) if use_weight else 0.0 for w in weights]
            else:
                vals = [0.0] * len(weights)
            if k and ha < k and hb < k:
                if not vals:
                    cell = ident
                elif semiring == PLUS_TIMES:
                    acc = np.float32(0.0)    # f32 accumulation, in order
                    for x in vals:
                        acc = np.float32(acc + np.float32(x))
                    cell = float(acc)
                else:
                    cell = min(vals)
                ent["dense"][ha, hb] = cell
                writes["dense"][ha * k + hb] = cell
            else:
                self._reconcile_ell_row(ent, hb, ha, vals, n, writes["col"],
                                        writes["val"])
            if ent["push"] is not None:
                self._reconcile_push(ent["push"], ha, hb, vals, n, writes)
        arrs = ent["arrs"]
        for m, w in writes.items():
            if not w:
                continue
            t = arrs[m]
            idx = torch.as_tensor(np.fromiter(w.keys(), dtype=np.int64,
                                              count=len(w)))
            t.view(-1)[idx.to(t.device)] = torch.as_tensor(
                list(w.values()), dtype=t.dtype).to(t.device)

    def _reconcile_push(self, push: dict, ha: int, hb: int, vals,
                        sentinel: int, writes: dict) -> None:
        """Match the push arrays' (ha → hb) slots to the live multiset:
        send extras back to the sentinel, claim spare slots for new edges.
        Weightless arrays match by count, min_plus by ⊗ value.  Raises
        :class:`_EllOverflow` when the spare slots run out (the caller
        rebuilds from the mutated graph)."""
        key = ha * push["width"] + hb
        slots = push["slots"].get(key)
        if slots is None:
            lo = int(np.searchsorted(push["keys"], key, "left"))
            hi = int(np.searchsorted(push["keys"], key, "right"))
            slots = push["order"][lo:hi].tolist()
        w = push["w"]
        if w is None:
            keep, extras = slots[:len(vals)], slots[len(vals):]
            remaining = vals[len(slots):]
        else:
            remaining, keep, extras = list(vals), [], []
            for j in slots:
                x = float(w[j])
                if x in remaining:
                    remaining.remove(x)
                    keep.append(j)
                else:
                    extras.append(j)
        for j in extras:
            writes["push_src"][j] = writes["push_dst"][j] = sentinel
            push["src"][j] = push["dst"][j] = sentinel
            if w is not None:
                writes["push_w"][j] = w[j] = 0.0
            push["free"].append(j)
        if remaining:
            if len(push["free"]) < len(remaining):
                raise _EllOverflow((ha, hb))
            for x in remaining:
                j = push["free"].pop()
                writes["push_src"][j] = push["src"][j] = ha
                writes["push_dst"][j] = push["dst"][j] = hb
                if w is not None:
                    writes["push_w"][j] = w[j] = float(x)
                keep.append(j)
        push["slots"][key] = keep

    def _reconcile_ell_row(self, ent: dict, row: int, col: int, want,
                           sentinel: int, col_w: dict, val_w: dict) -> None:
        """Match row ``row``'s slots of source ``col`` to the live multiset
        ``want``: fill sentinel slots, send extras back to the sentinel."""
        r0, r1 = int(ent["row_ptr"][row]), int(ent["row_ptr"][row + 1])
        col_row, val_row = ent["col"][r0:r1], ent["val"][r0:r1]  # views
        have = np.flatnonzero(col_row == col).tolist()
        remaining, keep = list(want), []
        for j in have:
            v = float(val_row[j])
            if v in remaining:
                remaining.remove(v)
                keep.append(j)
        for j in have:
            if j not in keep:
                col_w[r0 + j] = col_row[j] = sentinel
                val_w[r0 + j] = val_row[j] = ent["mul_ident"]
        if remaining:
            free = np.flatnonzero(col_row == sentinel).tolist()
            if len(free) < len(remaining):
                raise _EllOverflow(row)
            for j, v in zip(free, remaining):
                col_w[r0 + j] = col_row[j] = col
                val_w[r0 + j] = val_row[j] = v

    # ---------------------- tiered (out-of-core) ----------------------------

    def _bind_tiered(self, tiered, win_blocks: int) -> None:
        """Split the partitions over the device and host tiers.

        The hot partitions' arrays go on the device once; each cold
        partition's become clean-cut windows in one pinned host arena per
        direction, and one pair of device window buffers serves every
        window of both directions.  The fused backend keeps the block
        arrays its kernel reads; a window holds its blocks, their bases
        less the window's first segment, so the kernel reduces it into an
        accumulator of the window's segments only (its runs depend on id
        equality alone).  The reference and hybrid backends keep the
        reference compute's ``src``/``dst_ext``/``weight`` (the hybrid
        streams them for programs it cannot split; its split tiers by
        rows, ``_hybrid_tiered_for``).

        On a dynamic graph the plan counts the overlay, the hot partitions'
        tombstones and delta slots get device buffers (``_TierDir.ov``)
        and the window buffers gain a tombstone slice and a delta window.
        A compaction lands here again through ``_sync_dynamic``.
        """
        pg, block_e, dev, dg = self._pg, self._block_e, self.device, self.dg
        plan = tiered if isinstance(tiered, TierPlan) else build_tier_plan(
            pg, int(tiered), block_e=block_e, win_blocks=win_blocks,
            fused=self.fused, dynamic=dg)
        if plan.fwd.block_e != block_e:
            raise ValueError(f"the tier plan cuts windows at block_e="
                             f"{plan.fwd.block_e}, the engine's is {block_e}")
        self.tier_plan = plan
        hot = [int(p) for p in plan.hot]
        if hot and hot == list(range(hot[0], hot[-1] + 1)):
            self._tier_hot = slice(hot[0], hot[-1] + 1)     # views
        else:
            self._tier_hot = torch.as_tensor(hot, dtype=torch.int64,
                                             device=dev)
        i32, i64, f32 = torch.int32, torch.int64, torch.float32
        win_e = plan.fwd.win_e
        self._tier: Dict[bool, _TierDir] = {}
        sizes: dict = {}
        for use_rev, ea, sched in ((False, pg.fwd, plan.fwd),
                                   (True, pg.rev, plan.rev)):
            if ea is None or sched is None:
                continue
            if self.fused:
                blk = build_block_metadata(ea, block_e=block_e)
                arrays = dict(blk_src=(blk.src, i32),
                              blk_local=(blk.local, i32),
                              blk_mask=(blk.mask, i32),
                              blk_base=(blk.base, i32))
                if blk.weight is not None:
                    arrays["weight_blk"] = (blk.weight, f32)
            else:
                arrays = dict(src=(ea.src, i64), dst_ext=(ea.dst_ext, i64))
                if ea.weight is not None:
                    arrays["weight"] = (ea.weight, f32)
            hot_dev = ({k: self._put(a[hot], dt)
                        for k, (a, dt) in arrays.items()} if hot else None)
            windows, meta, spans = [], [], []
            for p, st, cnt in zip(sched.part, sched.start, sched.count):
                p, st, cnt = int(p), int(st), int(cnt)
                spans.append((p, st, cnt))
                lo = int(ea.dst_ext[p, st])
                nseg = int(ea.dst_ext[p, st + cnt - 1]) - lo + 1
                if self.fused:
                    nb = -(-cnt // block_e)
                    end = st + nb * block_e
                    w = {k: a[p, st:end] for k, (a, _) in arrays.items()
                         if k != "blk_base"}
                    b0 = st // block_e
                    w["blk_base"] = blk.base[p, b0:b0 + nb] - lo
                else:
                    w = {k: a[p, st:st + cnt].astype(
                        np.float32 if dt == f32 else np.int64)
                        for k, (a, dt) in arrays.items()}
                    w["dst_ext"] = w["dst_ext"] - lo
                windows.append(w)
                meta.append((p, lo, nseg))
            arena = None
            if windows:
                arena = HostArena(windows, pin=dev.type == "cuda")
                self.tiered_buffers_made += 1
                for k, (_, dt) in arrays.items():
                    sizes[k] = (dt, sched.win_blocks if k == "blk_base"
                                else win_e)
            ov = None
            if dg is not None:
                pl = dg.payload(use_rev)
                if hot:
                    ov = {k: torch.empty((len(hot),) + tuple(pl[k].shape[1:]),
                                         dtype=pl[k].dtype, device=dev)
                          for k in ("tomb", "d_src", "d_dst_ext", "d_weight")
                          if k in pl}
                if windows:
                    sizes["tomb"] = (torch.bool, win_e)
                    for k in ("d_src", "d_dst_ext", "d_weight"):
                        if k in pl:
                            sizes[k] = (pl[k].dtype, dg.delta_slots)
            self._tier[use_rev] = _TierDir(
                dims=_Dims(pg.num_parts, pg.v_max, ea.e_max, ea.o_max),
                inbox_dst=self._put(ea.inbox_dst, i64), hot=hot_dev,
                arena=arena, meta=tuple(meta), spans=tuple(spans), ov=ov)
        self._tier_stream = None
        if sizes:
            self._tier_stream = WindowStream(sizes, dev)
            self.tiered_buffers_made += 1

    def _tier_overlay(self, use_rev: bool, td: _TierDir) -> dict:
        """A tiered dynamic direction's host payload, with the hot
        partitions' tombstones and delta slots and the inbox map copied to
        the device if a batch came since the last copy."""
        pl = self.dg.payload(use_rev)
        if td.ov_mark != self.dg.num_batches:
            if td.ov is not None:
                hot = torch.as_tensor(self.tier_plan.hot, dtype=torch.int64)
                for k, buf in td.ov.items():
                    buf.copy_(pl[k].index_select(0, hot))
            td.inbox_dst.copy_(pl["inbox_dst"])
            td.ov_mark = self.dg.num_batches
        return pl

    def _tiered_step_fn(self, program: VertexProgram) -> Callable:
        """One tiered superstep (reference and fused backends): the hot
        partitions' compute into the identity-filled ``[Q, P, seg]``
        accumulator, each streamed window's compute written over its own
        segment range of row ``p`` (clean cuts: no other window has an edge
        there), then the resident superstep's tail.

        On a dynamic graph the hot compute folds the hot tombstones in and
        combines the hot delta slots' reference compute, as the resident
        superstep does; a base window folds its tombstone slice in (out
        of the block mask, or to a sink segment past the window's range),
        and each cold partition's delta window, streamed after the base
        windows, is combined into its row."""
        use_rev = bool(program.use_reverse)
        td = self._tier.get(use_rev)
        if td is None:
            raise ValueError("program needs reverse edges; partition with "
                             "include_reverse=True")
        spec = program.edge_msg
        fused = self.fused and spec is not None
        combine = program.combine
        dims, hot, stream = td.dims, self._tier_hot, self._tier_stream
        hot_e, arena, hot_delta, cold = td.hot, td.arena, None, ()
        if self.dg is not None:
            pl = self._tier_overlay(use_rev, td)
            if td.ov is not None:
                tomb = td.ov["tomb"]
                hot_e = dict(hot_e)
                if fused:
                    alive = torch.zeros(hot_e["blk_mask"].shape,
                                        dtype=torch.int32, device=self.device)
                    alive[:, :tomb.shape[1]] = ~tomb
                    hot_e["blk_mask"] = hot_e["blk_mask"] * alive
                else:
                    hot_e["dst_ext"] = torch.where(tomb, dims.v_max,
                                                   hot_e["dst_ext"])
                hot_delta = dict(src=td.ov["d_src"],
                                 dst_ext=td.ov["d_dst_ext"])
                if "d_weight" in td.ov:
                    hot_delta["weight"] = td.ov["d_weight"]
            if arena is not None:
                cold = [int(p) for p in self.tier_plan.cold]
                arena = OverlayArena(
                    arena, td.spans, pl["tomb"],
                    {k: pl[k] for k in ("d_src", "d_dst_ext", "d_weight")
                     if k in pl}, cold)
        nbase = len(td.meta)

        def step_fn(state, step):
            def ref_compute(e, sel, nseg):
                msgs = program.edge_fn({k: v[:, sel] for k, v in state.items()},
                                       e["src"], e.get("weight"), float(step))
                return segment_reduce_ref(msgs, e["dst_ext"], nseg, combine)

            if fused:
                vstate, scal = _fused_inputs(spec, state, step)

                def compute(e, sel, nseg):
                    return fused_superstep_op(
                        spec, vstate[:, sel],
                        e.get("weight_blk") if spec.use_weight else None,
                        scal[:, sel], e["blk_src"], e["blk_local"],
                        e["blk_mask"], e["blk_base"], None,
                        num_segments=nseg, combine=combine,
                        block_e=self._block_e)
            else:
                compute = ref_compute

            wins = (stream.windows(arena) if arena is not None
                    else iter(()))
            acc = None
            if hot_e is not None:
                acc_h = compute(hot_e, hot, dims.seg)
                if hot_delta is not None:
                    acc_h = _combine(combine, acc_h,
                                     ref_compute(hot_delta, hot, dims.seg))
                acc = _identity_acc(program, state, dims, acc_h.dtype)
                acc[:, hot] = acc_h
            for w, views in wins:
                if w >= nbase:          # a cold partition's delta window
                    p = cold[w - nbase]
                    d = dict(src=views["d_src"][None],
                             dst_ext=views["d_dst_ext"][None])
                    if "d_weight" in views:
                        d["weight"] = views["d_weight"][None]
                    acc_d = ref_compute(d, slice(p, p + 1), dims.seg)[:, 0]
                    if acc is None:
                        acc = _identity_acc(program, state, dims, acc_d.dtype)
                    acc[:, p] = _combine(combine, acc[:, p], acc_d)
                    continue
                p, lo, nseg = td.meta[w]
                tomb, sink = views.pop("tomb", None), 0
                if tomb is not None:
                    # the buffers are this window's own until its compute
                    # is enqueued: fold the tombstones in place
                    if fused:
                        views["blk_mask"][:tomb.shape[0]].masked_fill_(tomb, 0)
                    else:
                        views["dst_ext"].masked_fill_(tomb, nseg)
                        sink = 1
                acc_w = compute({k: v[None] for k, v in views.items()},
                                slice(p, p + 1), nseg + sink)
                if acc is None:
                    acc = _identity_acc(program, state, dims, acc_w.dtype)
                acc[:, p, lo:lo + nseg] = acc_w[:, 0, :nseg]
            if acc is None:
                acc = _identity_acc(program, state, dims, torch.float32)
            return _finish_superstep(dims, program, td.inbox_dst,
                                     self._exchange, self._all_finished, acc,
                                     state, step, None)
        return step_fn

    def _hybrid_tiered_for(self, program: VertexProgram) -> _HybridTier:
        """The row-tiered degree split ``program`` runs on, built at its
        first run and cached like ``hybrid_for``.

        Rows whose vertex lies in a hot partition stay on the device as a
        compacted CSR; the cold rows stream in windows of ``max(8,
        min(n_cold, block_e))`` rows, as in the JAX package.  Each cut
        gets its own row plan with every row's lane count taken from the
        split's plan (``row_plan(lanes=)``), so every row reduces as in
        the resident engine.  The dense block stays resident.
        """
        key = self._hybrid_key(program)
        hit = self._hyb_tier_cache.get(key)
        if hit is not None:
            return hit
        semiring = self._hybrid_semiring(program)
        rev, k = program.use_reverse, self._hybrid_plan["k_dense"]
        g = self._splits.graph(rev)
        layout = self._splits.layout(k, rev)
        hg = self._splits.split(k, rev, semiring, program.edge_msg.use_weight)
        n = g.num_vertices
        slot, hid = self._slot_hid(layout, n)
        rp = layout.row_ptr.astype(np.int64)
        lens = np.diff(rp)
        col_all = layout.src[layout.rest]
        lanes = plan_lanes(layout.plan)
        with_val = semiring != "min"        # min reads no edge values

        def cut(sel):
            ptr = np.zeros(len(sel) + 1, dtype=np.int64)
            np.cumsum(lens[sel], out=ptr[1:])
            idx = np.repeat(rp[sel] - ptr[:-1], lens[sel]) + np.arange(
                ptr[-1])
            return (ptr, col_all[idx], hg.ell_val[idx],
                    row_plan(ptr, lanes=lanes[sel]))

        cold = np.isin(slot // self.pg.v_max, self.tier_plan.cold)
        hot_rows, cold_rows = np.flatnonzero(~cold), np.flatnonzero(cold)
        put = self._put
        arrs = dict(slot=put(slot, torch.int64), hid=put(hid, torch.int64),
                    dense=put(hg.dense_block, torch.float32))
        if len(hot_rows):
            ptr, col, val, plan = cut(hot_rows)
            arrs.update(row_ptr=put(ptr, torch.int32),
                        col=put(col, torch.int32), plan=plan.to(self.device),
                        rows=put(hot_rows, torch.int64))
            if with_val:
                arrs["val"] = put(val, torch.float32)
        windows, meta = [], []
        if len(cold_rows):
            win_rows = max(8, min(len(cold_rows), self._block_e))
            for s0 in range(0, len(cold_rows), win_rows):
                sel = cold_rows[s0:s0 + win_rows]
                ptr, col, val, plan = cut(sel)
                w = dict(row_ptr=ptr.astype(np.int32),
                         col=col.astype(np.int32), rows=sel,
                         blocks=np.asarray(plan.blocks, np.int32),
                         long_rows=np.asarray(plan.long_rows, np.int32))
                if with_val:
                    w["val"] = val.astype(np.float32)
                windows.append(w)
                meta.append((len(sel), len(col), plan.num_partials))
        arena = stream = None
        if windows:
            arena = HostArena(windows, pin=self.device.type == "cuda")
            stream = WindowStream(
                {k: (t.dtype, arena.max_length(k))
                 for k, t in arena.tensors.items()}, self.device)
            self.tiered_buffers_made += 2
        ent = _HybridTier(cfg=self._hybrid_cfg(program, g, hg), arrs=arrs,
                          arena=arena, stream=stream, meta=tuple(meta))
        self._hyb_tier_cache[key] = ent
        return ent

    def _tiered_hybrid_step_fn(self, program: VertexProgram) -> Callable:
        """One row-tiered hybrid superstep, pull only: the sparse stage on
        the hot rows, then on each streamed row window, each result set
        into its rows of ``y``; then the resident dense stage and the
        resident superstep's tail (``hybrid_spmv``'s stage order)."""
        ht = self._hybrid_tiered_for(program)
        cfg, arrs = ht.cfg, ht.arrs
        ident = add_identity(cfg.semiring)

        def step_fn(state, step):
            _require_f32(program.edge_msg, state, HYBRID)
            _, x = _hybrid_messages(program, arrs, state, step)   # [Q, n]
            xq = query_minor_view(x, ident)
            wins = (ht.stream.windows(ht.arena) if ht.arena is not None
                    else iter(()))
            y = torch.full((x.shape[0], cfg.num_vertices), ident,
                           dtype=torch.float32, device=x.device)
            if "rows" in arrs:
                y[:, arrs["rows"]] = ell_spmv_op(
                    arrs["row_ptr"], arrs["col"], arrs.get("val"), xq,
                    semiring=cfg.semiring, plan=arrs["plan"])
            for w, v in wins:
                rows, slots, parts = ht.meta[w]
                plan = EllPlan(v["blocks"].view(-1, 3),
                               v["long_rows"].view(-1, 2), parts, rows, slots)
                y[:, v["rows"]] = ell_spmv_op(
                    v["row_ptr"], v["col"], v.get("val"), xq,
                    semiring=cfg.semiring, plan=plan)
            dense_stage(y, xq, arrs["dense"], semiring=cfg.semiring,
                        k_dense=cfg.k_dense)
            return _hybrid_finish(program, cfg, arrs["hid"], state, y, step,
                                  None, None, None)
        return step_fn

    def residency_bytes(self, state_bytes: int = 4) -> dict:
        """``{"hbm_bytes", "host_bytes", "total_bytes"}`` of the layout under
        this engine's tier plan (all on the device without one): the paper's
        Table 5 measure (``partition.memory_residency_bytes``)."""
        return memory_residency_bytes(self.pg, tier_plan=self.tier_plan,
                                      state_bytes=state_bytes,
                                      dynamic=self.dg)

    def cache_entries(self) -> int:
        """How many structures this engine has built for its programs: the
        count a serving session's zero-retrace contract holds fixed.

        Eager PyTorch compiles nothing, so this stands in for the JAX
        package's jit-cache sizes.  It counts the hybrid splits and
        layouts (built at a program's first run), the dynamic hybrid's
        splits, the tiered hybrid's row windows, the tiered host arenas
        and window buffers, the pull layout and the CUDA libraries the
        process has loaded (each at its kernel's first launch).  A
        mutation batch adds nothing; a compaction rebind or a dynamic
        split rebuild replaces entries (``dynamic_rebinds``,
        ``hybrid_dyn_rebuilds``).  An engine that builds another structure
        lazily adds it here."""
        from repro_torch.kernels import _build

        return (len(self._hybrid_cache) + len(self._hybrid_layouts)
                + len(self._hyb_tier_cache) + len(self._hybrid_dyn_cache)
                + int(self._pull is not None)
                + self.tiered_buffers_made + len(_build._loaded))

    def tiered_stats(self) -> Optional[dict]:
        """The tier split's counters, or None on an all-resident engine.

        Beside the plan's figures: ``device_arena_bytes``, the bytes of the
        hot arenas (with a dynamic graph's hot overlay) and the window
        buffers the engine holds (equal to ``tier_plan.hbm_bytes``), ``host_arena_bytes``, the pinned arenas'
        bytes, ``row_tier_device_bytes``/``row_tier_host_bytes``, those of
        the hybrid's row-tiered splits built so far, and ``buffers_made``,
        the host arenas and window buffer pairs made so far.  The JAX
        package's compile-cache count (``tiered_cache_entries``) has no
        counterpart: eager PyTorch compiles nothing, and what stays fixed
        across supersteps is ``buffers_made``."""
        if self.tier_plan is None:
            return None
        plan = self.tier_plan
        dev_bytes = sum(t.nbytes for td in self._tier.values()
                        for arrs in (td.hot, td.ov) if arrs is not None
                        for t in arrs.values())
        if self._tier_stream is not None:
            dev_bytes += self._tier_stream.nbytes
        host = sum(td.arena.nbytes for td in self._tier.values()
                   if td.arena is not None)
        row_dev = row_host = 0
        for ht in self._hyb_tier_cache.values():
            row_dev += sum(t.nbytes for t in ht.arrs.values()
                           if isinstance(t, torch.Tensor))
            if "plan" in ht.arrs:
                row_dev += sum(t.nbytes for t in ht.arrs["plan"][:2])
            if ht.arena is not None:
                row_dev += ht.stream.nbytes
                row_host += ht.arena.nbytes
        return dict(hbm_resident_bytes=int(plan.hbm_bytes),
                    host_bytes=int(plan.host_bytes),
                    streamed_bytes_per_superstep=int(
                        plan.streamed_bytes_per_superstep),
                    window_count=int(plan.window_count),
                    num_hot=len(plan.hot), num_cold=len(plan.cold),
                    device_arena_bytes=int(dev_bytes),
                    host_arena_bytes=int(host),
                    row_tier_device_bytes=int(row_dev),
                    row_tier_host_bytes=int(row_host),
                    buffers_made=self.tiered_buffers_made)

    def _local(self, state: State) -> State:
        """The engine's part of a global ``[Q, P, ...]`` state: all of it."""
        return state

    def _global(self, state: State) -> State:
        """The global state back from the engine's part."""
        return state

    def execute(self, program: VertexProgram, state: State, *,
                num_steps: Optional[int] = None, chunk: Optional[int] = None,
                on_chunk: Optional[Callable] = None, incremental=None,
                start_step: int = 0, fin=None, steps_q=None,
                max_chunks: Optional[int] = None,
                chaos_ctx: Optional[dict] = None, monitor=None):
        """Run ``program`` on a batched ``[Q, P, v_max]`` state dict.

        - ``execute(program, state)`` — run to convergence; returns
          ``(state, steps_q [Q])``.
        - ``execute(program, state, num_steps=n)`` — exactly ``n``
          supersteps (PageRank); returns the final state.
        - ``execute(program, state, chunk=k)`` — the converge loop in
          windows of ``k`` supersteps, with the boundary protocol of
          :meth:`_run_batched_chunked` (``on_chunk``, ``monitor``, the
          checked exchange, the chaos sites with ``chaos_ctx``) and its
          resume carry (``start_step``, ``fin``, ``steps_q``,
          ``max_chunks``); returns ``(state, steps_q, info)``.

        - ``execute(program, prev_state, incremental=dirty)`` — warm start
          from a previous fixpoint over a ``[P, v_max]`` dirty mask: the
          program's :class:`IncrementalForm` seeds the state and its
          relaxation program runs to convergence; returns ``(state,
          steps_q)``, or None when the program has no form.

        Leaves are moved to the engine's device.  Eligible min-combine
        programs run direction optimized (see the class docstring), except
        in chunked mode, whose slot refills swap user state rows only: the
        fused and reference backends push there, the hybrid runs its pull
        SpMV.  Incompatible keywords raise with the fix spelled out.
        """
        modes = {"num_steps": num_steps is not None,
                 "chunk": chunk is not None,
                 "incremental": incremental is not None}
        picked = [k for k, v in modes.items() if v]
        if len(picked) > 1:
            raise ValueError(
                f"execute() got {' + '.join(picked)} — these select "
                f"mutually exclusive run modes; pass exactly one (or none "
                f"for run-to-convergence).  Fixed-step chunking is not a "
                f"mode: restate the program with a never-voting apply "
                f"(see _fixed_step_program) and pass chunk= alone.")
        if modes["chunk"] and self.tier_plan is not None:
            raise ValueError(
                "chunked/continuous mode is not supported on a tiered "
                "engine: chunk windows assume resident edge dicts; run "
                "tiered convergence (drop chunk=) or build the engine "
                "without tiered=")
        if not modes["chunk"]:
            chunked_only = [
                name for name, val in (("on_chunk", on_chunk),
                                       ("fin", fin), ("steps_q", steps_q),
                                       ("max_chunks", max_chunks),
                                       ("chaos_ctx", chaos_ctx),
                                       ("monitor", monitor))
                if val is not None] + (
                    ["start_step"] if start_step != 0 else [])
            if chunked_only:
                raise ValueError(
                    f"execute() got {', '.join(chunked_only)} without "
                    f"chunk= — boundary hooks and resume carries only "
                    f"exist in chunked mode; pass chunk=<supersteps per "
                    f"window> (e.g. chunk=2).")
        with tracing.span("engine.execute"):
            if modes["chunk"]:
                return self._run_batched_chunked(
                    program, state, checkpoint_every=chunk,
                    on_chunk=on_chunk, start_step=start_step, fin=fin,
                    steps_q=steps_q, max_chunks=max_chunks,
                    chaos_ctx=chaos_ctx, monitor=monitor)
            return self._execute(program, state, num_steps, incremental)

    def _execute(self, program: VertexProgram, state: State,
                 num_steps: Optional[int], incremental):
        """``execute`` to convergence, for ``num_steps`` or from a warm
        start, its arguments checked."""
        if self.dg is not None:
            self._sync_dynamic()
        self.last_direction_stats = None
        state = {k: torch.as_tensor(v, device=self.device)
                 for k, v in state.items()}
        if incremental is not None:
            inc = program.incremental
            if inc is None:
                return None
            # seed, then run the relaxation program to convergence (it
            # votes its direction like any other)
            state = inc.seed(state, torch.as_tensor(np.asarray(incremental),
                                                    device=self.device))
            program = inc.program
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
        if num_steps is not None:
            step_fn = self._step_fn(program, dopt_cfg)
            for i in range(num_steps):
                with tracing.span("bsp.superstep", step=i):
                    state, _ = step_fn(state, i)
            return self._dopt_finish(self._global(state))
        step_fn = self._step_fn(program, dopt_cfg)
        state, steps_q = _run_batched_loop(step_fn, program.max_steps, state,
                                           num_queries(state))
        return self._dopt_finish(self._global(state)), steps_q

    def _dopt_finish(self, state: State) -> State:
        """Strip the direction leaves and record per-query aggregates."""
        state, dopt = _dopt_strip(state)
        if dopt is not None:
            with tracing.span("engine.direction_stats"):
                self.last_direction_stats = dict(
                    direction=dopt["_dopt_dir"].cpu().numpy(),
                    edges_examined=dopt["_dopt_edges"].sum(1).cpu().numpy(),
                    switches=dopt["_dopt_switch"].sum(1).cpu().numpy())
        return state

    # ---------------------- chunked (continuous) mode ----------------------

    def _tombstone_flip(self, step: int) -> bool:
        """The ``tombstone.flip`` site of a dynamic chunk window."""
        return chaos.visit("tombstone.flip", step=int(step))

    def _chunk_call(self, program: VertexProgram, chunk: int, state: State,
                    step: int, fin: torch.Tensor, steps_q: torch.Tensor,
                    poison: bool = False):
        """One window of at most ``chunk`` supersteps on the global state:
        the engine's part of it goes in, the global state comes back (on
        a sharded engine, sliced on entry and all-gathered at the
        boundary; the votes are global on every rank).  Returns ``(state,
        step, fin, steps_q, bad)``.

        On a static graph every exchange of the window is checked, and
        ``bad`` is its count of tag mismatches: a tensor on the device, or
        None when no exchange ran.  ``poison`` corrupts the wire (the
        ``exchange.payload`` site).  Dynamic windows run unchecked (their
        integrity net is the certifier layer) and return None; their
        reference and fused backends visit ``tombstone.flip``."""
        guard, flip = None, False
        if self.dg is not None:
            self._sync_dynamic()
            flip = (not self._uses_hybrid(program)
                    and self._tombstone_flip(step))
        else:
            guard = _ExchangeGuard(poison)
        out, step, fin, steps_q = _run_chunked_loop(
            self._step_fn(program, guard=guard, flip_tomb=flip), chunk,
            program.max_steps, self._local(state), step, fin, steps_q)
        return (self._global(out), step, fin, steps_q,
                None if guard is None else guard.read())

    def _run_batched_chunked(self, program: VertexProgram, state: State, *,
                             checkpoint_every: int,
                             on_chunk: Optional[Callable] = None,
                             start_step: int = 0, fin=None, steps_q=None,
                             max_chunks: Optional[int] = None,
                             chaos_ctx: Optional[dict] = None,
                             monitor=None):
        """The converge loop in windows of ``checkpoint_every`` supersteps.

        Chained windows run the resident loop's superstep sequence, so
        every query's result and step count are those of ``execute(program,
        state)``; between windows the carry is on the host's side.
        ``on_chunk(snap)`` gets ``{"state", "step", "fin", "steps_q"}`` at
        each boundary (state tensors on the engine's device, the rest
        numpy) and may steer the carry:

        - return a ``[Q]`` bool mask: force-finish those queries
          (quarantine; they freeze bitwise like converged ones);
        - return a dict, the continuous-batching protocol: ``{"kill":
          mask}`` as above, ``{"refill": (new_rows, admit)}`` swaps the
          admitted slots' state in (:func:`_slot_swap`: votes cleared,
          counters zeroed), ``{"stop": True}`` ends the run at this
          boundary.  Kills apply before refills.

        The all-finished exit is checked after the hook, so a refill keeps
        the loop running.  ``monitor`` (duck-typed: ``observe(snap) ->
        {"violations", ...}`` and ``rebase(admit)``, e.g.
        :class:`repro_torch.runtime.verify.InvariantMonitor`) is observed
        once per window; its record rides to ``on_chunk`` as
        ``snap["monitor"]``.  Resume a carry with ``start_step``/``fin``/
        ``steps_q``.  Returns ``(state, steps_q, info)``, ``info =
        {"chunks", "final_step", "finished", "refilled",
        "monitors_fired"}``.

        Integrity: every static-graph window runs the checked exchange; its
        mismatch count is read with the votes and step counters in one copy
        at the boundary, and a nonzero count raises
        :class:`repro_torch.runtime.failures.ExchangeCorruption` *before*
        the corrupted carry replaces the live one, so the caller replays
        the window from its last checkpoint.  The chaos sites
        ``superstep.chunk``, ``state.corrupt`` and ``exchange.payload`` are
        visited before each window with ``chaos_ctx`` in their context.
        """
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        dev = self.device
        state = {k: torch.as_tensor(v, device=dev) for k, v in state.items()}
        q = num_queries(state)
        ctx = chaos_ctx or {}

        def mask(x):
            return torch.as_tensor(x, device=dev).to(torch.bool).reshape(q)

        fin = (torch.zeros(q, dtype=torch.bool, device=dev) if fin is None
               else mask(fin))
        steps_q = (torch.zeros(q, dtype=torch.int32, device=dev)
                   if steps_q is None else torch.as_tensor(
                       steps_q, device=dev).to(torch.int32).reshape(q))
        step = int(start_step)
        chunks = refilled = monitors_fired = 0
        while True:
            chaos.visit("superstep.chunk", step=step, chunk=chunks, **ctx)
            if chaos.visit("state.corrupt", step=step, **ctx):
                state = _flip_state_bit(state)
            poison = chaos.visit("exchange.payload", step=step, **ctx)
            new_state, new_step, new_fin, new_steps_q, bad = \
                self._chunk_call(program, int(checkpoint_every), state,
                                 step, fin, steps_q, poison)
            # the boundary's one read: votes, counters, mismatch count
            parts = [new_fin.to(torch.int64), new_steps_q.to(torch.int64)]
            if bad is not None:
                parts.append(bad.reshape(1).to(torch.int64))
            host = torch.cat(parts).cpu().numpy()
            n_bad = int(host[2 * q]) if bad is not None else 0
            if n_bad:
                # the corrupted window never replaces the live carry; the
                # caller's RestartPolicy replays it from the last
                # checkpoint (ExchangeCorruption is a WorkerFailure)
                raise ExchangeCorruption(
                    f"exchange checksum mismatch in window at superstep "
                    f"{step} ({n_bad} tag(s)): a payload block was "
                    f"corrupted in flight; replay the window from the last "
                    f"checkpoint")
            state, step, fin, steps_q = (new_state, new_step, new_fin,
                                         new_steps_q)
            chunks += 1
            stop = False
            snap = dict(state=state, step=step,
                        fin=host[:q].astype(bool),
                        steps_q=host[q:2 * q].astype(np.int32))
            if monitor is not None:
                rec = monitor.observe(dict(state=state, step=step,
                                           finished=snap["fin"],
                                           steps_q=snap["steps_q"]))
                monitors_fired += int(rec["violations"] > 0)
                snap["monitor"] = rec
            fin_h = snap["fin"].copy()    # fin as the hook leaves it
            if on_chunk is not None:
                out = on_chunk(snap)
                if isinstance(out, dict):
                    if out.get("kill") is not None:
                        fin = fin | mask(out["kill"])
                        fin_h |= np.asarray(out["kill"], bool).reshape(q)
                    if out.get("refill") is not None:
                        new_rows, admit = out["refill"]
                        admit_np = np.asarray(admit, dtype=bool).reshape(q)
                        state, fin, steps_q = _slot_swap(
                            state, new_rows, mask(admit_np), fin, steps_q)
                        fin_h &= ~admit_np
                        refilled += int(admit_np.sum())
                        if monitor is not None:
                            monitor.rebase(admit_np)
                    stop = bool(out.get("stop"))
                elif out is not None:        # a bare kill mask
                    fin = fin | mask(out)
                    fin_h |= np.asarray(out, bool).reshape(q)
            if stop or fin_h.all() or step >= program.max_steps:
                break
            if max_chunks is not None and chunks >= max_chunks:
                break
        info = dict(chunks=chunks, final_step=step,
                    finished=fin_h, refilled=refilled,
                    monitors_fired=monitors_fired)
        return state, steps_q, info


class _EllOverflow(RuntimeError):
    """A dynamic hybrid row (or the push arrays) ran out of spare slots:
    the split is rebuilt."""


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

    ``execute(chunk=k)`` runs the same windows as on one device: every
    rank runs the boundary protocol on the global state, which a window
    slices on entry and all-gathers at the boundary, and the votes are the
    global AND.  Each window visits ``worker.chunk`` (with the ``shards``
    of the group) and runs the checked exchange (:meth:`_exchange` with
    a guard, or the sharded hybrid's tagged compact exchange); the
    mismatch count is summed over the group, so
    every rank raises ``ExchangeCorruption`` at the same boundary.

    Over a ``DynamicGraph`` (each rank holds its own, built from the same
    graph and fed the same batches) the reference and fused backends read
    each rank's slice of the payload; the sharded hybrid's exchange maps
    are fixed used-slot sets, so it consumes pending batches by a
    compaction before its next run, and ``should_resplit_hybrid`` is False
    (each compaction re-plans).

    ``tiered=`` raises: tiering is single-device only, as in the JAX
    package.
    """

    def __init__(self, pg, group=None, *,
                 device: DeviceLike = None, tiered=None, **kwargs):
        from repro_torch.core.dynamic import DynamicGraph

        if tiered is not None:
            raise ValueError(
                "tiered= is single-device only: the sharded superstep has "
                "no host-streaming seam; drop tiered= or use BSPEngine")
        inner = pg.pg if isinstance(pg, DynamicGraph) else pg
        if not isinstance(inner, PartitionedGraph):
            raise TypeError(f"a sharded engine runs over a PartitionedGraph "
                            f"or a DynamicGraph, not {type(pg).__name__}")
        self.group = (group if isinstance(group, ShardGroup)
                      else ShardGroup(group, device))
        if inner.num_parts % self.group.world_size:
            raise ValueError(
                f"num_parts ({inner.num_parts}) must divide over the world "
                f"size ({self.group.world_size}): every rank holds the same "
                f"number of partitions")
        super().__init__(pg, device=self.group.device, **kwargs)

    # ------------------------- dynamic graphs ------------------------------

    def _sync_dynamic(self) -> None:
        # The sharded hybrid's exchange maps (send_idx/recv_ids) are fixed
        # used-slot sets that in-place deltas cannot extend, so pending
        # batches are consumed through a compaction, as in the JAX package.
        if self.backend == HYBRID and self.dg.batches_in_version:
            self.dg.compact()
        super()._sync_dynamic()

    def should_resplit_hybrid(self, threshold: float = 0.10) -> bool:
        """False: the sharded hybrid consumes mutations by compactions, each
        of which re-plans the per-shard split."""
        return False

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

    def _exchange(self, outbox: torch.Tensor,
                  guard: Optional[_ExchangeGuard] = None) -> torch.Tensor:
        """Outboxes ``[Q, pl, P, o_max]`` -> inboxes of the same shape (the
        JAX ``_dist_exchange``): the peer axis regroups as (rank, local
        partition), moves to the front for ``all_to_all``, and comes back.

        With ``guard`` it is checked (the JAX ``_checked_dist_exchange``):
        a tag per (rank, source partition, destination partition) block
        ships over its own ``all_to_all`` and the receiver re-derives it,
        so a wire flip lands in ``guard`` (see :func:`_checked_exchange`).
        Under the poison every rank corrupts its own first element, as
        every shard does in the JAX package, so the group counts the world
        size."""
        chaos.visit("exchange", world=self.group.world_size)
        q, pl, peers, o = outbox.shape
        world = self.group.world_size
        if peers != world * pl:
            raise ValueError(
                f"outbox shape {tuple(outbox.shape)} is inconsistent with the "
                f"group: the peer axis ({peers}) must equal the world size "
                f"({world}) x local partitions ({pl})")
        ob = outbox.reshape(q, pl, world, pl, o)
        if guard is not None:
            send_tags = _payload_tag(ob, (0, 4))    # [pl_src, world, pl_dst]
            ob = _flip_wire(ob) if guard.poison else ob
        recv = self.group.all_to_all(ob.permute(2, 0, 1, 3, 4))
        # recv: [world, Q, pl_src, pl_dst, o]
        if guard is not None:
            want = self.group.all_to_all(send_tags.permute(1, 0, 2))
            got = _payload_tag(recv, (1, 4))   # [world_src, pl_src, pl_dst]
            guard.add((got != want).sum())
        return recv.permute(1, 3, 0, 2, 4).reshape(q, pl, peers, o)

    def _guarded_exchange(self, guard: _ExchangeGuard) -> Callable:
        return functools.partial(self._exchange, guard=guard)

    def _tombstone_flip(self, step: int) -> bool:
        """False: the ``tombstone.flip`` site is the single-device
        dispatch's, as in the JAX package."""
        return False

    def _chunk_call(self, program: VertexProgram, chunk: int, state: State,
                    step: int, fin: torch.Tensor, steps_q: torch.Tensor,
                    poison: bool = False):
        """:meth:`BSPEngine._chunk_call` with the ``worker.chunk`` site and
        the mismatch count summed over the group (each rank only sees the
        payload it received)."""
        self._validate_state(state)
        chaos.visit("worker.chunk", step=int(step),
                    shards=tuple(range(self.group.world_size)))
        *out, bad = super()._chunk_call(program, chunk, state, step, fin,
                                        steps_q, poison)
        return (*out, None if bad is None else self.group.all_sum(bad))

    def _all_finished(self, fin: torch.Tensor) -> torch.Tensor:
        """Per-shard votes ``[Q]`` -> the global AND (JAX
        ``_dist_finished``)."""
        return self.group.all_true(fin)

    def superstep(self, program: VertexProgram) -> Callable:
        """One superstep ``f(state, step) -> (state, finished)`` of
        ``program``: the benchmarking hook.  ``state`` is a global
        unbatched ``[P, v_max]`` state dict, moved to the engine's device
        and run as a Q=1 batch by the step function ``execute`` runs
        (push: no direction leaves ride the state); ``finished`` is the
        global vote, a bool tensor.  Syncs a dynamic graph first."""
        if self.dg is not None:
            self._sync_dynamic()
        step_fn = self._step_fn(program)

        def fn(state, step):
            state = batch_state({k: torch.as_tensor(v, device=self.device)
                                 for k, v in state.items()})
            out, fin = step_fn(self._local(state), int(step))
            return unbatch_state(self._global(out)), fin[0]

        return fn

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
        per direction, semiring, weight use and frontier uniformity.  On a
        dynamic graph it is the split of the compacted layout."""
        if self.dg is not None:
            self._sync_dynamic()
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

    def _step_fn(self, program: VertexProgram,
                 dopt_cfg: Optional[_DoptCfg] = None,
                 guard: Optional[_ExchangeGuard] = None,
                 flip_tomb: bool = False) -> Callable:
        """:meth:`BSPEngine._step_fn`; the sharded hybrid checks its wire
        (the compact exchange) under ``guard``."""
        if self._uses_hybrid(program):     # never tiered (see __init__)
            cfg, arrs = self.hybrid_for(program)
            return functools.partial(_superstep_hybrid_dist, program, cfg,
                                     arrs, self.group, guard=guard)
        return super()._step_fn(program, dopt_cfg, guard, flip_tomb)
