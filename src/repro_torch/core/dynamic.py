"""The dynamic-graph layer: in-place edge mutations over a resident layout.

Port of ``repro.core.dynamic``.  :class:`DynamicGraph` makes mutation an
axis of the static stack (CSR → partition → block metadata → engine)
without a rebuild per batch:

- **Delta edge slots.**  Each partition reserves ``delta_slots`` edge slots
  (``[P, d_max]`` arrays beside ``src``/``dst_ext``/``weight``); inserted
  edges occupy slots, and unoccupied or cleared slots point their extended
  destination at the segment sink, so the engine's ⊕-reduction drops them.
- **Tombstones.**  Deleting a base edge flips one bit of a ``[P, e_max]``
  mask; the engine sends tombstoned edges to the sink (reference path) or
  zeroes their block mask (fused kernel).  Nothing moves.
- **Spare outbox slots.**  ``partition(..., spare_outbox=k)`` reserves
  ``k`` unassigned slots per (partition, peer) pair; an inserted boundary
  edge to a remote vertex that had no slot claims one, and the symmetric
  ``inbox_dst`` entry is written.  ``o_max`` never changes.
- **Application.**  ``apply_mutations(batch)`` plans on the host (slot
  allocation, FIFO delete resolution through :class:`graph.EdgeLedger`)
  and writes the device payload with one indexed write per array.  The
  JAX package pads each batch to ``mutation_capacity`` so one XLA trace
  serves every batch; eager PyTorch compiles nothing, so the writes carry
  only the batch's own entries.
- **Compaction.**  When the staleness signals trip (delta occupancy,
  tombstone fraction, outbox-slot pressure, degree-skew drift),
  ``compact()`` folds the ledger into a fresh canonical partition: the one
  rebuild, reported as a pause by the serving launcher.

The payload (``tomb``, ``d_src``, ``d_dst_ext``, ``d_weight``,
``inbox_dst``) lives as tensors on ``device`` (``cuda`` unless named); the
host mirrors equal the JAX package's arrays after the same stream.  The
engine (``core/bsp.py``) reads the payload at every run, so a mutation
batch rebuilds nothing there.  A tiered engine takes a graph whose
payload is on the CPU (pinned with ``pin=True`` for a card) and streams
the cold partitions' part of it.

Recovery: ``snapshot()`` gives the payload and the replay cursor for
``CheckpointManager.save_tree``; a restart rebuilds the graph from base
and ``replay``s the acknowledged batches, which gives the same payload bit
for bit.  ``apply_mutations`` visits the chaos sites ``mutation.apply``
(on entry) and ``mutation.scatter`` (after the host planning, before the
device writes).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.graph import CSRGraph, EdgeLedger, MutationBatch
from repro_torch.core.partition import (EdgeArrays, _build_edge_arrays,
                                        _round_up, build_block_metadata,
                                        partition)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime import chaos


class CapacityError(RuntimeError):
    """A mutation batch exceeds the graph's fixed in-place headroom."""


@dataclasses.dataclass
class _DirState:
    """Host mirrors of one direction's mutable layout."""

    ea: EdgeArrays
    reverse: bool
    tomb: np.ndarray                    # [P, e_max] bool
    d_src: np.ndarray                   # [P, d_max] int32
    d_dst_ext: np.ndarray               # [P, d_max] int32 (sink = v_max)
    d_w: Optional[np.ndarray]           # [P, d_max] f32 or None
    d_cnt: np.ndarray                   # [P] high-water occupancy
    d_free: List[List[int]]             # reusable cleared slots per partition
    obox_dst: np.ndarray                # [P, P, o_max] int32 (live copy)
    obox_used: np.ndarray               # [P, P] allocated slot counts
    obox_used0: np.ndarray              # [P, P] counts at bind time
    # (p, q, peer-local id) -> outbox slot, -1 where none: the JAX
    # package's per-pair dicts as one array
    slot_of: np.ndarray                 # [P, P, v_max] int32
    base_p: np.ndarray                  # [num_base] int32 partition
    base_pos: np.ndarray                # [num_base] int64 slot in [P, e_max]
    delta_loc: Dict[int, Tuple[int, int]]  # iid -> (p, delta slot)

    def delta_live(self, p: int) -> int:
        return int(self.d_cnt[p]) - len(self.d_free[p])


class DynamicGraph:
    """A partitioned graph that accepts in-place edge mutation batches.

    Wraps :func:`partition.partition` output plus per-partition delta
    slots, tombstone masks and live outbox maps.  Hand the
    *DynamicGraph* (not the inner ``pg``) to ``bsp.BSPEngine`` or
    ``DistributedBSPEngine``; the engine reads the device payload at each
    run, so ``apply_mutations`` between runs rebuilds nothing.

    ``delta_slots`` is the per-partition insert capacity between
    compactions, ``spare_outbox`` the per-peer-pair boundary headroom,
    ``mutation_capacity`` the most edges a batch may hold.  When a batch
    does not fit the remaining headroom the graph compacts first (the
    explicit pause), then applies it.  ``device`` holds the payload
    (``cuda`` unless named); ``pin=True`` keeps a CPU payload in pinned
    memory, which a tiered engine on a card streams from.
    """

    def __init__(self, g: CSRGraph, num_parts: int, strategy: str = "rand",
                 *, delta_slots: Optional[int] = None,
                 spare_outbox: Optional[int] = None,
                 mutation_capacity: int = 1024,
                 include_reverse: bool = False,
                 cpu_edge_fraction: Optional[float] = None,
                 seed: int = 0, align: int = 8,
                 device: DeviceLike = None, pin: bool = False):
        self.device = resolve_device(device)
        if pin and self.device.type != "cpu":
            raise ValueError(f"pin=True keeps the payload in pinned host "
                             f"memory; the device is {self.device}")
        self.pin = bool(pin)
        self.mutation_capacity = int(mutation_capacity)
        if delta_slots is None:
            delta_slots = _round_up(4 * self.mutation_capacity, align)
        if spare_outbox is None:
            spare_outbox = self.mutation_capacity
        self.delta_slots = max(_round_up(int(delta_slots), align), align)
        self._part_kwargs = dict(
            num_parts=num_parts, strategy=strategy,
            cpu_edge_fraction=cpu_edge_fraction, seed=seed,
            include_reverse=include_reverse, align=align,
            spare_outbox=int(spare_outbox))
        self.pg = partition(g, **self._part_kwargs)
        self.weighted = g.weights is not None
        self.version = 0             # bumped by every compaction
        self.num_batches = 0         # global batch counter (never reset)
        self.batches_in_version = 0
        self.compactions = 0
        self.last_compaction_ms = 0.0
        # Bounded history of recent batches (dirty sources, monotone flag,
        # the batch itself for the hybrid reconcile).  log_floor is the
        # highest batch index already dropped: a consumer holding an older
        # mark falls back (cold recompute, split rebuild).
        self.log_retain = 256
        self._batch_log: List[dict] = []
        self.log_floor = 0
        self._base_skew: Optional[float] = None
        self._csr_memo: Optional[tuple] = None
        self._bind()

    # ------------------------------------------------------------------
    # construction / rebind
    # ------------------------------------------------------------------

    @property
    def directions(self) -> int:
        return 2 if self.pg.rev is not None else 1

    @property
    def num_edges(self) -> int:
        return len(self.ledger)

    def _bind(self) -> None:
        """(Re)initialize the ledger, host mirrors and device payload from
        the current ``self.pg``: construction and compaction land here."""
        g = self.pg.source
        self.ledger = EdgeLedger(g)
        rev_of = np.argsort(g.col, kind="stable")  # rev edge j -> orig edge
        self._fwd = self._bind_dir(self.pg.fwd, None)
        self._rev = (self._bind_dir(self.pg.rev, rev_of)
                     if self.pg.rev is not None else None)
        self._payload = {False: self._device_payload(self._fwd)}
        if self._rev is not None:
            self._payload[True] = self._device_payload(self._rev)
        self.batches_in_version = 0

    def _bind_dir(self, ea: EdgeArrays, rev_of: Optional[np.ndarray]
                  ) -> _DirState:
        pg = self.pg
        P, e_max = pg.num_parts, ea.e_max
        d_max = self.delta_slots
        obox_used = ea.outbox_mask.sum(axis=2).astype(np.int64)
        slot_of = np.full((P, P, pg.v_max), -1, dtype=np.int32)
        for p in range(P):
            for q in range(P):
                k = int(obox_used[p, q])
                if p != q and k:
                    slot_of[p, q, ea.outbox_dst[p, q, :k]] = np.arange(k)
        np.fill_diagonal(obox_used, 0)
        num_base = int(ea.num_edges.sum())
        base_p = np.full(num_base, -1, dtype=np.int32)
        base_pos = np.full(num_base, -1, dtype=np.int64)
        for p in range(P):
            ids = ea.edge_id[p]
            pos = np.flatnonzero(ids >= 0)
            orig = ids[pos]
            if rev_of is not None:
                orig = rev_of[orig]
            base_p[orig] = p
            base_pos[orig] = pos
        return _DirState(
            ea=ea, reverse=rev_of is not None,
            tomb=np.zeros((P, e_max), dtype=bool),
            d_src=np.zeros((P, d_max), dtype=np.int32),
            d_dst_ext=np.full((P, d_max), pg.v_max, dtype=np.int32),
            d_w=(np.zeros((P, d_max), dtype=np.float32)
                 if ea.weight is not None else None),
            d_cnt=np.zeros(P, dtype=np.int64),
            d_free=[[] for _ in range(P)],
            obox_dst=ea.outbox_dst.copy(), obox_used=obox_used,
            obox_used0=obox_used.copy(), slot_of=slot_of,
            base_p=base_p, base_pos=base_pos, delta_loc={})

    def _device_payload(self, ds: _DirState) -> Dict[str, torch.Tensor]:
        def put(x, dtype):
            t = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                device=self.device)
            return t.pin_memory() if self.pin else t

        pl = {"tomb": put(ds.tomb, torch.bool),
              "d_src": put(ds.d_src, torch.int64),
              "d_dst_ext": put(ds.d_dst_ext, torch.int64),
              "inbox_dst": put(ds.obox_dst.transpose(1, 0, 2), torch.int64)}
        if ds.d_w is not None:
            pl["d_weight"] = put(ds.d_w, torch.float32)
        return pl

    def payload(self, use_reverse: bool = False) -> Dict[str, torch.Tensor]:
        """This direction's device arrays: ``tomb [P, e_max]`` bool,
        ``d_src``/``d_dst_ext [P, d_max]`` int64, ``d_weight [P, d_max]``
        f32 (weighted graphs), ``inbox_dst [P, P, o_max]`` int64.  Batches
        write them in place; a compaction makes new ones."""
        if use_reverse and True not in self._payload:
            raise ValueError("dynamic graph built without include_reverse")
        return self._payload[bool(use_reverse) and True in self._payload]

    # ------------------------------------------------------------------
    # mutation application
    # ------------------------------------------------------------------

    def _dirs(self):
        out = [(self._fwd, False)]
        if self._rev is not None:
            out.append((self._rev, True))
        return out

    def _fits(self, batch: MutationBatch) -> bool:
        """Exact dry-run capacity check (no state is touched)."""
        asg = self.pg.assignment
        for ds, reverse in self._dirs():
            free = {p: self.delta_slots - ds.delta_live(p)
                    for p in range(self.pg.num_parts)}
            new_slots: Dict[Tuple[int, int], set] = {}
            for i in range(len(batch)):
                if not batch.insert[i]:
                    continue
                a, b = ((batch.dst[i], batch.src[i]) if reverse
                        else (batch.src[i], batch.dst[i]))
                p = int(asg.part_of[a])
                q = int(asg.part_of[b])
                free[p] -= 1
                if free[p] < 0:
                    return False
                if p != q and ds.slot_of[p, q, asg.local_id[b]] < 0:
                    pend = new_slots.setdefault((p, q), set())
                    pend.add(int(b))
                    if ds.obox_used[p, q] + len(pend) > ds.ea.o_max:
                        return False
        return True

    def apply_mutations(self, batch: MutationBatch) -> dict:
        """Apply one batch in place; returns the application report.

        The host resolves every operation to indexed writes (delta slots,
        tombstones, new outbox/inbox slots, degree updates); the device
        takes one indexed write per array and direction.  Compacts first
        when the batch does not fit the remaining headroom.  The report
        carries ``edges_per_sec`` (host planning and device writes,
        compaction pauses excluded — those are ``compacted`` and
        ``last_compaction_ms``), ``dirty`` (global sources of inserted
        edges: the warm-start frontier seed) and ``monotone``.
        """
        chaos.visit("mutation.apply", index=self.num_batches)
        batch.validate(self.pg.num_vertices)
        if len(batch) > self.mutation_capacity:
            raise CapacityError(
                f"batch of {len(batch)} edges exceeds mutation_capacity="
                f"{self.mutation_capacity}")
        compacted = False
        if not self._fits(batch):
            self.compact()
            compacted = True
            if not self._fits(batch):
                raise CapacityError(
                    "mutation batch exceeds a freshly-compacted graph's "
                    "delta/outbox headroom; raise delta_slots/spare_outbox")

        t0 = time.perf_counter()
        asg = self.pg.assignment
        upds = {False: {}, True: {}}   # per direction: key -> {flat: val}

        def put(reverse, key, flat, val):
            upds[reverse].setdefault(key, {})[int(flat)] = val

        dirty = set()
        w_all = batch.weight
        for i in range(len(batch)):
            u, v = int(batch.src[i]), int(batch.dst[i])
            w = float(w_all[i]) if w_all is not None else None
            if batch.insert[i]:
                iid = self.ledger.insert(u, v, w)
                dirty.add(u)
                for ds, reverse in self._dirs():
                    a, b = (v, u) if reverse else (u, v)
                    self._insert_dir(ds, reverse, iid, a, b, w, put)
                self.pg.out_deg[asg.part_of[u], asg.local_id[u]] += 1.0
            else:
                iid, _ = self.ledger.delete(u, v)
                for ds, reverse in self._dirs():
                    rec = ds.delta_loc.pop(iid, None)
                    if rec is None:            # base instance: tombstone
                        p = int(ds.base_p[iid])
                        pos = int(ds.base_pos[iid])
                        ds.tomb[p, pos] = True
                        put(reverse, "tomb", p * ds.ea.e_max + pos, True)
                    else:                      # delta instance: clear slot
                        p, pos = rec
                        ds.d_dst_ext[p, pos] = self.pg.v_max
                        ds.d_free[p].append(pos)
                        put(reverse, "d_dst_ext",
                            p * self.delta_slots + pos, self.pg.v_max)
                self.pg.out_deg[asg.part_of[u], asg.local_id[u]] -= 1.0

        # mid-batch fault site: host planning done, device writes not yet
        # issued.  A fault here leaves the batch unacknowledged and the
        # host mirrors partly advanced, so recovery rebuilds from base and
        # replays the acknowledged log.
        chaos.visit("mutation.scatter", index=self.num_batches)
        for ds, reverse in self._dirs():
            self._apply_device(self._payload[reverse], upds[reverse])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        apply_s = time.perf_counter() - t0

        self.num_batches += 1
        self.batches_in_version += 1
        rec = dict(index=self.num_batches, batch=batch,
                   dirty=np.fromiter(dirty, dtype=np.int64,
                                     count=len(dirty)),
                   monotone=batch.monotone)
        self._batch_log.append(rec)
        while len(self._batch_log) > self.log_retain:
            self.log_floor = self._batch_log.pop(0)["index"]
        return dict(num_edges=len(batch), inserts=batch.num_inserts,
                    deletes=batch.num_deletes, monotone=batch.monotone,
                    apply_ms=apply_s * 1e3,
                    edges_per_sec=len(batch) / max(apply_s, 1e-9),
                    compacted=compacted,
                    dirty=rec["dirty"])

    def _insert_dir(self, ds: _DirState, reverse: bool, iid: int,
                    a: int, b: int, w: Optional[float], put) -> None:
        pg = self.pg
        asg = pg.assignment
        p = int(asg.part_of[a])
        q = int(asg.part_of[b])
        b_local = int(asg.local_id[b])
        if p == q:
            ext = b_local
        else:
            s = int(ds.slot_of[p, q, b_local])
            if s < 0:
                s = int(ds.obox_used[p, q])
                ds.obox_used[p, q] += 1
                ds.slot_of[p, q, b_local] = s
                ds.obox_dst[p, q, s] = b_local
                # symmetric inbox entry on the receiving side
                P, o_max = pg.num_parts, ds.ea.o_max
                put(reverse, "inbox_dst", (q * P + p) * o_max + s, b_local)
            ext = pg.v_max + 1 + q * ds.ea.o_max + s
        slot = ds.d_free[p].pop() if ds.d_free[p] else int(ds.d_cnt[p])
        if slot == ds.d_cnt[p]:
            ds.d_cnt[p] += 1
        ds.delta_loc[iid] = (p, slot)
        a_local = int(asg.local_id[a])
        ds.d_src[p, slot] = a_local
        ds.d_dst_ext[p, slot] = ext
        flat = p * self.delta_slots + slot
        put(reverse, "d_src", flat, a_local)
        put(reverse, "d_dst_ext", flat, ext)
        if ds.d_w is not None:
            wv = float(w if w is not None else 1.0)
            ds.d_w[p, slot] = wv
            put(reverse, "d_weight", flat, wv)

    def _apply_device(self, payload: Dict[str, torch.Tensor],
                      writes: Dict[str, dict]) -> None:
        """One indexed write per array: ``flat[idx] = val``, in place."""
        for k, kw in writes.items():
            arr = payload[k]
            idx = torch.as_tensor(np.fromiter(kw.keys(), dtype=np.int64,
                                              count=len(kw)))
            val = torch.as_tensor(list(kw.values()), dtype=arr.dtype)
            arr.view(-1)[idx.to(arr.device)] = val.to(arr.device)

    # ------------------------------------------------------------------
    # compaction / staleness
    # ------------------------------------------------------------------

    def mutated_csr(self) -> CSRGraph:
        """Canonical CSR of the current edge multiset — equals
        ``graph.apply_mutation_batches(base, batches)`` for the same
        history (the incremental contract's ground truth).  Kept until the
        next batch or compaction: the hybrid splits, ``should_resplit``
        and ``compact`` of one version share it."""
        key = (self.version, self.num_batches)
        if self._csr_memo is None or self._csr_memo[0] != key:
            self._csr_memo = (key, self.ledger.to_csr(self.pg.num_vertices))
        return self._csr_memo[1]

    def compact(self) -> float:
        """Fold ledger and deltas into a fresh canonical partition (the one
        rebuild).  Returns the pause in milliseconds."""
        t0 = time.perf_counter()
        g2 = self.mutated_csr()
        self.pg = partition(g2, **self._part_kwargs)
        self.version += 1
        self._base_skew = None
        self._bind()
        # the folded history is dealt with: engines rebind on the version
        # bump, and any pre-compaction mark now falls below the floor
        self._batch_log.clear()
        self.log_floor = self.num_batches
        self.compactions += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.last_compaction_ms = (time.perf_counter() - t0) * 1e3
        return self.last_compaction_ms

    def staleness(self) -> dict:
        """The compaction-trigger signals (cheap counters only)."""
        delta_occ = 0.0
        slot_occ = 0.0
        tombs = 0
        base = 0
        for ds, _ in self._dirs():
            for p in range(self.pg.num_parts):
                delta_occ = max(delta_occ,
                                ds.delta_live(p) / self.delta_slots)
            # fraction of each pair's *spare* headroom consumed since bind
            spare0 = np.maximum(ds.ea.o_max - ds.obox_used0, 1)
            taken = ds.obox_used - ds.obox_used0
            frac = taken / spare0
            np.fill_diagonal(frac, 0.0)
            slot_occ = max(slot_occ, float(frac.max()))
            tombs += int(ds.tomb.sum())
            base += int(ds.ea.num_edges.sum())
        return dict(delta_occupancy=delta_occ,
                    tombstone_fraction=tombs / max(base, 1),
                    outbox_occupancy=slot_occ,
                    batches_in_version=self.batches_in_version)

    def should_compact(self, max_delta: float = 0.5,
                       max_tombstone: float = 0.25,
                       max_outbox: float = 0.9,
                       max_skew_drift: Optional[float] = None) -> bool:
        """True when any staleness signal trips.  The occupancy signals are
        O(P²) counter reads; ``max_skew_drift`` also evaluates the
        O(|E| log |E|) :meth:`skew_drift` signal (pass it at
        compaction-check cadence, not per mutation)."""
        s = self.staleness()
        if (s["delta_occupancy"] > max_delta
                or s["tombstone_fraction"] > max_tombstone
                or s["outbox_occupancy"] > max_outbox):
            return True
        return (max_skew_drift is not None
                and abs(self.skew_drift()) > max_skew_drift)

    def skew_drift(self, block_e: int = 256) -> float:
        """Degree-skew drift of the mutated layout against the bound one:
        the ``BlockMetadata.span_histogram`` signal."""
        if self._base_skew is None:
            self._base_skew = build_block_metadata(
                self.pg.fwd, block_e=block_e).degree_skew()
        ea_now = _build_edge_arrays(self.mutated_csr(), self.pg.assignment,
                                    self.pg.v_max,
                                    self._part_kwargs["align"])
        now = build_block_metadata(ea_now, block_e=block_e).degree_skew()
        return float(now - self._base_skew)

    # ------------------------------------------------------------------
    # warm-start bookkeeping
    # ------------------------------------------------------------------

    def dirty_since(self, mark: int) -> Tuple[np.ndarray, bool]:
        """Union of inserted-edge sources since batch index ``mark`` (a
        global [n] bool mask) and whether every batch since was monotone
        (insert-only): the inputs of the warm-versus-cold decision.  A mark
        older than the bounded batch log (or before a compaction, which
        clears the history) reports non-monotone, sending the caller to a
        cold recompute."""
        if mark < self.log_floor:
            return np.ones(self.pg.num_vertices, dtype=bool), False
        dirty = np.zeros(self.pg.num_vertices, dtype=bool)
        monotone = True
        for rec in self._batch_log:
            if rec["index"] <= mark:
                continue
            dirty[rec["dirty"]] = True
            monotone = monotone and rec["monotone"]
        return dirty, monotone

    def pairs_since(self, mark: int) -> List[Tuple[int, int]]:
        """Sorted distinct ``(src, dst)`` pairs that the batches after
        batch index ``mark`` inserted or deleted: the rows the hybrid
        reconcile rewrites.  The caller checks ``mark`` against
        ``log_floor`` first, since older batches are no longer kept."""
        pairs = set()
        for rec in self._batch_log:
            if rec["index"] > mark:
                b = rec["batch"]
                pairs.update(zip(b.src.tolist(), b.dst.tolist()))
        return sorted(pairs)

    def mark(self) -> int:
        """Current batch clock, to pass back into :meth:`dirty_since`."""
        return self.num_batches

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def snapshot(self) -> Tuple[dict, dict]:
        """``(tree, extra)`` for ``CheckpointManager.save_tree``.

        The tree holds the device payload per direction (``fwd``/``rev``:
        the tensors of :meth:`payload`; the checkpoint manager copies them
        to the host); the extra carries the replay cursor (``cursor``, the
        batches the snapshot has absorbed), ``version`` and ``log_floor``.
        A restore does not write the payload back: the host mirrors (slot
        maps, free lists, the ledger) are not in the snapshot, so recovery
        rebuilds the graph from base and replays the acknowledged log up
        to the cursor.  Construction is deterministic, so the replayed
        payload equals the snapshot's bit for bit, which the serving
        launcher checks (no mutation lost).
        """
        tree = {("rev" if reverse else "fwd"): dict(self._payload[reverse])
                for reverse in self._payload}
        extra = dict(cursor=self.num_batches, version=self.version,
                     log_floor=self.log_floor)
        return tree, extra

    def replay(self, batches: List[MutationBatch]) -> None:
        """Apply acknowledged batches in log order onto a freshly built
        instance (the recovery path)."""
        for b in batches:
            self.apply_mutations(b)
