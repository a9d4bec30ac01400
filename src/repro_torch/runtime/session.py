"""ServeSession: continuous batching over the resident superstep loop.

A drain-batch driver inherits TOTEM's bulk-synchronous pathology: a
Q-batch occupies the engine until its *slowest* query converges, so one
deep query taxes Q-1 shallow ones.  Continuous batching applies the
LLM-serving fix to BSP: keep ONE resident loop running and, at every chunk
boundary (``engine.execute(chunk=)``'s windows), harvest the queries whose
votes say they finished, and admit new queries from the stream into the
freed slots.  The slot count Q stays static (occupancy is a host-side
mask), so no state shape ever changes: the refill is one ``torch.where``
per leaf (``core.bsp._slot_swap``).

Protocol: ``submit(queries)`` admits work (bounded by ``queue_capacity``,
rejects with a reason beyond it), ``step()`` advances one chunk window,
``drain()`` runs the resident loop until the queue and every slot are
empty, ``poll()`` pops completed results.

Correctness contract: every completed query's result is **bitwise** the
same query's result through drain-batch ``execute``, on every backend and
world size.  The mechanism is the step-frame translation of
``algorithms/continuous.py``: a slot refilled at global step ``s0`` seeds
its state translated by ``s0`` and the harvest translates back.  The
slot states are made on the engine's device, and the harvest gathers the
finished rows of the result leaf there and copies only those to the
host.

**Zero retraces.**  The JAX package counts its jit caches; eager PyTorch
compiles nothing, so the port counts what an engine has built for its
programs instead (``BSPEngine.cache_entries()``: the hybrid splits and
layouts, the tiered hybrid's row windows, the pull layout, the tiered host
arenas and window buffers, the CUDA libraries loaded).  The contract: that
count does not grow after the warm-up window and the first refill, so
``retraces()`` is 0.  On a dynamic engine a compaction rebind and a
dynamic split rebuild are expected rebuilds: they reset the baseline, as
the JAX package's recompiles do; a mutation batch (``mutate``) must add
nothing.

``snapshot``/``restore`` persist the full serving carry (vertex state,
votes, per-slot step frames, occupancy mask, per-slot query ids, pending
queue, completed results) through a ``CheckpointManager``, so a restart
resumes mid-refill (``failures.serve_with_restarts``).  A ``certifier``
checks every harvested result (recompute once, then quarantine); on a card
the recompute is the engine's own, never a host oracle's row.

Port of ``repro.runtime.session``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.runtime.sla import AdmissionController, QuarantinePolicy


def _where(device) -> tuple:
    """``(type, index)`` of a device, ``cuda`` read as the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return "cuda", torch.cuda.current_device()
    return dev.type, dev.index


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ServeSession:
    """One resident engine continuously serving a query stream.

    Parameters
    ----------
    engine:
        A ``BSPEngine`` or ``DistributedBSPEngine`` (static graphs; not
        tiered: a tiered engine refuses ``chunk=``).
    alg:
        Algorithm name with a continuous form (``bfs``/``sssp``); others
        raise the actionable error from :func:`continuous_form`.
    slots:
        The static query-batch width Q; occupancy varies.
    chunk:
        Supersteps per window: the refill granularity.
    queue_capacity:
        Admission bound; ``submit`` beyond it rejects with a reason.
    deadline_ms:
        Per-query SLA; completions past it are counted in the report.
    quarantine:
        Optional :class:`QuarantinePolicy` scanned at every boundary; a
        quarantined slot is freed for the next tenant in the same window.
    scheduler:
        ``"fifo"`` (arrival order) or ``"depth"`` (admit shallow-first by
        ``depth_key(source)``; see ``graph_serve.estimate_depth_order``).
    certifier:
        Optional :class:`repro_torch.runtime.verify.ResultCertifier` bound
        to the *current* graph: every harvested result is certified before
        it completes.  A failed verdict triggers the recompute-once policy
        (:meth:`_recompute`); if even the recomputed answer fails
        certification the query is quarantined with reason
        ``"certification"``.
    monitor:
        Optional duck-typed invariant monitor (``observe(snap)``,
        ``rebase(admit)``) observed at every window boundary (threaded
        through ``engine.execute``); fired windows are counted in the
        report.
    """

    def __init__(self, engine, alg: str, *, slots: int, chunk: int = 2,
                 queue_capacity: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 quarantine: Optional[QuarantinePolicy] = None,
                 scheduler: str = "fifo",
                 depth_key: Optional[Callable[[int], float]] = None,
                 certifier=None, monitor=None):
        from repro_torch.algorithms.continuous import (continuous_form,
                                                       result_key)

        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if scheduler not in ("fifo", "depth"):
            raise ValueError(f"scheduler must be 'fifo' or 'depth', "
                             f"got {scheduler!r}")
        if scheduler == "depth" and depth_key is None:
            raise ValueError(
                "scheduler='depth' needs depth_key(source) -> sort key "
                "(e.g. lambda s: -g.out_degrees()[s]); pass it or use "
                "scheduler='fifo'")
        self.engine = engine
        self.alg = alg
        self.form = continuous_form(alg)
        self._result_keys = result_key(alg)
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.deadline_ms = deadline_ms
        self.quarantine = quarantine
        self.scheduler = scheduler
        self.depth_key = depth_key
        self.certifier = certifier
        self.monitor = monitor
        self.certified_ok = 0
        self.recomputed = 0
        self.certify_failures: List[dict] = []
        self.admission = AdmissionController(
            queue_capacity if queue_capacity is not None else (1 << 30))

        # occupancy: host-side
        self.occupied = np.zeros(self.slots, bool)
        self.slot_query = np.full(self.slots, -1, np.int64)
        self.slot_source = np.zeros(self.slots, np.int64)
        self.slot_step0 = np.zeros(self.slots, np.int64)
        self.slot_refills = np.zeros(self.slots, np.int64)

        # resident-loop carry (None until primed)
        self._state = None
        self._fin = None
        self._steps_q = None
        self._step = 0

        self.windows = 0
        self.refills = 0
        self.monitors_fired = 0
        self._next_qid = 0
        self._qsource: Dict[int, int] = {}
        self._qdeadline: Dict[int, Optional[float]] = {}
        self._submit_t: Dict[int, float] = {}
        self._completed: Dict[int, np.ndarray] = {}
        self._completed_steps: Dict[int, int] = {}
        self._latency_ms: Dict[int, float] = {}
        self.quarantined_qids: set = set()
        self.sla_misses = 0

        # zero-retrace accounting: the baseline resets on the warm-up
        # events (first window, first refill), then any growth is a retrace
        self._entries0: Optional[int] = None
        self._warm_events: set = set()
        self._rebinds0 = getattr(engine, "dynamic_rebinds", 0)
        self._rebuilds0 = getattr(engine, "hybrid_dyn_rebuilds", 0)

    # ------------------------------------------------------------- admission

    def submit(self, queries: Sequence[int],
               deadline_ms: Optional[float] = None) -> List[Optional[int]]:
        """Offer sources to the admission queue; returns per-query ids
        (None where rejected — reasons in ``admission.rejected``)."""
        dl = deadline_ms if deadline_ms is not None else self.deadline_ms
        qids: List[Optional[int]] = []
        now = time.perf_counter()
        for src in np.asarray(queries).reshape(-1):
            qid = self._next_qid
            if self.admission.offer((qid, int(src)), dl):
                self._next_qid += 1
                self._qsource[qid] = int(src)
                self._qdeadline[qid] = dl
                self._submit_t[qid] = now
                qids.append(qid)
            else:
                qids.append(None)
        if self.scheduler == "depth":
            self.admission.reorder(lambda q: self.depth_key(q[1]))
        return qids

    # ------------------------------------------------------------ slot logic

    def _prime(self) -> None:
        """Initial admission: fill slots from the queue and build the
        step-0 carry.  Unfilled slots start finished (and unoccupied), so
        they cost nothing until the first refill claims them."""
        if self._state is not None:
            return
        entries = self.admission.take_entries(self.slots)
        sources = np.zeros(self.slots, np.int64)
        fin = np.ones(self.slots, bool)
        for slot, ((qid, src), _dl) in enumerate(entries):
            sources[slot] = src
            fin[slot] = False
            self.occupied[slot] = True
            self.slot_query[slot] = qid
            self.slot_source[slot] = src
            self.slot_step0[slot] = 0
        self._state = self.form.make_slot_state(
            self.engine.pg, sources, np.zeros(self.slots, np.int64),
            device=self.engine.device)
        self._fin = fin
        self._steps_q = np.zeros(self.slots, np.int32)
        self._step = 0
        if self.quarantine is not None:
            self.quarantine.begin(self.slots)

    def _recompute(self, source: int) -> np.ndarray:
        """The one recompute of a result that failed its certifier.

        On the CPU it is the certifier's numpy oracle, as in the JAX
        package.  On a card it is the query run again alone through the
        session's engine (a resident run from step 0, on its kernels), so
        nothing a kernel got wrong is served by host code; the numpy
        oracle only certifies it."""
        if self.engine.device.type == "cpu":
            return np.asarray(self.certifier.recompute(source))
        return self._rerun(source)

    def _rerun(self, source: int) -> np.ndarray:
        """Query ``source`` run alone through the engine from step 0."""
        zero = np.zeros(1, np.int64)
        state = self.form.make_slot_state(self.engine.pg, [source], zero,
                                          device=self.engine.device)
        out, _ = self.engine.execute(self.form.program, state)
        sub = {k: out[k] for k in self._result_keys}
        return np.asarray(self.form.harvest(self.engine.pg, sub, zero)[0])

    def _certified(self, result: np.ndarray, slot: int, qid: int,
                   step: int) -> np.ndarray:
        """Recompute-once-then-quarantine("certification") policy.

        A harvested result that fails its certifier is replaced by its
        recompute (:meth:`_recompute`); if that fails too (a certifier of
        another graph, say a stale one across a mutation) the query is
        quarantined."""
        source = int(self.slot_source[slot])
        verdict = self.certifier.certify(result, source=source)
        if verdict.ok:
            self.certified_ok += 1
            return result
        self.recomputed += 1
        ref = self._recompute(source)
        rec = dict(query=qid, source=source, step=step,
                   reason=verdict.reason(), recovered=True)
        if not self.certifier.certify(ref, source=source).ok:
            rec["recovered"] = False
            self.quarantined_qids.add(qid)
            if self.quarantine is not None:
                self.quarantine.quarantined.append(
                    {"query": qid, "reason": "certification",
                     "step": step, "steps_q": -1})
        self.certify_failures.append(rec)
        return ref

    def _harvest(self, snap: dict, done: np.ndarray) -> None:
        """Complete the slots of ``done``: their rows of the result leaf
        are indexed where the state lies and only they reach the host."""
        rows = np.flatnonzero(done)
        sub = {}
        for k in self._result_keys:
            leaf = snap["state"][k]
            if isinstance(leaf, torch.Tensor):
                sub[k] = leaf[torch.as_tensor(rows, device=leaf.device)]
            else:
                sub[k] = np.asarray(leaf)[rows]
        results = self.form.harvest(self.engine.pg, sub,
                                    self.slot_step0[rows])
        steps_q = snap["steps_q"]      # already per-slot (zeroed on refill)
        now = time.perf_counter()
        for i, slot in enumerate(rows):
            qid = int(self.slot_query[slot])
            result = np.asarray(results[i])
            if (self.certifier is not None
                    and qid not in self.quarantined_qids):
                result = self._certified(result, slot, qid, snap["step"])
            self._completed[qid] = result
            self._completed_steps[qid] = int(steps_q[slot])
            if qid in self._submit_t:
                lat = (now - self._submit_t[qid]) * 1e3
                self._latency_ms[qid] = lat
                dl = self._qdeadline.get(qid)
                if dl is not None and lat > dl:
                    self.sla_misses += 1
            self.occupied[slot] = False
            self.slot_query[slot] = -1

    def _boundary(self, snap: dict) -> dict:
        """The ``on_chunk`` hook: quarantine → harvest → refill.

        Order matters: the scan kills against the *pre-swap* state, the
        harvest reads the pre-swap state and per-slot counters, and only
        then do freed slots (converged, quarantined, or never-occupied)
        take new tenants — so a slot can be quarantined and handed to a
        fresh query at the same boundary.
        """
        out: dict = {}
        fin = np.asarray(snap["fin"]).copy()
        if self.quarantine is not None:
            kill = self.quarantine.scan(snap, ids=self.slot_query)
            if kill is not None:
                out["kill"] = kill
                fin |= kill
                for slot in np.flatnonzero(kill & self.occupied):
                    self.quarantined_qids.add(int(self.slot_query[slot]))
        done = fin & self.occupied
        if done.any():
            self._harvest(snap, done)
        free = np.flatnonzero(fin & ~self.occupied)
        entries = self.admission.take_entries(len(free))
        if entries:
            admit = np.zeros(self.slots, bool)
            sources = np.zeros(self.slots, np.int64)
            for slot, ((qid, src), _dl) in zip(free, entries):
                admit[slot] = True
                sources[slot] = src
                self.occupied[slot] = True
                self.slot_query[slot] = qid
                self.slot_source[slot] = src
                self.slot_step0[slot] = snap["step"]
                self.slot_refills[slot] += 1
            step0 = np.full(self.slots, snap["step"], np.int64)
            new_rows = self.form.make_slot_state(
                self.engine.pg, sources, step0, device=self.engine.device)
            out["refill"] = (new_rows, admit)
            if self.quarantine is not None:
                self.quarantine.release(admit)
        return out

    def _absorb(self, state, steps_q, info) -> None:
        self._state = state
        self._steps_q = steps_q
        self._fin = info["finished"]
        self._step = info["final_step"]
        self.windows += info["chunks"]
        self.refills += info["refilled"]
        self.monitors_fired += info.get("monitors_fired", 0)
        self._account_retraces()

    def step(self) -> bool:
        """Advance one chunk window.  Returns False once drained."""
        self._prime()
        state, steps_q, info = self.engine.execute(
            self.form.program, self._state, chunk=self.chunk,
            on_chunk=self._boundary, max_chunks=1,
            start_step=self._step, fin=self._fin, steps_q=self._steps_q,
            monitor=self.monitor)
        self._absorb(state, steps_q, info)
        return not self.drained()

    def drain(self) -> dict:
        """Serve until queue and slots are empty through ONE
        ``engine.execute`` call — the resident-loop path (``step()`` is
        for drivers that need a host boundary per window).  Returns the
        session report."""
        self._prime()
        while not self.drained():
            state, steps_q, info = self.engine.execute(
                self.form.program, self._state, chunk=self.chunk,
                on_chunk=self._boundary,
                start_step=self._step, fin=self._fin, steps_q=self._steps_q,
                monitor=self.monitor)
            self._absorb(state, steps_q, info)
        return self.report()

    def drained(self) -> bool:
        return (not self.occupied.any()) and len(self.admission) == 0

    def poll(self) -> List[dict]:
        """Pop completed queries: ``{"query", "source", "result", "steps",
        "quarantined", "latency_ms"}`` per completion, submit order."""
        out = []
        for qid in sorted(self._completed):
            out.append(dict(
                query=qid, source=self._qsource.get(qid),
                result=self._completed[qid],
                steps=self._completed_steps.get(qid),
                quarantined=qid in self.quarantined_qids,
                latency_ms=self._latency_ms.get(qid)))
        self._completed = {}
        return out

    def mutate(self, batch) -> dict:
        """Apply one edge-mutation batch to the resident dynamic graph in
        the session that is serving (``DynamicGraph.apply_mutations``'s
        report).  Call it at a window boundary (between ``step()``s or
        ``drain()`` waves): a traversal in flight would otherwise straddle
        two graph versions and match neither drain-batch result."""
        dg = getattr(self.engine, "dg", None)
        if dg is None:
            raise ValueError(
                "session.mutate() needs a dynamic engine — build it as "
                "BSPEngine(DynamicGraph(g, parts, strategy)); a "
                "static-partition engine cannot absorb mutations")
        return dg.apply_mutations(batch)

    # ---------------------------------------------------- retrace accounting

    def _cache_entries(self) -> int:
        return self.engine.cache_entries()

    def _account_retraces(self) -> None:
        legit = False
        for event, seen in (("window", self.windows > 0),
                            ("refill", self.refills > 0)):
            if seen and event not in self._warm_events:
                self._warm_events.add(event)
                legit = True           # warm-up build, resets the baseline
        rebinds = getattr(self.engine, "dynamic_rebinds", 0)
        rebuilds = getattr(self.engine, "hybrid_dyn_rebuilds", 0)
        if rebinds != self._rebinds0 or rebuilds != self._rebuilds0:
            self._rebinds0, self._rebuilds0 = rebinds, rebuilds
            legit = True               # compaction rebind, split rebuild
        if legit or self._entries0 is None:
            self._entries0 = self._cache_entries()

    def retraces(self) -> int:
        """Growth of the engine's ``cache_entries()`` since warm-up — the
        serving contract is 0."""
        if self._entries0 is None:
            return 0
        return self._cache_entries() - self._entries0

    # -------------------------------------------------------------- reports

    def report(self) -> dict:
        lat = sorted(self._latency_ms.values())

        def pct(p):
            return (float(np.percentile(lat, p, method="nearest"))
                    if lat else None)

        return dict(
            algorithm=self.alg, slots=self.slots, chunk=self.chunk,
            submitted=self._next_qid,
            completed=len(self._completed_steps),
            pending=len(self.admission),
            rejected=len(self.admission.rejected),
            windows=self.windows, refills=self.refills,
            min_slot_refills=int(self.slot_refills.min()),
            max_slot_refills=int(self.slot_refills.max()),
            retraces=self.retraces(),
            quarantined=sorted(self.quarantined_qids),
            sla_misses=self.sla_misses,
            certified_ok=self.certified_ok,
            recomputed=self.recomputed,
            certify_failed=list(self.certify_failures),
            monitors_fired=self.monitors_fired,
            latency_p50_ms=pct(50), latency_p99_ms=pct(99),
            final_step=int(self._step),
            backend=getattr(self.engine, "backend", None),
            engine=type(self.engine).__name__,
            # only hbm_bytes competes with other sessions for device
            # residency; host_bytes is streamed host memory
            **self._residency())

    def _residency(self) -> dict:
        fn = getattr(self.engine, "residency_bytes", None)
        if fn is None:
            return {}
        r = fn()
        return dict(hbm_bytes=int(r["hbm_bytes"]),
                    host_bytes=int(r["host_bytes"]))

    # --------------------------------------------------- checkpoint/restore

    def _like_carry(self) -> dict:
        state = self.form.make_slot_state(
            self.engine.pg, np.zeros(self.slots, np.int64),
            np.zeros(self.slots, np.int64), device=self.engine.device)
        return {"state": state,
                "fin": np.zeros(self.slots, bool),
                "steps_q": np.zeros(self.slots, np.int32)}

    def snapshot(self, manager, step: Optional[int] = None,
                 blocking: bool = True) -> None:
        """Persist the full serving carry.  Occupancy mask, per-slot query
        ids/step frames/refill counts, the pending queue and completed
        results ride along, so :meth:`restore` resumes *mid-refill*, not
        from the initial admission.  The state's tensors are copied to the
        host before this returns (``blocking=False`` only leaves the disk
        write to a thread)."""
        self._prime()
        tree = {"carry": {"state": self._state, "fin": self._fin,
                          "steps_q": self._steps_q},
                "completed": {str(q): v for q, v in self._completed.items()}}
        extra = dict(
            step=int(self._step), windows=self.windows,
            refills=self.refills, next_qid=self._next_qid,
            occupied=self.occupied.tolist(),
            slot_query=self.slot_query.tolist(),
            slot_source=self.slot_source.tolist(),
            slot_step0=self.slot_step0.tolist(),
            slot_refills=self.slot_refills.tolist(),
            pending=[[int(qid), int(src),
                      None if dl is None else float(dl)]
                     for (qid, src), dl in list(self.admission._queue)],
            qsource={str(q): int(s) for q, s in self._qsource.items()},
            completed_steps={str(q): int(s)
                             for q, s in self._completed_steps.items()},
            quarantined=sorted(self.quarantined_qids))
        manager.save_tree(step if step is not None else self.windows,
                          tree, extra=extra, blocking=blocking)

    def restore(self, manager, step: Optional[int] = None) -> int:
        """Load a :meth:`snapshot` (the latest without ``step``) into this
        session; the state comes back on the engine's device.  Returns the
        snapshot's step."""
        step = step if step is not None else manager.latest_step()
        if step is None:
            raise FileNotFoundError(f"no session snapshot in {manager.dir}")
        extra = manager.manifest_extra(step)
        n = self.engine.pg.num_vertices
        like = {"carry": self._like_carry(),
                "completed": {q: np.zeros(n, np.float32)
                              for q in extra["completed_steps"]}}
        _, tree = manager.restore_tree(like, step)
        self._state = tree["carry"]["state"]
        self._fin = np.asarray(tree["carry"]["fin"], bool)
        self._steps_q = np.asarray(tree["carry"]["steps_q"], np.int32)
        self._step = int(extra["step"])
        self.windows = int(extra["windows"])
        self.refills = int(extra["refills"])
        self._next_qid = int(extra["next_qid"])
        self.occupied = np.asarray(extra["occupied"], bool)
        self.slot_query = np.asarray(extra["slot_query"], np.int64)
        self.slot_source = np.asarray(extra["slot_source"], np.int64)
        self.slot_step0 = np.asarray(extra["slot_step0"], np.int64)
        self.slot_refills = np.asarray(extra["slot_refills"], np.int64)
        self._qsource = {int(q): int(s)
                         for q, s in extra["qsource"].items()}
        self._completed = {int(q): np.asarray(v)
                           for q, v in tree["completed"].items()}
        self._completed_steps = {int(q): int(s)
                                 for q, s in extra["completed_steps"].items()}
        self.quarantined_qids = set(extra["quarantined"])
        self.admission._queue.clear()
        for qid, src, dl in extra["pending"]:
            self.admission._queue.append(((int(qid), int(src)), dl))
            self._qsource[int(qid)] = int(src)
            self._qdeadline[int(qid)] = dl
        if self.quarantine is not None:
            self.quarantine.begin(self.slots)
        # a restored session may run on a rebuilt engine: its first window
        # and refill are warm-up again for the rebuild count
        self._entries0 = None
        self._warm_events = set()
        return step

    # ----------------------------------------------------------- degradation

    def handoff(self, other: "ServeSession") -> None:
        """Copy this session's carry + occupancy into ``other`` (a session
        over a different engine on the same graph) — the degradation path.
        The fallback resumes the *refilled* occupancy, mid-stream; the
        carry crosses as host numpy, so the engines' devices may differ."""
        other._state = (None if self._state is None
                        else {k: _host(v) for k, v in self._state.items()})
        other._fin = None if self._fin is None else _host(self._fin)
        other._steps_q = (None if self._steps_q is None
                          else _host(self._steps_q))
        other._step = self._step
        other.windows, other.refills = self.windows, self.refills
        other._next_qid = self._next_qid
        other.occupied = self.occupied.copy()
        other.slot_query = self.slot_query.copy()
        other.slot_source = self.slot_source.copy()
        other.slot_step0 = self.slot_step0.copy()
        other.slot_refills = self.slot_refills.copy()
        other._qsource = dict(self._qsource)
        other._qdeadline = dict(self._qdeadline)
        other._submit_t = dict(self._submit_t)
        other._completed = dict(self._completed)
        other._completed_steps = dict(self._completed_steps)
        other._latency_ms = dict(self._latency_ms)
        other.quarantined_qids = set(self.quarantined_qids)
        other.admission = self.admission

    def step_with_fallback(self, fallback: "ServeSession", ladder) -> bool:
        """One window through a :class:`DegradationLadder`: retry this
        session's engine, then hand the carry to ``fallback`` and continue
        there.  The handoff carries the refilled slot occupancy across the
        downgrade.

        The fallback stays where the primary is: on a card it must be an
        engine on the same device with a kernel backend (not the
        reference backend's plain PyTorch), or this raises ``ValueError``.
        A failed CUDA kernel is re-raised, never served around."""
        from repro_torch.core.bsp import REFERENCE

        mine, theirs = self.engine.device, fallback.engine.device
        if _where(theirs) != _where(mine):
            raise ValueError(
                f"the fallback session's engine is on {theirs}, the "
                f"primary's on {mine}: a downgrade stays on the primary's "
                f"device")
        if (_where(mine)[0] == "cuda"
                and getattr(fallback.engine, "backend", None) == REFERENCE):
            raise ValueError(
                "a session on a card falls back to another kernel backend "
                "(fused or hybrid), not to the reference backend's plain "
                "PyTorch")

        def fb():
            self.handoff(fallback)
            return fallback.step()

        return ladder.run(self.step, fb,
                          label=f"window{self.windows}:{self.alg}")


def drain_reference(engine, alg: str, sources, slots: int) -> np.ndarray:
    """The parity oracle: run ``sources`` through plain drain-batch
    ``execute`` in fixed batches of ``slots``; returns [len, n] results.
    Every session completion must equal its row bitwise."""
    from repro_torch.launch.graph_serve import run_query_batch

    sources = np.asarray(sources).reshape(-1)
    out = []
    for i in range(0, len(sources), slots):
        batch = np.resize(sources[i:i + slots], slots)
        out.append(run_query_batch(engine, alg, batch)[
            : min(slots, len(sources) - i)])
    return np.concatenate(out, axis=0)
