"""Serving SLA policies: admission control, query quarantine, degradation.

The serving driver treats the host as the reliability tier (the paper's
hybrid split applied to operations): accelerator work is optimistic, the
host enforces the contract.

- :class:`AdmissionController` — bounded queue in front of the query
  stream; when full, offers are rejected **with a reason** instead of
  growing latency unboundedly.
- :class:`QuarantinePolicy` — the divergence watchdog for the batched
  converge loop.  Runs at chunk boundaries of the chunked run mode
  (``execute(chunk=)``'s ``on_chunk`` hook): NaN-producing queries and
  queries exceeding a superstep budget are force-finished (frozen bitwise,
  exactly like converged queries) and reported — a poisoned query never
  pins the batch.
- :class:`DegradationLadder` — primary backend, bounded retry, then a
  fallback for the affected batch; every downgrade is reported.  A failed
  CUDA kernel is never retried or served around.

Port of ``repro.runtime.sla``; :func:`nonfinite_queries` reads the state
dict's tensors on their device and copies one ``[Q]`` mask to the host.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.runtime.failures import (KERNEL_FAILURES,
                                          RETRYABLE_EXCEPTIONS)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdmissionController:
    """Bounded admission queue: reject-with-reason when full."""
    capacity: int
    admitted: int = 0
    rejected: List[dict] = dataclasses.field(default_factory=list)
    _queue: deque = dataclasses.field(default_factory=deque)

    def offer(self, query: Any, deadline_ms: Optional[float] = None) -> bool:
        if len(self._queue) >= self.capacity:
            self.rejected.append({
                "query": query, "reason": "queue_full",
                "detail": f"admission queue at capacity "
                          f"{self.capacity}; resubmit or raise capacity"})
            return False
        self._queue.append((query, deadline_ms))
        self.admitted += 1
        return True

    def take(self, k: int) -> List[Any]:
        out = []
        while self._queue and len(out) < k:
            out.append(self._queue.popleft()[0])
        return out

    def take_entries(self, k: int) -> List[tuple]:
        """Pop up to ``k`` pending ``(query, deadline_ms)`` entries — how a
        continuous-batching session feeds freed slots without losing the
        per-query deadline it admitted with."""
        out = []
        while self._queue and len(out) < k:
            out.append(self._queue.popleft())
        return out

    def reorder(self, key: Callable[[Any], Any]) -> None:
        """Stable-reorder the pending queue by ``key(query)`` (ascending).

        The depth-aware admission schedule for continuous batching: order
        pending queries shallow-first (out-degree proxy, see
        ``graph_serve.estimate_depth_order``) so a freed slot never waits
        on a deep query while shallow ones queue behind it.  Admission
        accounting (capacity, rejects) is unaffected.
        """
        self._queue = deque(sorted(self._queue, key=lambda e: key(e[0])))

    def __len__(self) -> int:
        return len(self._queue)


# ---------------------------------------------------------------------------
# quarantine (divergence watchdog)
# ---------------------------------------------------------------------------

def nonfinite_queries(state, combine: str = "min") -> np.ndarray:
    """[Q] bool: queries whose vertex state is semiring-illegally non-finite.

    The legality of ``inf`` depends on the combine: under a min semiring
    (bfs/sssp/cc) ``+inf`` is the canonical "unreached" value, so only NaN
    and ``-inf`` are poison; under a sum combine (pagerank/bc forward
    sigma) *any* non-finite value means an overflow or poisoned
    accumulation escaped — ``~isfinite`` is the right net.  ``state`` maps
    names to ``[Q, ...]`` tensors (or arrays); the test runs where they
    lie.
    """
    out = None
    for leaf in state.values():
        t = torch.as_tensor(leaf)
        if not t.is_floating_point():
            continue
        flat = t.reshape(t.shape[0], -1)
        if combine == "sum":
            bad = ~torch.isfinite(flat)
        else:
            bad = torch.isnan(flat) | torch.isneginf(flat)
        bad = bad.any(dim=1)
        out = bad if out is None else out | bad
    if out is None:
        return np.zeros(0, bool)
    return out.cpu().numpy()


def nan_queries(state) -> np.ndarray:
    """Back-compat alias: min-semiring rules (NaN / -inf are poison)."""
    return nonfinite_queries(state, combine="min")


@dataclasses.dataclass
class QuarantinePolicy:
    """Chunk-boundary scan: quarantine non-finite / over-budget queries.

    ``combine`` selects the finiteness rule (see ``nonfinite_queries``):
    min-semiring states keep ``+inf`` legal for unreached slots; sum
    combines treat any non-finite value as poison.

    Use as the ``on_chunk`` hook: ``engine.execute(.., chunk=k,
    on_chunk=policy.scan)`` after ``policy.begin(q)``.  ``quarantined``
    accumulates (query, reason, step) reports across runs; ``begin`` resets
    only the per-run kill mask, so a standing query re-poisoned on every
    refresh is re-quarantined each run but reported once per
    (query, reason).
    """
    superstep_budget: Optional[int] = None
    check_nan: bool = True
    combine: str = "min"
    quarantined: List[dict] = dataclasses.field(default_factory=list)
    _killed: Optional[np.ndarray] = None
    _reported: set = dataclasses.field(default_factory=set)

    def begin(self, num_queries: int):
        self._killed = np.zeros(num_queries, bool)

    def release(self, slots: np.ndarray) -> None:
        """Clear the kill record for refilled ``slots`` (a [Q] bool mask).

        Continuous batching reuses slot indices for new tenants; without a
        release, a slot once quarantined would stay marked killed and its
        next tenant would silently escape the NaN / budget scan.
        """
        if self._killed is None:
            return
        slots = np.asarray(slots, bool)
        if len(slots) == len(self._killed):
            self._killed &= ~slots

    def scan(self, snap: dict,
             ids: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """Return a [Q] kill mask (or None).  ``ids`` maps slot index to a
        stable query id for reporting — continuous sessions pass their
        per-slot query ids so a report names the query, not the slot, and
        re-use of a slot by a new poisoned tenant is reported anew."""
        fin = np.asarray(snap["fin"])
        steps_q = np.asarray(snap["steps_q"])
        q = len(fin)
        if self._killed is None or len(self._killed) != q:
            self._killed = np.zeros(q, bool)
        kill = np.zeros(q, bool)
        reasons: Dict[int, str] = {}
        if self.check_nan:
            bad = nonfinite_queries(snap["state"], combine=self.combine)
            if len(bad) == q:
                for i in np.flatnonzero(bad & ~self._killed):
                    kill[i] = True
                    reasons[int(i)] = "nonfinite"
        if self.superstep_budget is not None:
            over = (steps_q >= self.superstep_budget) & ~fin & ~self._killed
            for i in np.flatnonzero(over):
                kill[i] = True
                reasons.setdefault(int(i), "superstep_budget")
        for i, reason in sorted(reasons.items()):
            qid = int(ids[i]) if ids is not None else i
            if (qid, reason) not in self._reported:
                self._reported.add((qid, reason))
                self.quarantined.append(
                    {"query": qid, "reason": reason,
                     "step": int(snap["step"]),
                     "steps_q": int(steps_q[i])})
        self._killed |= kill
        return kill if kill.any() else None


# ---------------------------------------------------------------------------
# degradation ladder
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DegradationLadder:
    """Primary → bounded retry → reference fallback for one query batch."""
    retries: int = 1
    backoff_s: float = 0.0
    retryable: tuple = RETRYABLE_EXCEPTIONS
    downgrades: List[dict] = dataclasses.field(default_factory=list)

    def run(self, primary: Callable[[], Any], fallback: Callable[[], Any],
            label: str = "") -> Any:
        """Call ``primary`` with bounded retries, else ``fallback``.

        Takes thunks, not engines: a continuous session threads itself
        through by closing over ``session.step()`` for the primary and a
        fallback-engine session *restored from the primary's snapshot*
        (occupancy mask and per-slot query ids ride the snapshot carry) —
        see ``ServeSession.step_with_fallback``.  A kernel failure
        (:data:`~repro_torch.runtime.failures.KERNEL_FAILURES`) is
        re-raised, whatever ``retryable`` holds: no retry, no fallback.
        """
        errors = []
        for attempt in range(1 + self.retries):
            try:
                return primary()
            except self.retryable as e:
                if isinstance(e, KERNEL_FAILURES):
                    raise
                errors.append(repr(e))
                if self.backoff_s:
                    time.sleep(self.backoff_s * (2 ** attempt))
        self.downgrades.append(
            {"label": label, "errors": errors,
             "detail": "primary backend failed on retry; batch served by "
                       "the fallback"})
        return fallback()
