"""Checkpoint/restart fault tolerance.

``run_with_restarts`` wraps a step function with periodic (asynchronous)
checkpoints, exception capture (a node failure surfaces as an exception in
the driver), restore from the latest snapshot and bounded retry with
exponential backoff; ``serve_with_restarts`` does the same for a serving
session.  The graph supersteps are deterministic, so a restart reproduces
the trajectory before the failure.  State is any tree of tensors and
arrays, persisted through ``CheckpointManager.save_tree``.

Only *retryable* errors burn a restart budget: ``WorkerFailure`` (what
injected faults and worker-death shims raise) and the PyTorch runtime
errors that stand in for the JAX package's XLA runtime errors (see
:data:`RETRYABLE_EXCEPTIONS`).  Programming bugs (``ValueError``,
``KeyError``...), a failed CUDA kernel (:data:`KERNEL_FAILURES`) and
control flow (``KeyboardInterrupt``) surface at once, from both restart
loops.

``FaultInjector`` raises at chosen steps or chaos sites
(``runtime/chaos.py``) deterministically: the drills of
``launch/graph_serve.py`` and the tests use it.

Port of ``repro.runtime.failures``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, Optional, Sequence, Set,
                    Tuple)

import torch
import torch.distributed


class WorkerFailure(RuntimeError):
    """A worker/shard died mid-step (or a drill pretended it did)."""


class ExchangeCorruption(WorkerFailure):
    """An exchange checksum mismatched: a payload block was corrupted in
    flight.  Subclasses :class:`WorkerFailure` so ``RestartPolicy`` treats
    it as retryable: the recovery is a window replay from the last
    checkpoint, as for a worker death at the same superstep."""


def _torch_errors(*names) -> tuple:
    mods = {"OutOfMemoryError": torch, "AcceleratorError": torch,
            "DistError": torch.distributed}
    return tuple(getattr(mods[n], n) for n in names if hasattr(mods[n], n))


#: Errors worth a restart: injected or real worker faults, and the torch
#: runtime errors in place of XLA's: ``torch.OutOfMemoryError`` (device
#: memory exhausted) and ``torch.distributed.DistError`` (a collective's
#: backend, network or store failed; NCCL and gloo raise its subclasses).
#: Each is named only where the installed torch has it.  A CUDA error
#: from a kernel (``torch.AcceleratorError``) is not among them: see
#: :data:`KERNEL_FAILURES`.
RETRYABLE_EXCEPTIONS: tuple = (WorkerFailure,) + _torch_errors(
    "OutOfMemoryError", "DistError")

#: A CUDA error raised by a launch or a synchronize.  Never retried and
#: never served around: a failed kernel is a fault of the program, most
#: such errors leave the CUDA context unusable, and a fallback would hand
#: its queries to another code path without anyone asking for it.
KERNEL_FAILURES: tuple = _torch_errors("AcceleratorError")


@dataclasses.dataclass
class RestartPolicy:
    """Bounded retry with exponential backoff over a retryable whitelist."""
    max_failures: int = 3
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    retryable: tuple = RETRYABLE_EXCEPTIONS
    failures: int = 0
    restarts: List[dict] = dataclasses.field(default_factory=list)

    def handle(self, exc: BaseException, context: Optional[dict] = None
               ) -> float:
        """Record a failure; return the backoff sleep in seconds.

        Re-raises when ``exc`` is a kernel failure, is not retryable or
        the budget is spent.
        """
        if (isinstance(exc, KERNEL_FAILURES)
                or not isinstance(exc, self.retryable)):
            raise exc
        self.failures += 1
        self.restarts.append({"error": repr(exc), **(context or {})})
        if self.failures > self.max_failures:
            raise exc
        return self.backoff_s * (self.backoff_factor ** (self.failures - 1))


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault drill: step-indexed (``maybe_fail``) and
    chaos-site-scoped (``on_visit``) injection.

    ``sites`` maps a site name to trigger specs.  A spec is a dict of
    matchers: ``{"at": n}`` fires at the n-th visit of the site,
    ``{"round": r}`` / ``{"index": i}`` / any other key matches the visit's
    context by equality, ``{"shard": s}`` matches a shard id (membership in
    a ctx ``shards`` tuple when the site is dispatched for a shard group).
    ``{"flag": True}`` makes the spec non-raising (the site's caller sees a
    True flag: data-level poison).  Each spec fires at most once.
    """
    fail_at_steps: Set[int] = dataclasses.field(default_factory=set)
    exc: type = WorkerFailure
    fired: Set[int] = dataclasses.field(default_factory=set)
    sites: Dict[str, Sequence[dict]] = dataclasses.field(default_factory=dict)
    site_fired: List[Tuple[str, int, dict]] = \
        dataclasses.field(default_factory=list)

    def maybe_fail(self, step: int):
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise self.exc(f"injected node failure at step {step}")

    def _matches(self, spec: dict, count: int, ctx: dict) -> bool:
        at = spec.get("at")
        if at is not None and count != at:
            return False
        want_shard = spec.get("shard")
        if want_shard is not None:
            if "shard" in ctx:
                if ctx["shard"] != want_shard:
                    return False
            elif "shards" in ctx:
                if want_shard not in ctx["shards"]:
                    return False
            else:
                return False
        for k, v in spec.items():
            if k in ("at", "shard", "flag", "exc", "_done"):
                continue
            if ctx.get(k) != v:
                return False
        return True

    def on_visit(self, site: str, count: int, ctx: dict) -> bool:
        flagged = False
        for spec in self.sites.get(site, ()):
            if spec.get("_done") or not self._matches(spec, count, ctx):
                continue
            spec["_done"] = True
            self.site_fired.append((site, count, dict(ctx)))
            if spec.get("flag"):
                flagged = True
            else:
                exc = spec.get("exc", self.exc)
                raise exc(f"injected fault at site {site!r} "
                          f"(visit {count}, ctx={ctx})")
        return flagged


def _policy(max_failures: int, backoff_s: float,
            retryable: Optional[tuple]) -> RestartPolicy:
    return RestartPolicy(
        max_failures=max_failures, backoff_s=backoff_s,
        retryable=retryable if retryable is not None
        else RETRYABLE_EXCEPTIONS)


def run_with_restarts(
    step_fn: Callable[[int, Any], Tuple[Any, dict]],
    state: Any,
    num_steps: int,
    manager,
    checkpoint_every: int = 10,
    max_failures: int = 3,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    retryable: Optional[tuple] = None,
    backoff_s: float = 0.0,
) -> Tuple[Any, dict]:
    """Run ``state = step_fn(step, state)`` for ``num_steps`` with
    checkpoint/restart (``manager`` a
    :class:`~repro_torch.checkpoint.CheckpointManager`).  ``state`` may be
    any tree of tensors and arrays; a restore puts each tensor leaf back
    on its device.  Returns ``(final_state, summary)``."""
    policy = _policy(max_failures, backoff_s, retryable)
    start = manager.latest_step()
    if start is not None:
        _, state = manager.restore_tree(state, start)
    else:
        manager.save_tree(0, state, blocking=True)
        start = 0

    step = start
    while step < num_steps:
        try:
            state, metrics = step_fn(step, state)
            if on_metrics:
                on_metrics(step, metrics)
            if (step + 1) % checkpoint_every == 0:
                manager.save_tree(step + 1, state, blocking=False)
            step += 1
        except Exception as e:                      # the node-failure drill
            sleep_s = policy.handle(e, context={"step": step})
            if sleep_s:
                time.sleep(sleep_s)
            latest = manager.latest_step()
            if latest is None:
                raise
            _, state = manager.restore_tree(state, latest)
            step = latest
    manager.wait()
    return state, {"failures": policy.failures, "restarts": policy.restarts,
                   "final_step": step}


def serve_with_restarts(
    make_session: Callable[[], Any],
    manager,
    checkpoint_every: int = 1,
    max_failures: int = 3,
    backoff_s: float = 0.0,
    retryable: Optional[tuple] = None,
) -> Tuple[Any, dict]:
    """Drive a continuous serving session to drained with checkpoint/restart.

    The session-shaped sibling of :func:`run_with_restarts`: it wraps the
    *session protocol*, any object with ``step() -> bool`` (False when
    drained), ``snapshot(manager, step)``, ``restore(manager)`` and a
    ``windows`` counter.  On a retryable failure the session is **rebuilt
    from the factory** (the engine may have died with it) and restored
    from the latest snapshot, which carries the refilled slot occupancy
    (occupancy mask, per-slot query ids and step frames), so the restarted
    loop resumes mid-refill, not from the initial admission.  Duck-typed:
    this module does not import the session layer (session -> sla ->
    failures).

    Returns ``(session, summary)`` with the drained session.
    """
    policy = _policy(max_failures, backoff_s, retryable)
    session = make_session()
    if manager.latest_step() is not None:
        session.restore(manager)
    else:
        session.snapshot(manager, 0, blocking=True)
    while True:
        try:
            alive = session.step()
            if session.windows % checkpoint_every == 0:
                session.snapshot(manager, session.windows)
            if not alive:
                break
        except Exception as e:                      # noqa: BLE001 — policy
            sleep_s = policy.handle(e, context={"windows": session.windows})
            if sleep_s:
                time.sleep(sleep_s)
            if manager.latest_step() is None:
                raise
            session = make_session()
            session.restore(manager)
    manager.wait()
    return session, {"failures": policy.failures,
                     "restarts": policy.restarts,
                     "windows": session.windows}
