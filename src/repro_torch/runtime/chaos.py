"""Failure-injection site registry (the chaos drill's control plane).

The engine stack is instrumented with named *sites* — host-visible seams
where a worker fault would surface in a real deployment:

- ``superstep.chunk``   chunk boundary of the checkpointable run mode
                        (``execute(chunk=)``); ctx: step, chunk, plus
                        caller context (e.g. serving round)
- ``worker.chunk``      distributed chunk dispatch; ctx: shards, step
- ``exchange``          inside the distributed outbox exchange
- ``kernel.fused``      inside the fused-kernel compute
- ``kernel.hybrid``     inside the hybrid two-engine superstep
- ``kernel.dispatch``   host-side dispatch of a query batch to the primary
                        backend (the degradation ladder's retry point)
- ``mutation.apply``    entry of ``DynamicGraph.apply_mutations``
- ``mutation.scatter``  mid-mutation-batch, after host planning but before
                        the device scatter — a crash here leaves the batch
                        unacknowledged (recovery must rebuild + replay)
- ``serve.round``       top of a serving round
- ``query.poison``      non-raising flag: the serving driver poisons a
                        query's initial state (NaN) when this fires

Data-corruption sites (the *fail-silent* half of the fault model — each
flips bits instead of raising, and the integrity layer in
``runtime/verify.py`` / the checksummed exchange must catch it):

- ``state.corrupt``     non-raising flag: the chunked loop bit-flips one
                        element of every float32 state leaf (a copy) at
                        the window boundary, between windows; ctx: step,
                        plus caller context
- ``exchange.payload``  non-raising flag: the checked exchange corrupts one
                        element of the payload on the wire *after* the
                        send-side tags are taken; the inbox-side tag check
                        must turn it into an ``ExchangeCorruption``
- ``checkpoint.torn``   non-raising flag: ``CheckpointManager.save_tree``
                        tears one tensor after manifest checksums are
                        computed — ``restore_tree(verify=True)`` must refuse
                        the snapshot; ctx: step
- ``tombstone.flip``    non-raising flag: the dynamic-graph chunk dispatch
                        flips one tombstone bit of a copy of the mask (a
                        deleted edge resurrects for that window); the
                        result certifier must reject the harvested fixpoint

``visit(site, **ctx)`` is a cheap no-op until an injector is installed
(``install``); injectors decide per-visit whether to raise (worker fault)
or to return a flag (data-level poison).  Visit counts per site are global
and monotone, so a drill's arming (``{"at": n}`` / ``{"round": r}``) is
deterministic for a fixed seed and schedule.

Port of ``repro.runtime.chaos``, with one difference of counting: the JAX
package visits ``kernel.fused``, ``kernel.hybrid`` and ``exchange`` while it
traces a computation, so once per compile; eager PyTorch visits them at
every call, once a superstep.  Arm those sites by context, not by
``{"at": n}``.  Each process has its own registry: a multi-rank drill
installs the same injector on every rank, so every rank fires at the same
visit.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Tuple


class ChaosRegistry:
    def __init__(self):
        self._injectors: List = []
        self.counts: Dict[str, int] = {}
        self.fired_log: List[Tuple[str, int]] = []

    @property
    def armed(self) -> bool:
        return bool(self._injectors)

    def install(self, injector):
        """Install an injector exposing ``on_visit(site, count, ctx)``."""
        self._injectors.append(injector)
        return injector

    def remove(self, injector):
        if injector in self._injectors:
            self._injectors.remove(injector)

    def clear(self):
        self._injectors.clear()

    def reset(self):
        """Forget visit counts and the fired log (injectors stay)."""
        self.counts.clear()
        self.fired_log.clear()

    def visit(self, site: str, **ctx) -> bool:
        """Record a visit; let injectors raise or flag.  Returns True when a
        non-raising (flag) injection fired at this visit."""
        if not self._injectors:
            return False
        n = self.counts.get(site, 0)
        self.counts[site] = n + 1
        flagged = False
        for inj in list(self._injectors):
            if inj.on_visit(site, n, ctx):      # may raise a worker fault
                flagged = True
        if flagged:
            self.fired_log.append((site, n))
        return flagged


registry = ChaosRegistry()


def visit(site: str, **ctx) -> bool:
    return registry.visit(site, **ctx)


def install(injector):
    return registry.install(injector)


def clear():
    registry.clear()


@contextmanager
def active(*injectors):
    """Scope injectors to a block; resets counts on exit."""
    for inj in injectors:
        registry.install(inj)
    try:
        yield registry
    finally:
        for inj in injectors:
            registry.remove(inj)
        registry.reset()
