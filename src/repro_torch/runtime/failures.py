"""The failure types and restart policy the serving layer uses.

Only *retryable* errors burn a restart budget: ``WorkerFailure`` (what
injected faults and worker-death shims raise) and the PyTorch runtime
errors that stand in for the JAX package's XLA runtime errors (see
:data:`RETRYABLE_EXCEPTIONS`).  Programming bugs (``ValueError``,
``KeyError``...), a failed CUDA kernel (:data:`KERNEL_FAILURES`) and
control flow (``KeyboardInterrupt``) surface at once.

Port of the part of ``repro.runtime.failures`` that ``runtime/sla.py`` and
``runtime/session.py`` import.  ``FaultInjector``, ``run_with_restarts``
and ``serve_with_restarts`` need the checkpoint manager and the chaos
sites, which come with ROADMAP Queue 1 item 13.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

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
