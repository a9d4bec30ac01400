"""The serving runtime: continuous batching, admission, quarantine and the
degradation ladder (port of ``repro.runtime``'s static-graph serving path;
the checkpoint, chaos, watchdog and certifier modules come with ROADMAP
Queue 1 item 13)."""
from repro_torch.runtime.failures import (
    WorkerFailure, ExchangeCorruption, RestartPolicy, RETRYABLE_EXCEPTIONS)
from repro_torch.runtime.sla import (
    AdmissionController, QuarantinePolicy, DegradationLadder,
    nonfinite_queries, nan_queries)
from repro_torch.runtime.session import ServeSession, drain_reference

__all__ = [
    "WorkerFailure", "ExchangeCorruption", "RestartPolicy",
    "RETRYABLE_EXCEPTIONS", "AdmissionController", "QuarantinePolicy",
    "DegradationLadder", "nonfinite_queries", "nan_queries",
    "ServeSession", "drain_reference",
]
