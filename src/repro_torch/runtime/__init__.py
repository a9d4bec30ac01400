"""The serving runtime: continuous batching, admission, quarantine, the
degradation ladder, checkpoint/restart, fault injection, the straggler
watchdog and the result certifiers (port of ``repro.runtime``)."""
from repro_torch.runtime.watchdog import StepWatchdog
from repro_torch.runtime.failures import (
    run_with_restarts, serve_with_restarts, FaultInjector, WorkerFailure,
    ExchangeCorruption, RestartPolicy, RETRYABLE_EXCEPTIONS, KERNEL_FAILURES)
from repro_torch.runtime.sla import (
    AdmissionController, QuarantinePolicy, DegradationLadder,
    nonfinite_queries, nan_queries)
from repro_torch.runtime.session import ServeSession, drain_reference
from repro_torch.runtime.verify import (
    CheckResult, Verdict, ResultCertifier, InvariantMonitor, certify,
    monitor_for)
from repro_torch.runtime import chaos

__all__ = [
    "StepWatchdog", "run_with_restarts", "serve_with_restarts",
    "FaultInjector", "WorkerFailure", "ExchangeCorruption", "RestartPolicy",
    "RETRYABLE_EXCEPTIONS", "KERNEL_FAILURES", "AdmissionController",
    "QuarantinePolicy", "DegradationLadder", "ServeSession",
    "drain_reference", "chaos", "CheckResult", "Verdict", "ResultCertifier",
    "InvariantMonitor", "certify", "monitor_for", "nonfinite_queries",
    "nan_queries",
]
