"""Straggler detection: per-step timing watchdog (port of
``repro.runtime.watchdog``, pure Python).

At 1000+ nodes the slowest worker sets the step time (the paper's makespan,
Eq. 2, applied to the fleet).  The watchdog keeps an EWMA + variance of step
durations and flags steps (or, multi-host, workers — the per-host hook is
``report``) that exceed ``threshold`` standard deviations.  Mitigation hooks:
skip-slow-data-shard, checkpoint-and-replace-node, or just alerting; the
driver decides via the callback.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepWatchdog:
    alpha: float = 0.1                 # EWMA factor
    threshold: float = 3.0             # flag at mean + threshold·std
    warmup_steps: int = 5              # ignore compile/first steps
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    # absolute ceiling: flag regardless of warmup/EWMA (serving drivers use
    # this as the checkpoint-now trigger — a step this slow may be a dying
    # worker, snapshot before it takes the batch down)
    hard_limit_s: Optional[float] = None

    _mean: float = 0.0
    _var: float = 0.0
    _count: int = 0
    _start: float = 0.0
    stragglers: List[int] = dataclasses.field(default_factory=list)

    def start(self):
        self._start = time.perf_counter()

    def stop(self, step: int) -> bool:
        """Returns True if this step was flagged as a straggler."""
        dur = time.perf_counter() - self._start
        return self.report(step, dur)

    def report(self, step: int, dur: float) -> bool:
        self._count += 1
        hard = self.hard_limit_s is not None and dur > self.hard_limit_s
        if self._count <= self.warmup_steps:
            self._mean = dur if self._count == 1 else \
                self._mean + (dur - self._mean) / self._count
            if hard:
                self.stragglers.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dur, self._mean)
            return hard
        std = max(self._var ** 0.5, 1e-9)
        flagged = hard or (dur > self._mean + self.threshold * std
                           and dur > 1.5 * self._mean)
        if flagged:
            self.stragglers.append(step)
            if self.on_straggler:
                self.on_straggler(step, dur, self._mean)
        # EWMA update; flagged steps contribute with dampened weight so a
        # single spike barely moves the mean but a persistent regime change
        # (e.g. a permanently slower replacement node) is eventually absorbed
        # instead of being flagged forever.
        a = self.alpha * (0.25 if flagged else 1.0)
        delta = dur - self._mean
        self._mean += a * delta
        self._var = (1 - a) * (self._var + a * delta * delta)
        return flagged

    @property
    def mean_step_s(self) -> float:
        return self._mean
