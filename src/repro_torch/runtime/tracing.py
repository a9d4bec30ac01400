"""Spans and counters of the engine's own work, recorded in memory.

    from repro_torch.runtime import tracing
    tracing.enable()
    levels, steps = bfs_batched(engine, roots)
    rec = tracing.snapshot()      # {"spans": [...], "counters": {...}}
    tracing.reset()

- ``span(name, **ints)`` is a context manager around a piece of work
  (``with tracing.span("bsp.superstep", step=i): ...``); ``count(name,
  n=1)`` adds to a named counter.
- Tracing is off until ``enable()`` and off again after ``disable()``.
  Off, ``span`` returns one shared no-op context and ``count`` returns at
  once: nothing is recorded, nothing calls torch and nothing waits for the
  device.
- On, each span records its name, its start and end (``time.time_ns()``,
  the wall clock in ns that ``torch.profiler``'s host stamps use, so a span
  can be laid over the profiler's events), the index of its parent span
  (-1 for a root), a call id that every span under one root shares, and its
  integer attributes.  The stack of open spans is per thread.

A span measures the host's time inside it; the device's time is charged
to spans afterwards, from a profiler trace of the same run (each kernel to
the span that launched it).  No span reads anything back from the device.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List

__all__ = ["span", "count", "enable", "disable", "enabled", "snapshot",
           "reset", "NULL_SPAN"]

_on = False
# One record per span, in the order the spans opened: [name, start_ns,
# end_ns (None while open), parent index, call id, attributes].
_spans: List[list] = []
_counters: Dict[str, int] = {}
_calls = itertools.count()
_local = threading.local()
_lock = threading.Lock()        # spans and counters may come from threads
_generation = 0     # bumped by reset(), so a span open across it is dropped


class _NullSpan:
    """The shared context of every span while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "index", "generation")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.index = -1
        self.generation = -1

    def __enter__(self):
        self.generation = _generation
        if getattr(_local, "generation", None) != _generation:
            _local.stack, _local.generation = [], _generation
        stack = _local.stack
        if stack:
            parent = stack[-1]
            call = _spans[parent][4]
        else:
            parent, call = -1, next(_calls)
        with _lock:
            self.index = len(_spans)
            _spans.append([self.name, time.time_ns(), None, parent, call,
                           self.attrs])
        stack.append(self.index)
        return self

    def __exit__(self, *exc):
        if self.generation == _generation:
            _spans[self.index][2] = time.time_ns()
            _local.stack.pop()
        return False


def span(name: str, **ints):
    """A context manager that records the work inside it as ``name``, with
    integer attributes ``ints``; the shared no-op while tracing is off."""
    if not _on:
        return NULL_SPAN
    return _Span(name, ints)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while tracing is off)."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def snapshot() -> dict:
    """What was recorded since the last ``reset()``: ``spans``, a list of
    ``(name, start_ns, end_ns, parent, call, attrs)`` in the order the
    spans opened (``end_ns`` None for a span still open), and
    ``counters``."""
    return {"spans": [tuple(rec[:5]) + (dict(rec[5]),) for rec in _spans],
            "counters": dict(_counters)}


def reset() -> None:
    """Forget every span and counter.  A span open across the reset is
    not recorded."""
    global _generation
    _generation += 1
    _spans.clear()
    _counters.clear()
