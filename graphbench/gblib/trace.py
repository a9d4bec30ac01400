"""Read a ``torch.profiler`` trace of the measured window.

The method of ``scripts/superstep_trace.py`` (device time by name from the
profiler's CUDA events over a synchronised window), extended:

- the traced window is the union of the client's calls into the program
  (each inside ``record_function(CALL_MARK)``), so the client's own work
  between calls is not the program's idle time;
- the device's busy time is the union of the intervals in which a kernel, a
  copy or a memset ran, clipped to the calls (operations on one stream do
  not overlap, but the union also holds for several);
- the idle gaps between those intervals are charged to what the host's main
  thread was doing meanwhile: the outermost traced host operation (an
  ``aten`` op or a CUDA runtime call) overlapping each part of a gap, or
  ``host outside any traced op`` (Python) where none does;
- device-to-host copies are summed apart (``dtoh_s``).

The summary is made from plain ``(name, start_ns, end_ns)`` tuples, so the
arithmetic is tested on synthetic events without a card.
"""
from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Event = Tuple[str, int, int]          # name, start ns, end ns

CALL_MARK = "graphbench.call"
NO_HOST_OP = "host outside any traced op"


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    head = name.split("(")[0] if "(" in name else name
    return head[:width]


def union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Sorted disjoint union of ``(start, end)`` intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def outermost(host: Sequence[Event]) -> List[Event]:
    """The host events not nested inside another (one thread's events nest
    or follow each other), sorted by start."""
    out: List[Event] = []
    end = None
    for name, s, e in sorted(host, key=lambda ev: (ev[1], -ev[2])):
        if end is None or s >= end:
            out.append((name, s, e))
            end = e
    return out


def charge_gaps(gaps: Sequence[Tuple[int, int]],
                host: Sequence[Event]) -> Dict[str, float]:
    """Seconds of each gap charged to the outermost host operation over it
    (``host`` sorted, disjoint), the rest to ``NO_HOST_OP``."""
    starts = [s for _, s, _ in host]
    charged: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(host) and host[i][1] < g1:
            name, s, e = host[i]
            part = min(e, g1) - max(s, g0)
            if part > 0:
                charged[name] += part * 1e-9
                covered += part
            i += 1
        rest = (g1 - g0) - covered
        if rest > 0:
            charged[NO_HOST_OP] += rest * 1e-9
    return dict(charged)


def intersect(a: Sequence[Tuple[int, int]],
              b: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def summarize(device: Sequence[Event], host: Sequence[Event],
              spans: Sequence[Tuple[int, int]], top: int = 10) -> dict:
    """Over the window ``spans`` (disjoint ``(start, end)``): its busy and
    idle seconds, device seconds by operation, device-to-host copy seconds
    and the idle gaps charged to the host's operations (``top`` of each,
    longest first)."""
    spans = union(spans)
    starts = [lo for lo, _ in spans]
    busy = intersect(union((s, e) for _, s, e in device), spans)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    by_name: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in device:
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(spans) and spans[i][0] < e:
            part = min(e, spans[i][1]) - max(s, spans[i][0])
            if part > 0:
                by_name[n] += part * 1e-9
            i += 1
    edges = [lo for lo, _ in spans[:1]] + [x for iv in busy for x in iv] + [
        hi for _, hi in spans[-1:]]
    free = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    gaps = intersect(free, spans)
    idle = charge_gaps(gaps, outermost(host))
    dtoh = sum(t for n, t in by_name.items() if "DtoH" in n)
    order = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": sum(hi - lo for lo, hi in spans) * 1e-9,
        "busy_s": busy_s,
        "dtoh_s": dtoh,
        "device_s": dict(by_name),
        "device_ops": [[short_name(n), t] for n, t in order[:top]],
        "idle_gaps": [[n, t] for n, t in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def device_seconds(summary: dict, *parts: str) -> float:
    """Device seconds of every operation whose name holds one of
    ``parts``."""
    return sum(t for n, t in summary["device_s"].items()
               if any(p in n for p in parts))


def from_profiler(prof) -> Optional[dict]:
    """Summarise a finished ``torch.profiler.profile`` whose calls into the
    program ran inside ``record_function(CALL_MARK)``: device events are
    the CUDA kernels, copies and memsets; host events are the operations of
    the thread that made the calls.  None without a call."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device: List[Event] = []
    host: List[Tuple[str, int, int, int]] = []
    spans, tid = [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if name == CALL_MARK:
            if ev.device_type() != cuda:
                spans.append((s, e))
                tid = ev.start_thread_id()
            continue
        if name.startswith("graphbench."):      # a mark on the device
            continue
        if ev.device_type() == cuda:
            device.append((name, s, e))
        else:
            host.append((name, s, e, ev.start_thread_id()))
    if not spans:
        return None
    main = [(n, s, e) for n, s, e, t in host if t == tid]
    return summarize(device, main, spans)
