"""Charge a traced window's device time and idle gaps to the program's own
spans (``repro_torch.runtime.tracing``).

The program records its spans on the host's wall clock in ns, the clock of
``torch.profiler``'s host events, so the two lie on one time line:

- each device kernel, copy or memset is charged to the innermost program
  span open when the runtime call that launched it started (the kineto
  ``correlation_id`` links the two), and only for its part inside the
  client's calls, as ``gblib/trace.py`` clips it; a kernel launched where
  no span is open goes to ``OUTSIDE``;
- each idle gap (no kernel, copy or memset running inside a call) is split
  at the span boundaries that fall in it, and each piece is charged to the
  innermost span open on the host meanwhile, or to ``OUTSIDE``.

Spans of one thread nest, so their innermost span over time is a list of
disjoint segments (``innermost``).  Everything is made from plain tuples,
so the arithmetic is tested on synthetic events without a card.
"""
from __future__ import annotations

import bisect
import collections
import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from gblib import trace

Span = Tuple[str, int, int, int]           # name, start ns, end ns, parent
Device = Tuple[str, int, int, int]         # name, start ns, end ns, launch ns
Segment = Tuple[int, int, int]             # start ns, end ns, span index

OUTSIDE = "outside any program span"


def innermost(spans: Sequence[Span]) -> List[Segment]:
    """The innermost open span over time: sorted disjoint ``(start, end,
    index)`` segments.  A span still open (end None) is left out; a child
    that outlasts its parent is cut at the parent's end."""
    order = sorted((s[1], -s[2], i) for i, s in enumerate(spans)
                   if s[2] is not None)
    out: List[Segment] = []
    stack: List[Tuple[int, int]] = []      # (end, index), innermost last
    cursor = 0

    def close_until(t):
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            end, i = stack.pop()
            if end > cursor:
                out.append((cursor, end, i))
                cursor = end

    for start, neg_end, i in order:
        close_until(start)
        if stack and start > cursor:
            out.append((cursor, start, stack[-1][1]))
        cursor = start
        end = -neg_end if not stack else min(-neg_end, stack[-1][0])
        stack.append((end, i))
    close_until(float("inf"))
    return out


def span_at(segments: Sequence[Segment], starts: Sequence[int],
            t: int) -> int:
    """The index of the innermost span open at ``t``, or -1."""
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and segments[k][0] <= t < segments[k][1]:
        return segments[k][2]
    return -1


def _clipped(s: int, e: int, windows: Sequence[Tuple[int, int]],
             wstarts: Sequence[int]) -> int:
    """ns of ``[s, e)`` inside the disjoint sorted ``windows``."""
    total = 0
    i = max(bisect.bisect_right(wstarts, s) - 1, 0)
    while i < len(windows) and windows[i][0] < e:
        total += max(0, min(e, windows[i][1]) - max(s, windows[i][0]))
        i += 1
    return total


def summarize(device: Sequence[Device], spans: Sequence[Span],
              windows: Sequence[Tuple[int, int]], top: int = 16) -> dict:
    """Over the calls ``windows``: device seconds and idle seconds by
    span name (``device_s``, ``idle_s``), their totals, the device seconds
    charged below the root spans (``below_root_s``: every span with a
    parent), the device-to-host copies launched in the calls
    (``dtoh_copies``), and the ``top`` spans of each, most first
    (``device_by_span``, ``idle_by_span``)."""
    calls = len(windows)
    windows = trace.union(windows)
    wstarts = [lo for lo, _ in windows]
    segs = innermost(spans)
    sstarts = [s for s, _, _ in segs]

    def name(i):
        return spans[i][0] if i >= 0 else OUTSIDE

    dev: Dict[str, float] = collections.defaultdict(float)
    below = 0.0
    dtoh = 0
    for n, s, e, launch in device:
        if "DtoH" in n:
            # counted where it was launched: a copy's device stamps may
            # fall just past the end of a call on the host's clock
            t = launch if launch is not None else s
            dtoh += _clipped(t, t + 1, windows, wstarts)
        part = _clipped(s, e, windows, wstarts)
        if part <= 0:
            continue
        i = span_at(segs, sstarts, launch) if launch is not None else -1
        dev[name(i)] += part * 1e-9
        if i >= 0 and spans[i][3] >= 0:
            below += part * 1e-9
    busy = trace.intersect(trace.union((s, e) for _, s, e, _ in device),
                           windows)
    edges = [lo for lo, _ in windows[:1]] + [x for iv in busy for x in iv] + [
        hi for _, hi in windows[-1:]]
    free = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in trace.intersect(free, windows):
        covered = 0
        k = max(bisect.bisect_right(sstarts, g0) - 1, 0)
        while k < len(segs) and segs[k][0] < g1:
            part = min(segs[k][1], g1) - max(segs[k][0], g0)
            if part > 0:
                idle[name(segs[k][2])] += part * 1e-9
                covered += part
            k += 1
        if g1 - g0 > covered:
            idle[OUTSIDE] += (g1 - g0 - covered) * 1e-9

    def ranked(d):
        return [[n, t] for n, t in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return {"device_s": dict(dev), "idle_s": dict(idle),
            "device_total_s": sum(dev.values()),
            "idle_total_s": sum(idle.values()), "below_root_s": below,
            "calls": calls, "dtoh_copies": dtoh, "spans": len(spans),
            "device_by_span": ranked(dev), "idle_by_span": ranked(idle)}


def span_seconds(spans: Sequence[Span]) -> Dict[str, float]:
    """Host seconds of the closed spans, summed by name."""
    out: Dict[str, float] = collections.defaultdict(float)
    for n, s, e, _ in spans:
        if e is not None:
            out[n] += (e - s) * 1e-9
    return dict(out)


def superstep_kinds(spans: Sequence[Span],
                    windows: Sequence[Tuple[int, int]] = ()) -> Dict[str, int]:
    """Supersteps by what they ran, from the spans: ``push`` (a ``bsp.push``
    span and no ``bsp.pull`` under its ``bsp.superstep``), ``pull`` or
    ``mixed`` (both), as the program's ``bsp.supersteps.*`` counters count
    them; with ``windows``, only the supersteps that start inside them."""
    ran = collections.defaultdict(set)
    for name, _, _, parent in spans:
        if name not in ("bsp.push", "bsp.pull"):
            continue
        while parent >= 0 and spans[parent][0] != "bsp.superstep":
            parent = spans[parent][3]
        if parent >= 0:
            ran[parent].add(name)
    out = {"push": 0, "pull": 0, "mixed": 0}
    for i, names in ran.items():
        if windows and not any(lo <= spans[i][1] < hi for lo, hi in windows):
            continue
        out["mixed" if len(names) == 2 else
            "push" if "bsp.push" in names else "pull"] += 1
    return out


def program_spans(snapshot: Optional[dict]) -> List[Span]:
    """``(name, start_ns, end_ns, parent)`` of a tracing snapshot's
    spans."""
    if not snapshot:
        return []
    return [tuple(rec[:4]) for rec in snapshot["spans"]]


def read_profile(prof, snapshot: Optional[dict]) -> Optional[dict]:
    """``summarize`` a finished ``torch.profiler.profile`` whose calls ran
    inside ``record_function(trace.CALL_MARK)``, against the program's
    spans of the same run (a ``tracing.snapshot()``; None gives every
    device second to ``OUTSIDE``), with the window's ``supersteps`` by kind
    and the host seconds by name of the spans that ended before the first
    call (``setup``: set-up and warm-up).  Device events are linked to the
    runtime call (``cuda*``/``cu*``) that launched them by correlation id.
    None without a call."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    windows, launches, device = [], {}, []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if ev.device_type() == cuda:
            if not name.startswith("graphbench."):
                device.append((name, s, e, ev.correlation_id()))
        elif name == trace.CALL_MARK:
            windows.append((s, e))
        elif name.startswith("cu"):
            launches[ev.correlation_id()] = s
    if not windows:
        return None
    linked = [(n, s, e, launches.get(c)) for n, s, e, c in device]
    sp = program_spans(snapshot)
    first = min(lo for lo, _ in windows)
    out = summarize(linked, sp, windows)
    out["supersteps"] = superstep_kinds(sp, trace.union(windows))
    out["setup"] = span_seconds([x for x in sp
                                 if x[2] is not None and x[2] <= first])
    return out


# -- the hook.  ``run.py`` loads a traced run's per-layer readers before
# set-up and summarises the window's profile through
# ``trace.from_profiler``; a span metric's reader calls ``install`` when it
# is loaded, so the program's spans are recorded from set-up on and the
# trace summary carries the window's ``spans`` (``read_profile``). ---------

def _log(*parts) -> None:
    print("[graphbench]", *parts, file=sys.stderr, flush=True)


def install(root) -> bool:
    """Turn the program's tracing on (``repro_torch.runtime.tracing``,
    under ``root/src``) and make ``trace.from_profiler`` add the window's
    spans to its summary as ``spans``.  False, and nothing changed, for a
    program that records no spans."""
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return False
    if not tracing.enabled():
        tracing.reset()
        tracing.enable()
    if not getattr(trace.from_profiler, "reads_spans", False):
        trace.from_profiler = _with_spans(trace.from_profiler, tracing)
    return True


def _with_spans(base, tracing):
    def from_profiler(prof):
        summary = base(prof)
        if summary is None or not tracing.enabled():
            return summary
        rec = tracing.snapshot()
        tracing.disable()
        tracing.reset()
        sp = summary["spans"] = read_profile(prof, rec)
        sp["counters"] = rec["counters"]
        _log("set-up spans s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(sp["setup"].items(),
                                             key=lambda kv: -kv[1])))
        _log(f"device s by span: {sp['device_by_span']}")
        _log(f"idle s by span: {sp['idle_by_span']}")
        _log(f"spans {sp['spans']}; the window's supersteps "
             f"{sp['supersteps']}; the program's counters (set-up "
             f"included) {sp['counters']}; device "
             f"{sp['device_total_s']:.6f} s, below the entries "
             f"{sp['below_root_s']:.6f} s, the trace's "
             f"{sum(summary['device_s'].values()):.6f} s; DtoH copies "
             f"{sp['dtoh_copies']} in {sp['calls']} calls")
        return summary
    from_profiler.reads_spans = True
    return from_profiler


# -- reductions the span metrics' readers share; each returns None where
# the run holds nothing to read ---------------------------------------------

def _spans_of(run) -> Optional[dict]:
    return (run.get("trace") or {}).get("spans")


def device_ms_per_superstep(run, span: str, *kinds: str):
    """Device ms charged to ``span`` in the window, over the window's
    supersteps of ``kinds`` (``push``, ``pull``, ``mixed``)."""
    sp = _spans_of(run)
    if not sp or not sp["device_s"].get(span):
        return None
    steps = sum(sp["supersteps"].get(k, 0) for k in kinds)
    return 1e3 * sp["device_s"][span] / steps if steps else None


def device_ms_per_call(run, span: str):
    """Device ms charged to ``span`` in the window, per call."""
    sp = _spans_of(run)
    if not sp or not sp["device_s"].get(span) or not sp["calls"]:
        return None
    return 1e3 * sp["device_s"][span] / sp["calls"]


def setup_span_s(run, span: str):
    """Host seconds of the ``span`` spans before the first call, summed."""
    sp = _spans_of(run)
    if not sp or not sp["setup"].get(span):
        return None
    return sp["setup"][span]
