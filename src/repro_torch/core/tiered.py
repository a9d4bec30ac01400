"""Host arenas and the double-buffered copy stream of a tiered engine.

A tiered engine (``BSPEngine(pg, tiered=...)``) keeps its cold edge arenas
in host memory and streams them through the superstep window by window.
:class:`HostArena` holds one direction's windows: one contiguous host
tensor per window array, pinned when the engine runs on a CUDA device, each
window a slice of it.  :class:`WindowStream` holds the two device buffers
a window is copied into, allocated once, and issues the copies.  On a
dynamic graph :class:`OverlayArena` adds to one direction's windows their
slices of the graph's current tombstones and, after them, one window of
delta slots per cold partition, read from the graph's host payload.

On a CUDA device the copies are ``non_blocking`` copies from pinned memory
on a side stream.  The compute stream waits on the event recorded after a
window's copy before it reads the window, and the next copy into a buffer
waits on the event recorded after the compute that read it, so the copy of
window ``w + 1`` runs while window ``w`` is computed and no buffer is
overwritten while a kernel still reads it.  Nothing synchronises the host.
On a CPU device the copy is a plain copy and nothing is pinned (the tests'
path); on a CUDA device a failure to pin or to copy raises.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

Window = Dict[str, torch.Tensor]


class HostArena:
    """One direction's windows in host memory.

    ``windows`` is a list of dicts of numpy arrays with the same keys; each
    key's arrays are concatenated into one host tensor (pinned when
    ``pin``), and window ``w``'s array is its slice
    ``offsets[key][w]:offsets[key][w + 1]``.
    """

    def __init__(self, windows: List[Dict[str, np.ndarray]], pin: bool):
        self.num_windows = len(windows)
        self.names = tuple(windows[0]) if windows else ()
        self.tensors: Dict[str, torch.Tensor] = {}
        self.offsets: Dict[str, np.ndarray] = {}
        for k in self.names:
            parts = [np.ascontiguousarray(w[k]).ravel() for w in windows]
            t = torch.from_numpy(np.concatenate(parts))
            self.tensors[k] = t.pin_memory() if pin else t
            self.offsets[k] = np.concatenate(
                [[0], np.cumsum([len(a) for a in parts])]).astype(np.int64)

    def names_of(self, w: int) -> Tuple[str, ...]:
        return self.names

    def length(self, name: str, w: int) -> int:
        off = self.offsets[name]
        return int(off[w + 1] - off[w])

    def max_length(self, name: str) -> int:
        return int(np.diff(self.offsets[name]).max(initial=0))

    def window(self, name: str, w: int) -> torch.Tensor:
        off = self.offsets[name]
        return self.tensors[name][int(off[w]):int(off[w + 1])]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors.values())


class OverlayArena:
    """One direction's stream on a tiered dynamic graph: the base windows
    of ``base``, each with its slice of the tombstones (``tomb``), then
    one window per cold partition of its delta slots (``delta``: ``d_src``
    and ``d_dst_ext``, and ``d_weight`` on a weighted graph).

    ``tomb`` and ``delta`` are the graph's host payload, which mutation
    batches write in place; a window reads it when its copy is issued, so
    every run streams the current overlay.  ``spans[w]`` is base window
    ``w``'s ``(partition, first slot, slots)``.
    """

    def __init__(self, base: HostArena, spans, tomb: torch.Tensor,
                 delta: Dict[str, torch.Tensor], cold):
        self.base, self.spans, self.tomb, self.delta = base, spans, tomb, delta
        self.cold = [int(p) for p in cold]
        self.num_windows = base.num_windows + len(self.cold)
        self._base_names = base.names + ("tomb",)
        self._delta_names = tuple(delta)

    def names_of(self, w: int) -> Tuple[str, ...]:
        return (self._base_names if w < self.base.num_windows
                else self._delta_names)

    def length(self, name: str, w: int) -> int:
        if w >= self.base.num_windows:
            return self.delta[name].shape[1]
        if name == "tomb":
            return self.spans[w][2]
        return self.base.length(name, w)

    def window(self, name: str, w: int) -> torch.Tensor:
        nb = self.base.num_windows
        if w >= nb:
            return self.delta[name][self.cold[w - nb]]
        if name == "tomb":
            p, st, cnt = self.spans[w]
            return self.tomb[p, st:st + cnt]
        return self.base.window(name, w)


class WindowStream:
    """Two device buffers per window array (``sizes``: name -> (dtype,
    elements)), allocated once, and the copies of a :class:`HostArena`'s
    windows into them.

    ``timing``, when set to a list, gets one ``(copy_start, copy_end,
    compute_start, compute_end)`` tuple of CUDA events per window (the
    measurement of ``chip_smoke.py``; :func:`stream_times` reads it).
    """

    def __init__(self, sizes: Dict[str, Tuple[torch.dtype, int]],
                 device: torch.device):
        self.device = device
        self.bufs = [{k: torch.empty(n, dtype=dt, device=device)
                      for k, (dt, n) in sizes.items()} for _ in range(2)]
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(device)
            self.ready = [torch.cuda.Event(), torch.cuda.Event()]
            self.free = [torch.cuda.Event(), torch.cuda.Event()]
        self.timing: Optional[list] = None
        self._pending: list = [None, None]    # a slot's copy events

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for bufs in self.bufs for t in bufs.values())

    def _put(self, arena: HostArena, w: int, slot: int) -> None:
        bufs = self.bufs[slot]
        if not self.cuda:
            for k in arena.names_of(w):
                bufs[k][:arena.length(k, w)].copy_(arena.window(k, w))
            return
        cs = self.copy_stream
        # the buffer's last reader has been enqueued on the compute stream
        cs.wait_event(self.free[slot])
        start = None
        if self.timing is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(cs)
        with torch.cuda.stream(cs):
            for k in arena.names_of(w):
                bufs[k][:arena.length(k, w)].copy_(arena.window(k, w),
                                                   non_blocking=True)
        self.ready[slot].record(cs)
        if start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(cs)
            self._pending[slot] = (start, end)

    def windows(self, arena: HostArena) -> Iterator[Tuple[int, Window]]:
        """Issue the copy of window 0 now, and return an iterator over
        ``(w, views)``: ``views`` maps each array to its window's prefix of
        a buffer.  The caller enqueues all the work that reads ``views``
        before it takes the next window."""
        if arena.num_windows:
            self._put(arena, 0, 0)
        return self._iter(arena)

    def _iter(self, arena: HostArena) -> Iterator[Tuple[int, Window]]:
        n = arena.num_windows
        for w in range(n):
            if w + 1 < n:
                self._put(arena, w + 1, (w + 1) % 2)
            slot = w % 2
            cur = None
            if self.cuda:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(self.ready[slot])
                if self.timing is not None:
                    c0 = torch.cuda.Event(enable_timing=True)
                    c0.record(cur)
            bufs = self.bufs[slot]
            yield w, {k: bufs[k][:arena.length(k, w)]
                      for k in arena.names_of(w)}
            if self.cuda:
                self.free[slot].record(cur)
                if self.timing is not None:
                    c1 = torch.cuda.Event(enable_timing=True)
                    c1.record(cur)
                    self.timing.append(self._pending[slot] + (c0, c1))


def stream_times(timing: list) -> dict:
    """Sum a :class:`WindowStream` ``timing`` list after a synchronise:
    copy and compute milliseconds, the wall from the first copy's start to
    the last compute's end, and the overlap, the share of the shorter of
    the two hidden under the other."""
    if not timing:
        return dict(copy_ms=0.0, compute_ms=0.0, wall_ms=0.0, overlap=0.0)
    copy_ms = sum(c0.elapsed_time(c1) for c0, c1, _, _ in timing)
    compute_ms = sum(k0.elapsed_time(k1) for _, _, k0, k1 in timing)
    wall_ms = timing[0][0].elapsed_time(timing[-1][3])
    hidden = copy_ms + compute_ms - wall_ms
    return dict(copy_ms=copy_ms, compute_ms=compute_ms, wall_ms=wall_ms,
                overlap=hidden / max(min(copy_ms, compute_ms), 1e-9))
