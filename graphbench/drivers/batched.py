"""Closed-loop client of a batched single-source entry (``sssp_batched``,
``bfs_batched``): one call at a time, the next after the previous returns,
each with a batch of ``roots_per_batch`` roots.

The batches are a fixed pool of ``pool_batches`` batches of distinct roots,
drawn from the configuration's graph seed among the vertices of out-degree
at least ``root_min_out_degree``; a run walks the pool in an order drawn
from its seed, from the start again when the window outlasts it.  So every
seed does the same work in another order: the time of a call is set by the
deepest of its roots, and roots drawn anew for each seed made runs of one
seed agree within 0.3 % while seeds differed by 6.5 % (``PERF.md``).

Every call's wall is its own (host clock; the call returns host arrays, so
the device has finished).  After each call, outside its wall, the client
counts the call's traversed edges (Graph500's rule) and keeps, for each of
the batch's slots, a reservoir sample drawn from the seed of
``check_rows_per_slot`` of that slot's answers (a root and its ``[n]``
row), for the comparison with the plain reference once the window has
closed: every slot of a batch is compared, each in calls drawn from all the
window's calls.
"""
from __future__ import annotations

import contextlib
import importlib
import time

import numpy as np
import torch

from gblib import yardstick

PROGRAMS = {"sssp_batched": ("sssp", "SSSP_PROGRAM"),
            "bfs_batched": ("bfs", "BFS_PROGRAM")}

SSSP_ENTRY = "sssp_batched"


def programs(traffic: dict, n: int):
    """The vertex programs the entry runs, whose splits set-up builds."""
    module, name = PROGRAMS[traffic["entry"]]
    return [getattr(importlib.import_module(
        f"repro_torch.algorithms.{module}"), name)]


class Client:
    """One client of ``traffic``'s entry on the graph ``host`` (``n``,
    ``out_deg`` int64 ``[n]`` on the host, ``candidates`` the root ids,
    ``graph_seed``)."""

    def __init__(self, traffic: dict, seed: int, host: dict):
        self.traffic = traffic
        self.q = int(traffic["roots_per_batch"])
        self.host = host
        self.seed = int(seed) % (1 << 64)
        self.entry = traffic["entry"]
        self.per_slot = int(traffic["check_rows_per_slot"])
        self.sample_size = self.q * self.per_slot
        self.sample = [[] for _ in range(self.q)]  # per slot: [(root, row)]
        self.sample_rng = np.random.default_rng([self.seed, 2])
        self.calls_kept = 0
        cands = host["candidates"]
        pool = np.random.default_rng([host["graph_seed"], 1]).choice(
            cands, size=int(traffic["pool_batches"]) * self.q, replace=False)
        self.pool = pool.reshape(-1, self.q)
        self.warm = np.random.default_rng([host["graph_seed"], 0]).choice(
            cands, size=self.q, replace=False)
        self.order = np.random.default_rng([self.seed, 1]).permutation(
            len(self.pool))

    def _call(self, engine, roots):
        algos = importlib.import_module("repro_torch.algorithms")
        return getattr(algos, self.entry)(engine, roots)

    def roots(self, i: int) -> np.ndarray:
        """The roots of the window's ``i``-th call."""
        return self.pool[self.order[i % len(self.pool)]]

    def warmup(self, engine) -> None:
        for _ in range(int(self.traffic["warmup_batches"])):
            self._call(engine, self.warm)

    def _keep(self, roots, result) -> None:
        """Algorithm R over the window's calls, slot by slot."""
        k = self.calls_kept
        if k < self.per_slot:
            for slot, root in enumerate(roots):
                self.sample[slot].append((int(root), result[slot].copy()))
        else:
            draws = self.sample_rng.integers(0, k + 1, size=len(roots))
            for slot in np.flatnonzero(draws < self.per_slot):
                self.sample[slot][draws[slot]] = (int(roots[slot]),
                                                  result[slot].copy())
        self.calls_kept += 1

    def window(self, engine, seconds: float,
               span=contextlib.nullcontext) -> dict:
        """Calls until ``seconds`` have passed, each inside ``span()``."""
        walls, steps, traversed, examined = [], [], 0, 0
        client_s = 0.0
        start = time.perf_counter()
        while True:
            roots = self.roots(len(walls))
            with span():
                t0 = time.perf_counter()
                result, call_steps = self._call(engine, roots)
                t1 = time.perf_counter()
            walls.append(t1 - t0)
            steps.append(int(np.max(call_steps)))
            stats = engine.last_direction_stats
            if stats is not None:
                examined += int(np.sum(stats["edges_examined"]))
            traversed += yardstick.traversed_edges(result,
                                                   self.host["out_deg"])
            self._keep(roots, result)
            del result
            client_s += time.perf_counter() - t1
            if t1 - start >= seconds:
                break
        return {"seconds": t1 - start, "calls": len(walls), "walls": walls,
                "queries": len(walls) * self.q, "supersteps": sum(steps),
                "steps": steps,
                "traversed": traversed, "edges_examined": examined,
                "client_s": client_s}

    def check(self, ref, graph: dict, control: bool = False) -> dict:
        """Compare every kept answer with the plain reference, bit for bit
        (BFS levels and float32 SSSP distances each have one right value):
        ``{name: (value, limit)}``, each value at most its limit.
        ``control`` puts the reference computed in TF32 in the program's
        place."""
        kept = [pair for slot in self.sample for pair in slot]
        roots = [r for r, _ in kept]
        src, dst, n = graph["src"], graph["dst"], graph["n"]
        if self.entry == SSSP_ENTRY:
            def solve(ctl):
                return ref.sssp_distances(src, dst, graph["weight"], n,
                                          roots, control=ctl)
        else:
            def solve(ctl):
                return ref.bfs_levels(src, dst, n, roots, control=ctl)
        want = solve(False)
        if control:
            got = solve(True)
        else:
            got = torch.as_tensor(np.stack([row for _, row in kept]),
                                  device=want.device)
        bad = int((got != want).sum())     # inf == inf holds
        limits = self.traffic["limits"]
        return {"mismatched_values": (bad, limits["mismatched_values"]),
                "rows_short": (self.sample_size - len(roots),
                               limits["rows_short"])}
