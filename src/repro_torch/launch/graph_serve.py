"""Batched graph query serving: one resident partitioned graph, a query
stream, and queries per second with latency percentiles.

  1. generate a synthetic workload (RMAT / uniform, the paper's Table 2
     generators) and partition it once;
  2. build one engine (reference / fused / hybrid backend) on the device:
     the topology, block metadata and degree splits stay resident for the
     whole run;
  3. drain a synthetic query stream in fixed batches of Q sources, each
     batch one ``engine.execute`` call, so per-query cost amortizes the
     launches and the graph's residency Q ways;
  4. report queries/sec, per-query latency percentiles (a query's latency
     is its batch's wall time: batch-synchronous serving), the amortized
     per-query time, and the retrace count (growth of the structures an
     engine builds at a program's first run,
     ``BSPEngine.cache_entries``; 0 after warm-up is the
     serving contract).

  PYTHONPATH=src python -m repro_torch.launch.graph_serve \
      [--scale 12] [--parts 4] [--alg bfs] [--batch 32] \
      [--num-queries 256] [--backend fused] [--out serve_report.json]
  PYTHONPATH=src python -m repro_torch.launch.graph_serve --smoke \
      --device cpu [--continuous | --depth-buckets 2 | --mutate]

Runs on ``cuda`` unless ``--device`` names another device.  ``--smoke``
shrinks everything for CI.  The first batch pays the host layouts and the
kernels' build and is reported apart (``cold_ms``).

Serving modes compose through a validated :class:`ServeConfig`.
``--continuous`` swaps drain-batch scheduling for a resident
:class:`~repro_torch.runtime.session.ServeSession`: converged slots are
harvested and refilled from the admission queue at chunk boundaries, and
the report compares ``continuous_qps``/p99 against the drain-batch
baseline on the same stream.  ``--depth-buckets`` orders the stream by
estimated depth.  ``--hbm-budget`` builds a tiered engine, which the drain
and mutating modes serve and the continuous mode refuses; with
``--mutate`` the dynamic graph's payload stays in host memory (pinned on
a card), and the engine streams the cold partitions' tombstones and delta
slots with their windows.

``--mutate`` serves an evolving graph: a resident ``DynamicGraph`` takes
``--mutation-rounds`` batches of ``--mutation-batch`` edges (``--churn``
inserts, the rest deletes; ``data/graphs.py::edge_stream``), and each
round serves fresh queries cold and keeps a ``--standing`` query set
fresh, warm-started when the window was insert-only
(:func:`serve_mutating`).  With ``--continuous`` the stream is served in
waves with a mutation batch between them (``serve_continuous(
mutation_stream=)``), ``--depth-buckets`` composing as the scheduler.

``--chaos`` runs the fault drill (:func:`run_chaos_drill`): a clean
mutating session, then the same session with injected crashes, recovered
by :func:`serve_fault_tolerant` (checkpoints, the replayed mutation log,
the degradation ladder, the quarantine); it prints ``CHAOS OK``.
``--corrupt`` runs the silent-corruption drill (:func:`run_corrupt_drill`)
on the reference, fused and hybrid backends and prints ``CORRUPT OK``.
On a card the ladder's fallback is the other kernel backend on the same
device (hybrid for fused, fused for hybrid); on the CPU it is the
reference backend, as in the JAX package.

Port of ``repro.launch.graph_serve``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np


def _percentile(vals, p: float) -> float:
    if not len(vals):
        return float("nan")
    return float(np.percentile(vals, p, method="nearest"))


@dataclasses.dataclass
class ServeConfig:
    """The validated serving-mode surface.  :meth:`validate` makes every
    incompatible pair an actionable error and names the spelling that
    does compose (usually ``--continuous``, whose :class:`ServeSession`
    takes the other knobs as options)."""
    alg: str = "bfs"
    batch: int = 32
    mutate: bool = False
    chaos: bool = False
    corrupt: bool = False
    continuous: bool = False
    depth_buckets: int = 0
    deadline_ms: Optional[float] = None
    queue_capacity: Optional[int] = None
    chunk: int = 2

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        return cls(alg=args.alg, batch=args.batch, mutate=args.mutate,
                   chaos=args.chaos, corrupt=args.corrupt,
                   continuous=args.continuous,
                   depth_buckets=args.depth_buckets,
                   deadline_ms=args.deadline_ms,
                   queue_capacity=args.queue_capacity,
                   chunk=args.checkpoint_every).validate()

    def validate(self) -> "ServeConfig":
        def bad(combo: str, why: str, instead: str):
            raise ValueError(f"incompatible serving flags: {combo} — {why}. "
                             f"{instead}")

        if self.chaos:
            for name, on in (("--mutate", self.mutate),
                             ("--continuous", self.continuous),
                             ("--depth-buckets", bool(self.depth_buckets)),
                             ("--deadline-ms", self.deadline_ms is not None),
                             ("--queue-capacity",
                              self.queue_capacity is not None)):
                if on:
                    bad(f"--chaos + {name}",
                        "the chaos drill is a self-contained mutating "
                        "session with its own injection schedule",
                        "Run --chaos alone; fault tolerance for continuous "
                        "sessions is serve_with_restarts (see "
                        "tests/test_continuous.py).")
        if self.corrupt:
            if self.chaos:
                bad("--chaos + --corrupt",
                    "the drills have disjoint injection schedules (worker "
                    "faults vs silent bit-flips)",
                    "Run them as two invocations — CI does.")
            for name, on in (("--mutate", self.mutate),
                             ("--continuous", self.continuous),
                             ("--depth-buckets", bool(self.depth_buckets)),
                             ("--deadline-ms", self.deadline_ms is not None),
                             ("--queue-capacity",
                              self.queue_capacity is not None)):
                if on:
                    bad(f"--corrupt + {name}",
                        "the corruption drill runs its own sessions across "
                        "all three backends with a fixed injection schedule",
                        "Run --corrupt alone; certification in production "
                        "sessions is ServeSession(certifier=..., "
                        "monitor=...) — see docs/robustness.md.")
            if self.alg not in ("bfs", "sssp"):
                raise ValueError(
                    f"--corrupt drills the continuous-session certification "
                    f"path, which serves step-translatable programs only "
                    f"(bfs, sssp), not {self.alg!r}.")
        if self.continuous and self.alg not in ("bfs", "sssp"):
            raise ValueError(
                f"--continuous serves step-translatable programs only "
                f"(bfs, sssp), not {self.alg!r}: slot refill re-seeds a "
                f"query mid-loop in the global step frame "
                f"(algorithms/continuous.py).  Drop --continuous to "
                f"drain-batch {self.alg!r}.")
        if not self.continuous:
            if self.mutate:
                for name, on in (("--depth-buckets",
                                  bool(self.depth_buckets)),
                                 ("--deadline-ms",
                                  self.deadline_ms is not None),
                                 ("--queue-capacity",
                                  self.queue_capacity is not None)):
                    if on:
                        bad(f"--mutate + {name}",
                            "the drain-batch mutating driver has no "
                            "admission queue or scheduler",
                            "Add --continuous: ServeSession composes "
                            "mutations with deadlines, admission and the "
                            "depth scheduler in one resident engine.")
            elif self.depth_buckets:
                for name, on in (("--deadline-ms",
                                  self.deadline_ms is not None),
                                 ("--queue-capacity",
                                  self.queue_capacity is not None)):
                    if on:
                        bad(f"--depth-buckets + {name}",
                            "the bucketed A/B driver re-runs the stream "
                            "twice and reports buckets, not SLA",
                            "Add --continuous to schedule depth-first "
                            "under a deadline, or drop --depth-buckets.")
        return self

    @property
    def mode(self) -> str:
        if self.chaos:
            return "chaos"
        if self.corrupt:
            return "corrupt"
        if self.continuous:
            return "continuous"
        if self.mutate:
            return "mutate"
        if self.depth_buckets:
            return "depth"
        return "drain"


def query_batch(engine, alg: str, sources: np.ndarray):
    """Dispatch one batch of queries: ``(results [Q, n], steps [Q])``,
    steps None for PPR (a fixed round count)."""
    from repro_torch.algorithms import (betweenness_centrality_batched,
                                        bfs_batched, personalized_pagerank,
                                        sssp_batched)

    if alg == "bfs":
        return bfs_batched(engine, sources)
    if alg == "sssp":
        return sssp_batched(engine, sources)
    if alg == "bc":
        return betweenness_centrality_batched(engine, sources)
    if alg == "ppr":
        return personalized_pagerank(engine, sources, num_iterations=10), None
    raise ValueError(f"unknown algorithm {alg!r}")


def run_query_batch(engine, alg: str, sources: np.ndarray) -> np.ndarray:
    """Dispatch one batch of queries; returns the [Q, n] result block."""
    return query_batch(engine, alg, sources)[0]


def serve(engine, alg: str, sources: np.ndarray, batch: int,
          check_fn=None, deadline_ms=None, queue_capacity=None) -> dict:
    """Drain ``sources`` in batches of ``batch``; returns the metrics dict.

    ``check_fn(sources, results)`` optionally validates a batch.  The query
    stream is padded to a whole number of batches with repeats of its head
    so every batch has the same Q.

    ``queue_capacity`` bounds admission: sources beyond it are rejected
    with a reason (``report["admission"]``) instead of growing tail
    latency.  ``deadline_ms`` is a per-query SLA: a query's latency is its
    queue wait plus its batch's wall time (batch-synchronous serving);
    queries over deadline are counted in ``report["sla"]``.
    """
    from repro_torch.runtime import AdmissionController

    admission = None
    if queue_capacity is not None:
        ctl = AdmissionController(queue_capacity)
        for s in np.asarray(sources).reshape(-1):
            ctl.offer(int(s), deadline_ms)
        sources = np.asarray(ctl.take(len(ctl)))
        admission = dict(capacity=queue_capacity, admitted=ctl.admitted,
                         rejected=len(ctl.rejected),
                         reject_reasons=sorted(
                             {r["reason"] for r in ctl.rejected}))
    num = len(sources)
    pad = (-num) % batch
    # np.resize repeats the stream cyclically, so padding works even when
    # pad > num (a stream shorter than one batch).
    stream = np.resize(sources, num + pad)
    batches = stream.reshape(-1, batch)

    entries0 = None
    lat_ms, cold_ms = [], None
    batch_done_ms = []                  # cumulative wall at batch completion
    served = 0
    t_all = time.perf_counter()
    for i, srcs in enumerate(batches):
        t0 = time.perf_counter()
        out = run_query_batch(engine, alg, srcs)
        dt = (time.perf_counter() - t0) * 1e3
        batch_done_ms.append((time.perf_counter() - t_all) * 1e3)
        if i == 0:
            cold_ms = dt               # includes the first run's builds
            entries0 = engine.cache_entries()
        else:
            lat_ms.append(dt)
        served += batch
        if check_fn is not None:
            check_fn(srcs, out)
    wall_s = time.perf_counter() - t_all
    retraces = engine.cache_entries() - entries0

    warm_s = sum(lat_ms) / 1e3
    warm_queries = max(served - batch, 0)
    report = dict(
        algorithm=alg, batch=batch, num_queries=num,
        batches=len(batches), cold_ms=cold_ms,
        queries_per_sec=(warm_queries / warm_s) if warm_s > 0 else None,
        ms_per_query=(warm_s * 1e3 / warm_queries) if warm_queries else None,
        batch_p50_ms=_percentile(lat_ms, 50),
        batch_p90_ms=_percentile(lat_ms, 90),
        batch_p99_ms=_percentile(lat_ms, 99),
        wall_s=wall_s,
        # structures built after the first batch: 0 == nothing rebuilt
        retraces=retraces,
        backend=getattr(engine, "backend", None),
        engine=type(engine).__name__,
    )
    if admission is not None:
        report["admission"] = admission
    if deadline_ms is not None:
        # query i rides batch i // batch; its latency is that batch's
        # completion time (queue wait included)
        lat_q = np.asarray(batch_done_ms)[
            np.arange(num) // batch] if num else np.zeros(0)
        misses = int((lat_q > deadline_ms).sum())
        report["sla"] = dict(deadline_ms=deadline_ms, misses=misses,
                             met=num - misses)
    return report


def build_engine(args, dynamic: bool = False):
    """``(graph, partitioned graph, engine)`` from the CLI arguments;
    with ``dynamic`` a ``DynamicGraph`` (mutation capacity
    ``--mutation-batch``) in place of the partitioned graph, its payload
    in host memory under ``--hbm-budget``."""
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.device import resolve_device

    gen = G.rmat if args.graph == "rmat" else G.uniform
    g = gen(args.scale, args.edge_factor, seed=args.seed)
    if args.alg == "sssp":
        g = g.with_uniform_weights(seed=args.seed + 1)
    kw = dict(backend=args.backend, block_e=args.block_e)
    if args.hbm_budget is not None:
        kw["tiered"] = args.hbm_budget
        kw["win_blocks"] = args.win_blocks
    if dynamic:
        # a tiered engine streams the cold overlay from host memory
        host = args.hbm_budget is not None
        on_card = resolve_device(args.device).type == "cuda"
        dg = DynamicGraph(g, args.parts, args.strategy,
                          include_reverse=(args.alg == "bc"),
                          mutation_capacity=args.mutation_batch,
                          device="cpu" if host else args.device,
                          pin=host and on_card)
        return g, dg, BSPEngine(dg, device=args.device, **kw)
    pg = PT.partition(g, args.parts, args.strategy,
                      include_reverse=(args.alg == "bc"))
    return g, pg, BSPEngine(pg, device=args.device, **kw)


def estimate_depth_order(g, sources: np.ndarray) -> np.ndarray:
    """Order ``sources`` by estimated traversal depth, shallow first.

    A batch runs ``max_q(steps_q)`` supersteps, so one deep query taxes
    every shallow query sharing its batch.  The proxy: BFS from a hub
    reaches the massive component in few levels, BFS from a fringe vertex
    walks long chains first — out-degree (cheap, already resident) orders
    hubs before fringe.  Returns indices into ``sources``.
    """
    deg = g.out_degrees()[np.asarray(sources)]
    return np.argsort(-deg, kind="stable")


def serve_depth_bucketed(engine, g, alg: str, sources: np.ndarray,
                         batch: int, num_buckets: int = 4) -> dict:
    """Depth-bucketing scheduler: drain the stream in estimated-depth order
    so shallow queries never ride a deep query's superstep count.

    Runs the same stream twice — arrival order (baseline: batches mix
    depths) and depth-bucketed — and reports per-bucket p50/p99 per-query
    latency for both (a query's latency is its batch's wall time).
    """
    order = estimate_depth_order(g, sources)
    num = len(sources)
    num_buckets = max(1, min(num_buckets, num))  # every bucket non-empty
    bucket_of = np.empty(num, dtype=np.int64)   # by stream position
    for b in range(num_buckets):
        lo = b * num // num_buckets
        hi = (b + 1) * num // num_buckets
        bucket_of[order[lo:hi]] = b

    run_query_batch(engine, alg, np.asarray(sources[:batch]))  # warm

    def drain(stream_idx):
        lat = np.empty(num, dtype=np.float64)
        for i in range(0, num, batch):
            idx = stream_idx[i: i + batch]
            srcs = np.asarray(sources)[idx]
            if len(srcs) < batch:                 # pad the tail batch
                srcs = np.resize(srcs, batch)
            t0 = time.perf_counter()
            run_query_batch(engine, alg, srcs)
            lat[idx] = (time.perf_counter() - t0) * 1e3
        return lat

    lat_base = drain(np.arange(num))              # arrival order (mixed)
    lat_buck = drain(order)                       # depth-homogeneous batches
    buckets = []
    for b in range(num_buckets):
        m = bucket_of == b
        buckets.append(dict(
            bucket=b, queries=int(m.sum()),
            min_degree=int(g.out_degrees()[sources[m]].min()),
            baseline_p50_ms=_percentile(lat_base[m], 50),
            baseline_p99_ms=_percentile(lat_base[m], 99),
            bucketed_p50_ms=_percentile(lat_buck[m], 50),
            bucketed_p99_ms=_percentile(lat_buck[m], 99)))
    return dict(num_buckets=num_buckets, batch=batch,
                baseline_p99_ms=_percentile(lat_base, 99),
                bucketed_p99_ms=_percentile(lat_buck, 99),
                buckets=buckets)


def refresh_standing(engine, dg, alg: str, sources, prev, mark) -> dict:
    """Refresh a standing query set after mutations: warm-start when the
    window allows (a program with an incremental form, insert-only
    batches), cold otherwise.  Runs the cold path too, so the report can
    state the superstep savings.  Returns the new results and metrics."""
    from repro_torch.algorithms import (bfs_batched, bfs_incremental,
                                        sssp_batched, sssp_incremental)

    dirty, monotone = dg.dirty_since(mark)
    incremental = {"bfs": (bfs_incremental, bfs_batched),
                   "sssp": (sssp_incremental, sssp_batched)}.get(alg)
    cold_fn = (incremental[1] if incremental
               else (lambda e, s: (run_query_batch(e, alg, s), None)))
    t0 = time.perf_counter()
    cold_out = cold_fn(engine, sources)
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold_res, cold_steps = cold_out
    rec = dict(mode="cold", cold_ms=cold_ms,
               cold_steps=(None if cold_steps is None
                           else [int(s) for s in cold_steps]))
    result = cold_res
    if incremental is not None and monotone:
        t0 = time.perf_counter()
        warm_res, warm_steps = incremental[0](engine, prev, dirty)
        rec.update(mode="incremental", warm_ms=(time.perf_counter() - t0)
                   * 1e3, warm_steps=[int(s) for s in warm_steps],
                   bitwise_equal=bool(np.array_equal(warm_res, cold_res)))
        result = warm_res
    return dict(rec, result=result)


def serve_mutating(engine, dg, alg: str, *, batches, batch: int,
                   standing: int, query_batches_per_round: int,
                   seed: int = 1, compact: bool = True,
                   skew_drift_threshold: float = 0.5,
                   resplit_threshold: float = 0.10) -> dict:
    """Interleave mutation batches with query batches against the resident
    graph: the evolving-graph serving regime end to end.

    Per round: one mutation batch is applied in place (edges/s), fresh
    random queries are served cold, and a *standing* query set is kept
    fresh (warm-started from its previous fixpoint when the window is
    monotone, cold otherwise) under the zero-rebuild contract: the
    engine's ``cache_entries()`` must not grow after warm-up except at a
    compaction rebind, a hybrid split rebuild, or the warm path's first
    run at a graph version (its relaxation program's first structures).
    Compactions trigger on the staleness signals (degree-skew drift at
    ``skew_drift_threshold`` included) or, on the hybrid backend, on
    ``engine.should_resplit_hybrid``.
    """
    rng = np.random.default_rng(seed)
    n = dg.pg.num_vertices
    standing_sources = rng.integers(0, n, size=standing)

    # warm-up: the cold path's first-run builds before timing
    prev = run_query_batch(engine, alg, standing_sources)
    mark = dg.mark()

    rounds, lat_ms = [], []
    mut_edges = mut_s = 0.0
    compact_ms = 0.0
    resplits = 0
    warm_steps_all, cold_steps_all = [], []
    retraces = 0
    entries_prev = rebinds_prev = rebuilds_prev = None
    warm_versions = set()     # graph versions whose warm path has run
    t_all = time.perf_counter()
    for i, mb in enumerate(batches):
        rep = dg.apply_mutations(mb)
        mut_edges += rep["num_edges"]
        mut_s += rep["apply_ms"] / 1e3
        if rep["compacted"]:
            # capacity-overflow compaction inside apply_mutations —
            # --no-compact only disables the threshold-driven kind
            compact_ms += dg.last_compaction_ms
        if compact and dg.should_compact(
                max_skew_drift=skew_drift_threshold):
            compact_ms += dg.compact()
        elif compact and engine.should_resplit_hybrid(resplit_threshold):
            # re-ranking the degree split rides a compaction: the rebind
            # re-plans the split on the mutated graph
            compact_ms += dg.compact()
            resplits += 1
        for _ in range(query_batches_per_round):
            srcs = rng.integers(0, n, size=batch)
            t0 = time.perf_counter()
            run_query_batch(engine, alg, srcs)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
        ref = refresh_standing(engine, dg, alg, standing_sources, prev, mark)
        prev = ref.pop("result")
        mark = dg.mark()
        if ref.get("warm_steps"):
            warm_steps_all.append(max(ref["warm_steps"]))
        if ref.get("cold_steps"):
            cold_steps_all.append(max(ref["cold_steps"]))
        rounds.append(dict(round=i, mutation=dict(
            (k, v) for k, v in rep.items() if k != "dirty"), refresh=ref))
        # Per round: growth counts as a rebuild unless something
        # legitimately new was built this round (a compaction rebind, a
        # split rebuild, the warm path's first run at this version)
        legit = (engine.dynamic_rebinds != rebinds_prev
                 or engine.hybrid_dyn_rebuilds != rebuilds_prev)
        if (ref.get("mode") == "incremental"
                and dg.version not in warm_versions):
            warm_versions.add(dg.version)
            legit = True
        if entries_prev is not None and not legit:
            retraces += engine.cache_entries() - entries_prev
        entries_prev = engine.cache_entries()
        rebinds_prev = engine.dynamic_rebinds
        rebuilds_prev = engine.hybrid_dyn_rebuilds
    wall_s = time.perf_counter() - t_all

    return dict(
        algorithm=alg, batch=batch, rounds=len(rounds),
        standing=standing,
        mutation_edges_per_sec=(mut_edges / mut_s) if mut_s else None,
        mutation_edges=int(mut_edges),
        incremental_steps=(int(np.mean(warm_steps_all))
                           if warm_steps_all else None),
        cold_steps=(int(np.mean(cold_steps_all))
                    if cold_steps_all else None),
        batch_p50_ms=_percentile(lat_ms, 50),
        batch_p99_ms=_percentile(lat_ms, 99),
        compactions=dg.compactions, compaction_pause_ms=compact_ms,
        resplits=resplits,
        dynamic_rebinds=engine.dynamic_rebinds,
        hybrid_rebuilds=engine.hybrid_dyn_rebuilds,
        retraces=retraces,
        wall_s=wall_s, per_round=rounds,
        staleness=dg.staleness())


# ---------------------------------------------------------------------------
# fault-tolerant serving and the drills
# ---------------------------------------------------------------------------

def _require(ok: bool, what: str) -> None:
    """A drill's check: raises (not an ``assert``, which ``-O`` drops)."""
    if not ok:
        raise AssertionError(what)




def _fallback_backend(backend: str, device) -> Optional[str]:
    """The degradation ladder's fallback rung for a ``backend`` primary, or
    None when the primary is the reference backend itself.  On a card it
    is the other kernel backend on the same device (hybrid for fused,
    fused for hybrid: a failed rung is never served by plain PyTorch on
    the card); elsewhere the reference backend, as in the JAX package."""
    import torch

    if backend == "reference":
        return None
    if torch.device(device).type == "cuda":
        return "hybrid" if backend == "fused" else "fused"
    return "reference"


def chunked_refresh(engine, alg: str, sources, *, chunk: int,
                    on_chunk=None, round_i: int = 0):
    """Refresh a standing query set through the chunked run mode (the
    checkpointable one).  Returns ``([Q, n] results, steps [Q], info)``.
    The ``query.poison`` site poisons query 0's initial state (NaN)."""
    import torch

    from repro_torch.algorithms.bfs import (BFS_PROGRAM, gather_batch,
                                            multi_source_state)
    from repro_torch.algorithms.sssp import SSSP_PROGRAM
    from repro_torch.runtime import chaos

    pg = engine.pg
    d0 = multi_source_state(pg, sources, device=engine.device)
    if alg == "bfs":
        program, key = BFS_PROGRAM, "level"
        state = {"level": d0}
    elif alg == "sssp":
        program, key = SSSP_PROGRAM, "dist"
        state = {"dist": d0, "active": torch.isfinite(d0)}
    else:
        raise ValueError(f"chunked refresh supports bfs/sssp, not {alg!r}")
    if chaos.visit("query.poison", round=round_i):
        # data-level fault drill: corrupt query 0's initial state; the
        # quarantine scan must catch it at the first chunk boundary
        state[key] = state[key].clone()
        state[key][0] = float("nan")
    state, steps_q, info = engine.execute(
        program, state, chunk=chunk, on_chunk=on_chunk,
        chaos_ctx={"round": round_i})
    return gather_batch(pg, state[key]), steps_q.cpu().numpy(), info


def serve_fault_tolerant(args, manager, *, midrun_manager=None,
                         hard_limit_s=None, g=None):
    """Mutating serving session that survives injected (or real) faults.

    Per round: apply one mutation batch (acknowledged only after its
    device writes complete), serve a fresh query batch through the
    degradation ladder (primary backend -> retry -> :func:`_fallback_backend`),
    refresh the standing set through the chunked run mode with the
    quarantine scan and the superstep watchdog at every chunk boundary,
    then snapshot ``{standing results, dynamic payload}`` and ``{round,
    acked cursor}`` through ``save_tree``.

    Recovery (a retryable fault anywhere in the round): backoff, rebuild
    the graph from base, **replay the acknowledged mutation log**, restore
    the latest round snapshot, and check that the replayed device payload
    equals the snapshot's bit for bit: a crash between compactions loses
    no acknowledged mutation.  The watchdog's ``hard_limit_s`` triggers
    checkpoint-now: the chunk carry in flight is saved to
    ``midrun_manager`` without waiting for the round boundary.  ``g`` is
    the base graph when the caller has it (else made from ``args``).

    Returns ``(report, standing results [Q, n], quarantined query ids)``.
    The report adds to the JAX package's keys the fallback backend, each
    recovery's seconds (``recovery_s``), the recoveries whose replayed
    payload was checked against the snapshot (``replay_checked``), and the
    round snapshots' bytes on disk and save times (``snapshot_bytes``,
    ``snapshot_ms``).
    """
    import torch

    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.core import graph as G
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.core.graph import apply_mutation_batches
    from repro_torch.data.graphs import edge_stream
    from repro_torch.runtime import (RETRYABLE_EXCEPTIONS, DegradationLadder,
                                     QuarantinePolicy, RestartPolicy,
                                     StepWatchdog, chaos)

    if g is None:
        gen = G.rmat if args.graph == "rmat" else G.uniform
        g = gen(args.scale, args.edge_factor, seed=args.seed)
        if args.alg == "sssp":
            g = g.with_uniform_weights(seed=args.seed + 1)
    kw = dict(backend=args.backend, block_e=args.block_e)
    fb_backend = _fallback_backend(args.backend, args.device)

    rounds = args.mutation_rounds
    stream = edge_stream(g, rounds, args.mutation_batch, churn=args.churn,
                         seed=args.seed)
    rng = np.random.default_rng(args.seed)
    standing = rng.integers(0, g.num_vertices, size=(args.standing, 1))

    def build_session():
        dg = DynamicGraph(g, args.parts, args.strategy,
                          mutation_capacity=args.mutation_batch,
                          device=args.device)
        primary = BSPEngine(dg, device=args.device, **kw)
        fallback = (BSPEngine(dg, device=args.device,
                              backend=fb_backend, block_e=args.block_e)
                    if fb_backend is not None else primary)
        return dg, primary, fallback

    policy = RestartPolicy(max_failures=args.max_restarts,
                           backoff_s=args.restart_backoff_s)
    quar = QuarantinePolicy(superstep_budget=args.superstep_budget)
    ladder = DegradationLadder(retries=1)
    wd = StepWatchdog(warmup_steps=2, hard_limit_s=hard_limit_s)
    midrun_snapshots = 0
    n = g.num_vertices

    def cache_entries():
        return engine.cache_entries() + (
            fb_engine.cache_entries() if fb_engine is not engine else 0)

    dg, engine, fb_engine = build_session()
    # warm both rungs of the ladder, so a downgrade builds nothing
    warm = rng.integers(0, n, size=args.batch)
    run_query_batch(engine, args.alg, warm)
    if fb_engine is not engine:
        run_query_batch(fb_engine, args.alg, warm)

    acked = 0                 # durable cursor: stream[:acked] acknowledged
    round_i = 0
    prev = None
    snapshots = replay_checked = 0
    snapshot_bytes, snapshot_ms, recovery_s = [], [], []
    # Rebuilds after warm-up, per engine life: eager PyTorch compiles
    # nothing, so this counts what the engines build (cache_entries); a
    # restart's new engines are warmed, and their baseline is taken after
    # their first round.
    retraces = 0
    entries0 = None

    def recover():
        nonlocal dg, engine, fb_engine, round_i, prev, retraces, entries0
        nonlocal replay_checked
        t0 = time.perf_counter()
        if entries0 is not None:
            retraces += cache_entries() - entries0
            entries0 = None
        del dg, engine, fb_engine
        dg, engine, fb_engine = build_session()
        if acked:
            dg.replay(stream[:acked])   # the durable log is the truth
        latest = manager.latest_step()
        if latest is None:
            round_i, prev = 0, None
        else:
            dyn_tree, dyn_extra = dg.snapshot()
            like = {"standing": np.zeros((args.standing, n), np.float32),
                    "dyn": dyn_tree}
            _, tree = manager.restore_tree(like, latest)
            extra = manager.manifest_extra(latest)
            round_i = int(extra["round"])
            prev = tree["standing"]
            if (int(extra["cursor"]) == dyn_extra["cursor"]
                    and int(extra["version"]) == dyn_extra["version"]):
                # no mutation lost: rebuilding from base and replaying the
                # acknowledged log gives the snapshot's payload bit for bit
                live = _flatten(dyn_tree)
                for name, a in _flatten(tree["dyn"]).items():
                    if not torch.equal(a, live[name]):
                        raise RuntimeError(
                            f"replayed payload leaf {name!r} differs from "
                            f"the snapshot — a mutation was lost or "
                            f"double-applied")
                replay_checked += 1
        recovery_s.append(time.perf_counter() - t0)

    while round_i < rounds:
        try:
            chaos.visit("serve.round", round=round_i)
            if round_i >= acked:
                dg.apply_mutations(stream[round_i])
                acked = round_i + 1
            # fresh queries ride the degradation ladder
            srcs = np.random.default_rng(
                args.seed + 100 + round_i).integers(0, n, size=args.batch)
            r = round_i

            def primary():
                chaos.visit("kernel.dispatch", round=r,
                            backend=args.backend)
                return run_query_batch(engine, args.alg, srcs)

            ladder.run(primary,
                       lambda: run_query_batch(fb_engine, args.alg, srcs),
                       label=f"round{r}:{args.alg}")

            # standing refresh through the checkpointable chunked mode
            quar.begin(args.standing)
            t_chunk = [time.perf_counter()]

            def on_chunk(snap):
                nonlocal midrun_snapshots
                now = time.perf_counter()
                flagged = wd.report(snap["step"], now - t_chunk[0])
                t_chunk[0] = now
                if flagged and midrun_manager is not None:
                    # checkpoint-now: persist the chunk carry in flight
                    midrun_manager.save_tree(
                        snap["step"],
                        {"state": snap["state"], "fin": snap["fin"],
                         "steps_q": snap["steps_q"]},
                        extra={"round": r, "step": snap["step"],
                               "mid_run": True}, blocking=True)
                    midrun_snapshots += 1
                return quar.scan(snap)

            prev, steps_q, info = chunked_refresh(
                engine, args.alg, standing, chunk=args.checkpoint_every,
                on_chunk=on_chunk, round_i=round_i)

            dyn_tree, dyn_extra = dg.snapshot()
            t0 = time.perf_counter()
            path = manager.save_tree(
                round_i + 1,
                {"standing": np.asarray(prev), "dyn": dyn_tree},
                extra=dict(round=round_i + 1, acked=acked, **dyn_extra),
                blocking=True)
            snapshot_ms.append((time.perf_counter() - t0) * 1e3)
            snapshot_bytes.append(path.stat().st_size)
            snapshots += 1
            round_i += 1
            if entries0 is None:
                entries0 = cache_entries()
        except RETRYABLE_EXCEPTIONS as e:
            # only the restart whitelist (worker faults, the runtime errors
            # of RETRYABLE_EXCEPTIONS, exchange corruption) burns the retry
            # budget; anything else propagates, as RestartPolicy.handle's
            # own contract says, and so does a failed CUDA kernel
            sleep_s = policy.handle(e, context=dict(round=round_i))
            if sleep_s:
                time.sleep(sleep_s)
            recover()

    # ledger-vs-oracle audit: the served graph equals a from-scratch apply
    # of every acknowledged batch
    mut = dg.mutated_csr()
    oracle = apply_mutation_batches(g, stream[:acked])
    if not (np.array_equal(mut.row_ptr, oracle.row_ptr)
            and np.array_equal(mut.col, oracle.col)):
        raise RuntimeError("mutated CSR diverged from the mutation-log "
                           "oracle — acknowledged mutations were lost")

    if entries0 is not None:
        retraces += cache_entries() - entries0
    report = dict(
        rounds=rounds, acked=acked, snapshots=snapshots,
        midrun_snapshots=midrun_snapshots,
        failures=policy.failures, restarts=policy.restarts,
        downgrades=ladder.downgrades, quarantined=quar.quarantined,
        stragglers=len(wd.stragglers), retraces=retraces,
        backend=args.backend, fallback=fb_backend, algorithm=args.alg,
        recovery_s=recovery_s, replay_checked=replay_checked,
        snapshot_bytes=snapshot_bytes, snapshot_ms=snapshot_ms)
    quarantined_ids = {rec["query"] for rec in quar.quarantined}
    return report, np.asarray(prev), quarantined_ids


def run_chaos_drill(args, g=None) -> dict:
    """``--chaos``: a clean session against a fault-injected one, with
    recovery and parity checks.

    Injected faults: a crash between mutation batches (``serve.round``), a
    shard/worker death mid-refresh (``superstep.chunk``), a crash
    mid-mutation-batch before the device writes (``mutation.scatter``), a
    kernel-dispatch fault that exhausts its retry (``kernel.dispatch`` x2
    -> the fallback rung), and a poisoned query (``query.poison`` -> NaN
    state, quarantined every round).  Checks: the session recovers within
    the restart budget, the mutation log replays with no lost mutation,
    the standing results not quarantined equal the clean run's bit for
    bit, rebuilds stay within the restarts, and the clean path
    quarantines nothing.  Raises on a failed check; returns ``{"clean",
    "faulty"}`` reports, each with its wall seconds.
    """
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.runtime import FaultInjector, chaos

    rounds = args.mutation_rounds
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        clean_rep, clean_res, clean_quar = serve_fault_tolerant(
            args, CheckpointManager(td + "/clean", keep=3), g=g)
        clean_rep["wall_s"] = time.perf_counter() - t0
        print(f"clean session: rounds={clean_rep['rounds']} "
              f"snapshots={clean_rep['snapshots']} "
              f"retraces={clean_rep['retraces']} "
              f"quarantined={len(clean_rep['quarantined'])} "
              f"({clean_rep['wall_s']:.1f} s)", flush=True)
        _require(clean_rep["failures"] == 0 and not clean_quar,
                 f"the clean session failed or quarantined: "
                 f"{clean_rep['failures']} failures, {sorted(clean_quar)}")
        _require(clean_rep["retraces"] == 0,
                 f"clean path rebuilt: {clean_rep['retraces']}")

        inj = FaultInjector(sites={
            "serve.round": [{"round": min(1, rounds - 1)}],
            "superstep.chunk": [{"round": min(1, rounds - 1), "chunk": 1}],
            "mutation.scatter": [{"index": min(2, rounds - 1)}],
            "kernel.dispatch": [{"round": min(2, rounds - 1)},
                                {"round": min(2, rounds - 1)}],
            "query.poison": [{"round": r, "flag": True}
                             for r in range(rounds)],
        })
        with chaos.active(inj):
            t0 = time.perf_counter()
            faulty_rep, faulty_res, faulty_quar = serve_fault_tolerant(
                args, CheckpointManager(td + "/faulty", keep=3),
                midrun_manager=CheckpointManager(td + "/midrun", keep=3),
                hard_limit_s=0.0, g=g)
            faulty_rep["wall_s"] = time.perf_counter() - t0

    print(f"faulty session: failures={faulty_rep['failures']} "
          f"restarts={[r.get('round') for r in faulty_rep['restarts']]} "
          f"downgrades={len(faulty_rep['downgrades'])} "
          f"(fallback {faulty_rep['fallback']}) "
          f"quarantined={sorted(faulty_quar)} "
          f"midrun_snapshots={faulty_rep['midrun_snapshots']} "
          f"retraces={faulty_rep['retraces']} "
          f"({faulty_rep['wall_s']:.1f} s; recoveries "
          f"{[round(t, 2) for t in faulty_rep['recovery_s']]} s)",
          flush=True)

    _require(faulty_rep["failures"] >= 3,
             "expected >=3 injected worker faults to fire")
    _require(faulty_rep["acked"] == rounds, "mutation log not fully replayed")
    _require(len(faulty_rep["downgrades"]) == 1,
             "kernel fault did not fall back to the fallback backend")
    _require(faulty_quar == {0},
             f"poisoned query 0 not quarantined: {faulty_quar}")
    _require(any(rec["reason"] == "nonfinite"
                 for rec in faulty_rep["quarantined"]),
             "the poisoned query was not quarantined as nonfinite")
    _require(faulty_rep["midrun_snapshots"] > 0,
             "watchdog checkpoint-now never fired")
    _require(faulty_rep["retraces"] <= faulty_rep["failures"],
             f"retraces ({faulty_rep['retraces']}) exceed restarts "
             f"({faulty_rep['failures']})")

    ok = np.ones(len(clean_res), bool)
    for q in faulty_quar | clean_quar:
        ok[q] = False
    _require(np.array_equal(clean_res[ok], faulty_res[ok]),
             "recovered results diverge from the uninjected run")
    print(f"chaos parity: {int(ok.sum())}/{len(ok)} standing queries "
          f"bitwise identical to the uninjected run "
          f"(quarantined: {sorted(faulty_quar)})", flush=True)
    return dict(clean=clean_rep, faulty=faulty_rep,
                parity=int(ok.sum()), quarantined=sorted(faulty_quar))


def run_corrupt_drill(args, engines=None, dynamic=None) -> dict:
    """``--corrupt``: the silent-corruption drill.

    Worker faults raise; silent faults don't.  This drill flips bits at
    every data-corruption site and checks that the integrity layer turns
    each into a *detection* (checksum mismatch, monitor fire, or certifier
    rejection with a recompute) or a *mask* (the harvested result is the
    clean run's bit for bit anyway).  Per backend (reference, fused,
    hybrid):

    - clean pass: a certified ``ServeSession`` and a certified chunked
      refresh give **zero** false positives;
    - ``state.corrupt``: a bit-flipped state at a window boundary is caught
      by the invariant monitor and/or the harvest certifier, and the
      recompute-once policy restores the right answer;
    - ``exchange.payload``: a corrupted wire element mismatches its
      inbox-side tag -> ``ExchangeCorruption`` -> a clean replay of the
      window gives the uncorrupted result bit for bit (the single-device
      hybrid has no wire exchange, so the site is inert there and the
      result must stay clean).

    Backend-independent sites, drilled once: ``checkpoint.torn`` (a torn
    tensor fails its manifest CRC at restore; the previous snapshot still
    loads) and ``tombstone.flip`` (a resurrected deleted edge on the
    dynamic path gives a fixpoint the certifier rejects against the true
    mutated graph).

    ``engines`` maps each backend to a prebuilt ``(graph, engine)`` and
    ``dynamic`` is a prebuilt ``(graph, DynamicGraph, engine)`` for BFS
    on a backend that visits ``tombstone.flip`` (reference or fused); each
    is built from ``args`` when None (a reference engine, as in JAX).
    Raises on a failed check; returns ``{"detections", "masked",
    "walls"}`` (seconds per part).
    """
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import CheckpointCorruption
    from repro_torch.runtime import (ExchangeCorruption, FaultInjector,
                                     QuarantinePolicy, ResultCertifier,
                                     ServeSession, chaos, monitor_for)

    rng = np.random.default_rng(args.seed)
    detections = 0
    masked = 0
    walls = {}

    def flag(site, **ctx):
        return FaultInjector(sites={site: [dict(ctx, flag=True)]})

    for backend in ("reference", "fused", "hybrid"):
        t_backend = time.perf_counter()
        if engines is None:
            a = argparse.Namespace(**vars(args))
            a.backend = backend
            g, _, engine = build_engine(a)
        else:
            g, engine = engines[backend]
        sources = rng.integers(0, g.num_vertices, size=args.num_queries)
        certifier = ResultCertifier(args.alg, g)

        def run_session():
            # all three detection layers armed: in-loop monitors, the
            # non-finite/budget quarantine, and harvest certification
            s = ServeSession(engine, args.alg, slots=args.batch,
                             chunk=args.checkpoint_every,
                             quarantine=QuarantinePolicy(
                                 superstep_budget=args.superstep_budget),
                             certifier=ResultCertifier(args.alg, g),
                             monitor=monitor_for(args.alg,
                                                 chunk=args.checkpoint_every))
            s.submit(sources)
            s.drain()
            rep = s.report()
            res = {r["query"]: r["result"] for r in s.poll()}
            return res, rep, set(s.quarantined_qids)

        # -- clean pass: zero false positives -----------------------------
        clean, rep, cq = run_session()
        _require(rep["recomputed"] == 0 and not rep["certify_failed"],
                 f"[{backend}] clean session raised certifier false "
                 f"positives: {rep['certify_failed']}")
        _require(rep["monitors_fired"] == 0 and not cq,
                 f"[{backend}] clean session fired {rep['monitors_fired']} "
                 f"invariant monitors, quarantined {sorted(cq)}")
        std = sources[:args.batch]
        clean_chunk, _, _ = chunked_refresh(
            engine, args.alg, std, chunk=args.checkpoint_every)
        verdicts = certifier.certify_batch(clean_chunk, sources=std)
        _require(all(v.ok for v in verdicts),
                 f"[{backend}] clean chunked fixpoint failed certification: "
                 f"{[v.reason() for v in verdicts if not v.ok]}")
        print(f"[{backend}] clean: {rep['completed']} queries certified, "
              f"0 false positives, 0 monitor fires", flush=True)

        # -- state.corrupt: bit-flipped state at a window boundary --------
        with chaos.active(flag("state.corrupt", step=0)):
            dirty, rep, dq = run_session()
        hits = rep["monitors_fired"] + rep["recomputed"] + len(dq)
        parity = all(np.array_equal(dirty[q], clean[q])
                     for q in clean if q not in dq)
        _require(bool(hits or parity),
                 f"[{backend}] state.corrupt neither detected nor masked")
        _require(all(r["recovered"] for r in rep["certify_failed"]),
                 f"[{backend}] certifier recompute did not recover: "
                 f"{rep['certify_failed']}")
        _require(bool(parity or rep["recomputed"]),
                 f"[{backend}] state.corrupt changed results without a "
                 f"recompute")
        detections += bool(hits)
        masked += bool(not hits)
        print(f"[{backend}] state.corrupt: "
              f"{'detected' if hits else 'masked'} "
              f"(monitors={rep['monitors_fired']} "
              f"recomputes={rep['recomputed']} "
              f"quarantined={sorted(dq)})", flush=True)

        # -- exchange.payload: corrupted wire block vs reduction tags -----
        try:
            with chaos.active(flag("exchange.payload", step=0)):
                got, _, _ = chunked_refresh(
                    engine, args.alg, std, chunk=args.checkpoint_every)
            caught = None
        except ExchangeCorruption as e:
            caught = e
        if caught is not None:
            # bounded window replay: the clean rerun is the recovery
            replay, _, _ = chunked_refresh(
                engine, args.alg, std, chunk=args.checkpoint_every)
            _require(np.array_equal(replay, clean_chunk),
                     f"[{backend}] post-corruption replay diverged")
            detections += 1
            print(f"[{backend}] exchange.payload: detected "
                  f"({caught}); replay bitwise clean", flush=True)
        else:
            _require(backend == "hybrid",
                     f"[{backend}] corrupted exchange escaped the tag check")
            _require(np.array_equal(got, clean_chunk),
                     "[hybrid] inert exchange site still changed the result")
            masked += 1
            print("[hybrid] exchange.payload: masked (single-device hybrid "
                  "supersteps have no wire exchange)", flush=True)
        walls[backend] = time.perf_counter() - t_backend

    # -- checkpoint.torn: torn tensor vs manifest CRC (backend-free) ------
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=3)
        tree = {"state": rng.standard_normal(64).astype(np.float32)}
        mgr.save_tree(0, tree, blocking=True)
        with chaos.active(flag("checkpoint.torn", step=1)):
            mgr.save_tree(1, tree, blocking=True)
        try:
            mgr.restore_tree(tree)
            raise AssertionError("torn checkpoint restored silently")
        except CheckpointCorruption as e:
            detections += 1
            print(f"checkpoint.torn: detected ({e})", flush=True)
        _, prev = mgr.restore_tree(tree, step=0)
        _require(np.array_equal(prev["state"], tree["state"]),
                 "fallback snapshot does not match the saved state")
        print("checkpoint.torn: fallback to step 0 bitwise clean",
              flush=True)

    # -- tombstone.flip: resurrected deleted edge on the dynamic path -----
    from repro_torch.data.graphs import edge_stream

    t0 = time.perf_counter()
    if dynamic is None:
        a = argparse.Namespace(**vars(args))
        a.backend, a.alg = "reference", "bfs"
        g, dg, engine = build_engine(a, dynamic=True)
    else:
        g, dg, engine = dynamic
    batch = edge_stream(g, 1, args.mutation_batch, churn=0.5,
                        seed=args.seed)[0]
    dg.apply_mutations(batch)
    truth = dg.mutated_csr()
    cert = ResultCertifier("bfs", truth)
    std = rng.integers(0, g.num_vertices, size=args.batch)
    base, _, _ = chunked_refresh(engine, "bfs", std,
                                 chunk=args.checkpoint_every)
    verdicts = cert.certify_batch(base, sources=std)
    _require(all(v.ok for v in verdicts),
             "clean dynamic fixpoint failed certification against the "
             "mutated graph")
    # flip at EVERY window so the engine converges to a consistent
    # fixpoint of the *wrong* graph: the hardest case, which only a
    # certifier checking against the true mutated topology can tell
    persistent = FaultInjector(sites={"tombstone.flip": [
        {"step": s, "flag": True}
        for s in range(0, 64, args.checkpoint_every)]})
    with chaos.active(persistent):
        flipped, _, _ = chunked_refresh(engine, "bfs", std,
                                        chunk=args.checkpoint_every)
    verdicts = cert.certify_batch(flipped, sources=std)
    bad = [v.reason() for v in verdicts if not v.ok]
    if np.array_equal(flipped, base):
        masked += 1
        _require(not bad, f"masked tombstone flip still failed: {bad}")
        print("tombstone.flip: masked (min-semiring path redundancy "
              "absorbed the flipped slot; fixpoint bitwise clean)",
              flush=True)
    else:
        detections += 1
        _require(bool(bad), "tombstone flip changed the fixpoint but every "
                            "certifier check passed")
        print(f"tombstone.flip: detected ({bad[0]})", flush=True)
    # teeth proof: had the flip produced ANY wrong fixpoint, the certifier
    # rejects it: perturb one reached vertex's level by one and re-certify
    slot = next(i for i in range(len(std))
                if (np.isfinite(flipped[i]) & (flipped[i] > 0)).any())
    wrong = np.asarray(flipped[slot]).copy()
    v = int(np.flatnonzero(np.isfinite(wrong) & (wrong > 0))[0])
    wrong[v] -= 1.0
    verdict = cert.certify(wrong, source=int(std[slot]))
    _require(not verdict.ok,
             "certifier accepted a provably wrong BFS fixpoint")
    print(f"tombstone.flip: certifier rejects a perturbed fixpoint "
          f"({verdict.reason()})", flush=True)
    walls["tombstone"] = time.perf_counter() - t0

    print(f"corruption drill: {detections} detected, {masked} masked, "
          f"0 false positives across 3 backends", flush=True)
    return dict(detections=detections, masked=masked, walls=walls)


def serve_continuous(engine, g, cfg: ServeConfig, sources, *,
                     dg=None, mutation_stream=None, parity: bool = False,
                     warm: bool = True) -> dict:
    """Serve ``sources`` through one resident :class:`ServeSession` and
    report it against fixed-batch drain at the same Q.

    Without ``mutation_stream`` the whole stream is submitted up front
    ("under load": every query's latency includes its queue wait) and
    drained by ONE resident loop; the same stream then runs through
    drain-batch ``execute`` for the q/s / p99 baseline and, with
    ``parity=True``, the oracle: a completion mismatches unless its result
    is bitwise its drain row's and its superstep count equals the drain's.
    With ``mutation_stream`` (which needs the dynamic ``dg``) the stream is
    served in waves — drain, mutate, drain — so every query completes
    against one graph version and parity holds per wave.
    """
    from repro_torch.runtime import ServeSession, drain_reference

    deg = g.out_degrees()
    scheduler = "depth" if cfg.depth_buckets else "fifo"
    depth_key = (lambda s: -int(deg[s])) if cfg.depth_buckets else None

    def make_session():
        return ServeSession(
            engine, cfg.alg, slots=cfg.batch, chunk=cfg.chunk,
            queue_capacity=cfg.queue_capacity, deadline_ms=cfg.deadline_ms,
            scheduler=scheduler, depth_key=depth_key)

    if warm:
        # pay every first-run build (splits, layouts, kernel libraries)
        # outside the timed run: a 2x-slots throwaway stream forces one
        # refill cycle, and the oracle warms the drain-batch path
        warm_srcs = np.resize(np.asarray(sources), 2 * cfg.batch)
        ws = make_session()
        ws.submit(warm_srcs)
        ws.drain()
        drain_reference(engine, cfg.alg, warm_srcs[:cfg.batch], cfg.batch)

    stream = np.asarray(sources).reshape(-1)
    waves = [stream]
    if mutation_stream is not None:
        if dg is None:
            raise ValueError("mutation_stream needs the dynamic graph (dg)")
        waves = np.array_split(stream, len(mutation_stream) + 1)
    session = make_session()
    mismatches = checked = 0
    drain_lat: list = []
    cont_wall = drain_wall = 0.0
    t_all = time.perf_counter()
    for w, wave in enumerate(waves):
        if w > 0:
            session.mutate(mutation_stream[w - 1])
        qids = session.submit(wave)
        t0 = time.perf_counter()
        session.drain()
        cont_wall += time.perf_counter() - t0
        # fixed-batch drain of the same wave on the same graph version:
        # the q/s + p99 baseline, and (parity=True) the oracle
        t0 = time.perf_counter()
        num = len(wave)
        ref_rows, ref_steps = [], []
        for i in range(0, num, cfg.batch):
            batch = np.resize(wave[i:i + cfg.batch], cfg.batch)
            res, steps = query_batch(engine, cfg.alg, batch)
            ref_rows.append(res)
            ref_steps.append(np.asarray(steps))
            # a drained query's latency is its batch's completion time
            done_ms = (time.perf_counter() - t0) * 1e3
            drain_lat.extend([done_ms] * min(cfg.batch, num - i))
        drain_wall += time.perf_counter() - t0
        if parity:
            ref = np.concatenate(ref_rows, axis=0)[:num]
            ref_s = np.concatenate(ref_steps)[:num]
            by_qid = {q: j for j, q in enumerate(qids) if q is not None}
            for r in session.poll():
                j = by_qid.get(r["query"])
                if j is not None:
                    checked += 1
                    if not (np.array_equal(r["result"], ref[j])
                            and r["steps"] == int(ref_s[j])):
                        mismatches += 1
    wall_s = time.perf_counter() - t_all
    rep = session.report()
    cont_lat = sorted(session._latency_ms.values())
    completed = rep["completed"]
    report = dict(
        mode="continuous", algorithm=cfg.alg, slots=cfg.batch,
        chunk=cfg.chunk, stream=len(stream), waves=len(waves),
        completed=completed,
        rejected=rep["rejected"], windows=rep["windows"],
        refills=rep["refills"],
        min_slot_refills=rep["min_slot_refills"],
        max_slot_refills=rep["max_slot_refills"],
        retraces=rep["retraces"], sla_misses=rep["sla_misses"],
        scheduler=scheduler,
        continuous_qps=(completed / cont_wall) if cont_wall else None,
        continuous_p50_ms=_percentile(cont_lat, 50),
        continuous_p99_ms=_percentile(cont_lat, 99),
        drain_qps=(len(drain_lat) / drain_wall) if drain_wall else None,
        drain_p50_ms=_percentile(drain_lat, 50),
        drain_p99_ms=_percentile(drain_lat, 99),
        wall_s=wall_s,
        backend=getattr(engine, "backend", None),
        engine=type(engine).__name__)
    if parity:
        report["parity_checked"] = checked
        report["parity_mismatches"] = mismatches
    return report


def _write(args, report: dict) -> None:
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(vars(args), **report), f, indent=2)
        print(f"wrote {args.out}")


def build_parser() -> argparse.ArgumentParser:
    """The launcher's command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (cuda by "
                         "default; cpu runs the plain PyTorch path)")
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--graph", choices=("rmat", "uniform"), default="rmat")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--strategy", default="high",
                    choices=("rand", "high", "low"))
    ap.add_argument("--backend", default="fused",
                    choices=("reference", "fused", "hybrid"))
    ap.add_argument("--block-e", type=int, default=256)
    ap.add_argument("--win-blocks", type=int, default=8,
                    help="edge blocks per out-of-core streaming window "
                         "(with --hbm-budget)")
    ap.add_argument("--hbm-budget", type=int, default=None, metavar="BYTES",
                    help="out-of-core tiering: device-memory byte budget "
                         "for the graph arenas; partitions that do not fit "
                         "stay in pinned host memory and stream through "
                         "two device window buffers (drain mode only)")
    ap.add_argument("--alg", default="bfs",
                    choices=("bfs", "sssp", "bc", "ppr"))
    ap.add_argument("--batch", type=int, default=32,
                    help="queries per batch (the Q axis)")
    ap.add_argument("--num-queries", type=int, default=256,
                    help="synthetic query stream length")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None, help="write the report JSON here")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI (scale 8, 3 batches of 4)")
    ap.add_argument("--mutate", action="store_true",
                    help="interleave edge-mutation batches with query "
                         "batches against a resident DynamicGraph")
    ap.add_argument("--mutation-batch", type=int, default=256,
                    help="edges per mutation batch")
    ap.add_argument("--mutation-rounds", type=int, default=8,
                    help="mutation batches in the stream")
    ap.add_argument("--churn", type=float, default=0.7,
                    help="insert fraction of each mutation batch (the rest "
                         "deletes; 1.0 keeps warm starts monotone)")
    ap.add_argument("--standing", type=int, default=8,
                    help="standing query set kept fresh across mutations")
    ap.add_argument("--no-compact", action="store_true",
                    help="disable threshold-driven compaction (capacity-"
                         "overflow compaction still applies; its pauses "
                         "are reported either way)")
    ap.add_argument("--depth-buckets", type=int, default=0, metavar="B",
                    help="serve the stream in B estimated-depth buckets and "
                         "report per-bucket p99 vs the unbucketed baseline")
    ap.add_argument("--chaos", action="store_true",
                    help="run the fault-injection drill: a clean mutating "
                         "session, then the same session with injected "
                         "crashes; check recovery, zero lost mutations, "
                         "and bitwise parity")
    ap.add_argument("--corrupt", action="store_true",
                    help="run the silent-corruption drill: inject bit-flips "
                         "at every data-corruption site (state rows, "
                         "exchange payloads, checkpoint tensors, tombstone "
                         "masks) across all three backends; check every "
                         "fault is detected or masked and the clean path "
                         "raises zero false positives")
    ap.add_argument("--checkpoint-every", type=int, default=2,
                    help="supersteps per chunk window (--continuous and "
                         "the drills' checkpointable refresh)")
    ap.add_argument("--superstep-budget", type=int, default=64,
                    help="quarantine standing queries still unconverged "
                         "after this many supersteps (divergence watchdog)")
    ap.add_argument("--max-restarts", type=int, default=5,
                    help="retryable-failure budget for the serving session")
    ap.add_argument("--restart-backoff-s", type=float, default=0.0,
                    help="base exponential-backoff sleep between restarts")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-query SLA deadline; misses are reported")
    ap.add_argument("--queue-capacity", type=int, default=None,
                    help="admission-control bound on the query queue; "
                         "overflow is rejected with a reason")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through one resident ServeSession: refill "
                         "converged query slots mid-loop instead of "
                         "draining the batch (composes with --mutate, "
                         "--deadline-ms, --queue-capacity, --depth-buckets)")
    return ap


def _report_tiers(engine, args) -> bool:
    """Print a tiered engine's split; True when the plan exceeds the
    budget.  Admission charges the device figure only against the budget:
    host-tier partitions stream from host memory."""
    stats = engine.tiered_stats()
    resid = engine.residency_bytes()
    print(f"tiered: {stats['num_hot']} hot / {stats['num_cold']} "
          f"host-tier partitions; arena hbm={stats['hbm_resident_bytes']:,}"
          f" B <= budget {args.hbm_budget:,} B; residency "
          f"hbm={resid['hbm_bytes']:,} B host={resid['host_bytes']:,} B "
          f"(streams {stats['streamed_bytes_per_superstep']:,} B/"
          f"superstep over {stats['window_count']} windows)", flush=True)
    if stats["hbm_resident_bytes"] > args.hbm_budget:
        print("error: tier plan exceeds the HBM budget", file=sys.stderr)
        return True
    return False


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.smoke:
        args.scale = min(args.scale, 8)
        args.batch = min(args.batch, 4)
        args.num_queries = min(args.num_queries, 3 * args.batch)
        args.mutation_batch = min(args.mutation_batch, 32)
        args.mutation_rounds = min(args.mutation_rounds, 3)
        args.standing = min(args.standing, 4)

    try:
        cfg = ServeConfig.from_args(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if cfg.mode == "chaos":
        run_chaos_drill(args)
        print("CHAOS OK")
        return 0
    if cfg.mode == "corrupt":
        run_corrupt_drill(args)
        print("CORRUPT OK")
        return 0

    dg = stream = None
    if cfg.mutate:
        from repro_torch.data.graphs import edge_stream

        g, dg, engine = build_engine(args, dynamic=True)
        stream = edge_stream(g, args.mutation_rounds, args.mutation_batch,
                             churn=args.churn, seed=args.seed)
    else:
        g, _, engine = build_engine(args)
    rng = np.random.default_rng(args.seed)
    sources = rng.integers(0, g.num_vertices, size=args.num_queries)

    if cfg.mode == "continuous":
        print(f"resident graph: |V|={g.num_vertices:,} "
              f"|E|={g.num_edges:,} parts={args.parts} "
              f"backend={args.backend} continuous slots={cfg.batch} "
              f"device={engine.device}", flush=True)
        report = serve_continuous(engine, g, cfg, sources, dg=dg,
                                  mutation_stream=stream,
                                  parity=args.smoke)
        print(f"{cfg.alg}: {report['completed']}/{report['stream']} "
              f"queries through {report['slots']} resident slots "
              f"({report['waves']} wave(s)) -> "
              f"{report['continuous_qps']:.1f} q/s continuous vs "
              f"{report['drain_qps']:.1f} q/s drain; p99 "
              f"{report['continuous_p99_ms']:.1f} vs "
              f"{report['drain_p99_ms']:.1f} ms; "
              f"refills={report['refills']} "
              f"(min/slot={report['min_slot_refills']}); "
              f"retraces={report['retraces']}", flush=True)
        if "parity_checked" in report:
            print(f"parity: {report['parity_checked']} checked, "
                  f"{report['parity_mismatches']} mismatches", flush=True)
            if report["parity_mismatches"]:
                print("error: continuous results diverge from drain-batch",
                      file=sys.stderr)
                return 1
        if report["retraces"]:
            print(f"WARNING: {report['retraces']} engine structures built "
                  f"after warm-up — refills are rebuilding",
                  file=sys.stderr)
        _write(args, report)
        print("GRAPH SERVE OK")
        return 0

    if cfg.mode == "mutate":
        print(f"resident dynamic graph: |V|={g.num_vertices:,} "
              f"|E|={g.num_edges:,} parts={args.parts} "
              f"strategy={args.strategy} backend={args.backend} "
              f"delta_slots={dg.delta_slots}/partition "
              f"device={engine.device}", flush=True)
        if engine.tier_plan is not None and _report_tiers(engine, args):
            return 2
        report = serve_mutating(
            engine, dg, args.alg, batches=stream, batch=args.batch,
            standing=args.standing, query_batches_per_round=2,
            seed=args.seed, compact=not args.no_compact)
        inc = report["incremental_steps"]
        cold = report["cold_steps"]
        savings = (f"{inc} vs {cold} supersteps "
                   f"({cold / max(inc, 1):.1f}x fewer)"
                   if inc is not None and cold else "n/a (non-monotone)")
        print(f"{args.alg}: {report['rounds']} mutation rounds x "
              f"{args.mutation_batch} edges -> "
              f"{report['mutation_edges_per_sec']:.0f} edges/s applied; "
              f"incremental refresh {savings}; query batch "
              f"p50={report['batch_p50_ms']:.1f} "
              f"p99={report['batch_p99_ms']:.1f} ms; "
              f"compactions={report['compactions']} "
              f"({report['compaction_pause_ms']:.0f} ms paused); "
              f"retraces={report['retraces']}", flush=True)
        if report["retraces"]:
            print(f"WARNING: {report['retraces']} engine structures built "
                  f"after warm-up without a compaction — mutation batches "
                  f"are rebuilding", file=sys.stderr)
        _write(args, report)
        print("GRAPH SERVE OK")
        return 0

    print(f"resident graph: |V|={g.num_vertices:,} |E|={g.num_edges:,} "
          f"parts={args.parts} strategy={args.strategy} "
          f"backend={args.backend} device={engine.device}", flush=True)
    if engine.tier_plan is not None and _report_tiers(engine, args):
        return 2

    if cfg.mode == "depth":
        rep = serve_depth_bucketed(engine, g, args.alg, sources, args.batch,
                                   num_buckets=args.depth_buckets)
        for b in rep["buckets"]:
            print(f"bucket {b['bucket']} (deg>={b['min_degree']}, "
                  f"{b['queries']} queries): p99 "
                  f"{b['baseline_p99_ms']:.1f} -> "
                  f"{b['bucketed_p99_ms']:.1f} ms "
                  f"(p50 {b['baseline_p50_ms']:.1f} -> "
                  f"{b['bucketed_p50_ms']:.1f})", flush=True)
        print(f"stream p99 {rep['baseline_p99_ms']:.1f} -> "
              f"{rep['bucketed_p99_ms']:.1f} ms with {args.depth_buckets} "
              f"depth buckets", flush=True)
        _write(args, rep)
        print("GRAPH SERVE OK")
        return 0

    report = serve(engine, args.alg, sources, args.batch,
                   deadline_ms=args.deadline_ms,
                   queue_capacity=args.queue_capacity)
    if "admission" in report:
        a = report["admission"]
        print(f"admission: {a['admitted']} admitted, {a['rejected']} "
              f"rejected ({', '.join(a['reject_reasons']) or 'none'}) at "
              f"capacity {a['capacity']}", flush=True)
    if "sla" in report:
        s = report["sla"]
        print(f"SLA {s['deadline_ms']:.0f} ms: {s['met']} met, "
              f"{s['misses']} missed", flush=True)
    if report["ms_per_query"] is None:
        print(f"{args.alg}: {report['num_queries']} queries in one cold "
              f"batch of {args.batch} -> {report['cold_ms']:.0f} ms incl. "
              f"first-run builds (add batches for steady-state numbers)",
              flush=True)
    else:
        print(f"{args.alg}: {report['num_queries']} queries in batches of "
              f"{args.batch} -> {report['queries_per_sec']:.1f} q/s, "
              f"{report['ms_per_query']:.2f} ms/query amortized "
              f"(cold first batch {report['cold_ms']:.0f} ms; warm batch "
              f"p50={report['batch_p50_ms']:.1f} "
              f"p90={report['batch_p90_ms']:.1f} "
              f"p99={report['batch_p99_ms']:.1f} ms; "
              f"retraces={report['retraces']})", flush=True)
    if report["retraces"]:
        print(f"WARNING: {report['retraces']} engine structures built "
              f"after the first batch — batches are rebuilding",
              file=sys.stderr)
    _write(args, report)
    print("GRAPH SERVE OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
