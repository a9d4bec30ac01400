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
mode serves and the continuous mode refuses.

``--mutate`` serves an evolving graph: a resident ``DynamicGraph`` takes
``--mutation-rounds`` batches of ``--mutation-batch`` edges (``--churn``
inserts, the rest deletes; ``data/graphs.py::edge_stream``), and each
round serves fresh queries cold and keeps a ``--standing`` query set
fresh, warm-started when the window was insert-only
(:func:`serve_mutating`).  With ``--continuous`` the stream is served in
waves with a mutation batch between them (``serve_continuous(
mutation_stream=)``), ``--depth-buckets`` composing as the scheduler.

Port of ``repro.launch.graph_serve`` without the fault drills:
``--chaos`` and ``--corrupt`` raise ``NotImplementedError`` naming ROADMAP
Queue 1 item 13.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np

from repro_torch.core.bsp import _not_in_slice


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
            raise _not_in_slice("graph_serve --chaos (the fault drill)",
                                "13")
        if self.corrupt:
            raise _not_in_slice("graph_serve --corrupt (the corruption "
                                "drill)", "13")
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
    ``--mutation-batch``) in place of the partitioned graph."""
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.core.dynamic import DynamicGraph

    gen = G.rmat if args.graph == "rmat" else G.uniform
    g = gen(args.scale, args.edge_factor, seed=args.seed)
    if args.alg == "sssp":
        g = g.with_uniform_weights(seed=args.seed + 1)
    kw = {}
    if args.backend == "fused":
        kw = dict(fused=True, block_e=args.block_e)
    elif args.backend == "hybrid":
        kw = dict(backend="hybrid")
    if args.hbm_budget is not None:
        kw["tiered"] = args.hbm_budget
        kw["win_blocks"] = args.win_blocks
        kw.setdefault("block_e", args.block_e)
    if dynamic:
        dg = DynamicGraph(g, args.parts, args.strategy,
                          include_reverse=(args.alg == "bc"),
                          mutation_capacity=args.mutation_batch,
                          device=args.device)
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
                    help="the fault-injection drill (not ported yet: item "
                         "13)")
    ap.add_argument("--corrupt", action="store_true",
                    help="the silent-corruption drill (not ported yet: "
                         "item 13)")
    ap.add_argument("--checkpoint-every", type=int, default=2,
                    help="supersteps per chunk window (--continuous)")
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
    if engine.tier_plan is not None:
        # admission charges the device figure only against the budget:
        # host-tier partitions stream from host memory
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
