#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, the CUDA toolkit (``nvcc``) and the checkout's ``src/``; without a
card, or alone in a directory, it exits non-zero before printing a result.

Phases (any failed check exits non-zero; nothing is caught and passed over):

1. device check and kernel build, one ``nvcc`` per kernel, all started
   together (``-Xptxas -v`` reports printed);
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes: RMAT20 (``totem_rmat.RMAT_MEDIUM``, 2^20 vertices, 16
   edges each), 2 partitions, HIGH, ``block_e=1024``, reverse edges, Q=8.
   The fused superstep for all six message kinds: min kinds bit for bit,
   sum kinds against a float64 evaluation of the plain version within the
   kernel's own f32 error bound (below).  The bottom-up scan on the
   engine's transposed rows in its three modes (BFS's early exit, CC's
   min, SSSP's min_plus): bit for bit, counts included.  Two launches of
   each bit-equal;
3. the main path at that size through the user entry points, with the
   engine's defaults (min algorithms direction optimized), fused backend
   against the reference backend on the card: ``bfs_batched`` and
   ``sssp_batched`` (Q=8 seeded sources), ``pagerank`` (20 iterations),
   ``betweenness_centrality`` (one source), ``connected_components`` (on
   the symmetrized graph).  Min algorithms bit for bit with equal steps,
   both backends also against plain push (``direction_switch=False`` on
   the reference backend, no kernel).  PageRank and BC against a float64
   run of the reference backend, within a fixed relative error (2e-6 and
   1e-6) with equal steps; the reference backend's own error is printed.
   The fused kernel must launch in every fused run and the scan kernel on
   the path.  Then the fused backend with and without the direction vote,
   timed in turns, and BFS and SSSP forced to pull, against plain push;
   Then the hybrid backend (``backend="hybrid"``, the split the planner
   picks) through the same entry points: BFS, SSSP and CC bit for bit with
   equal steps against plain push, under the vote, without it
   (``direction_switch=False``) and forced to pull; PageRank and BC against
   the float64 runs within the same limits.  Its three kernels must launch;
4. the sharded engine (``DistributedBSPEngine``) as a world of one on the
   same card, holding both partitions of the same graphs (``[shard]``
   lines): the outbox kernel against its plain version on the sharded
   hybrid's real boundary arrays in every mode on the path (min for BFS
   and CC, min_plus for SSSP, plus_times for PageRank and BC forward and
   backward; min results bit for bit, sums within the kernel's f32 bound
   of float64, two launches bit-equal, timed beside its bound, its plain
   version and, for plus_times, ``torch.sparse.mm``); the sharded hybrid
   backend through the same entry points, under the vote and without it,
   bit for bit with equal steps against the single-device hybrid runs
   (BFS, SSSP, CC) and within the fixed limits of the float64 runs
   (PageRank, BC), with the per-shard plan, each call's wall and each
   kernel's launches printed (the outbox kernel must launch); and the
   sharded reference and fused backends on BFS, bit for bit with
   ``BSPEngine``.  One card is enough: NCCL refuses two ranks on one
   card, so the wire between ranks is tested by the gloo tests on the CPU
   and by ``launch/hybrid_selftest.py --device cuda`` on several cards;
5. the numpy oracles at RMAT12 on the card, all five algorithms, on the
   fused and the hybrid backends.

Phase 2 also holds the hybrid kernels at the planner's RMAT20 split (|H|,
Q=8): ``ell_spmv`` in its three semirings on the forward remainder (min and
min_plus bit for bit, plus_times within its f32 bound of float64),
``dense_spmv`` within its bound and ``dense_spmv_minplus`` bit for bit.

Why sums are held to float64 and not to the plain f32 version: at RMAT20 a
hub sums ~10^4-10^5 messages, and two f32 summation orders (the kernel's
fixed order, the plain version's atomics) differ by up to ~1e-5 relative,
beyond the 1e-6 the scale-10 tests use.  The kernel's sum is a fixed tree:
at most ``block_e/128`` sequential adds in a thread, 5 warp-scan levels, 4
adds across warps, one carry, and two adds per block a segment spans in the
merge, plus two roundings of the message itself; so its error is at most
``depth * 2^-24 * sum|messages|`` with that depth.

The hybrid kernels' sums are fixed trees too: ``ell_spmv`` adds at most
128 products in a thread, then a warp (5 levels) and block (4 levels) tree
and, for rows over 65,536 slots, the segments in order; ``dense_spmv`` a
slice of 128, then a pairwise tree over the slices.  ``outbox_reduce``
takes the fused kernel's tree (``block_e/128`` adds in a thread, the warp
scan and fold, a carry, two adds per block a slot spans) plus the message.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20
Q = 8
BLOCK_E = 1024
PR_ITERS = 20
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_OPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
UNIT_ROUNDOFF = 2.0 ** -24
# fused vs float64, max relative error (measured 4.3e-7 and 2.1e-7)
SUM_LIMITS = {"pagerank": 2e-6, "betweenness_centrality": 1e-6}
KERNELS = {
    "fused_superstep": ("src/repro_torch/kernels/csrc/fused_superstep.cu",
                        "src/repro/kernels/fused_superstep.py:146"),
    "bottomup_scan": ("src/repro_torch/kernels/csrc/bottomup.cu",
                      "src/repro/kernels/bottomup.py:113"),
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:102"),
    "dense_spmv": ("src/repro_torch/kernels/csrc/dense_spmv.cu",
                   "src/repro/kernels/dense_spmv.py:63"),
    "dense_spmv_minplus": ("src/repro_torch/kernels/csrc/dense_spmv.cu",
                           "src/repro/kernels/dense_spmv.py:103"),
    "outbox_reduce": ("src/repro_torch/kernels/csrc/outbox_reduce.cu",
                      "src/repro/kernels/outbox_reduce.py:128"),
}
# the outbox kernel's modes on the sharded path: program -> (graph, reverse
# edges, combine, weight_op, semiring of its messages)
OUTBOX_MODES = {"bfs": ("pg", False, "min", None, "min"),
                "cc": ("pgs", False, "min", None, "min"),
                "sssp": ("pg", False, "min", "add", "min_plus"),
                "pagerank": ("pg", False, "sum", None, "plus_times"),
                "bc_fwd": ("pg", False, "sum", None, "plus_times"),
                "bc_bwd": ("pg", True, "sum", None, "plus_times")}
# hybrid sparse-stage semirings on the path: the program whose split feeds
# each (semiring -> program name)
ELL_MODES = {"min": "bfs", "min_plus": "sssp", "plus_times": "pagerank"}
# bottom-up scan modes on the path: (program, semiring, early exit)
SCAN_MODES = {"bfs": ("min", True), "cc": ("min", False),
              "sssp": ("min_plus", False)}


def log(*args):
    print(*args, flush=True)


class Checks:
    """Collects failed checks; the run exits non-zero if any failed."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> None:
        log(("PASS " if ok else "FAIL ") + what)
        if not ok:
            self.failed.append(what)


def max_abs_err(a, b) -> float:
    """max |a - b| over entries, equal infinities counting as 0."""
    import torch
    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def max_rel_err(x, ref) -> float:
    """max |x - ref| / |ref| over entries (0/0 counting as 0)."""
    import numpy as np
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(x - ref)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.max(np.where(diff == 0, 0.0, diff / np.abs(ref))))


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` from CUDA events over ``reps`` calls, warmed."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_inputs(kind, pg, blk, rng, device):
    """Inputs of one kind at the main path's shapes: state made from the
    seed with every branch of the message taken (frontier and not, +inf,
    inactive, zero sigma); PageRank's inverse degrees from the graph."""
    import numpy as np
    import torch

    shape = (Q, pg.num_parts, pg.v_max)
    levels = rng.choice(np.array([0, 1, 2, 3, np.inf], np.float32), shape)
    active = (rng.random(shape) < 0.3).astype(np.float32)
    consts = []
    if kind == "bfs":
        cols = [levels]
    elif kind == "sssp":
        dist = rng.uniform(0, 64, shape).astype(np.float32)
        dist[rng.random(shape) < 0.5] = np.inf
        cols = [dist, active]
    elif kind == "cc":
        cols = [rng.integers(0, pg.num_vertices, shape).astype(np.float32),
                active]
    elif kind == "pagerank":
        inv = np.where(pg.out_deg > 0, 1.0 / np.maximum(pg.out_deg, 1.0), 0)
        rank = rng.uniform(0.5, 1.5, shape) / pg.num_vertices
        cols = [rank.astype(np.float32),
                np.broadcast_to(inv, shape).astype(np.float32)]
    elif kind == "bc_fwd":
        cols = [levels, rng.integers(1, 50, shape).astype(np.float32)]
    else:
        cols = [levels, rng.integers(0, 50, shape).astype(np.float32),
                rng.random(shape, dtype=np.float32) * 8]
        consts = [np.full(shape[:2], 4.0, np.float32)]
    vstate = np.stack(cols, axis=2)                   # [Q, Pl, K, V]
    scal = np.stack([np.full(shape[:2], 1.0, np.float32)] + consts, axis=2)

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return dict(vstate=put(vstate, torch.float32),
                scal=put(scal, torch.float32),
                src=put(blk.src, torch.int32),
                local=put(blk.local, torch.int32),
                mask=put(blk.mask, torch.int32),
                weight=(put(blk.weight, torch.float32)
                        if blk.weight is not None else None),
                base=put(blk.base, torch.int32))


def max_blocks_per_segment(blk) -> int:
    """The most edge blocks one segment's edges fall in (a hub's span)."""
    import numpy as np

    ids = blk.base[:, :, None] + blk.local.reshape(blk.base.shape + (-1,))
    most = 1
    for first, last in zip(ids[:, :, 0], ids[:, :, -1]):
        per_block = np.concatenate([first, last[last != first]])
        most = max(most, int(np.bincount(per_block).max()))
    return most


def sum_depth(blk) -> int:
    """Roundings on the longest path of the kernel's summation tree, plus
    two for forming the message (see the module docstring)."""
    return blk.block_e // 128 + 5 + 4 + 1 + 2 * max_blocks_per_segment(blk) + 2


def bound_ms(kind, pg, blk) -> float:
    """Least time for one launch: bytes moved (topology once, each gathered
    state array once, the accumulator once) over the memory rate, or the
    message and reduce operations over the f32 rate, whichever is larger."""
    from repro_torch.kernels.fused_superstep import KINDS

    spec = KINDS[kind]
    pl, e_pad = blk.src.shape
    topo = pl * e_pad * (12 + (4 if spec.use_weight else 0))
    state = spec.num_gather * Q * pl * pg.v_max * 4
    out = Q * pl * pg.seg_count * 4
    ops = Q * pl * int(blk.mask.sum()) * 4
    return 1e3 * max((topo + state + out) / HBM_BYTES_PER_S,
                     ops / F32_OPS_PER_S)


def _edge_message(kind, num_vertices):
    """The port's EdgeMessage of each kernel kind."""
    def alg(name):   # the package re-exports functions named like modules
        return importlib.import_module(f"repro_torch.algorithms.{name}")

    return {
        "bfs": lambda: alg("bfs").BFS_PROGRAM,
        "sssp": lambda: alg("sssp").SSSP_PROGRAM,
        "cc": lambda: alg("cc").CC_PROGRAM,
        "pagerank": lambda: alg("pagerank").make_pagerank_program(
            num_vertices),
        "bc_fwd": lambda: alg("bc").FORWARD_PROGRAM,
        "bc_bwd": lambda: alg("bc").BACKWARD_PROGRAM,
    }[kind]().edge_msg


def scan_inputs(mode, pg, tc, rng, device):
    """Messages of one bottom-up mode over the engine's transposed rows,
    made from the seed: BFS frontiers of a few densities (every live
    message is step + 1, the uniform licence), CC labels and SSSP distances
    with half the sources inactive; a skip mask of visited rows."""
    import numpy as np
    import torch

    x_len = pg.num_parts * pg.v_max
    if mode == "bfs":
        dens = rng.choice(np.array([0.001, 0.05, 0.3, 0.6]), size=(Q, 1))
        x = np.where(rng.random((Q, x_len)) < dens, 2.0, np.inf)
    elif mode == "cc":
        x = rng.integers(0, pg.num_vertices, (Q, x_len)).astype(np.float64)
        x[rng.random((Q, x_len)) < 0.5] = np.inf
    else:
        x = rng.uniform(0, 64, (Q, x_len))
        x[rng.random((Q, x_len)) < 0.5] = np.inf

    def put(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return dict(row_ptr=put(tc.row_ptr, torch.int32),
                col=put(tc.col, torch.int32),
                val=(put(tc.val, torch.float32) if mode == "sssp" else None),
                x=put(x, torch.float32),
                skip=put(rng.random((Q, x_len)) < 0.4, torch.bool))


def scan_bound_ms(x, scanned, semiring) -> float:
    """Least time for one scan launch: row_ptr once, the col (and val)
    slots this run's scans reach, each row's slots once for all queries, x
    once, y and scanned written once; or a compare (and an add) per scanned
    slot over the f32 rate, whichever is larger."""
    q, x_len = x.shape
    v = scanned.shape[1]
    per_slot = 2 if semiring == "min_plus" else 1
    slots = int(scanned.max(0).values.sum())
    moved = 4 * (v + 1) + 4 * per_slot * slots + 4 * q * x_len + 8 * q * v
    ops = per_slot * int(scanned.sum())
    return 1e3 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def ell_inputs(semiring, n, rng, device):
    """Per-source values of one sparse-stage semiring, made from the seed:
    PageRank-like positive contributions (plus_times), BFS levels (min) and
    SSSP distances (min_plus), half of them +inf."""
    import numpy as np
    import torch

    if semiring == "plus_times":
        x = rng.uniform(0.5, 1.5, (Q, n)) / n
    elif semiring == "min":
        x = rng.integers(0, 8, (Q, n)).astype(np.float64)
        x[rng.random((Q, n)) < 0.5] = np.inf
    else:
        x = rng.uniform(0, 64, (Q, n))
        x[rng.random((Q, n)) < 0.5] = np.inf
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def ell_sum_depth(kmax) -> int:
    """Roundings on the longest path of ``ell_spmv``'s sum of a row of
    ``kmax`` slots: a run of 128, the warp and block trees (5 + 4), the
    65,536-slot segments in order, and the product."""
    return 128 + 9 + -(-kmax // (512 * 128)) + 1


def dense_sum_depth(k) -> int:
    """Roundings of ``dense_spmv``'s sum over ``k``: a slice of 128, the
    pairwise tree over the slices, and the product."""
    import math
    return 128 + math.ceil(math.log2(max(-(-k // 128), 1))) + 1


def ell_bound_ms(semiring, v, nnz, q, x_len) -> float:
    """Least time for one sparse-stage launch: row_ptr, col (and val) once,
    x once, y written once; or the ⊗ and ⊕ of every slot and query over the
    f32 rate, whichever is larger."""
    moved = 4 * (v + 1) + 4 * nnz * (1 if semiring == "min" else 2) + (
        4 * q * x_len + 4 * q * v)
    ops = q * nnz * (1 if semiring == "min" else 2)
    return 1e3 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def dense_bound_ms(m, k, n) -> float:
    """Least time for one dense-stage launch: a, x and y once, or the
    2 * M * K * N operations over the f32 rate, whichever is larger."""
    moved = 4 * (k * n + m * k + m * n)
    return 1e3 * max(moved / HBM_BYTES_PER_S, 2 * m * k * n / F32_OPS_PER_S)


def outbox_sum_depth(flat, block_e) -> int:
    """Roundings on the longest path of ``outbox_reduce``'s sum: a thread's
    run, the warp scan (5) and fold (4), a carry, two per block a slot's
    run touches in the merge, and the message's product."""
    import numpy as np

    nb = -(-len(flat) // block_e)
    first = flat[::block_e]
    last = flat[np.minimum(np.arange(1, nb + 1) * block_e, len(flat)) - 1]
    spans = np.bincount(np.concatenate([first, last[last != first]])).max()
    return block_e // 128 + 5 + 4 + 1 + 2 * int(spans) + 1


def outbox_bound_ms(e, weighted, q, x_len, num_slots) -> float:
    """Least time for one outbox launch: src and flat (and the weight)
    once, x once, the outboxes written once; or the ⊗ and ⊕ of every edge
    and query over the f32 rate, whichever is larger."""
    moved = 4 * e * (3 if weighted else 2) + 4 * q * (x_len + num_slots)
    ops = q * e * (2 if weighted else 1)
    return 1e3 * max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def within_f32_bound(got, exact, mag, depth) -> bool:
    """|got - exact| <= depth * 2^-24 * sum|terms| everywhere."""
    slack = (got.double() - exact).abs() - 1.01 * depth * UNIT_ROUNDOFF * mag
    return bool((slack <= 0).all())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs a "
            "CUDA card")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np

        from repro_torch.algorithms import (bc_reference, betweenness_centrality,
                                            bfs_batched, bfs_reference,
                                            cc_reference, connected_components,
                                            pagerank, pagerank_reference,
                                            sssp_batched, sssp_reference,
                                            symmetrize)
        from repro_torch.configs.totem_rmat import RMAT_MEDIUM
        from repro_torch.core import graph as G
        from repro_torch.core import partition as PT
        from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine
        from repro_torch.core.hybrid import splits_of
        from repro_torch.kernels import _build
        from repro_torch.kernels import bottomup as kbu
        from repro_torch.kernels import dense_spmv as kds
        from repro_torch.kernels import ell_spmv as kell
        from repro_torch.kernels import fused_superstep as kfs
        from repro_torch.kernels import outbox_reduce as kob
        from repro_torch.kernels.ops import (bottomup_scan_op,
                                             dense_spmv_minplus_op,
                                             dense_spmv_op, ell_spmv_op,
                                             outbox_reduce_op)
        from repro_torch.kernels.ref import (bottomup_scan_ref,
                                             dense_spmv_minplus_ref,
                                             dense_spmv_ref, ell_spmv_ref,
                                             fused_superstep_ref,
                                             outbox_reduce_ref)
        # the package re-exports functions named like these modules
        bfs_mod, sssp_mod, pr_mod = (importlib.import_module(
            f"repro_torch.algorithms.{m}") for m in ("bfs", "sssp",
                                                      "pagerank"))
    except ImportError as exc:
        log(f"FAIL: the port is not beside this script ({exc}); run it from "
            f"the root of a checkout")
        return 2

    check = Checks()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"card: {card}")

    # -- phase 1: build ------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all([kfs.SOURCE, kbu.SOURCE, kell.SOURCE,
                              kds.SOURCE, kob.SOURCE])
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    for path, build_log in built.values():
        log(f"[build] {path.name}")
        log(build_log.strip() or "[build] (cached)")

    # -- host setup ----------------------------------------------------------
    t0 = time.perf_counter()
    g = G.rmat(RMAT_MEDIUM.scale, RMAT_MEDIUM.edge_factor, seed=SEED)
    t_gen = time.perf_counter() - t0
    gw = g.with_uniform_weights(seed=SEED)
    t0 = time.perf_counter()
    pg = PT.partition(gw, 2, PT.HIGH, include_reverse=True)
    t_part = time.perf_counter() - t0
    t0 = time.perf_counter()
    gs = symmetrize(g)
    pgs = PT.partition(gs, 2, PT.HIGH)
    t_cc = time.perf_counter() - t0
    t0 = time.perf_counter()
    blks = {"fwd": PT.build_block_metadata(pg.fwd, block_e=BLOCK_E),
            "rev": PT.build_block_metadata(pg.rev, block_e=BLOCK_E)}
    t_blk = time.perf_counter() - t0
    t0 = time.perf_counter()
    tcs = {"fwd": PT.build_transposed_csc(pg.fwd, pg.v_max),
           "cc": PT.build_transposed_csc(pgs.fwd, pgs.v_max)}
    tc_graphs = {"fwd": pg, "cc": pgs}
    t_csc = time.perf_counter() - t0
    log(f"[host] {RMAT_MEDIUM.name}: V={g.num_vertices} E={g.num_edges}; "
        f"generate {t_gen:.2f} s, partition fwd+rev {t_part:.2f} s, "
        f"symmetrize+partition (CC) {t_cc:.2f} s, block metadata "
        f"{t_blk:.2f} s, transposed rows (fwd + CC) {t_csc:.2f} s")
    log(f"[host] P=2 HIGH: v_max={pg.v_max} e_max={pg.fwd.e_max} "
        f"o_max={pg.fwd.o_max} seg={pg.seg_count} "
        f"nb={blks['fwd'].num_blocks} span(fwd)={blks['fwd'].span_req} "
        f"span(rev)={blks['rev'].span_req}")
    for name, tc in tcs.items():
        tpg = tc_graphs[name]
        ell_gb = tpg.num_parts * tpg.v_max * tc.kmax * 4 / 1e9
        log(f"[host] transposed rows ({name}): nnz={tc.nnz} kmax={tc.kmax}; "
            f"the JAX package's ELL block [P, v_max, kmax] would hold "
            f"{ell_gb:.1f} GB of int32 ids")

    # the hybrid backend's plan and forward splits (the main path's engine)
    t0 = time.perf_counter()
    hyb = BSPEngine(pg, backend="hybrid")
    t_plan = time.perf_counter() - t0
    programs = {"bfs": bfs_mod.BFS_PROGRAM, "sssp": sssp_mod.SSSP_PROGRAM,
                "pagerank": pr_mod.make_pagerank_program(g.num_vertices)}
    t0 = time.perf_counter()
    splits = {sr: hyb.hybrid_for(programs[name])
              for sr, name in ELL_MODES.items()}
    t_split = time.perf_counter() - t0
    plan = hyb.hybrid_plan()
    chosen = next(r for r in plan["table"] if r["k_dense"] == plan["k_dense"])
    kmax = splits["min"][0].kmax
    log(f"[host] hybrid plan {t_plan:.2f} s, forward splits (3 semirings) "
        f"{t_split:.2f} s: k_dense={plan['k_dense']} mode={plan['mode']} "
        f"skew={plan['skew']:.3f} e_dense={chosen['e_dense']} "
        f"e_sparse={chosen['e_sparse']} density={chosen['density']:.4f} "
        f"kmax={kmax}; the JAX package's ELL remainder [V, kmax] (col + "
        f"val) would hold {g.num_vertices * kmax * 8 / 1e9:.1f} GB")
    check(plan["k_dense"] > 0 and plan["mode"] == "hybrid",
          f"[host] the planner splits RMAT20 in hybrid mode "
          f"(k_dense={plan['k_dense']})")

    # -- phase 2: kernel vs plain at the main path's shapes -----------------
    rng = np.random.default_rng(SEED)
    kernel_rows = {}
    worst_err = 0.0
    for kind, spec in kfs.KINDS.items():
        d = "rev" if kind == "bc_bwd" else "fwd"
        blk = blks[d]
        x = kernel_inputs(kind, pg, blk, rng, dev)
        dst_ext = torch.as_tensor(getattr(pg, d).dst_ext, dtype=torch.int64,
                                  device=dev)
        msg = _edge_message(kind, pg.num_vertices)
        weight = x["weight"] if spec.use_weight else None

        def kernel():
            return kfs.fused_superstep(
                kind, x["vstate"], x["scal"], x["src"], x["local"], x["mask"],
                weight, x["base"], num_segments=pg.seg_count, block_e=BLOCK_E)

        def plain(m=msg, dtype=torch.float32):
            return fused_superstep_ref(
                m, x["vstate"].to(dtype), None if weight is None
                else weight.to(dtype), x["scal"].to(dtype), x["src"],
                x["mask"], dst_ext, num_segments=pg.seg_count,
                combine=spec.combine)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst_err = max(worst_err, err)
        if spec.combine == "min":
            check(torch.equal(got, want), f"[kernel] {kind}: bit-equal to "
                  f"the plain version (max |err| {err})")
        else:
            exact = plain(dtype=torch.float64)
            mag = plain(dataclasses.replace(
                msg, fn=lambda *a, f=msg.fn: f(*a).abs()), torch.float64)
            depth = sum_depth(blk)
            slack = (got.double() - exact).abs() - (
                1.01 * depth * UNIT_ROUNDOFF * mag)
            plain_rel = max_rel_err(want.cpu(), exact.cpu())
            kern_rel = max_rel_err(got.cpu(), exact.cpu())
            check(bool((slack <= 0).all()),
                  f"[kernel] {kind}: within its f32 bound ({depth} "
                  f"roundings x 2^-24 x sum|msg|) of float64; max rel err "
                  f"kernel {kern_rel:.3e}, plain f32 {plain_rel:.3e}; "
                  f"kernel vs plain max |err| {err}")
            del exact, mag, slack
        check(torch.equal(got, again), f"[kernel] {kind}: two launches "
              f"bit-equal")
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 5)
        bms = bound_ms(kind, pg, blk)
        kernel_rows[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms)
        log(f"[kernel] {kind}: Q={Q} kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms, bound {bms:.4f} ms (bytes), {bms / ms:.1%} of bound")
        del x, got, again, want
    torch.cuda.empty_cache()

    scan_rows = {}
    scan_err = 0.0
    for mode, (semiring, early) in SCAN_MODES.items():
        which = "cc" if mode == "cc" else "fwd"
        tc = tcs[which]
        x = scan_inputs(mode, tc_graphs[which], tc, rng, dev)

        def scan(skip=None):
            return bottomup_scan_op(x["row_ptr"], x["col"], x["val"], x["x"],
                                    semiring=semiring, early_exit=early,
                                    skip=skip)

        def plain():
            return bottomup_scan_ref(x["row_ptr"], x["col"], x["val"],
                                     x["x"], semiring=semiring,
                                     early_exit=early)

        (y, cnt), (y2, cnt2), (want_y, want_cnt) = scan(), scan(), plain()
        y_s, cnt_s = scan(x["skip"])
        torch.cuda.synchronize()
        err = max_abs_err(y, want_y)
        scan_err = max(scan_err, err)
        check(torch.equal(y, want_y) and torch.equal(cnt, want_cnt),
              f"[kernel] bottomup {mode} ({semiring}, early exit {early}): "
              f"y and scanned bit-equal to the plain version (max |err| "
              f"{err}, scanned {int(cnt.sum())} of {Q * tc.nnz} slots)")
        check(torch.equal(y, y2) and torch.equal(cnt, cnt2)
              and torch.equal(y_s, y) and torch.equal(
                  cnt_s, torch.where(x["skip"] & early, 0, cnt)),
              f"[kernel] bottomup {mode}: two launches bit-equal; skip "
              f"zeroes only the counts")
        ms = cuda_ms(scan, 20)
        plain_ms = cuda_ms(plain, 5)
        bms = scan_bound_ms(x["x"], cnt, semiring)
        scan_rows[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms)
        log(f"[kernel] bottomup {mode}: Q={Q} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms (bytes), "
            f"{bms / ms:.1%} of bound")
        del x, y, y2, want_y, cnt, cnt2, want_cnt, y_s, cnt_s
    torch.cuda.empty_cache()

    # the hybrid kernels at the planner's split of RMAT20, Q=8
    hyb_rows = {}
    n = g.num_vertices
    for semiring, (cfg, arrs) in splits.items():
        x = ell_inputs(semiring, n, rng, dev)
        rp, col, val = arrs["row_ptr"], arrs["col"], arrs["val"]

        def ell(sr=semiring, x=x):
            return ell_spmv_op(rp, col, val, x, semiring=sr)

        def plain(sr=semiring, x=x):
            return ell_spmv_ref(rp, col, val, x, sr)

        got, again, want = ell(), ell(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if semiring == "plus_times":
            exact = ell_spmv_ref(rp, col, val.double(), x.double(), semiring)
            mag = ell_spmv_ref(rp, col, val.double().abs(),
                               x.double().abs(), semiring)
            depth = ell_sum_depth(cfg.kmax)
            check(within_f32_bound(got, exact, mag, depth),
                  f"[kernel] ell_spmv {semiring}: within its f32 bound "
                  f"({depth} roundings x 2^-24 x sum|terms|) of float64; max "
                  f"rel err kernel {max_rel_err(got.cpu(), exact.cpu()):.3e}"
                  f", plain f32 {max_rel_err(want.cpu(), exact.cpu()):.3e}")
            del mag
        else:
            check(torch.equal(got, want), f"[kernel] ell_spmv {semiring}: "
                  f"bit-equal to the plain version (max |err| {err})")
        check(torch.equal(got, again), f"[kernel] ell_spmv {semiring}: two "
              f"launches bit-equal")
        ms, plain_ms = cuda_ms(ell, 20), cuda_ms(plain, 5)
        lib_ms = None
        if semiring == "plus_times":
            # A row may repeat a column (multi-edges), which the CSR
            # invariant check rejects; the product adds repeats as the
            # kernel does.
            a = torch.sparse_csr_tensor(rp.long(), col.long(), val,
                                        size=(n, n), check_invariants=False)
            xt = x.t().contiguous()
            lib_ms = cuda_ms(lambda: torch.sparse.mm(a, xt), 20)
            lib_y = torch.sparse.mm(a, xt).t().cpu()
            log(f"[kernel] ell_spmv plus_times: torch.sparse.mm max rel err "
                f"vs float64 {max_rel_err(lib_y, exact.cpu()):.3e}")
            del a, xt, exact
        bms = ell_bound_ms(semiring, n, col.numel(), Q, n)
        hyb_rows[f"ell_{semiring}"] = dict(ms=ms, plain_ms=plain_ms,
                                           bound_ms=bms, library_ms=lib_ms,
                                           err=err)
        log(f"[kernel] ell_spmv {semiring}: Q={Q} nnz={col.numel()} kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"(bytes), {bms / ms:.1%} of bound"
            + ("" if lib_ms is None else
               f", torch.sparse.mm (CSR) {lib_ms:.4f} ms"))
        del x, got, again, want

    k = plan["k_dense"]
    for name, semiring in (("dense_spmv", "plus_times"),
                           ("dense_spmv_minplus", "min_plus")):
        cfg, arrs = splits[semiring]
        a = arrs["dense"]
        x = ell_inputs(semiring, k, rng, dev)
        op, ref = ((dense_spmv_op, dense_spmv_ref) if name == "dense_spmv"
                   else (dense_spmv_minplus_op, dense_spmv_minplus_ref))

        def kern(op=op, x=x, a=a):
            return op(x, a)

        def plain(ref=ref, x=x, a=a):
            return ref(x, a)

        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        if name == "dense_spmv":
            exact = dense_spmv_ref(x.double(), a.double())
            depth = dense_sum_depth(k)
            check(within_f32_bound(got, exact, exact, depth),
                  f"[kernel] dense_spmv: within its f32 bound ({depth} "
                  f"roundings) of float64; max rel err kernel "
                  f"{max_rel_err(got.cpu(), exact.cpu()):.3e}, plain f32 "
                  f"{max_rel_err(want.cpu(), exact.cpu()):.3e}")
            del exact
        else:
            check(torch.equal(got, want), "[kernel] dense_spmv_minplus: "
                  f"bit-equal to the plain version (max |err| {err})")
        check(torch.equal(got, again), f"[kernel] {name}: two launches "
              f"bit-equal")
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 5)
        lib_ms = None
        if name == "dense_spmv":
            torch.backends.cuda.matmul.allow_tf32 = False
            lib_ms = cuda_ms(lambda: torch.matmul(x, a), 20)
        bms = dense_bound_ms(Q, k, k)
        hyb_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              library_ms=lib_ms, err=err)
        log(f"[kernel] {name}: Q={Q} K=N={k} kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms (bytes), "
            f"{bms / ms:.1%} of bound"
            + ("" if lib_ms is None else
               f", torch.matmul (f32, no TF32) {lib_ms:.4f} ms"))
        del x, got, again, want
    torch.cuda.empty_cache()

    # -- phase 3: the main path at RMAT20 ------------------------------------
    sources = np.random.default_rng(SEED).choice(
        g.num_vertices, size=Q, replace=False)
    engines = {b: BSPEngine(pg, backend=b, block_e=BLOCK_E)
               for b in ("reference", "fused")}
    cc_engines = {b: BSPEngine(pgs, backend=b, block_e=BLOCK_E)
                  for b in ("reference", "fused")}
    runs = {
        "bfs_batched": lambda e, _: bfs_batched(e, sources),
        "sssp_batched": lambda e, _: sssp_batched(e, sources),
        "pagerank": lambda e, _: (pagerank(e, PR_ITERS), None),
        "betweenness_centrality": lambda e, _: betweenness_centrality(
            e, int(sources[0])),
        "connected_components": lambda _, c: connected_components(c),
    }
    counters = (kfs.fused_superstep, kbu.bottomup_scan)
    outs = {}
    for fn in counters:
        fn.launches = 0
    for name, run in runs.items():
        outs[name] = {}
        for backend in ("reference", "fused"):
            before = [fn.launches for fn in counters]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res, steps = run(engines[backend], cc_engines[backend])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            used = [fn.launches - b for fn, b in zip(counters, before)]
            peak = torch.cuda.max_memory_allocated() / 2**30
            outs[name][backend] = (np.asarray(res), np.asarray(steps))
            eng = (cc_engines if name == "connected_components"
                   else engines)[backend]
            stats = eng.last_direction_stats
            log(f"[main] {name} {backend}: {wall:.3f} s wall, steps "
                f"{np.asarray(steps).tolist()}, launches fused_superstep "
                f"{used[0]} bottomup_scan {used[1]}, peak {peak:.2f} GiB"
                + ("" if stats is None else
                   f", edges examined {stats['edges_examined'].tolist()}, "
                   f"switches {stats['switches'].tolist()}"))
            if backend == "fused":
                check(used[0] > 0, f"[main] {name}: fused run launched the "
                      f"fused kernel ({used[0]} times)")
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"[main] launches on the main path: {launches}")
    check(launches["bottomup_scan"] > 0, "[main] the bottom-up scan kernel "
          "launched on the main path")

    # yardsticks: plain push (no kernel) for the min algorithms, float64 on
    # the reference backend for the sums; the fused backend without the
    # direction vote, timed beside the main path's runs
    plain = BSPEngine(pg, direction_switch=False)
    plain_cc = BSPEngine(pgs, direction_switch=False)
    push = BSPEngine(pg, backend="fused", block_e=BLOCK_E,
                     direction_switch=False)
    push_cc = BSPEngine(pgs, backend="fused", block_e=BLOCK_E,
                        direction_switch=False)
    yardstick, exact_sums = {}, {}
    for name, run in runs.items():
        (r_res, r_steps) = outs[name]["reference"]
        (f_res, f_steps) = outs[name]["fused"]
        check(bool(np.isfinite(f_res).any()) and f_res.shape == r_res.shape,
              f"[main] {name}: output shape {f_res.shape}, finite values")
        same_steps = np.array_equal(f_steps, r_steps)
        if name in SUM_LIMITS:
            exact = (pagerank(engines["reference"], PR_ITERS,
                              dtype=torch.float64)
                     if name == "pagerank" else betweenness_centrality(
                         engines["reference"], int(sources[0]),
                         dtype=torch.float64)[0])
            exact_sums[name] = exact
            ref_rel = max_rel_err(r_res, exact)
            fus_rel = max_rel_err(f_res, exact)
            check(fus_rel <= SUM_LIMITS[name] and same_steps,
                  f"[main] {name}: fused max rel err vs float64 {fus_rel:.3e}"
                  f" <= {SUM_LIMITS[name]:.0e} (reference backend's "
                  f"{ref_rel:.3e}); fused vs reference max |diff| "
                  f"{np.max(np.abs(f_res - r_res)):.3e}; equal steps")
            continue
        p_res, p_steps = (np.asarray(a) for a in run(plain, plain_cc))
        yardstick[name] = (p_res, p_steps)
        u_res, u_steps = (np.asarray(a) for a in run(push, push_cc))
        check(np.array_equal(f_res, r_res) and same_steps
              and np.array_equal(f_res, p_res)
              and np.array_equal(f_steps, p_steps)
              and np.array_equal(u_res, p_res)
              and np.array_equal(u_steps, p_steps),
              f"[main] {name}: fused == reference == plain push == fused "
              f"push bit for bit, equal steps")

    # the direction vote end to end: the fused backend with it (the
    # default) and without, both warm, in turns (push, vote, vote, push)
    for name in ("bfs_batched", "sssp_batched", "connected_components"):
        sides = {"push": (push, push_cc),
                 "vote": (engines["fused"], cc_engines["fused"])}
        walls = {"push": [], "vote": []}
        for side in ("push", "vote", "vote", "push"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name](*sides[side])
            torch.cuda.synchronize()
            walls[side].append(time.perf_counter() - t0)
        log(f"[dir] {name} fused, in turns: push only "
            f"{walls['push'][0]:.4f} / {walls['push'][1]:.4f} s, with the "
            f"vote {walls['vote'][0]:.4f} / {walls['vote'][1]:.4f} s")
    del engines, cc_engines, plain_cc, push, push_cc
    torch.cuda.empty_cache()

    # BFS and SSSP forced to pull (early-exit and min_plus scans at RMAT20)
    pull = BSPEngine(pg, backend="fused", block_e=BLOCK_E, direction="pull")
    for name in ("bfs_batched", "sssp_batched"):
        before = kbu.bottomup_scan.launches
        res, steps = runs[name](pull, None)
        used = kbu.bottomup_scan.launches - before
        p_res, p_steps = yardstick[name]
        check(used > 0 and np.array_equal(res, p_res)
              and np.array_equal(steps, p_steps),
              f"[pull] {name} forced to pull on the fused backend: bit-equal "
              f"to plain push with equal steps ({used} scan launches, edges "
              f"examined {pull.last_direction_stats['edges_examined']})")
    del pull, plain
    torch.cuda.empty_cache()

    # -- phase 3, hybrid backend: the same entry points at RMAT20 -----------
    t0 = time.perf_counter()
    hybrids = {"vote": (hyb, BSPEngine(pgs, backend="hybrid")),
               "no switch": (BSPEngine(pg, backend="hybrid",
                                       direction_switch=False),
                             BSPEngine(pgs, backend="hybrid",
                                       direction_switch=False)),
               "pull": (BSPEngine(pg, backend="hybrid", direction="pull"),
                        BSPEngine(pgs, backend="hybrid", direction="pull"))}
    bc_mod = importlib.import_module("repro_torch.algorithms.bc")
    cc_prog = importlib.import_module("repro_torch.algorithms.cc").CC_PROGRAM
    for side, (eng, eng_cc) in hybrids.items():
        for prog in (bfs_mod.BFS_PROGRAM, sssp_mod.SSSP_PROGRAM):
            eng.hybrid_for(prog)
        eng_cc.hybrid_for(cc_prog)
    for prog in (bc_mod.FORWARD_PROGRAM, bc_mod.BACKWARD_PROGRAM):
        hyb.hybrid_for(prog)
    log(f"[host] hybrid engines and splits (vote, no switch, pull; CC "
        f"graph too) {time.perf_counter() - t0:.2f} s; CC graph k_dense="
        f"{hybrids['vote'][1].hybrid_plan()['k_dense']} kmax="
        f"{hybrids['vote'][1].hybrid_for(cc_prog)[0].kmax}, reverse kmax="
        f"{hyb.hybrid_for(bc_mod.BACKWARD_PROGRAM)[0].kmax}")
    hyb_counters = (kell.ell_spmv, kds.dense_spmv, kds.dense_spmv_minplus,
                    kbu.bottomup_scan, kfs.fused_superstep)
    for fn in hyb_counters:
        fn.launches = 0
    hyb_runs = [(side, name) for side in hybrids
                for name in ("bfs_batched", "sssp_batched",
                             "connected_components")]
    hyb_runs += [("vote", "pagerank"), ("vote", "betweenness_centrality")]
    hyb_out = {}
    for side, name in hyb_runs:
        before = [fn.launches for fn in hyb_counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, steps = runs[name](*hybrids[side])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res, steps = np.asarray(res), np.asarray(steps)
        hyb_out[side, name] = (res, steps)
        used = [fn.launches - b for fn, b in zip(hyb_counters, before)]
        eng = hybrids[side][1 if name == "connected_components" else 0]
        stats = eng.last_direction_stats
        log(f"[hybrid] {name} ({side}): {wall:.3f} s wall, steps "
            f"{steps.tolist()}, launches ell_spmv {used[0]} dense_spmv "
            f"{used[1]} dense_spmv_minplus {used[2]} bottomup_scan {used[3]}"
            + ("" if stats is None else
               f", edges examined {stats['edges_examined'].tolist()}, "
               f"switches {stats['switches'].tolist()}"))
        check(used[4] == 0, f"[hybrid] {name} ({side}): no fused launch")
        if name in SUM_LIMITS:
            r_steps = outs[name]["reference"][1]
            rel = max_rel_err(res, exact_sums[name])
            check(rel <= SUM_LIMITS[name] and np.array_equal(steps, r_steps),
                  f"[hybrid] {name}: max rel err vs float64 {rel:.3e} <= "
                  f"{SUM_LIMITS[name]:.0e}, equal steps")
        else:
            p_res, p_steps = yardstick[name]
            check(np.array_equal(res, p_res)
                  and np.array_equal(steps, p_steps),
                  f"[hybrid] {name} ({side}): bit-equal to plain push, "
                  f"equal steps")
    hyb_launches = {fn.__name__: fn.launches for fn in hyb_counters[:4]}
    log(f"[hybrid] launches on the hybrid path: {hyb_launches}")
    for name in ("ell_spmv", "dense_spmv", "dense_spmv_minplus"):
        check(hyb_launches[name] > 0, f"[hybrid] {name} launched on the "
              f"hybrid path ({hyb_launches[name]} times)")
    del hybrids, hyb, splits
    torch.cuda.empty_cache()

    # -- phase 4: the sharded engine, a world of one ------------------------
    graphs = {"pg": pg, "pgs": pgs}
    t0 = time.perf_counter()
    shards = {"vote": (DistributedBSPEngine(pg, backend="hybrid"),
                       DistributedBSPEngine(pgs, backend="hybrid")),
              "no switch": (DistributedBSPEngine(pg, backend="hybrid",
                                                 direction_switch=False),
                            DistributedBSPEngine(pgs, backend="hybrid",
                                                 direction_switch=False))}
    t_plan = time.perf_counter() - t0
    progs = {"bfs": bfs_mod.BFS_PROGRAM, "sssp": sssp_mod.SSSP_PROGRAM,
             "pagerank": programs["pagerank"], "cc": cc_prog,
             "bc_fwd": bc_mod.FORWARD_PROGRAM,
             "bc_bwd": bc_mod.BACKWARD_PROGRAM}
    t0 = time.perf_counter()
    for side, (eng, eng_cc) in shards.items():
        for name in ("bfs", "sssp", "pagerank", "bc_fwd", "bc_bwd"):
            eng.hybrid_for(progs[name])
        eng_cc.hybrid_for(cc_prog)
    t_split = time.perf_counter() - t0
    splan = shards["vote"][0].hybrid_plan()
    for label, eng in (("main", shards["vote"][0]), ("CC", shards["vote"][1])):
        for rec in eng.hybrid_plan()["per_shard"]:
            log(f"[shard] plan ({label} graph), shard {rec['shard']}: "
                f"|H|={rec['k_dense']} mode={rec['mode']} e_dense="
                f"{rec['e_dense']} e_sparse={rec['e_sparse']} "
                f"boundary_slots={rec['boundary_slots']:.0f} t_comm="
                f"{rec['t_comm']:.3e} s")
    log(f"[host] shard plans {t_plan:.2f} s, per-shard splits (vote and no "
        f"switch; forward min/min_plus/plus_times, reverse plus_times, CC "
        f"min) {t_split:.2f} s")

    # the outbox kernel on the sharded hybrid's boundary arrays
    shard_rows = {}
    shard_err = 0.0
    for name, (gname, rev, combine, wop, semiring) in OUTBOX_MODES.items():
        prog = progs[name]
        cache = splits_of(graphs[gname])
        ks = [r["k_dense"] for r in (shards["vote"][1] if gname == "pgs"
                                     else shards["vote"][0]
                                     ).hybrid_plan()["per_shard"]]
        shd = cache.shard_split(1, ks, rev, semiring,
                                prog.edge_msg.use_weight,
                                prog.combine == "min")
        b_src, b_flat, b_w = shd.boundary(0)
        src = torch.as_tensor(b_src, device=dev)
        flat = torch.as_tensor(b_flat, device=dev)
        w = (torch.as_tensor(b_w, device=dev) if wop is not None else None)
        x = ell_inputs(semiring, shd.n_max, rng, dev)
        kw = dict(num_slots=shd.num_slots, combine=combine, weight_op=wop)

        def kern(x=x, src=src, flat=flat, w=w, kw=kw):
            return outbox_reduce_op(x, src, flat, w, **kw)

        def plain(x=x, src=src, flat=flat, w=w, kw=kw):
            return outbox_reduce_ref(x, src, flat, w, **kw)

        got, again, want = kern(), kern(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        shard_err = max(shard_err, err)
        if combine == "min":
            check(torch.equal(got, want), f"[shard] outbox_reduce {name} "
                  f"({combine}, weight {wop}): bit-equal to the plain version"
                  f" (max |err| {err})")
        else:
            exact = outbox_reduce_ref(x.double(), src, flat, None, **kw)
            depth = outbox_sum_depth(b_flat, kob.BLOCK_E)
            check(within_f32_bound(got, exact, exact, depth),
                  f"[shard] outbox_reduce {name}: within its f32 bound "
                  f"({depth} roundings) of float64; max rel err kernel "
                  f"{max_rel_err(got.cpu(), exact.cpu()):.3e}, plain f32 "
                  f"{max_rel_err(want.cpu(), exact.cpu()):.3e}")
        check(torch.equal(got, again), f"[shard] outbox_reduce {name}: two "
              f"launches bit-equal")
        if combine == "min":
            # the vote's work count of the boundary leg: the engine weighs
            # each live vertex by its boundary out-degree instead of
            # gathering x over the edges
            b_deg = torch.as_tensor(np.bincount(b_src, minlength=shd.n_max),
                                    device=dev)

            def by_edge(x=x, src=src):
                return (x[:, src] != np.inf).sum(1)

            def by_vertex(x=x, b_deg=b_deg):
                return torch.where(x != np.inf, b_deg, 0).sum(1)

            check(torch.equal(by_edge(), by_vertex()),
                  f"[shard] {name}: the vote's boundary count by vertex "
                  f"equals the per-edge count ({by_vertex().tolist()}); "
                  f"{cuda_ms(by_vertex, 20):.4f} ms per superstep, per-edge "
                  f"gather {cuda_ms(by_edge, 20):.4f} ms")
            del b_deg
        ms, plain_ms = cuda_ms(kern, 20), cuda_ms(plain, 5)
        lib_ms = None
        if combine == "sum":
            # the same function as one library call: a CSR matrix
            # [num_slots, n_max] (rows = slots) times x^T; unchecked, since
            # a slot may repeat a source (RMAT multi-edges)
            crow = torch.searchsorted(flat.long(), torch.arange(
                shd.num_slots + 1, device=dev))
            a = torch.sparse_csr_tensor(
                crow, src.long(), torch.ones(len(b_src), device=dev),
                size=(shd.num_slots, shd.n_max), check_invariants=False)
            xt = x.t().contiguous()
            lib_ms = cuda_ms(lambda: torch.sparse.mm(a, xt), 20)
            lib_y = torch.sparse.mm(a, xt).t().cpu()
            log(f"[shard] outbox_reduce {name}: torch.sparse.mm max rel err"
                f" vs float64 {max_rel_err(lib_y, exact.cpu()):.3e}")
            del a, xt, exact
        bms = outbox_bound_ms(len(b_src), wop is not None, Q, shd.n_max,
                              shd.num_slots)
        shard_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                library_ms=lib_ms)
        log(f"[shard] outbox_reduce {name}: Q={Q} edges={len(b_src)} slots="
            f"{shd.num_slots} used={len(np.unique(b_flat))} kernel {ms:.4f}"
            f" ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms (bytes), "
            f"{bms / ms:.1%} of bound"
            + ("" if lib_ms is None else
               f", torch.sparse.mm (CSR) {lib_ms:.4f} ms"))
        del x, got, again, want, src, flat, w
    torch.cuda.empty_cache()

    # the sharded hybrid through the entry points
    shard_counters = (kob.outbox_reduce, kell.ell_spmv, kds.dense_spmv,
                      kds.dense_spmv_minplus, kbu.bottomup_scan,
                      kfs.fused_superstep)
    for fn in shard_counters:
        fn.launches = 0
    shard_runs = [(side, name) for side in shards
                  for name in ("bfs_batched", "sssp_batched",
                               "connected_components")]
    shard_runs += [("vote", "pagerank"), ("vote", "betweenness_centrality")]
    shard_out = {}
    for side, name in shard_runs:
        before = [fn.launches for fn in shard_counters]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, steps = runs[name](*shards[side])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res, steps = np.asarray(res), np.asarray(steps)
        shard_out[side, name] = res
        used = [fn.launches - b for fn, b in zip(shard_counters, before)]
        eng = shards[side][1 if name == "connected_components" else 0]
        stats = eng.last_direction_stats
        log(f"[shard] {name} ({side}): {wall:.3f} s wall, steps "
            f"{steps.tolist()}, launches outbox_reduce {used[0]} ell_spmv "
            f"{used[1]} dense_spmv {used[2]} dense_spmv_minplus {used[3]} "
            f"bottomup_scan {used[4]}"
            + ("" if stats is None else
               f", edges examined {stats['edges_examined'].tolist()}, "
               f"switches {stats['switches'].tolist()}"))
        check(used[5] == 0, f"[shard] {name} ({side}): no fused launch")
        if name in SUM_LIMITS:
            rel = max_rel_err(res, exact_sums[name])
            h_res, h_steps = hyb_out[side, name]
            check(rel <= SUM_LIMITS[name] and np.array_equal(steps, h_steps),
                  f"[shard] {name}: max rel err vs float64 {rel:.3e} <= "
                  f"{SUM_LIMITS[name]:.0e}, equal steps (single-device "
                  f"hybrid {max_rel_err(h_res, exact_sums[name]):.3e})")
        else:
            h_res, h_steps = hyb_out[side, name]
            check(np.array_equal(res, h_res)
                  and np.array_equal(steps, h_steps),
                  f"[shard] {name} ({side}): bit-equal to the single-device "
                  f"hybrid, equal steps")
    shard_launches = {fn.__name__: fn.launches for fn in shard_counters}
    log(f"[shard] launches on the sharded path: {shard_launches}")
    check(shard_launches["outbox_reduce"] > 0, f"[shard] outbox_reduce "
          f"launched on the sharded path ({shard_launches['outbox_reduce']} "
          f"times)")
    check(np.array_equal(pr_mod.pagerank_distributed(shards["vote"][0],
                                                     PR_ITERS),
                         shard_out["vote", "pagerank"]),
          "[shard] pagerank_distributed (the converge loop with a vote that "
          "never finishes) bit-equal to pagerank (num_steps)")
    del shards
    torch.cuda.empty_cache()

    # the sharded reference and fused backends at world one on BFS
    for backend in ("reference", "fused"):
        eng = DistributedBSPEngine(pg, backend=backend, block_e=BLOCK_E)
        before = kfs.fused_superstep.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, steps = runs["bfs_batched"](eng, None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        p_res, p_steps = yardstick["bfs_batched"]
        used = kfs.fused_superstep.launches - before
        check(np.array_equal(res, p_res) and np.array_equal(steps, p_steps)
              and (used > 0) == (backend == "fused"),
              f"[shard] bfs_batched on the sharded {backend} backend: "
              f"bit-equal to BSPEngine, equal steps ({wall:.3f} s wall, "
              f"{used} fused launches)")
        del eng
    torch.cuda.empty_cache()

    # -- phase 5: numpy oracles at RMAT12 on the card ------------------------
    small = G.rmat(12, 16, seed=SEED)
    sw = small.with_uniform_weights(seed=SEED)
    ss = symmetrize(small)
    eng = BSPEngine(PT.partition(sw, 2, PT.HIGH, include_reverse=True),
                    fused=True, block_e=BLOCK_E)
    cc_eng = BSPEngine(PT.partition(ss, 2, PT.HIGH), fused=True,
                       block_e=BLOCK_E)
    lv, _ = bfs_batched(eng, [0, 1])
    check(np.array_equal(lv[1], bfs_reference(small, 1)),
          "[oracle] rmat12 bfs == bfs_reference")
    dist, _ = sssp_batched(eng, [0, 1])
    check(np.allclose(dist[1], sssp_reference(sw, 1), rtol=1e-5),
          "[oracle] rmat12 sssp within rtol=1e-5 of sssp_reference")
    check(np.allclose(pagerank(eng, PR_ITERS),
                      pagerank_reference(small, PR_ITERS),
                      rtol=1e-4, atol=1e-7),
          "[oracle] rmat12 pagerank within rtol=1e-4, atol=1e-7")
    bc, _ = betweenness_centrality(eng, 0)
    check(np.allclose(bc, bc_reference(small, 0), rtol=1e-3, atol=1e-3),
          "[oracle] rmat12 bc within rtol=1e-3, atol=1e-3 of bc_reference")
    labels, _ = connected_components(cc_eng)
    check(np.array_equal(labels, cc_reference(ss)),
          "[oracle] rmat12 cc == cc_reference")
    eng = BSPEngine(PT.partition(sw, 2, PT.HIGH), backend="hybrid")
    cc_eng = BSPEngine(PT.partition(ss, 2, PT.HIGH), backend="hybrid")
    lv, _ = bfs_batched(eng, [0, 1])
    dist, _ = sssp_batched(eng, [0, 1])
    bc, _ = betweenness_centrality(eng, 0)
    labels, _ = connected_components(cc_eng)
    check(np.array_equal(lv[1], bfs_reference(small, 1))
          and np.allclose(dist[1], sssp_reference(sw, 1), rtol=1e-5)
          and np.allclose(pagerank(eng, PR_ITERS),
                          pagerank_reference(small, PR_ITERS),
                          rtol=1e-4, atol=1e-7)
          and np.allclose(bc, bc_reference(small, 0), rtol=1e-3, atol=1e-3)
          and np.array_equal(labels, cc_reference(ss)),
          f"[oracle] rmat12 on the hybrid backend (k_dense="
          f"{eng.hybrid_plan()['k_dense']}, {eng.hybrid_plan()['mode']}): "
          f"bfs, cc exact; sssp, pagerank, bc within the tolerances above "
          f"(no include_reverse: the backend splits the reverse graph)")

    if check.failed:
        log(f"FAILED {len(check.failed)} check(s):")
        for what in check.failed:
            log("  " + what)
        return 1
    rows = {"fused_superstep": (kernel_rows["bfs"], worst_err),
            "bottomup_scan": (scan_rows["cc"], scan_err),
            "ell_spmv": (hyb_rows["ell_plus_times"], max(
                hyb_rows[f"ell_{sr}"]["err"] for sr in ELL_MODES)),
            "dense_spmv": (hyb_rows["dense_spmv"],
                           hyb_rows["dense_spmv"]["err"]),
            "dense_spmv_minplus": (hyb_rows["dense_spmv_minplus"],
                                   hyb_rows["dense_spmv_minplus"]["err"]),
            "outbox_reduce": (shard_rows["pagerank"], shard_err)}
    launches.update(
        (name, hyb_launches[name]) for name in ("ell_spmv", "dense_spmv",
                                                "dense_spmv_minplus"))
    launches["outbox_reduce"] = shard_launches["outbox_reduce"]
    record = {"kernels": [dict(
        name=name, route="cuda", source=KERNELS[name][0],
        replaces=KERNELS[name][1], launches=launches[name],
        max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by="bytes",
        library_ms=row.get("library_ms"))
        for name, (row, err) in rows.items()]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
