#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card, the CUDA toolkit (``nvcc``) and the checkout's ``src/``; without a
card, or alone in a directory, it exits non-zero before printing a result.

Phases (any failed check exits non-zero; nothing is caught and passed over):

1. device check and kernel build, one ``nvcc`` per kernel, all started
   together (``-Xptxas -v`` reports printed, with each library's spill
   stores; the flash library must spill nothing and hold tensor-core
   instructions, counted in ``cuobjdump -sass``: ``HGMMA`` for ``wgmma``);
2. each kernel against its plain PyTorch version on the card at the main
   path's shapes: RMAT20 (``totem_rmat.RMAT_MEDIUM``, 2^20 vertices, 16
   edges each), 2 partitions, HIGH, ``block_e=1024``, reverse edges, Q=8.
   The fused superstep for all six message kinds: min kinds bit for bit,
   sum kinds against a float64 evaluation of the plain version within the
   kernel's own f32 error bound (below).  The bottom-up scan on the
   engine's transposed rows with their row plan, in its three modes (BFS's
   early exit, CC's min, SSSP's min_plus): bit for bit, counts included,
   on ``x`` and on the engine's query-minor view of it; timed as the op
   with its own query-minor copy of ``x``, given the view, and the copy
   alone.  Two launches of each bit-equal;
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
   of float64, two launches bit-equal, on ``x`` and on the engine's
   query-minor view; timed as the op with its own copy of ``x``, given the
   view, and the copy alone, beside its bound, its plain version and, for
   plus_times, ``torch.sparse.mm``); the sharded hybrid
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
   fused and the hybrid backends;
6. ``[segment_reduce]``: the sorted segment reduce through its entry point
   (``ops.segment_reduce_op``) on partition 0's sorted forward ``dst_ext``
   at RMAT20 / P=2 / HIGH with messages made from the seed, one row and
   Q=8 rows, sum and min: min bit for bit, sum within its f32 bound of
   float64, two launches bit-equal, the identity in the empty segments;
   the kernel timed cold (L2 flushed), warm with the host ahead and
   host-paced, beside its bytes bound, its plain version and
   ``torch.segment_reduce`` (one call a row);
7. ``[lm]``: the LM serving path, tinyllama-1.1b at full width (22 layers,
   d_model 2048, GQA 32/4, random weights from a generator seeded 0, bf16
   compute) through ``models.api.build`` and the serve launcher's
   ``generate``: a B=4, S=2048 Zipf prompt, prefill, 32 greedy tokens; the
   flash kernel must launch once per layer in the prefill.  Checks: the
   flash kernel against its plain version at the layer's shapes (bf16
   within the bound of rounding P and the output to bf16,
   ``bf16_bound_ratio``; f32 within 1e-4; window 0 and 1024); decode
   after ``prefill(2048)`` against ``prefill(2049)`` at f32 compute within
   the JAX test's 2e-3 and at bf16 within 0.1 + 0.05 |logit|; f32 prefill logits (B=1, S=256) against a
   float64 run of the same forward assembled from the plain functions.
   Timed: prefill and decode wall and tok/s beside their bounds, the flash
   kernel beside its operations bound, its plain version and
   ``scaled_dot_product_attention`` (the yardstick only; the port never
   calls it).

Phase 2 also holds the hybrid kernels at the planner's RMAT20 split (|H|,
Q=8): ``ell_spmv`` in its three semirings on the forward remainder with the
split's row plan, as the engine calls it (min and min_plus bit for bit,
plus_times within its f32 bound of float64; the query-minor copy of ``x``
and the kernel timed apart; ``scripts/ell_ablation.py`` times the kernel
on query-major ``x``),
``dense_spmv`` within its bound and ``dense_spmv_minplus`` bit for bit,
both and ``torch.matmul`` timed with the L2 flushed before each launch
(a 256 MB write; the engine finds the dense block cold, after
``ell_spmv`` has read its 100+ MB of rows) and warm, with the ratio to
``torch.matmul`` both ways.  The fused kernel is timed as the op (its
query-minor copy of the state included), and the copy and the kernel
apart; ``scripts/fused_ablation.py`` times variants of its source.  The
``[build]`` lines give every fused, dense, outbox, scan and segment-reduce
kernel's registers and spill stores (the dense kernel is one template,
``dense_spmv_kernel<MODE, kVec>``, for both semirings), and check that
the fused library spills no more than 40 bytes and the outbox, scan,
dense and segment-reduce libraries nothing;
``scripts/scan_outbox_ablation.py`` and
``scripts/minplus_segment_ablation.py`` time variants of those sources.

Why sums are held to float64 and not to the plain f32 version: at RMAT20 a
hub sums ~10^4-10^5 messages, and two f32 summation orders (the kernel's
fixed order, the plain version's atomics) differ by up to ~1e-5 relative,
beyond the 1e-6 the scale-10 tests use.  The kernel's sum is a fixed tree:
at most ``block_e/128`` sequential adds in a thread, 5 warp-scan levels, 4
adds across warps, one carry, and two adds per block a segment spans in the
merge, plus two roundings of the message itself; so its error is at most
``depth * 2^-24 * sum|messages|`` with that depth.

The hybrid kernels' sums are fixed trees too: ``ell_spmv`` follows its
row plan, a row of a run adding at most 64 products in a lane then a
butterfly over at most 32 lanes (5 levels), a longer row 8 products in a
thread, a warp (5) and block (3) tree per 2048-slot chunk and the chunks
in order; ``dense_spmv`` 32 products in a lane, the 8 warps of a block,
then the 256-row slices in order.  ``outbox_reduce``
takes the fused kernel's tree (``block_e/128`` adds in a thread, the warp
scan and fold, a carry, two adds per block a slot spans) plus the message.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import math
import re
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
BF16_OPS_PER_S = 989e12      # H100 SXM, dense bf16 tensor cores
UNIT_ROUNDOFF = 2.0 ** -24
FLUSH_BYTES = 256 * 2**20    # written before each cold launch: 5x the L2
FUSED_SPILL_LIMIT = 40       # bytes of spill stores (the fused library)
SLEEP_CYCLES = 10 ** 7       # ~5 ms at 1.98 GHz: the host enqueues meanwhile
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
    "segment_reduce": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce.py:67"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:87"),
}
# the LM serving phase: tinyllama-1.1b at full width, the serve launcher's
# batch, the model's own context length as the prompt, 32 new tokens
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 32
LM_WINDOWS = (0, 1024)       # full causal, and gemma3's local window
# flash kernel vs its plain version in f32 (f32 statistics on both sides);
# in bf16 both round each P value and the output, so the limit is the
# rounding bound (bf16_bound_ratio)
FLASH_F32_TOL = dict(rtol=1e-4, atol=1e-5)
BF16_UNIT_ROUNDOFF = 2.0 ** -8
# decode after prefill(t) vs prefill(t + 1), |diff| <= atol + rtol |logit|:
# at f32 compute the JAX test's tolerance (tests/test_models.py), at bf16
# the CPU parity tests' (tests/test_torch_lm.py; measured here: 0.0625 on
# logits up to 4.3)
DECODE_TOL = {"f32": (2e-3, 2e-3), "bf16": (0.1, 0.05)}
# f32 prefill logits vs a float64 run of the same forward, max |diff| over
# max |logit|
F64_REL = 1e-3
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


def cuda_ms_cold(fn, reps: int, flush) -> float:
    """Median time of ``fn`` from CUDA events around each launch alone,
    with ``flush`` (a write of ``FLUSH_BYTES``) before each: ``fn``'s
    inputs start in device memory, not in the L2.  The median, since the
    write-back of the flushed lines varies from launch to launch."""
    import torch
    fn()
    pairs = []
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return (times[(reps - 1) // 2] + times[reps // 2]) / 2


def cuda_ms_ahead(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls back to back: a sleep
    on the stream lets the host enqueue every call before the first runs,
    so the host's time between launches does not show (``cuda_ms`` shows
    it where a call's host work outlasts its kernel)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(build_log: str, cufilt=None):
    """Each function's ``(name, registers, spill stores in bytes)`` from an
    ``nvcc -Xptxas -v`` log, names demangled with ``cufilt`` where given
    (entry functions carry registers; other functions None)."""
    rows, name = [], None
    for line in build_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name is not None:
            rows.append([name, None, int(m.group(1))])
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and rows and rows[-1][1] is None:
            rows[-1][1] = int(m.group(1))
    if cufilt is not None and rows:
        out = subprocess.run([str(cufilt)],
                             input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            for r, n in zip(rows, names):
                r[0] = n
    return [tuple(r) for r in rows]


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
    """Roundings on the longest path of ``ell_spmv``'s sum of a row of up
    to ``kmax`` slots (``csrc/ell_spmv.cu``): in a run, ``LANE_RUN`` adds
    in a lane, 5 butterfly levels and the product; in chunks,
    ``BUDGET / THREADS`` adds in a thread, 5 warp and 3 block levels, the
    chunk partials in order and the product."""
    from repro_torch.kernels import ell_spmv as kell
    return max(kell.LANE_RUN + 6, kell.BUDGET // kell.THREADS + 8
               + -(-kmax // kell.BUDGET))


def dense_sum_depth(k) -> int:
    """Roundings of ``dense_spmv``'s sum over ``k`` (``csrc/dense_spmv.cu``):
    32 products in a lane, the 8 warps of a block in order, the
    ``ceil(k / 256)`` slices in order, and the product."""
    return 32 + 8 + -(-k // 256) + 1


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


def bf16_bound_ratio(got, want, q, k, v, window, causal=True) -> float:
    """Largest |got - want| / (2 * 2^-8 * (|want| + sum p|v| / l)) of the
    bf16 flash kernel against its plain version.  Both round each
    P value (weight p / l of its row of V) and the output to bf16, each
    rounding off by at most 2^-8 relative; ``sum p|v| / l`` is the plain
    version on |v| in f32.  At most 1 (1.01 with slack) by design."""
    from repro_torch.kernels.ref import flash_attention_ref
    mag = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                              causal=causal, window=window)
    want = want.float()
    limit = 2 * BF16_UNIT_ROUNDOFF * (want.abs() + mag)
    return float(((got.float() - want).abs() / limit).max())


def within_f32_bound(got, exact, mag, depth) -> bool:
    """|got - exact| <= depth * 2^-24 * sum|terms| everywhere."""
    slack = (got.double() - exact).abs() - 1.01 * depth * UNIT_ROUNDOFF * mag
    return bool((slack <= 0).all())


def segment_reduce_phase(pg, rng, dev, check):
    """``[segment_reduce]``: the sorted segment reduce on partition 0's
    sorted ``dst_ext`` (its real forward edges) at RMAT20 / P=2 / HIGH,
    messages made from the seed (one row, and Q rows over the same ids),
    through ``ops.segment_reduce_op`` (the op's entry point, its only
    path), in sum and min.  Min bit for bit against the plain version, sum
    within its f32 bound of float64, two launches bit-equal, empty segments
    the identity; the kernel (with the wrapper's identity pre-fill) timed
    cold (L2 flushed), warm with the host ahead and host-paced, beside its
    bytes bound, the plain version and ``torch.segment_reduce`` (one call
    a row: a loop over the Q rows).  Returns ``(rows by (Q, combine), max
    |err|, launches on the path)``."""
    import numpy as np
    import torch

    from repro_torch.kernels import segment_reduce as ksr
    from repro_torch.kernels.ops import segment_reduce_op
    from repro_torch.kernels.ref import identity, segment_reduce_ref

    n = int(pg.fwd.num_edges[0])
    ids_np = np.sort(pg.fwd.dst_ext[0, :n]).astype(np.int32)
    seg = pg.seg_count
    ids = torch.as_tensor(ids_np, device=dev)
    ids64 = ids.long()
    msgs_by_q = {q: torch.as_tensor(rng.normal(size=(q, n)).astype(
        np.float32), device=dev) for q in (1, Q)}
    msgs_by_q[1] = msgs_by_q[1][0]          # the op's [E] form
    empty = torch.as_tensor(np.setdiff1d(np.arange(seg), ids_np), device=dev)
    lengths = torch.bincount(ids64, minlength=seg)
    depth = outbox_sum_depth(ids_np, ksr.BLOCK_E) - 1
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():
        scratch.fill_(1.0)

    ksr.segment_reduce.launches = 0
    outs = {(q, c): segment_reduce_op(m, ids, seg, combine=c)
            for q, m in msgs_by_q.items() for c in ("sum", "min")}
    torch.cuda.synchronize()
    launches = ksr.segment_reduce.launches
    check(launches == len(outs), f"[segment_reduce] the op launched the "
          f"kernel once per call ({launches} launches for sum and min at "
          f"Q=1 and Q={Q})")
    rows, worst = {}, 0.0
    for (q, combine), got in outs.items():
        msgs = msgs_by_q[q]
        m2 = msgs.reshape(-1, n)

        def kern(c=combine, m2=m2):
            return ksr.segment_reduce(m2, ids, num_segments=seg, combine=c)

        def plain(c=combine, msgs=msgs):
            return segment_reduce_ref(msgs, ids64, seg, c)

        def library(c=combine, m2=m2):
            return torch.stack([torch.segment_reduce(
                row, c, lengths=lengths, unsafe=True, initial=identity(c))
                for row in m2])

        again, want = kern().reshape(got.shape), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        what = f"[segment_reduce] Q={q} {combine}"
        if combine == "min":
            check(torch.equal(got, want), f"{what}: bit-equal to the plain "
                  f"version (max |err| {err})")
        else:
            exact = segment_reduce_ref(msgs.double(), ids64, seg, "sum")
            mag = segment_reduce_ref(msgs.double().abs(), ids64, seg, "sum")
            check(within_f32_bound(got, exact, mag, depth),
                  f"{what}: within its f32 bound ({depth} roundings x 2^-24 "
                  f"x sum|msg|) of float64; max |err| vs float64 kernel "
                  f"{max_abs_err(got, exact):.3e}, plain f32 "
                  f"{max_abs_err(want, exact):.3e}")
            del exact, mag
        check(torch.equal(got, again) and bool(
            (got[..., empty] == identity(combine)).all()),
            f"{what}: two launches bit-equal; the {len(empty)} empty "
            f"segments hold the identity")
        lib_err = max_abs_err(library().reshape(got.shape), got)
        cold = cuda_ms_cold(kern, 20, flush)
        ahead, paced = cuda_ms_ahead(kern, 50), cuda_ms(kern, 20)
        plain_ms, lib_ms = cuda_ms(plain, 5), cuda_ms(library, 20)
        bms = 1e3 * (4 * n + 4 * q * n + 4 * q * seg) / HBM_BYTES_PER_S
        rows[q, combine] = dict(ms=cold, plain_ms=plain_ms, bound_ms=bms,
                                library_ms=lib_ms, bound_by="bytes")
        log(f"{what}: E={n} segments={seg} (used {seg - len(empty)}) "
            f"kernel {cold:.4f} ms cold, {ahead:.4f} ms warm with the host "
            f"ahead, {paced:.4f} ms host-paced (the wrapper's allocations "
            f"and ctypes call included); plain {plain_ms:.4f} ms; bound "
            f"{bms:.4f} ms (bytes), {bms / cold:.1%} of bound cold, "
            f"{bms / ahead:.1%} warm; torch.segment_reduce (one call a row) "
            f"{lib_ms:.4f} ms (max |diff| vs kernel {lib_err:.3e})")
    del scratch
    return rows, worst, launches


def lm_forward64(module, tokens):
    """The prefill's last-token logits in float64, assembled from the
    port's plain functions (``rms_norm``, ``rope``, ``flash_attention_ref``)
    and ``module``'s weights: the yardstick of the f32 prefill."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.common import rms_norm, rope

    cfg = module.cfg
    b, s = tokens.shape
    g, hd = cfg.n_kv_heads, cfg.hd
    r = cfg.n_heads // g
    pos = torch.arange(s, device=tokens.device)[None]
    x = module.embed.double()[tokens] * math.sqrt(cfg.d_model)
    for layer in module.layers:
        w = {n: p.double() for n, p in layer.named_parameters()}
        h = rms_norm(x, w["norm1"], cfg.norm_eps)
        q = rope((h @ w["wq"]).reshape(b, s, g, r, hd), pos, cfg.rope_theta)
        k = rope((h @ w["wk"]).reshape(b, s, g, hd), pos, cfg.rope_theta)
        v = (h @ w["wv"]).reshape(b, s, g, hd)
        o = flash_attention_ref(q, k, v, causal=True, window=layer.window)
        x = x + o.reshape(b, s, -1) @ w["wo"]
        h = rms_norm(x, w["norm2"], cfg.norm_eps)
        x = x + (F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]
    x = rms_norm(x[:, -1:], module.final_norm.double(), cfg.norm_eps)
    head = module.embed.t() if cfg.tie_embeddings else module.lm_head
    return (x @ head.double())[:, 0]


def lm_phase(dev, check):
    """``[lm]``: tinyllama-1.1b at full width, random weights from a
    generator seeded 0, bf16 compute, through ``models.api.build`` and the
    serve launcher's ``generate``: a B=4, S=2048 Zipf prompt
    (``TokenStream(seed=0).batch_at(0)``) and 32 greedy tokens.  Checks:
    (a) the flash kernel against its plain version at the layer's shapes,
    bf16 and f32, window 0 and 1024; (b) decode after ``prefill(t)``
    against ``prefill(t + 1)`` at full width; (c) f32 prefill logits at
    B=1, S=256 against a float64 run of the same forward.  Returns
    ``(flash row, max |err|, launches per prefill)``."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import tinyllama_1_1b as TL
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch.serve import generate
    from repro_torch.models import api
    from repro_torch.models.transformer import layer_param_shapes

    torch.backends.cuda.matmul.allow_tf32 = False    # f32 products in f32
    cfg = TL.CONFIG
    b, s, n_gen = LM_BATCH, LM_PROMPT, LM_GEN
    g, hd = cfg.n_kv_heads, cfg.hd
    r = cfg.n_heads // g
    t0 = time.perf_counter()
    model = api.build(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.module.parameters())
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {g} KV heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {n_params} parameters ({cfg.compute_dtype}), built "
        f"in {time.perf_counter() - t0:.2f} s")
    check(n_params == 1_100_048_384, f"[lm] full width: {n_params} "
          f"parameters (1,100,048,384)")
    tokens = TokenStream(cfg, b, s, seed=0).batch_at(0)["tokens"].to(dev)
    prompt = tokens[:, :s]

    # the serve path: warm once (cuBLAS handles), then the measured run
    generate(model, prompt[:, :128], 2)
    torch.cuda.reset_peak_memory_stats()
    kfa.flash_attention.launches = 0
    res = generate(model, prompt, n_gen)
    launches = kfa.flash_attention.launches
    out = res["tokens"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(out.shape == (b, n_gen) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab,
          f"[lm] generated tokens [{b}, {n_gen}] in the vocabulary")
    check(launches == cfg.n_layers, f"[lm] the flash kernel launched "
          f"{launches} times in the prefill (one per layer, {cfg.n_layers})")
    weights = cfg.n_layers * sum(math.prod(shape) for name, shape in
                                 layer_param_shapes(cfg).items()
                                 if not name.startswith("norm"))
    pairs = s * (s + 1) // 2
    attn_flops = 4 * hd * pairs * b * cfg.n_heads
    attn_bytes = 2 * (2 * b * s * cfg.n_heads * hd + 2 * b * s * g * hd)
    attn_bound = 1e3 * max(attn_flops / BF16_OPS_PER_S,
                           attn_bytes / HBM_BYTES_PER_S)
    mm_flops = 2 * b * s * weights + 2 * b * cfg.d_model * cfg.vocab
    prefill_bound = 1e3 * mm_flops / BF16_OPS_PER_S + cfg.n_layers * attn_bound
    # a step reads every weight but the embedding table's unused rows, and
    # the live KV cache (its mean length over the steps)
    unread = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    step_bytes = (2 * (n_params - unread)
                  + 2 * 2 * cfg.n_layers * b * (s + n_gen // 2) * g * hd)
    step_bound = 1e3 * step_bytes / HBM_BYTES_PER_S
    steps = n_gen - 1
    log(f"[lm] prefill: {b * s} tokens in {res['prefill_s'] * 1e3:.1f} ms "
        f"({b * s / res['prefill_s']:.0f} tok/s); bound {prefill_bound:.2f} "
        f"ms ({mm_flops / 1e12:.2f} TFLOP of products at 989 TFLOP/s plus "
        f"{cfg.n_layers} x {attn_bound:.4f} ms of attention)")
    log(f"[lm] decode: {b * steps} tokens in {res['decode_s'] * 1e3:.1f} ms "
        f"({b * steps / res['decode_s']:.0f} tok/s, "
        f"{res['decode_s'] * 1e3 / steps:.3f} ms per step); bound "
        f"{step_bound:.3f} ms per step (weights and live cache at 3.35 TB/s)"
        f"; peak {peak:.2f} GiB; first tokens {out[0, :8].tolist()}")

    # (a) the flash kernel at the layer's shapes
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q32 = torch.randn(b, s, g, r, hd, generator=gen, device=dev)
    k32 = torch.randn(b, s, g, hd, generator=gen, device=dev)
    v32 = torch.randn(b, s, g, hd, generator=gen, device=dev)
    worst = 0.0
    for dtype in ("bfloat16", "float32"):
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q32, k32, v32))
        for window in LM_WINDOWS:
            got = kfa.flash_attention(q, k, v, causal=True, window=window)
            again = kfa.flash_attention(q, k, v, causal=True, window=window)
            want = flash_attention_ref(q, k, v, causal=True, window=window)
            err = max_abs_err(got, want)
            if dtype == "bfloat16":
                worst = max(worst, err)
                ratio = bf16_bound_ratio(got, want, q, k, v, window)
                ok, limit = ratio <= 1.01, (
                    f"its rounding bound (largest |err| / bound {ratio:.4f})")
            else:
                ok = torch.allclose(got, want, **FLASH_F32_TOL)
                limit = f"{FLASH_F32_TOL}"
            check(ok and torch.equal(got, again),
                  f"[lm] flash kernel {dtype}, window {window}: within "
                  f"{limit} of the plain version (max |err| {err:.3e}), two "
                  f"launches bit-equal")
    q, k, v = (t.bfloat16() for t in (q32, k32, v32))
    del q32, k32, v32

    def kern():
        return kfa.flash_attention(q, k, v, causal=True)

    def plain():
        return flash_attention_ref(q, k, v, causal=True)

    qh = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                              enable_gqa=True)

    lib_err = max_abs_err(library().transpose(1, 2).reshape(q.shape), kern())
    ms, plain_ms, lib_ms = cuda_ms(kern, 10), cuda_ms(plain, 3), cuda_ms(
        library, 20)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=attn_bound,
               library_ms=lib_ms, bound_by="operations")
    log(f"[lm] flash kernel (bf16, causal, q [{b}, {s}, {g}, {r}, {hd}]): "
        f"{ms:.4f} ms per launch, {launches} launches per prefill; plain "
        f"{plain_ms:.4f} ms; bound {attn_bound:.4f} ms (operations: "
        f"{attn_flops / 1e9:.1f} GFLOP at 989 TFLOP/s; bytes "
        f"{attn_bytes / 1e6:.1f} MB), {attn_bound / ms:.1%} of bound, "
        f"{attn_flops / ms / 1e9:.1f} TFLOP/s; scaled_dot_product_attention "
        f"{lib_ms:.4f} ms (max |diff| vs kernel {lib_err:.3e})")
    del q, k, v, qh, kh, vh

    # (b) decode after prefill(t) against prefill(t + 1), at full width
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model32 = api.build(cfg32, dev, torch.Generator(device=dev).manual_seed(0))
    for name, m in (("bf16", model), ("f32", model32)):
        _, cache = m.prefill({"tokens": prompt}, max_len=s + 1)
        lg_dec, _ = m.decode_step(cache, tokens[:, s])
        del cache
        lg_full, _ = m.prefill({"tokens": tokens})
        diff = (lg_dec.float() - lg_full.float()).abs()
        top = lg_full.float().abs().max()
        same = bool((lg_dec.argmax(-1) == lg_full.argmax(-1)).all())
        atol, rtol = DECODE_TOL[name]
        check(bool((diff <= atol + rtol * lg_full.float().abs()).all()),
              f"[lm] decode after prefill({s}) vs prefill({s + 1}), {name}: "
              f"max |diff| {float(diff.max()):.3e} (max |logit| "
              f"{float(top):.3f}) within atol {atol} + rtol {rtol}; greedy "
              f"tokens equal: {same}")

    # (c) f32 prefill logits against float64, B=1, S=256
    short = tokens[:1, :256]
    lg32, _ = model32.prefill({"tokens": short})
    with torch.inference_mode():
        lg64 = lm_forward64(model32.module, short)
    rel = float((lg32.double() - lg64).abs().max() / lg64.abs().max())
    check(rel <= F64_REL and bool(torch.isfinite(lg32).all()),
          f"[lm] f32 prefill logits (B=1, S=256) vs float64: max |diff| / "
          f"max |logit| {rel:.3e} <= {F64_REL:.0e}")
    del model, model32
    torch.cuda.empty_cache()
    return row, worst, launches


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
        from repro_torch.kernels import flash_attention as kfa
        from repro_torch.kernels import outbox_reduce as kob
        from repro_torch.kernels import segment_reduce as ksr
        from repro_torch.kernels.ops import (bottomup_scan_op,
                                             dense_spmv_minplus_op,
                                             dense_spmv_op, ell_spmv_op,
                                             fused_superstep_op,
                                             outbox_reduce_op)
        from repro_torch.kernels.ref import (SEMIRINGS, bottomup_scan_ref,
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
                              kds.SOURCE, kob.SOURCE, ksr.SOURCE,
                              kfa.SOURCE])
    log(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    spills = {}
    for name, (path, build_log) in built.items():
        log(f"[build] {path.name}")
        log(build_log.strip())
        spills[name] = sum(int(n) for n in re.findall(
            r"(\d+) bytes spill stores", build_log))
    log(f"[build] spill stores in bytes, summed over each library's "
        f"kernels: {spills}")
    check(spills[kfa.SOURCE] == 0, f"[build] the flash library spills "
          f"nothing ({spills[kfa.SOURCE]} bytes)")
    check(spills[kfs.SOURCE] <= FUSED_SPILL_LIMIT, f"[build] the fused "
          f"library spills {spills[kfs.SOURCE]} bytes, no more than "
          f"{FUSED_SPILL_LIMIT}")
    clean = (kob.SOURCE, kbu.SOURCE, kds.SOURCE, ksr.SOURCE)
    check(all(spills[lib] == 0 for lib in clean),
          f"[build] the outbox, scan, dense and segment-reduce libraries "
          f"spill nothing ({[spills[lib] for lib in clean]} bytes)")
    cufilt = Path(_build.nvcc()).parent / "cu++filt"
    for lib in (kfs.SOURCE, *clean):
        for name, regs, spill in ptxas_report(
                built[lib][1], cufilt if cufilt.exists() else None):
            log(f"[build] {lib}: {name}: "
                + ("" if regs is None else f"{regs} registers, ")
                + f"{spill} bytes spill stores"
                + (" (spills)" if spill else ""))
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(built[kfa.SOURCE][0])], capture_output=True,
                          text=True, timeout=300).stdout.splitlines()
    tc_ops = {op: sum(op in line for line in sass) for op in ("HGMMA",
                                                              "HMMA")}
    check(tc_ops["HGMMA"] > 0, f"[build] the flash library holds tensor-core "
          f"instructions: {tc_ops} (cuobjdump -sass)")

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
    t0 = time.perf_counter()
    scan_plans = {name: kell.row_plan(tc.row_ptr) for name, tc in tcs.items()}
    t_scan_plan = time.perf_counter() - t0
    log(f"[host] {RMAT_MEDIUM.name}: V={g.num_vertices} E={g.num_edges}; "
        f"generate {t_gen:.2f} s, partition fwd+rev {t_part:.2f} s, "
        f"symmetrize+partition (CC) {t_cc:.2f} s, block metadata "
        f"{t_blk:.2f} s, transposed rows (fwd + CC) {t_csc:.2f} s, their "
        f"row plans (the scan's; an engine makes one with its pull layout) "
        f"{t_scan_plan:.2f} s")
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

        def kernel():     # the op: the query-minor copy, then the kernel
            return fused_superstep_op(
                msg, x["vstate"], weight, x["scal"], x["src"], x["local"],
                x["mask"], x["base"], dst_ext, num_segments=pg.seg_count,
                combine=spec.combine, block_e=BLOCK_E)

        def copy():
            return kfs.query_minor_state(x["vstate"])

        def kern(vt=copy()):
            return kfs.fused_superstep(
                kind, vt, x["scal"], x["src"], x["local"], x["mask"], weight,
                x["base"], num_segments=pg.seg_count, block_e=BLOCK_E)

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
        check(torch.equal(got, again) and torch.equal(got, kern()),
              f"[kernel] {kind}: two launches bit-equal, through the op and "
              f"on the query-minor state")
        ms = cuda_ms(kernel, 20)
        plain_ms = cuda_ms(plain, 5)
        copy_ms, kern_ms = cuda_ms(copy, 20), cuda_ms(kern, 20)
        bms = bound_ms(kind, pg, blk)
        kernel_rows[kind] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms)
        log(f"[kernel] {kind}: Q={Q} op {ms:.4f} ms (query-minor copy "
            f"{copy_ms:.4f} ms, kernel {kern_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms (bytes), "
            f"{bms / ms:.1%} of bound")
        del x, got, again, want
    torch.cuda.empty_cache()

    scan_rows = {}
    scan_err = 0.0
    for mode, (semiring, early) in SCAN_MODES.items():
        which = "cc" if mode == "cc" else "fwd"
        tc = tcs[which]
        x = scan_inputs(mode, tc_graphs[which], tc, rng, dev)
        rows = scan_plans[which].to(dev)
        xq = kell.query_minor_view(x["x"], math.inf)    # the engine's copy

        def scan(skip=None, xs=x["x"], rows=rows):  # the op, its own copy
            return bottomup_scan_op(x["row_ptr"], x["col"], x["val"], xs,
                                    semiring=semiring, early_exit=early,
                                    skip=skip, plan=rows)

        def plain():
            return bottomup_scan_ref(x["row_ptr"], x["col"], x["val"],
                                     x["x"], semiring=semiring,
                                     early_exit=early)

        def copy(xs=x["x"]):
            return kell.query_minor(xs, math.inf)

        (y, cnt), (y2, cnt2), (want_y, want_cnt) = scan(), scan(), plain()
        y_s, cnt_s = scan(x["skip"])
        y_v, cnt_v = scan(xs=xq)
        torch.cuda.synchronize()
        err = max_abs_err(y, want_y)
        scan_err = max(scan_err, err)
        check(torch.equal(y, want_y) and torch.equal(cnt, want_cnt),
              f"[kernel] bottomup {mode} ({semiring}, early exit {early}): "
              f"y and scanned bit-equal to the plain version (max |err| "
              f"{err}, scanned {int(cnt.sum())} of {Q * tc.nnz} slots)")
        check(torch.equal(y, y2) and torch.equal(cnt, cnt2)
              and torch.equal(y_v, y) and torch.equal(cnt_v, cnt)
              and torch.equal(y_s, y) and torch.equal(
                  cnt_s, torch.where(x["skip"] & early, 0, cnt)),
              f"[kernel] bottomup {mode}: two launches bit-equal, on x and "
              f"on the engine's query-minor view; skip zeroes only the "
              f"counts")
        ms = cuda_ms(scan, 20)
        view_ms = cuda_ms(lambda: scan(xs=xq), 20)
        copy_ms = cuda_ms(copy, 20)
        plain_ms = cuda_ms(plain, 5)
        bms = scan_bound_ms(x["x"], cnt, semiring)
        scan_rows[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms)
        log(f"[kernel] bottomup {mode}: Q={Q} op {ms:.4f} ms (its own "
            f"query-minor copy of x; given the engine's view {view_ms:.4f} "
            f"ms, the copy alone {copy_ms:.4f} ms), plain {plain_ms:.4f} "
            f"ms, bound {bms:.4f} ms (bytes), {bms / ms:.1%} of bound; row "
            f"plan {rows.blocks.shape[0]} blocks, {rows.long_rows.shape[0]} "
            f"long rows in {rows.num_partials} chunks")
        del x, xq, y, y2, want_y, cnt, cnt2, want_cnt, y_s, cnt_s, y_v, cnt_v
    torch.cuda.empty_cache()

    # the hybrid kernels at the planner's split of RMAT20, Q=8
    hyb_rows = {}
    n = g.num_vertices
    for semiring, (cfg, arrs) in splits.items():
        x = ell_inputs(semiring, n, rng, dev)
        rp, col, val = arrs["row_ptr"], arrs["col"], arrs["val"]
        rows = arrs["plan"]

        def ell(sr=semiring, x=x, rows=rows):
            return ell_spmv_op(rp, col, val, x, semiring=sr, plan=rows)

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

        # the op's two parts apart
        def copy(x=x, fill=SEMIRINGS[semiring][1]):
            return kell.query_minor(x, fill)

        def kern(sr=semiring, xt=copy(), rows=rows):
            return kell.ell_spmv(rp, col, val, xt, rows, semiring=sr,
                                 num_queries=Q)

        copy_ms, kern_ms = cuda_ms(copy, 20), cuda_ms(kern, 20)
        log(f"[kernel] ell_spmv {semiring}: query-minor copy of x "
            f"{copy_ms:.4f} ms, kernel on it {kern_ms:.4f} ms; row plan "
            f"{rows.blocks.shape[0]} blocks, {rows.long_rows.shape[0]} long "
            f"rows in {rows.num_partials} chunks")
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
    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)

    def flush():          # L2 full of dirty lines of scratch
        scratch.fill_(1.0)

    def flush_clean():    # the same, then read back: L2 clean
        scratch.fill_(1.0)
        scratch.sum()

    torch.backends.cuda.matmul.allow_tf32 = False
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

        def matmul(x=x, a=a):
            return torch.matmul(x, a)

        # kernel and matmul in turns: cold (L2 flushed before each launch;
        # dirty, then clean), warm (back to back; the host ahead, then
        # as cuda_ms times every other kernel)
        times = {}
        for how, timer in (
                ("cold", lambda f: cuda_ms_cold(f, 20, flush)),
                ("cold, clean L2", lambda f: cuda_ms_cold(f, 20, flush_clean)),
                ("warm", lambda f: cuda_ms_ahead(f, 50)),
                ("warm, host-paced", lambda f: cuda_ms(f, 20))):
            times[how] = (timer(kern), timer(matmul))
        ms, mm_ms = times["cold"]
        plain_ms = cuda_ms(plain, 5)
        bms = dense_bound_ms(Q, k, k)
        hyb_rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                              library_ms=(mm_ms if name == "dense_spmv"
                                          else None), err=err)
        log(f"[kernel] {name}: Q={Q} K=N={k} kernel {ms:.4f} ms cold; plain "
            f"{plain_ms:.4f} ms (warm); bound {bms:.4f} ms (bytes), "
            f"{bms / ms:.1%} of bound cold")
        for how, (t_k, t_mm) in times.items():
            log(f"[kernel] {name} {how}: kernel {t_k:.4f} ms, torch.matmul "
                f"(f32, no TF32) {t_mm:.4f} ms, kernel / matmul "
                f"{t_k / t_mm:.3f}")
        del x, got, again, want
    del scratch
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
        # the engine's one query-minor copy of x per superstep
        xq = kell.query_minor_view(x, SEMIRINGS[semiring][1])

        def kern(x=x, src=src, flat=flat, w=w, kw=kw):  # its own copy
            return outbox_reduce_op(x, src, flat, w, **kw)

        def on_view(xq=xq, src=src, flat=flat, w=w, kw=kw):
            return outbox_reduce_op(xq, src, flat, w, **kw)

        def copy(x=x, fill=SEMIRINGS[semiring][1]):
            return kell.query_minor(x, fill)

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
        check(torch.equal(got, again) and torch.equal(got, on_view()),
              f"[shard] outbox_reduce {name}: two launches bit-equal, on x "
              f"and on the engine's query-minor view")
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
        view_ms, copy_ms = cuda_ms(on_view, 20), cuda_ms(copy, 20)
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
            f"{shd.num_slots} used={len(np.unique(b_flat))} op {ms:.4f} ms "
            f"(its own query-minor copy of x; given the engine's view "
            f"{view_ms:.4f} ms, the copy alone {copy_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, bound {bms:.4f} ms (bytes), "
            f"{bms / ms:.1%} of bound"
            + ("" if lib_ms is None else
               f", torch.sparse.mm (CSR) {lib_ms:.4f} ms"))
        del x, xq, got, again, want, src, flat, w
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

    # -- phase 6: the sorted segment reduce at RMAT20 ------------------------
    seg_rows, seg_err, seg_launches = segment_reduce_phase(pg, rng, dev,
                                                           check)
    del pg, pgs, blks, tcs, tc_graphs
    torch.cuda.empty_cache()

    # -- phase 7: the LM serving path, tinyllama-1.1b at full width ---------
    lm_row, lm_err, lm_launches = lm_phase(dev, check)

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
            "outbox_reduce": (shard_rows["pagerank"], shard_err),
            "segment_reduce": (seg_rows[1, "sum"], seg_err),
            "flash_attention": (lm_row, lm_err)}
    launches.update(
        (name, hyb_launches[name]) for name in ("ell_spmv", "dense_spmv",
                                                "dense_spmv_minplus"))
    launches["outbox_reduce"] = shard_launches["outbox_reduce"]
    launches["segment_reduce"] = seg_launches
    launches["flash_attention"] = lm_launches
    record = {"kernels": [dict(
        name=name, route="cuda", source=KERNELS[name][0],
        replaces=KERNELS[name][1], launches=launches[name],
        max_abs_err=err, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row.get("bound_by", "bytes"),
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
