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
   The fused superstep for all seven message kinds (``bfs_relax``, BFS's
   warm-start relaxation, among them): min kinds bit for bit,
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
   the path; the BFS batch's TEPS (``bfs.teps``) beside its wall.  Then
   the fused backend with and without the direction vote,
   timed in turns, and BFS and SSSP forced to pull, against plain push;
   Then the hybrid backend (``backend="hybrid"``, the split the planner
   picks) through the same entry points: BFS, SSSP and CC bit for bit with
   equal steps against plain push, under the vote, without it
   (``direction_switch=False``) and forced to pull; PageRank and BC against
   the float64 runs within the same limits.  Its three kernels must launch;
   Then ``[tiered]``: the same entry points on engines built with
   ``tiered=`` (``partition.build_tier_plan``'s ``table[1]`` budget, the
   denser partition hot and the other streamed from pinned host memory;
   ``table[0]``, all cold, where row 1's windows would keep both hot, as
   on the symmetrized CC graph), ``win_blocks`` the least power of two
   that plans, printed with the longest destination run.  The five
   algorithms on the fused and hybrid backends bit for bit against
   resident engines of the same backend with equal steps, sums included,
   each called twice (the first call builds host layouts); BFS on the
   reference backend bit for bit and PageRank there within the f32
   rounding bound of a float64 run (``pagerank_f32_bound``: its compute
   scatter sums with atomics); BFS on the fused backend with every
   partition cold.  Checked: ``TierPlan.hbm_bytes`` equal to the engine's
   device arena bytes, the peak device memory of the tiered engines and
   runs below the resident ones', and the fused, ``ell_spmv``,
   ``dense_spmv`` and ``dense_spmv_minplus`` kernels launched on the
   windows or hot rows.  Printed: windows, streamed bytes, the copy and
   window-compute time per superstep and their overlap (CUDA events of
   ``core/tiered.py::WindowStream.timing`` over one PageRank call), the
   host-to-device rate of the pinned copies through the two buffers and
   in one call, and the walls;
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
   the sharded engine's ``superstep()`` hook (fused and hybrid; BFS and
   PageRank stepped to the finish bit for bit ``execute``'s, ms a step);
   then ``[serve]`` (``serve_phase``): ``execute(chunk=2)`` on the fused
   and hybrid engines bit for bit against phase 3's resident BFS and SSSP
   runs with equal steps; one boundary's host costs; the continuous
   serving path (``graph_serve.serve_continuous``, 8 slots, chunk 2, 32
   queries) for {fused, hybrid} x {bfs, sssp}: every completion bit for
   bit and with equal steps against drain batches of 8, 24 refills, zero
   retraces, the kernels launched in a session timed with the counts set
   to 0 just before it; and a BFS session on the sharded hybrid (world of
   one) against the single-device drain rows, ``outbox_reduce`` launched;
   then ``[dynamic]`` (``dynamic_phase``): a ``DynamicGraph`` of the
   weighted RMAT18 (``DYN_SCALE``, edge factor 16, seed 20; P=2, HIGH;
   ``mutation_capacity=256``) takes ``edge_stream``'s 5 batches of 256
   (churn 0.7, seed 20), with the apply rate in edges/s and
   BFS on the fused and hybrid dynamic engines after every batch, nothing
   rebuilt but at a compaction or a split rebuild; then, with the counts
   set to 0 just before: BFS and SSSP at Q=8 on both engines bit for bit
   with equal steps against fresh engines over the rebuilt graph,
   PageRank within ``pagerank_f32_bound``, warm BFS and SSSP after an
   insert-only window bit for bit with cold runs in fewer supersteps (the
   ``bfs_relax`` kind launched once a superstep), one compaction and its
   pause, the sharded hybrid (a world of one) consuming a batch by
   compaction, bit for bit with the fused engine, and two rounds of
   ``graph_serve --mutate``'s ``serve_mutating`` on the hybrid engine (a
   cold refresh, then a warm one bit-equal to cold); every kernel of the
   dynamic path must launch (the counts read just after); then
   ``ServeSession.mutate`` through ``serve_continuous(mutation_stream=)``
   with parity against drain batches, and the phase's seconds; and
   ``[dir]``: ``launch/direction_selftest.py`` as a world of one NCCL rank;
   then ``[robust]`` (``robust_phase``), with every count set to 0 just
   before it: ``graph_serve.run_chaos_drill`` on the unweighted RMAT18
   (BFS, fused primary, hybrid fallback, 2 mutation rounds of 256 at
   churn 0.7, 8 standing queries: at least 3 failures recovered, one
   downgrade, query 0 quarantined, the standing results bit for bit the
   clean session's, with the walls, each recovery's seconds and the
   snapshots' bytes and save times), ``graph_serve.run_corrupt_drill`` on
   reference, fused and hybrid engines over RMAT18 / P=2 / HIGH (detected
   or masked, no false positive), ``serve_with_restarts`` over a fused BFS
   session with one injected fault (every completion bit for bit
   ``drain_reference``'s), the checked exchange's window time and host
   syncs beside the plain exchange's and the monitor's time a window, and
   the sharded hybrid's checked window (world of one: ``exchange.payload``
   detected, the clean run bit for bit the single-device hybrid's); the
   fused kernel, ``ell_spmv``, ``dense_spmv_minplus`` and
   ``outbox_reduce`` must launch;
   then ``[tiered-dynamic]`` (``tiered_dynamic_phase``): the weighted
   RMAT20 and 5 batches of ``[dynamic]``'s stream with the payload in
   pinned host memory, a tiered
   engine (one partition hot, one streamed) beside a resident one on the fused and
   reference backends: BFS bit for bit after every batch, SSSP, PageRank
   within ``pagerank_f32_bound``, warm BFS, a forced compaction that
   re-plans, ``hbm_bytes`` against the arena bytes, peak device memory
   below resident's, the hybrid refusing, the fused kernel launched on
   the hot partition and every window;
5. the numpy oracles at RMAT12 on the card, all five algorithms, on the
   fused and the hybrid backends; then ``[bc-exact]``
   (``bc_exact_phase``): all-sources exact BC on the fused and hybrid
   backends: RMAT9 bit for bit the per-source loop, RMAT15 over its 32,768
   sources in chunks of 252 (wall, sources/s, supersteps, launches; the
   first and the padded last chunk's rows bit for bit single-source runs
   and within 1e-6 of float64; the two backends' totals against each
   other), RMAT14 at JAX's default chunk 32, and the fused kernel's BC
   kinds at Q=252;
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
   the JAX test's 2e-3 and at bf16 within 0.1 + 0.05 |logit|; f32 prefill
   logits (B=1, S=256) against a float64 run of the same forward
   assembled from the plain functions.
   Timed: prefill and decode wall and tok/s beside their bounds, the flash
   kernel beside its operations bound, its plain version and
   ``scaled_dot_product_attention`` (the yardstick only; the port never
   calls it).  The same for gemma3-4b (34 layers, head dim 256, windows
   1024 / 0 at 5:1; the flash kernel at D = 256, listed apart in the
   kernels' line); deepseek-67b and command-r-plus-104b at full width and
   2 layers, 8 tokens, the flash kernel at their D = 128 shapes; every
   model's parameter count against the JAX shapes';
   then ``[moe]`` (``moe_phase``): olmoe-1b-7b at full width and depth
   (the dropped share of token-choices, layer 0's expert load, its
   ``moe_ffn`` two card runs bit-equal and at f32 against the CPU, the
   flash kernel at R = 1, one flash launch a layer, decode against
   prefill at capacity factor E/k, at bf16 with the prefill pinned to the
   decode path's experts), qwen3-moe-235b-a22b at 2 layers (the flash
   kernel at its R = 16), and olmoe training at 2 layers (B=8, S=2048, 8
   microbatches: the loss at init against f32 compute, one step's
   gradients at bf16 against f32 compute and AdamW's update of them,
   3 steps, f32 against float64);
   then ``[encdec]`` (``encdec_phase``): seamless-m4t-large-v2 (24
   encoder and 24 decoder layers) and internvl2-26b (48 layers, 256
   patches before the prompt) at full width and depth on the same prompt
   with the stream's frames or patches: the flash kernel against its plain
   version and timed at seamless's causal and non-causal ``[4, 2048, 16,
   1, 64]`` and internvl2's causal ``[4, 2304, 8, 6, 128]`` (the
   non-causal and internvl2 rows listed apart in the kernels' line), the
   parameter counts, the prefill's launches (24 non-causal and 24 causal;
   48), decode against prefill at bf16 and f32 (internvl2's f32 at 2
   layers), f32 prefill logits against float64 (internvl2 at 2 layers),
   and one seamless training step at 2 layers (its gradients at bf16
   against f32 compute, every leaf and layer: the encoder's, the cross
   blocks' and ``frontend_proj``);
   then ``[ssm]`` (``ssm_phase``), after the memory earlier phases left is
   freed and printed (as before every LM phase): zamba2-2.7b (54 mamba2
   layers, the shared MHA block of 32 heads of 80 every 6) and
   xlstm-125m (12 layers, sLSTM every 4th) at full width and depth on the
   same prompt (xLSTM's first ``XLSTM_PROMPT`` tokens): the flash kernel at D = 80, ``[4, 2048, 32, 1, 80]``
   causal, against its plain version and timed (listed apart in the
   kernels' line), the parameter counts, zamba2's 9 flash launches a
   prefill, prefill and decode tok/s beside their bounds (xLSTM's prefill
   is JAX's token-by-token replay), decode vs prefill (xLSTM bit for bit;
   zamba2 at bf16 and f32), zamba2 at B=1 in a 524,288-slot cache against
   a 2,080-slot one (every logit equal), f32 prefill logits against a
   float64 parallel forward (zamba2 at 6 layers), and training at a cut
   (xlstm-125m at 4 layers, B=8, S=``XLSTM_TRAIN_SEQ``; zamba2-2.7b at
   6, B=8, S=2048:
   the loss at init, bf16 against f32 gradients per leaf and layer, 2
   AdamW steps);
8. ``[train]`` (``train_phase``): tinyllama-1.1b training at full width
   (1,100,048,384 f32 parameters, bf16 compute, remat, 4 microbatches):
   the loss at init, four steps on one B=8, S=2048 batch, f32 against
   float64 at 2 layers, 4 microbatches against 1, the flash route
   refusing a graph, ``launch/train.py`` for 3 steps at 2 layers with its
   checkpoint, and a deterministic restart drill at 2 layers.  No kernel
   of the repo is on this path: the JAX training path reaches no Pallas
   kernel either.
9. ``[mesh]`` (``mesh_phase``): the production-mesh tools.  A world of one
   NCCL rank as a ``(1, 1)`` DTensor mesh: a tinyllama-1.1b AdamW step at
   2 layers with parameters by ``param_specs`` under ``activation_rules``
   against the plain step, and a full-depth prefill whose 22 flash
   launches go through the kernel's custom op, against the plain
   prefill's logits; the mesh's sharded checkpoint restored onto the card
   alone and the card's whole one onto the mesh
   (``checkpoint.restore_resharded``), the leaves and each next step's
   loss bit for bit; then six dry-run cells on fake CUDA tensors over a
   fake 256-rank process group (``launch/dryrun.py``).  The kernels line
   lists the mesh prefill's flash launches as ``flash_attention.mesh``.

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

import contextlib
import dataclasses
import importlib
import json
import math
import os
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
    # the same kernel's BFS relaxation kind (warm starts), listed apart
    "fused_superstep.bfs_relax": (
        "src/repro_torch/kernels/csrc/fused_superstep.cu",
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
    # the same kernel at gemma3's head dim (D = 256), listed apart
    "flash_attention.d256": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87"),
    # the same kernel non-causal (seamless's encoder), listed apart
    "flash_attention.noncausal": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87"),
    # the same kernel at internvl2's patch-prefixed prompt (S = 2304, R = 6,
    # D = 128), listed apart
    "flash_attention.vlm": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87"),
    # the same kernel at zamba2's head dim (D = 80, MHA), listed apart
    "flash_attention.d80": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87"),
    # the same kernel through its custom op on DTensors ([mesh]'s prefill
    # of tinyllama-1.1b; timed at that shape in [lm]), listed apart
    "flash_attention.mesh": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:87"),
}
# the depth of [dynamic], [tiered-dynamic] and [robust], cut to keep the
# script within its time limit: mutation batches of the streams
# (graph_serve --mutate's default is 8; at 5 no stream compacts, and each
# phase's own compaction is checked apart), chaos drill rounds (at 2 the
# drill's faults still land: 3 failures, a downgrade, a quarantine, a
# replayed payload; at 1 nothing is replayed), queries a corruption-drill
# session certifies on the host, and the scale of [dynamic]'s graph and of
# [robust]'s two drills (their host work, the DynamicGraph builds and a
# recovery's rebuild from base, grows with the graph: 183 s for the chaos
# drill at RMAT20 on a slow host)
BC_SCALE = 15             # [bc-exact]: RMAT15, 32,768 sources (RMAT16
                          # took 185 s for the phase: PERF.md §4)
BC_CHUNK = 252            # 131 chunks, the last 8 sources + 244 pads
BC_SMALL = (9, 96)        # 512 sources against the sequential loop
BC_SMALL_K = 128          # its hybrid split: the planner's would be all dense
BC_DEFAULT = (14, 32)     # JAX's default chunk
DYN_BATCHES = 5
DYN_SCALE = 18
ROBUST_ROUNDS = 2
ROBUST_QUERIES = 4
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
# an MoE model's bf16 decode against prefill(t + 1) with the prefill's
# experts pinned to the decode path's: a pinned choice the prefill would not
# make itself must trail its own k-th router probability by at most this (a
# near-tie; the mean probability over olmoe's 64 experts is 1.6e-2)
NEAR_TIE = 5e-3
# one olmoe training step's gradients at bf16 compute against f32 compute
# on the same parameters and batch, ||g16 - g32|| / ||g32|| for each leaf
# of each layer (bf16 rounds each activation to 2^-9 relative)
TRAIN_BF16_GRAD_REL = 5e-2
# f32 prefill logits vs a float64 run of the same forward, max |diff| over
# max |logit|
F64_REL = 1e-3
# [ssm]: zamba2's depth for f32 vs float64 and training (one group of
# attn_every mamba layers and the shared block), and the long_500k
# shape's cache slots (src/repro/models/api.py)
SSM_F64_LAYERS = 6
SSM_LONG_SLOTS = 524288
# [ssm]: xLSTM's served prompt and its training sequence, cut (from [lm]'s
# 2048 and from 512) to keep the script within its time limit: its prefill
# is the decode step replayed token by token (2048 steps took 41.1 s on a
# slow host, and the decode-vs-prefill check replays 2079 more) and its
# recurrent state is the same size at any length
XLSTM_PROMPT = 512
XLSTM_TRAIN_SEQ = 256
# [ssm] training at f32 against float64 (B=1, S=256): max |diff| / max |g|
# of any gradient leaf.  Measured on the CPU at the same cuts: 3.8e-3 for
# xLSTM (its recurrences amplify f32 rounding), 1.1e-4 for zamba2.
SSM_F64_GRAD = 1e-2
# [train]'s launcher run at full width, cut in depth to keep the script
# within its time: at 22 layers its checkpoint (12.29 GiB) took 35.4 s of
# the phase's 107 s on a slow host
TRAIN_LAUNCHER_LAYERS = 2
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


T_START = time.perf_counter()


def log(*args):
    print(*args, flush=True)


class PhaseClock:
    """Prints each phase's seconds (``[time]`` lines) when called with
    its name, timed from the previous call."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log(f"[time] {name} {now - self.t:.1f} s (script "
            f"{now - T_START:.1f} s)")
        self.t = now


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


def kernel_inputs(kind, pg, blk, rng, device, q=Q):
    """Inputs of one kind at the main path's shapes (``q`` queries): state
    made from the seed with every branch of the message taken (frontier
    and not, +inf, inactive, zero sigma); PageRank's inverse degrees from
    the graph."""
    import numpy as np
    import torch

    shape = (q, pg.num_parts, pg.v_max)
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
    elif kind == "bfs_relax":
        cols = [levels, active]
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


def bound_ms(kind, pg, blk, q=Q) -> float:
    """Least time for one launch of ``q`` queries: bytes moved (topology
    once, each gathered state array once, the accumulator once) over the
    memory rate, or the message and reduce operations over the f32 rate,
    whichever is larger."""
    from repro_torch.kernels.fused_superstep import KINDS

    spec = KINDS[kind]
    pl, e_pad = blk.src.shape
    topo = pl * e_pad * (12 + (4 if spec.use_weight else 0))
    state = spec.num_gather * q * pl * pg.v_max * 4
    out = q * pl * pg.seg_count * 4
    ops = q * pl * int(blk.mask.sum()) * 4
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
        "bfs_relax": lambda: alg("bfs").BFS_RELAX_PROGRAM,
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


def fused_kind_check(kind, pg, blks, rng, dev, check, q=Q,
                     tag="[kernel]"):
    """One fused kernel kind against its plain version at ``q`` queries on
    ``pg``'s block layout (``blks``: forward and reverse): min kinds bit
    for bit, sum kinds within the kernel's f32 bound of float64; two
    launches bit-equal, through the op and on the query-minor state; the
    op, its copy, the kernel and the plain version timed.  Returns the
    kernel's row (``ms``, ``plain_ms``, ``bound_ms``) and its max |err|
    against the plain version."""
    import torch

    from repro_torch.kernels import fused_superstep as kfs
    from repro_torch.kernels.ops import fused_superstep_op
    from repro_torch.kernels.ref import fused_superstep_ref

    spec = kfs.KINDS[kind]
    d = "rev" if kind == "bc_bwd" else "fwd"
    blk = blks[d]
    x = kernel_inputs(kind, pg, blk, rng, dev, q)
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
    if spec.combine == "min":
        check(torch.equal(got, want), f"{tag} {kind}: bit-equal to the "
              f"plain version at Q={q} (max |err| {err})")
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
              f"{tag} {kind}: within its f32 bound ({depth} roundings x "
              f"2^-24 x sum|msg|) of float64 at Q={q}; max rel err kernel "
              f"{kern_rel:.3e}, plain f32 {plain_rel:.3e}; kernel vs plain "
              f"max |err| {err}")
        del exact, mag, slack
    check(torch.equal(got, again) and torch.equal(got, kern()),
          f"{tag} {kind}: two launches bit-equal, through the op and on the "
          f"query-minor state")
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 5)
    copy_ms, kern_ms = cuda_ms(copy, 20), cuda_ms(kern, 20)
    bms = bound_ms(kind, pg, blk, q)
    log(f"{tag} {kind}: Q={q} op {ms:.4f} ms (query-minor copy "
        f"{copy_ms:.4f} ms, kernel {kern_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {bms:.4f} ms (bytes), "
        f"{bms / ms:.1%} of bound")
    del x, got, again, want
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms), err


def superstep_hook_checks(pg, hybrid, source, pr_program, dev, check):
    """``[shard]``'s superstep hook (``DistributedBSPEngine.superstep``, a
    world of one) on the fused backend and on ``hybrid`` (the sharded
    hybrid engine): BFS from ``source`` and PageRank stepped from the
    initial state to the finish, each state and the step count bit for
    bit ``execute``'s, and PageRank's ``PR_ITERS`` steps bit for bit
    ``execute(num_steps=)``'s; the ms a step from CUDA events around the
    host loop (each step reads its vote)."""
    import torch

    from repro_torch.core.bsp import DistributedBSPEngine

    bfs_mod = importlib.import_module("repro_torch.algorithms.bfs")
    pr_mod = importlib.import_module("repro_torch.algorithms.pagerank")
    fused = DistributedBSPEngine(pg, backend="fused", block_e=BLOCK_E)
    for backend, eng in (("fused", fused), ("hybrid", hybrid)):
        for alg, prog, init in (
                ("bfs", bfs_mod.BFS_PROGRAM, {"level": bfs_mod.
                                              multi_source_state(
                                                  pg, [source])[0]}),
                ("pagerank", pr_program, pr_mod.initial_state(pg))):
            init = {k: torch.as_tensor(v, device=dev)
                    for k, v in init.items()}
            fn = eng.superstep(prog)
            fn(init, 0)                                  # warm
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            state, steps, limit = init, 0, (
                PR_ITERS if alg == "pagerank" else prog.max_steps)
            first_fin = None
            start.record()
            while steps < limit:
                state, fin = fn(state, steps)
                steps += 1
                if first_fin is None and bool(fin):
                    first_fin = steps
                    if alg == "bfs":
                        break
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / steps
            batched = {k: v[None] for k, v in init.items()}
            want, want_steps = eng.execute(prog, batched)
            if alg == "bfs":
                same = all(torch.equal(state[k], want[k][0]) for k in state)
            else:
                one, _ = fn(init, 0)
                same = all(torch.equal(one[k], want[k][0]) for k in one)
                nsteps = eng.execute(prog, batched, num_steps=PR_ITERS)
                same = same and all(torch.equal(state[k], nsteps[k][0])
                                    for k in state)
            check(same and first_fin == int(want_steps[0]),
                  f"[shard] superstep({alg}) hook on the {backend} backend "
                  f"(world of one): stepped to the finish in {first_fin} "
                  f"steps, bit for bit execute's state and step count "
                  f"({int(want_steps[0])})"
                  + (f", {PR_ITERS} steps bit for bit execute(num_steps="
                     f"{PR_ITERS})" if alg == "pagerank" else "")
                  + f"; {ms:.4f} ms a step (CUDA events, {steps} steps)")
    del fused


def _counting_supersteps(eng):
    """Wrap ``eng.execute`` to add each run-to-convergence call's
    supersteps (the loop runs until its slowest query finishes: the most
    of ``steps_q``) to ``eng.supersteps``."""
    run = eng.execute
    eng.supersteps = 0

    def execute(program, state, **kw):
        out = run(program, state, **kw)
        eng.supersteps += int(out[1].max())
        return out

    eng.execute = execute
    return eng


def bc_exact_phase(dev, check):
    """``[bc-exact]``: all-sources exact BC (``algorithms/bc.py::bc_exact``)
    on the fused and hybrid backends, P=2, HIGH, reverse edges.

    (a) RMAT9 (``BC_SMALL``: 512 sources, chunks of 96, the last padded
    with source 0; the hybrid split at ``BC_SMALL_K``, so both its kernels
    run): ``bc_exact`` bit for bit ``bc_exact_sequential``.
    (b) RMAT15 (``BC_SCALE``, the seed of ``totem_rmat``) at ``BC_CHUNK``:
    the wall, chunks, sources/s, supersteps and the kernels' launches;
    the rows of the first and the padded last chunk bit for bit each
    source's ``betweenness_centrality`` and within
    ``SUM_LIMITS["betweenness_centrality"]`` (elementwise) of a float64
    run of the reference backend; the fused total against the hybrid
    total within ``2 * SUM_LIMITS + 2^-23`` elementwise (each row within
    the limit of float64, rows nonnegative, two f32 casts).  (c) RMAT14
    at JAX's default chunk 32, both backends, totals within the same
    bound.  Every ``bc_exact`` call of (a), (b) and (c) is counted on its
    own, the counts read just before and just after it: on the fused
    engine the fused kernel must launch in both BC kinds, on the hybrid
    engine ``ell_spmv`` and ``dense_spmv`` must.  Then the fused kernel's ``bc_fwd`` and ``bc_bwd`` kinds at Q =
    ``BC_CHUNK`` on RMAT15's blocks against their plain version, timed."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (bc_exact, bc_exact_sequential,
                                        betweenness_centrality,
                                        betweenness_centrality_batched)
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.kernels import dense_spmv as kds
    from repro_torch.kernels import ell_spmv as kell
    from repro_torch.kernels import fused_superstep as kfs

    t_phase = time.perf_counter()
    limit = SUM_LIMITS["betweenness_centrality"]
    pair_bound = 2 * limit + 2.0 ** -23

    def engines(pg, k_dense=None):
        return {"fused": BSPEngine(pg, backend="fused", block_e=BLOCK_E),
                "hybrid": BSPEngine(pg, backend="hybrid",
                                    hybrid_k_dense=k_dense)}

    def partition(scale):
        t0 = time.perf_counter()
        g = G.rmat(scale, 16, seed=SEED)
        pg = PT.partition(g, 2, PT.HIGH, include_reverse=True)
        log(f"[bc-exact] rmat{scale}: V={g.num_vertices} E={g.num_edges} "
            f"P=2 HIGH with reverse edges, {time.perf_counter() - t0:.2f} s")
        return g, pg

    counters = (kfs.fused_superstep, kell.ell_spmv, kds.dense_spmv)
    needed = {"fused": ("bc_fwd", "bc_bwd"),
              "hybrid": ("ell_spmv", "dense_spmv")}

    def timed_bc(tag, name, eng, chunk):
        """``(bc_exact(eng, chunk=chunk), wall, launches)``: the launches
        of this call alone, and a check that the engine's kernels made
        some."""
        before = [fn.launches for fn in counters]
        kinds0 = dict(kfs.fused_superstep.kind_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bc_exact(eng, chunk=chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        used = {fn.__name__: fn.launches - b
                for fn, b in zip(counters, before)}
        used.update({k: kfs.fused_superstep.kind_launches.get(k, 0)
                     - kinds0.get(k, 0) for k in ("bc_fwd", "bc_bwd")})
        check(all(used[k] > 0 for k in needed[name]),
              f"[bc-exact] {tag} {name}: bc_exact at chunk {chunk} "
              f"launched {' and '.join(needed[name])} (launches of this "
              f"call: {used})")
        return out, wall, used

    # (a) bit for bit against the sequential loop, padded last chunk
    scale, chunk = BC_SMALL
    _, pg = partition(scale)
    for name, eng in engines(pg, BC_SMALL_K).items():
        got, wall, _ = timed_bc(f"rmat{scale}", name, eng, chunk)
        t1 = time.perf_counter()
        want = bc_exact_sequential(eng)
        t2 = time.perf_counter()
        n = pg.num_vertices
        check(np.array_equal(got, want), f"[bc-exact] rmat{scale} {name}: "
              f"bc_exact (chunk {chunk}: {-(-n // chunk)} chunks, the last "
              f"{n % chunk or chunk} sources + {-n % chunk} pads) bit for "
              f"bit bc_exact_sequential ({n} single-source calls): "
              f"{wall:.3f} s against {t2 - t1:.3f} s")

    # (b) RMAT15 over all sources
    g, pg = partition(BC_SCALE)
    n = g.num_vertices
    chunks = -(-n // BC_CHUNK)
    last_lo = (chunks - 1) * BC_CHUNK
    first = np.arange(BC_CHUNK)
    last = np.concatenate([np.arange(last_lo, n),
                           np.zeros(chunks * BC_CHUNK - n, np.int64)])
    real_last = n - last_lo
    exact = {}
    ref = BSPEngine(pg, backend="reference")
    for tag, srcs in (("first", first), ("last", last)):
        exact[tag] = betweenness_centrality_batched(
            ref, srcs, dtype=torch.float64)[0]
    del ref
    totals = {}
    for name, eng in engines(pg).items():
        _counting_supersteps(eng)
        if name == "hybrid":
            bc_mod = importlib.import_module("repro_torch.algorithms.bc")
            for prog in (bc_mod.FORWARD_PROGRAM, bc_mod.BACKWARD_PROGRAM):
                eng.hybrid_for(prog)           # set-up, outside the wall
        totals[name], wall, used = timed_bc(f"rmat{BC_SCALE}", name, eng,
                                            BC_CHUNK)
        log(f"[bc-exact] rmat{BC_SCALE} {name}: bc_exact over {n} sources "
            f"in {chunks} chunks of {BC_CHUNK} (the last {real_last} + "
            f"{chunks * BC_CHUNK - n} pads): {wall:.3f} s wall, "
            f"{n / wall:.1f} sources/s, {eng.supersteps} supersteps "
            f"({wall / eng.supersteps * 1e3:.3f} ms each), launches "
            f"{used}")
        bad, worst = [], 0.0
        for tag, srcs, real in (("first", first, BC_CHUNK),
                                ("last", last, real_last)):
            rows = betweenness_centrality_batched(eng, srcs)[0]
            for i in range(real):
                single = betweenness_centrality(eng, int(srcs[i]))[0]
                if not np.array_equal(rows[i], single):
                    bad.append(int(srcs[i]))
                worst = max(worst, max_rel_err(rows[i], exact[tag][i]))
        check(not bad, f"[bc-exact] rmat{BC_SCALE} {name}: the first and the "
              f"padded last chunk's rows ({BC_CHUNK} + {real_last}) bit for "
              f"bit each source's betweenness_centrality (mismatched "
              f"sources {bad[:8]})")
        check(worst <= limit, f"[bc-exact] rmat{BC_SCALE} {name}: those rows "
              f"within {limit:.0e} of a float64 reference-backend run "
              f"(max rel err {worst:.3e})")
        check(bool(np.isfinite(totals[name]).all())
              and totals[name].shape == (n,) and totals[name].max() > 0,
              f"[bc-exact] rmat{BC_SCALE} {name}: total finite, shape "
              f"{totals[name].shape}, max {totals[name].max():.6e}")
    rel = max_rel_err(totals["fused"], totals["hybrid"])
    check(rel <= pair_bound, f"[bc-exact] rmat{BC_SCALE}: fused total "
          f"against hybrid total, max rel err {rel:.3e} <= {pair_bound:.3e}")

    pg_big = pg

    # (c) JAX's default chunk on RMAT14
    scale, chunk = BC_DEFAULT
    g, pg = partition(scale)
    got = {}
    for name, eng in engines(pg).items():
        _counting_supersteps(eng)
        got[name], wall, used = timed_bc(f"rmat{scale}", name, eng, chunk)
        log(f"[bc-exact] rmat{scale} {name}: bc_exact at chunk {chunk} "
            f"({-(-g.num_vertices // chunk)} chunks): {wall:.3f} s wall, "
            f"{g.num_vertices / wall:.1f} sources/s, {eng.supersteps} "
            f"supersteps, launches {used}")
    rel = max_rel_err(got["fused"], got["hybrid"])
    check(rel <= pair_bound, f"[bc-exact] rmat{scale}: fused total against "
          f"hybrid total, max rel err {rel:.3e} <= {pair_bound:.3e}")

    # the fused kernel's BC kinds at Q = BC_CHUNK on the large graph's
    # blocks (outside every counted call: these launches are comparisons)
    blks = {"fwd": PT.build_block_metadata(pg_big.fwd, block_e=BLOCK_E),
            "rev": PT.build_block_metadata(pg_big.rev, block_e=BLOCK_E)}
    rng = np.random.default_rng(SEED)
    for kind in ("bc_fwd", "bc_bwd"):
        fused_kind_check(kind, pg_big, blks, rng, dev, check, q=BC_CHUNK,
                         tag="[bc-exact] kernel")
    log(f"[bc-exact] the phase {time.perf_counter() - t_phase:.1f} s")


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


def lm_forward64(module, tokens, front=None):
    """The prefill's last-token logits in float64, assembled from the
    port's plain functions (``rms_norm``, ``rope``, ``flash_attention_ref``,
    ``cross_attention``) and ``module``'s weights: the yardstick of the f32
    prefill.  ``front``: a vision model's ``patches`` (projected and put
    before the tokens) or an encoder-decoder's ``frames`` (through the
    encoder's non-causal layers, then each decoder layer's cross block)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.attention import cross_attention
    from repro_torch.models.common import rms_norm, rope

    cfg = module.cfg
    front = front or {}
    g, hd = cfg.n_kv_heads, cfg.hd
    r = cfg.n_heads // g

    def layer64(layer, x, enc=None):
        b, s, _ = x.shape
        pos = torch.arange(s, device=x.device)[None]
        w = {n: p.double() for n, p in layer.named_parameters()}
        h = rms_norm(x, w["norm1"], cfg.norm_eps)
        q = rope((h @ w["wq"]).reshape(b, s, g, r, hd), pos, cfg.rope_theta)
        k = rope((h @ w["wk"]).reshape(b, s, g, hd), pos, cfg.rope_theta)
        v = (h @ w["wv"]).reshape(b, s, g, hd)
        o = flash_attention_ref(q, k, v, causal=layer.causal,
                                window=layer.window)
        x = x + o.reshape(b, s, -1) @ w["wo"]
        if enc is not None:
            se = enc.shape[1]
            h = rms_norm(x, w["norm_x"], cfg.norm_eps)
            o = cross_attention((h @ w["wq_x"]).reshape(b, s, g, r, hd),
                                (enc @ w["wk_x"]).reshape(b, se, g, hd),
                                (enc @ w["wv_x"]).reshape(b, se, g, hd))
            x = x + o.reshape(b, s, -1) @ w["wo_x"]
        h = rms_norm(x, w["norm2"], cfg.norm_eps)
        return x + (F.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]

    x = module.embed.double()[tokens] * math.sqrt(cfg.d_model)
    if "patches" in front:
        proj = module.frontend_proj.double()
        x = torch.cat([front["patches"].double() @ proj, x], 1)
    enc = None
    if cfg.enc_dec:
        enc = front["frames"].double() @ module.frontend_proj.double()
        for layer in module.encoder:
            enc = layer64(layer, enc)
        enc = rms_norm(enc, module.enc_norm.double(), cfg.norm_eps)
    for layer in module.layers:
        x = layer64(layer, x, enc)
    x = rms_norm(x[:, -1:], module.final_norm.double(), cfg.norm_eps)
    head = module.embed.t() if cfg.tie_embeddings else module.lm_head
    return (x @ head.double())[:, 0]


def param_count(cfg) -> int:
    """The parameters of ``cfg``'s model from its shapes, nothing
    allocated: the embedding (and an untied head), each layer's
    ``layer_param_shapes`` (the JAX ``_layer_param_shapes``; the cross
    leaves in an encoder-decoder's decoder) and the final norm; an
    encoder-decoder's encoder layers and ``enc_norm``, a front end's
    ``frontend_proj``."""
    from repro_torch.models.transformer import layer_param_shapes

    def stack(cross):
        return cfg.n_layers * sum(math.prod(shape) for shape in
                                  layer_param_shapes(cfg, cross).values())

    d = cfg.d_model
    tables = 1 if cfg.tie_embeddings else 2
    n = tables * cfg.vocab * d + stack(cfg.enc_dec) + d
    if cfg.enc_dec:
        n += stack(False) + d
    if cfg.frontend:
        n += d * d
    return n


def attention_bound(b, s, g, r, hd, window=0, causal=True):
    """``(ms, flops, bytes)`` of one flash launch: its live (query, key)
    pairs' two products (all ``s * s`` pairs when not causal), 4 hd
    operations a pair a head, at the bf16 tensor-core rate, or q, k, v and
    o moved once in bf16, whichever takes longer."""
    w = window if 0 < window < s else s
    pairs = (w * (w + 1) // 2 + (s - w) * w) if causal else s * s
    flops = 4 * hd * pairs * b * g * r
    nbytes = 2 * (2 * b * s * g * r * hd + 2 * b * s * g * hd)
    return (1e3 * max(flops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S),
            flops, nbytes)


def flash_checks(dev, check, tag, shape, windows, timed=True, causal=True):
    """The flash kernel at one layer's shapes ``shape = (B, S, G, R, D)``
    against its plain version: bf16 within the bound of rounding P and the
    output to bf16 (``bf16_bound_ratio``), f32 within ``FLASH_F32_TOL``,
    each window in ``windows`` (causal; not causal, an encoder's, takes
    none), two launches bit-equal.  ``timed``: the bf16 kernel (full
    attention) timed beside its operations bound, its plain version and
    ``scaled_dot_product_attention`` (the yardstick only; the port never
    calls it).  Returns ``(row or None, max |err| of bf16)``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels.ref import flash_attention_ref

    b, s, g, r, hd = shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q32 = torch.randn(b, s, g, r, hd, generator=gen, device=dev)
    k32 = torch.randn(b, s, g, hd, generator=gen, device=dev)
    v32 = torch.randn(b, s, g, hd, generator=gen, device=dev)
    worst = 0.0
    for dtype in ("bfloat16", "float32"):
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q32, k32, v32))
        for window in windows if causal else (0,):
            got = kfa.flash_attention(q, k, v, causal=causal, window=window)
            again = kfa.flash_attention(q, k, v, causal=causal,
                                        window=window)
            want = flash_attention_ref(q, k, v, causal=causal, window=window)
            err = max_abs_err(got, want)
            if dtype == "bfloat16":
                worst = max(worst, err)
                ratio = bf16_bound_ratio(got, want, q, k, v, window, causal)
                ok, limit = ratio <= 1.01, (
                    f"its rounding bound (largest |err| / bound {ratio:.4f})")
            else:
                ok = torch.allclose(got, want, **FLASH_F32_TOL)
                limit = f"{FLASH_F32_TOL}"
            mode = f"window {window}" if causal else "not causal"
            check(ok and torch.equal(got, again),
                  f"[{tag}] flash kernel {dtype}, q {list(shape)}, {mode}: "
                  f"within {limit} of the plain version (max |err| "
                  f"{err:.3e}), two launches bit-equal")
    if not timed:
        return None, worst
    q, k, v = (t.bfloat16() for t in (q32, k32, v32))
    del q32, k32, v32

    def kern():
        return kfa.flash_attention(q, k, v, causal=causal)

    def plain():
        return flash_attention_ref(q, k, v, causal=causal)

    qh = q.reshape(b, s, g * r, hd).transpose(1, 2).contiguous()
    kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal,
                                              enable_gqa=True)

    lib_err = max_abs_err(library().transpose(1, 2).reshape(q.shape), kern())
    ms, plain_ms, lib_ms = cuda_ms(kern, 10), cuda_ms(plain, 3), cuda_ms(
        library, 20)
    bound, flops, nbytes = attention_bound(b, s, g, r, hd, causal=causal)
    mode = "causal" if causal else "not causal"
    log(f"[{tag}] flash kernel (bf16, {mode}, q [{b}, {s}, {g}, {r}, {hd}]): "
        f"{ms:.4f} ms per launch; plain {plain_ms:.4f} ms; bound "
        f"{bound:.4f} ms (operations: {flops / 1e9:.1f} GFLOP at 989 "
        f"TFLOP/s; bytes {nbytes / 1e6:.1f} MB), {bound / ms:.1%} of bound, "
        f"{flops / ms / 1e9:.1f} TFLOP/s; scaled_dot_product_attention "
        f"{lib_ms:.4f} ms (max |diff| vs kernel {lib_err:.3e})")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, library_ms=lib_ms,
                bound_by="operations"), worst


def lm_batch(cfg, dev):
    """``[lm]``'s prompt batch for ``cfg``: the Zipf ``TokenStream(seed=0)``'s
    first batch, B=4, S=2048 tokens (and the next token), with a vision
    config's ``patches`` or an encoder-decoder config's ``frames``, on the
    card."""
    from repro_torch.data.tokens import TokenStream

    return {k: v.to(dev) for k, v in TokenStream(
        cfg, LM_BATCH, LM_PROMPT, seed=0).batch_at(0).items()}


def lm_tokens(cfg, dev):
    """``lm_batch``'s tokens ``[4, 2049]``."""
    return lm_batch(cfg, dev)["tokens"]


def build_lm(cfg, dev, check, tag, want_params):
    """``cfg``'s serving model through ``models.api.build``, random weights
    from a generator seeded 0; its parameter count checked against
    ``want_params`` (the JAX shapes') and against ``param_count(cfg)``."""
    import torch

    from repro_torch.models import api

    t0 = time.perf_counter()
    model = api.build(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.module.parameters())
    moe = (f", {cfg.moe_experts} experts top {cfg.moe_top_k} (capacity "
           f"factor {cfg.moe_capacity_factor})" if cfg.is_moe else "")
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, "
        f"d_ff {cfg.d_ff}{moe}, vocab {cfg.vocab}; {n_params} parameters "
        f"({cfg.compute_dtype}), built in {time.perf_counter() - t0:.2f} s")
    check(n_params == want_params == param_count(cfg),
          f"[{tag}] {cfg.name} at full width, {cfg.n_layers} layers: "
          f"{n_params:,} parameters ({want_params:,} from the JAX shapes)")
    return model


def serve_lm(model, tokens, check, tag, n_gen=LM_GEN, kept=1.0,
             experts_read=None, front=None):
    """The serve launcher's ``generate`` on ``tokens[:, :2048]`` (B=4) and
    ``front`` (a vision model's ``patches`` or an encoder-decoder's
    ``frames``), ``n_gen`` greedy tokens, warmed once; checks the tokens
    and the flash launches of the prefill (one a layer, and one not causal
    a layer of an encoder); prints the prefill and decode walls and tok/s
    beside their bounds and the peak device memory.  An MoE model's bounds
    count the share ``kept`` of token-choices its prefill keeps and the
    ``experts_read`` experts a layer its decode step reads (all of them
    when not given).  Returns the flash launches of the prefill, all and
    not causal."""
    import torch

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.serve import generate
    from repro_torch.models.transformer import (layer_param_shapes,
                                                layer_windows)

    cfg = model.cfg
    front = front or {}
    b, s, d = LM_BATCH, LM_PROMPT, cfg.d_model
    g, hd = cfg.n_kv_heads, cfg.hd
    r = cfg.n_heads // g
    n_front = front["patches"].shape[1] if "patches" in front else 0
    se = front["frames"].shape[1] if "frames" in front else 0
    st = s + n_front                          # the decoder's positions
    # cuBLAS handles, first launches
    generate(model, {"tokens": tokens[:, :128], **front}, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfa.flash_attention.launches = kfa.flash_attention.noncausal_launches = 0
    res = generate(model, {"tokens": tokens[:, :s], **front}, n_gen)
    launches = kfa.flash_attention.launches
    noncausal = kfa.flash_attention.noncausal_launches
    out = res["tokens"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(out.shape == (b, n_gen) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab,
          f"[{tag}] {cfg.name}: generated tokens [{b}, {n_gen}] in the "
          f"vocabulary")
    want = (2 if cfg.enc_dec else 1) * cfg.n_layers
    want_nc = cfg.n_layers if cfg.enc_dec else 0
    check(launches == want and noncausal == want_nc,
          f"[{tag}] {cfg.name}: the flash kernel launched {launches} times "
          f"in the prefill, {noncausal} not causal (one per layer"
          f"{' and one per encoder layer, not causal' if cfg.enc_dec else ''}"
          f": {want}, {want_nc})")
    shapes = layer_param_shapes(cfg, cfg.enc_dec)
    # the cross k and v are products of the frames, not of the tokens
    dense = sum(math.prod(shape) for name, shape in shapes.items()
                if not name.startswith(("norm", "moe_w1", "moe_w2"))
                and name not in ("wk_x", "wv_x"))
    expert = 3 * d * cfg.d_ff                    # one expert's weights
    kv_x = 2 * d * g * hd                        # a layer's wk_x and wv_x
    enc_layer = sum(math.prod(shape) for shape in
                    layer_param_shapes(cfg).values())
    # products a token: its layers' projections (and router), the experts
    # of its kept choices; the head for the last position only; the front
    # ends' projections, and a frame's encoder layers and cross k and v
    per_token = cfg.n_layers * (dense + cfg.moe_top_k * kept * expert)
    mm_flops = (2 * b * st * per_token + 2 * b * d * cfg.vocab
                + 2 * b * n_front * d * d
                + 2 * b * se * (d * d + cfg.n_layers * (enc_layer + kv_x)))
    attn = sum(attention_bound(b, st, g, r, hd, int(w))[0]
               for w in layer_windows(cfg))
    if se:
        attn += cfg.n_layers * attention_bound(b, se, g, r, hd,
                                               causal=False)[0]
    # the cross attention's two products in f32 (as JAX computes them)
    cross = 1e3 * cfg.n_layers * 4 * b * cfg.n_heads * st * se * hd \
        / F32_OPS_PER_S
    prefill_bound = 1e3 * mm_flops / BF16_OPS_PER_S + attn + cross
    # a step reads the weights it uses (not the embedding's other rows; of
    # an MoE layer's experts the ones its tokens chose; not the front end,
    # the encoder or the cross k and v weights) and the live caches
    n_params = sum(p.numel() for p in model.module.parameters())
    unread = 0 if cfg.tie_embeddings else cfg.vocab * d
    if cfg.is_moe and experts_read is not None:
        unread += cfg.n_layers * (cfg.moe_experts - experts_read) * expert
    if cfg.frontend:
        unread += d * d
    if cfg.enc_dec:
        unread += cfg.n_layers * (enc_layer + kv_x) + d
    step_bytes = (2 * (n_params - unread)
                  + 2 * 2 * cfg.n_layers * b * (st + n_gen // 2 + se) * g
                  * hd)
    step_bound = 1e3 * step_bytes / HBM_BYTES_PER_S
    steps = n_gen - 1
    extra = (f" and {n_front} patches" if n_front else
             f" and {se} frames" if se else "")
    log(f"[{tag}] {cfg.name} prefill: {b * s} tokens{extra} a batch of {b} "
        f"in {res['prefill_s'] * 1e3:.1f} ms ({b * s / res['prefill_s']:.0f} "
        f"tok/s); bound {prefill_bound:.2f} ms ({mm_flops / 1e12:.2f} TFLOP "
        f"of products at 989 TFLOP/s plus {attn:.4f} ms of attention"
        f"{f' and {cross:.4f} ms of f32 cross attention' if se else ''})")
    log(f"[{tag}] {cfg.name} decode: {b * steps} tokens in "
        f"{res['decode_s'] * 1e3:.1f} ms ({b * steps / res['decode_s']:.0f} "
        f"tok/s, {res['decode_s'] * 1e3 / steps:.3f} ms per step); bound "
        f"{step_bound:.3f} ms per step ({step_bytes / 1e9:.2f} GB of weights "
        f"and live cache at 3.35 TB/s); peak {peak:.2f} GiB; first tokens "
        f"{out[0, :8].tolist()}")
    return launches, noncausal


@contextlib.contextmanager
def pinned_experts(pins):
    """While the block runs, the i-th call of ``moe.top_k`` (one a MoE
    layer, from ``moe.route``) returns the experts ``pins[i] [T, k]`` and
    its own probabilities at them, in place of its own top k.  Yields a
    list that gets, for each call, the tokens whose pinned set differs
    from the call's own and the largest amount by which a pinned
    probability trails the call's own k-th.  ``pins=None``: nothing is
    pinned or recorded."""
    from repro_torch.models import moe

    own_top_k, report = moe.top_k, []

    def pinned(probs, k):
        pin = pins[len(report)]
        values, idx = own_top_k(probs, k)
        got = probs.gather(-1, pin)
        moved = (idx.sort(-1).values != pin.sort(-1).values).any(-1)
        trail = (values[:, k - 1] - got.min(-1).values)[moved]
        report.append((int(moved.sum()),
                       float(trail.max()) if trail.numel() else 0.0))
        return got, pin

    if pins is not None:
        moe.top_k = pinned
    try:
        yield report
    finally:
        moe.top_k = own_top_k


def decode_vs_prefill(model, tokens, name, tag, check, front=None):
    """Decode after ``prefill(2048)`` against ``prefill(2049)``, both with
    the same ``front`` inputs (patches or frames): the last logits of every
    row within ``DECODE_TOL[name]``.  An MoE model at f32
    must route every decoded token as ``prefill(2049)`` routes it, layer by
    layer.  At bf16 the two paths' rounding of the activations moves
    choices at near-ties, so ``prefill(2049)`` runs with each layer's
    experts pinned to the ones ``prefill(2048)`` and the decode step chose
    (``pinned_experts``; the gates its own probabilities at them): every
    pinned choice it would not make itself must trail its own k-th
    probability by at most ``NEAR_TIE``."""
    import torch

    cfg = model.cfg
    s = LM_PROMPT
    b = tokens.shape[0]
    front = front or {}
    n_front = front["patches"].shape[1] if "patches" in front else 0
    with moe_spy() as (_, dec_routes):
        _, cache = model.prefill({"tokens": tokens[:, :s], **front},
                                 max_len=s + 1 + n_front)
        n_pre = len(dec_routes)
        lg_dec, _ = model.decode_step(cache, tokens[:, s])
    del cache
    pin = cfg.is_moe and name == "bf16"
    pins = [torch.cat([r_p.expert.reshape(b, s, -1),
                       r_d.expert.reshape(b, 1, -1)], 1).reshape(b * (s + 1),
                                                                -1)
            for (_, r_p), (_, r_d) in zip(dec_routes[:n_pre],
                                          dec_routes[n_pre:])] if pin else None
    with moe_spy() as (_, full_routes), pinned_experts(pins) as report:
        lg_full, _ = model.prefill({"tokens": tokens, **front})
    # decoded tokens routed elsewhere than by prefill(2049), over the layers
    unlike = sum(int((r_d.expert.sort(-1).values != r_f.expert.reshape(
        b, s + 1, -1)[:, s].sort(-1).values).any(-1).sum())
        for (_, r_d), (_, r_f) in zip(dec_routes[n_pre:], full_routes))
    del dec_routes, full_routes, pins
    diff = (lg_dec.float() - lg_full.float()).abs()
    top = lg_full.float().abs().max()
    same = bool((lg_dec.argmax(-1) == lg_full.argmax(-1)).all())
    atol, rtol = DECODE_TOL[name]
    within = bool((diff <= atol + rtol * lg_full.float().abs()).all())
    trail = max((t for _, t in report), default=0.0)
    note = ""
    if pin:
        note = (f"; prefill({s + 1}) pinned to the decode path's experts: "
                f"{sum(n for n, _ in report)} of {b * (s + 1)} x "
                f"{len(report)} token-layers moved from its own choice, "
                f"trailing its k-th probability by at most {trail:.2e} (<= "
                f"{NEAR_TIE:.0e})")
    elif cfg.is_moe:
        note = (f"; the decoded tokens routed as in prefill({s + 1}) in all "
                f"{cfg.n_layers} layers ({unlike} token-layers differ)")
    check(within and trail <= NEAR_TIE and (pin or unlike == 0),
          f"[{tag}] {cfg.name} decode after prefill({s}) vs "
          f"prefill({s + 1}), {name}: max |diff| {float(diff.max()):.3e} "
          f"(max |logit| {float(top):.3f}) within atol {atol} + rtol {rtol} "
          f"on all {b} rows{note}; greedy tokens equal: {same}")


def lm_phase(dev, check):
    """``[lm]``: the dense family's serving path at full width, random
    weights from a generator seeded 0, bf16 compute, through
    ``models.api.build`` and the serve launcher's ``generate``: a B=4,
    S=2048 Zipf prompt (``TokenStream(seed=0).batch_at(0)``) and greedy
    tokens.  tinyllama-1.1b (22 layers, 32 tokens): (a) the flash kernel
    against its plain version at the layer's shapes, bf16 and f32, window
    0 and 1024, and timed; (b) decode after ``prefill(t)`` against
    ``prefill(t + 1)``, bf16 and f32; (c) f32 prefill logits at B=1,
    S=256 against a float64 run of the same forward.  gemma3-4b (34
    layers, head dim 256, 5:1 local/global windows 1024 / 0, 32 tokens):
    the flash kernel at D = 256 as (a), (b).  deepseek-67b and
    command-r-plus-104b at 2 layers (``--layers``), 8 tokens, and the
    flash kernel at each one's D = 128 shape (R = 8, 12) against its plain
    version, bf16 and f32, window 0.  Every model
    its parameter count against the JAX shapes' and one flash launch a
    layer a prefill.  Returns ``{"d64": (row, max |err|, launches),
    "d256": (...)}``."""
    import dataclasses

    import torch

    from repro_torch import configs

    torch.backends.cuda.matmul.allow_tf32 = False    # f32 products in f32
    rows = {}
    for arch, want, key in (("tinyllama-1.1b", 1_100_048_384, "d64"),
                            ("gemma3-4b", 3_879_907_840, "d256")):
        cfg = configs.get(arch)
        g = cfg.n_kv_heads
        model = build_lm(cfg, dev, check, "lm", want)
        tokens = lm_tokens(cfg, dev)
        launches, _ = serve_lm(model, tokens, check, "lm")
        row, worst = flash_checks(
            dev, check, "lm", (LM_BATCH, LM_PROMPT, g, cfg.n_heads // g,
                               cfg.hd), LM_WINDOWS)
        rows[key] = (row, worst, launches)
        decode_vs_prefill(model, tokens, "bf16", "lm", check)
        del model
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        model32 = build_lm(cfg32, dev, check, "lm", want)
        decode_vs_prefill(model32, tokens, "f32", "lm", check)
        if key == "d64":
            # (c) f32 prefill logits against float64, B=1, S=256
            short = tokens[:1, :256]
            lg32, _ = model32.prefill({"tokens": short})
            with torch.inference_mode():
                lg64 = lm_forward64(model32.module, short)
            rel = float((lg32.double() - lg64).abs().max()
                        / lg64.abs().max())
            check(rel <= F64_REL and bool(torch.isfinite(lg32).all()),
                  f"[lm] f32 prefill logits (B=1, S=256) vs float64: max "
                  f"|diff| / max |logit| {rel:.3e} <= {F64_REL:.0e}")
        del model32
        torch.cuda.empty_cache()

    # the dense configs that do not fit one card, at 2 layers
    for arch, full in (("deepseek-67b", 67_425_001_472),
                       ("command-r-plus-104b", 103_810_609_152)):
        cfg = configs.get(arch)
        check(param_count(cfg) == full, f"[lm] {arch} at full depth: "
              f"{param_count(cfg):,} parameters from the shapes ({full:,})")
        cut = dataclasses.replace(cfg, n_layers=2)
        model = build_lm(cut, dev, check, "lm", param_count(cut))
        serve_lm(model, lm_tokens(cut, dev), check, "lm", n_gen=8)
        del model
        torch.cuda.empty_cache()
        # D = 128 with both warpgroups of a pair storing (R = 8, 12)
        g = cfg.n_kv_heads
        flash_checks(dev, check, "lm", (LM_BATCH, LM_PROMPT, g,
                                        cfg.n_heads // g, cfg.hd), (0,),
                     timed=False)
    return rows


@contextlib.contextmanager
def moe_spy():
    """Record every MoE layer's input ``(h, weights)`` and routing
    ``(logits, Routing)`` while the block runs (``transformer.moe_ffn``
    and ``moe.route`` wrapped, results unchanged)."""
    from repro_torch.models import moe, transformer

    calls, routes = [], []
    ffn, route = transformer.moe_ffn, moe.route

    def spy_ffn(h, lp, cfg):
        calls.append((h, lp))
        return ffn(h, lp, cfg)

    def spy_route(logits, cfg, *args, **kwargs):
        r = route(logits, cfg, *args, **kwargs)
        routes.append((logits, r))
        return r

    transformer.moe_ffn, moe.route = spy_ffn, spy_route
    try:
        yield calls, routes
    finally:
        transformer.moe_ffn, moe.route = ffn, route


def dropped_share(routes) -> float:
    """Token-choices past capacity over all choices of ``routes``."""
    dropped = sum(int((~r.keep).sum()) for _, r in routes)
    return dropped / sum(r.keep.numel() for _, r in routes)


def moe_phase(dev, check):
    """``[moe]``: the MoE family at full width, random weights from a
    generator seeded 0, bf16 compute, ``[lm]``'s B=4, S=2048 Zipf prompt.

    olmoe-1b-7b (16 layers, 64 experts top 8, capacity factor 1.25):
    the parameter count; the routing of one prefill and one decode step
    (the dropped share of token-choices in each, layer 0's
    ``expert_load_stats``, the experts a decode step reads); layer 0's
    ``moe_ffn`` on its real input, two card runs bit-equal at bf16, and at
    f32 the card against the CPU on the card's router logits (routing
    equal, outputs within 1e-4; the CPU's own logits and the routes they
    change printed); the flash kernel at olmoe's R = 1 shape against its
    plain version; ``generate`` with 32 tokens, one flash launch a layer;
    decode after ``prefill(t)`` against ``prefill(t + 1)`` at capacity
    factor E/k = 8 (no choice drops), bf16 and f32 (``decode_vs_prefill``:
    at bf16 the prefill pinned to the decode path's experts).
    qwen3-moe-235b-a22b at 2 layers (128 experts, R = 16): the parameter
    counts, ``generate`` with 8 tokens, the flash kernel at its shape
    against its plain version.  olmoe training at 2 layers
    (``moe_train``).  Returns olmoe's flash launches a prefill."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import api, moe

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get("olmoe-1b-7b")
    e, k = cfg.moe_experts, cfg.moe_top_k
    b, s = LM_BATCH, LM_PROMPT
    model = build_lm(cfg, dev, check, "moe", 6_816_073_728)
    tokens = lm_tokens(cfg, dev)

    # the routing of one prefill and one decode step
    with moe_spy() as (calls, routes):
        _, cache = model.prefill({"tokens": tokens[:, :s]}, max_len=s + 1)
        n_pre = len(routes)
        model.decode_step(cache, tokens[:, s])
    del cache
    pre, dec = routes[:n_pre], routes[n_pre:]
    read = sum(int(torch.unique(r.expert).numel()) for _, r in dec) / len(dec)
    stats = moe.expert_load_stats(pre[0][0], cfg)
    counts = stats["counts"]
    check(len(pre) == len(dec) == cfg.n_layers
          and int(counts.sum()) == b * s * k,
          f"[moe] one MoE call a layer in prefill and decode "
          f"({len(pre)}, {len(dec)}); layer 0's choices {int(counts.sum())} "
          f"= T·k")
    log(f"[moe] dropped token-choices at capacity factor "
        f"{cfg.moe_capacity_factor}: prefill {dropped_share(pre):.4%} "
        f"({pre[0][1].capacity} slots an expert for {b * s * k} choices "
        f"over {e} experts), one decode step {dropped_share(dec):.4%} "
        f"({dec[0][1].capacity} slots for {b * k}); layer 0's expert load "
        f"max / mean {float(stats['max_over_mean']):.3f} (counts "
        f"{int(counts.min())}..{int(counts.max())}, mean "
        f"{float(counts.mean()):.0f}); a decode step reads {read:.1f} of "
        f"{e} experts a layer")

    # layer 0's moe_ffn on its real input
    h0, lp0 = calls[0]
    del calls, routes
    with torch.inference_mode():
        a, a2 = moe.moe_ffn(h0, lp0, cfg), moe.moe_ffn(h0, lp0, cfg)
        h32 = h0.reshape(b * s, -1).float()
        lp32 = {n: w.float() for n, w in lp0.items()}
        logits = moe.router_logits(h32, lp32["moe_wg"])
        r_card = moe.route(logits, cfg)
        y_card = moe.moe_ffn(h32[None], lp32, cfg)[0]
        t0 = time.perf_counter()
        lp_cpu = {n: w.cpu() for n, w in lp32.items()}
        r_cpu = moe.route(logits.cpu(), cfg)
        y_cpu = moe.combine(moe.expert_ffn(
            moe.dispatch(h32.cpu(), r_cpu, e), lp_cpu["moe_w1"],
            lp_cpu["moe_w2"]), r_cpu)
        own = moe.router_logits(h32.cpu(), lp_cpu["moe_wg"])
        r_own = moe.route(own, cfg)
        t_cpu = time.perf_counter() - t0
    check(torch.equal(a, a2), f"[moe] layer 0's moe_ffn (bf16, T={b * s}): "
          f"two card runs bit-equal")
    same = all(torch.equal(getattr(r_card, n).cpu(), getattr(r_cpu, n))
               for n in ("expert", "slot", "keep"))
    err = max_abs_err(y_card.cpu(), y_cpu)
    check(same and torch.allclose(y_card.cpu(), y_cpu, rtol=1e-4, atol=1e-4),
          f"[moe] layer 0's moe_ffn at f32, card against the CPU on the "
          f"card's router logits: experts, slots and keep equal, outputs "
          f"max |diff| {err:.3e} within 1e-4 (CPU {t_cpu:.1f} s)")
    moved = int((r_own.expert != r_cpu.expert).any(-1).sum())
    log(f"[moe] the CPU's own f32 router logits differ from the card's by "
        f"max {max_abs_err(own, logits.cpu()):.3e}; they route {moved} of "
        f"{b * s} tokens elsewhere (top-k near-ties)")
    del a, a2, h0, lp0, h32, lp32, logits, y_card, lp_cpu, y_cpu

    # the flash kernel at olmoe's shape (one query head a KV group)
    flash_checks(dev, check, "moe", (b, s, cfg.n_kv_heads,
                                     cfg.n_heads // cfg.n_kv_heads, cfg.hd),
                 (0,), timed=False)
    launches, _ = serve_lm(model, tokens, check, "moe",
                           kept=1 - dropped_share(pre), experts_read=read)
    del model, pre, dec
    torch.cuda.empty_cache()

    # decode against prefill(t + 1) where no choice drops
    for name, dtype in (("bf16", "bfloat16"), ("f32", "float32")):
        full = dataclasses.replace(cfg, moe_capacity_factor=e / k,
                                   compute_dtype=dtype)
        m = api.build(full, dev, torch.Generator(device=dev).manual_seed(0))
        decode_vs_prefill(m, tokens, name, "moe", check)
        del m
        torch.cuda.empty_cache()

    # qwen3-moe at 2 layers
    q = configs.get("qwen3-moe-235b-a22b")
    check(param_count(q) == 235_093_610_496, f"[moe] {q.name} at full "
          f"depth: {param_count(q):,} parameters from the shapes "
          f"(235,093,610,496)")
    q = dataclasses.replace(q, n_layers=2)
    model = build_lm(q, dev, check, "moe",
                     2 * 2_487_754_752 + 1_244_659_712 + 4_096)
    serve_lm(model, lm_tokens(q, dev), check, "moe", n_gen=8)
    del model
    torch.cuda.empty_cache()
    flash_checks(dev, check, "moe", (b, s, q.n_kv_heads,
                                     q.n_heads // q.n_kv_heads, q.hd), (0,),
                 timed=False)

    moe_train(dev, check)
    log(f"[moe] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def leaf_names(tree, prefix=""):
    """``(path, leaf)`` of a parameter tree in ``tree_leaves`` order
    (sorted keys), the path's keys joined by ``/``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaf_names(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def moe_train(dev, check):
    """olmoe-1b-7b training at full width and 2 layers: the model, the
    token stream (B=8, S=2048) and the config's 8 microbatches from
    ``launch/train.py``'s ``build_everything``, ``AdamW(learning_rate=1e-3,
    warmup_steps=1)`` (the launcher's optimizer warms up over 100 steps,
    too slowly for three).  (a) The loss at init at bf16 compute within
    1e-2 of the f32 compute's (the tied head puts it far above ln(vocab));
    (b) one step on the stream's first batch: the gradients at bf16
    compute against f32 compute on the same parameters, each leaf of each
    layer within ``TRAIN_BF16_GRAD_REL`` (the router's and the experts'
    included), and AdamW's first update of them equal to its closed form;
    (c) three ``make_train_step`` steps on that batch: finite, the last
    loss below the first; the step time against its operations bound and
    the peak device memory; (d) at d_model 256 (64 experts top 8 kept),
    B=1, S=256, f32 compute: the loss and every gradient, the router's
    included, against a float64 run."""
    import numpy as np
    import torch

    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    from repro_torch.optim import AdamW, global_norm, tree_leaves, tree_map

    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    b, s = 8, 2048
    cfg, model, _, _, stream = ltrain.build_everything(
        "olmoe-1b-7b", False, b, s, 8, 1e-3, False, dev, layers=2)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == param_count(cfg) == 942_155_776,
          f"[moe] train {cfg.name} at 2 layers: {n_params:,} f32 "
          f"parameters (942,155,776), microbatches {cfg.microbatches}")
    batch = stream.batch_at(0)
    one = {"tokens": batch["tokens"][:1]}
    with torch.no_grad():
        loss0 = float(model.loss(params, one))
        loss32 = float(api.build(dataclasses.replace(
            cfg, compute_dtype="float32"), dev, serve=False).loss(
                params, one))
    # the head is the embedding (tied): at init the input token's own
    # logit, about sqrt(d_model), dominates, so the loss is far above
    # ln(vocab), in the JAX model as in the port
    check(math.isfinite(loss0) and abs(loss0 - loss32) <= 1e-2 * loss32,
          f"[moe] train (a) the loss at init {loss0:.4f} (bf16 compute) "
          f"within 1e-2 of the f32 compute's {loss32:.4f} on the same "
          f"parameters (ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}; the "
          f"tied head's self-logit ~ sqrt({cfg.d_model}) = "
          f"{math.sqrt(cfg.d_model):.1f})")
    opt = AdamW(learning_rate=1e-3, warmup_steps=1)

    # (b) one step's gradients, bf16 compute against f32, and its update
    g16, _ = api.accumulate_grads(model, params, batch, cfg.microbatches)
    g32, _ = api.accumulate_grads(api.build(dataclasses.replace(
        cfg, compute_dtype="float32"), dev, serve=False), params, batch,
        cfg.microbatches)
    rels = {}
    for (name, a), c in zip(leaf_names(g16), tree_leaves(g32)):
        for i, (x, y) in enumerate(zip(a, c) if name.startswith("layers/")
                                   else [(a, c)]):
            key = f"{name}[{i}]" if name.startswith("layers/") else name
            rels[key] = float((x - y).norm() / y.norm())
    worst = max(rels, key=rels.get)
    moe_rel = max(v for n, v in rels.items() if "/moe_" in n)
    check(all(v <= TRAIN_BF16_GRAD_REL for v in rels.values()),
          f"[moe] train (b) one step's gradients (B={b}, S={s}, "
          f"{cfg.microbatches} microbatches) at bf16 compute against f32 "
          f"compute, each of the {len(rels)} leaf-layers (moe_wg, moe_w1, "
          f"moe_w2 included): ||g16 - g32|| / ||g32|| <= "
          f"{TRAIN_BF16_GRAD_REL:.0e}, worst {rels[worst]:.3e} ({worst}), "
          f"worst MoE leaf {moe_rel:.3e}")
    # AdamW's first step with warm-up 1: -lr (g / (|g| + eps) + wd p),
    # g clipped to global norm clip_norm
    upd, _ = opt.update(g16, opt.init(params), params)
    clip = min(1.0, opt.clip_norm / float(global_norm(g16)))
    upd_err = max(float((u - (-opt.learning_rate) * (
        g * clip / ((g * clip).abs() + opt.eps) + opt.weight_decay * w))
        .abs().max()) for u, g, w in zip(
            tree_leaves(upd), tree_leaves(g16), tree_leaves(params)))
    moved = all(bool((u != 0).any()) for u in tree_leaves(upd))
    check(upd_err <= 1e-4 * opt.learning_rate and moved,
          f"[moe] train (b) AdamW's first update of those gradients (clip "
          f"{clip:.3e}) equals -lr (g / (|g| + eps) + wd p) in every leaf: "
          f"max |diff| {upd_err:.3e} <= 1e-4 lr; every leaf moves")
    del g16, g32, upd

    # (c) three steps on the batch: the step time
    step_fn = api.make_train_step(model, opt, cfg.microbatches)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    p = params
    for _ in range(3):
        t = time.perf_counter()
        p, state, met = step_fn(p, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated() - m0
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(p))
    check(losses[-1] < losses[0] and finite,
          f"[moe] train (c) 3 steps on one batch: losses "
          f"{[round(x, 4) for x in losses]}, the last below the first, no "
          f"NaN in the parameters")
    tokens = b * s
    d, f = cfg.d_model, cfg.d_ff
    dense = 2 * d * cfg.n_heads * cfg.hd + 2 * d * cfg.n_kv_heads * cfg.hd
    active = cfg.n_layers * (dense + d * cfg.moe_experts
                             + cfg.moe_top_k * 3 * d * f) + d * cfg.vocab
    attn_fwd = 4 * b * s * s * cfg.n_heads * cfg.hd * cfg.n_layers
    # forward, its recompute and the backward (twice a forward's products)
    bound_s = (4 * 2 * active * tokens / BF16_OPS_PER_S
               + 4 * attn_fwd / F32_OPS_PER_S)
    step_ms = float(np.mean(secs[1:])) * 1e3
    log(f"[moe] train step {step_ms:.1f} ms (steps 2-3; the first "
        f"{secs[0] * 1e3:.1f} ms), {tokens / step_ms * 1e3:.0f} tokens/s; "
        f"operations bound {bound_s * 1e3:.1f} ms (every choice kept: bf16 "
        f"products at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, the f32 "
        f"attention at {F32_OPS_PER_S / 1e12:.0f}); peak device memory of "
        f"the steps {peak / 2**30:.2f} GiB")
    del p, state, params, step_fn, batch, met, model
    torch.cuda.empty_cache()

    # (d) f32 against float64 at a small width
    small = dataclasses.replace(cfg, d_model=256, n_heads=4, n_kv_heads=4,
                                head_dim=64, d_ff=128,
                                compute_dtype="float32")
    m32 = api.build(small, dev, serve=False)
    m64 = api.build(dataclasses.replace(small, compute_dtype="float64",
                                        param_dtype="float64"), dev,
                    serve=False)
    p32 = m32.init_params(torch.Generator(device=dev).manual_seed(1))
    one = {"tokens": api.synth_batch(small, api.ShapeSpec(
        "t", "train", 256, 1), seed=1, device=dev)["tokens"]}
    g32, l32 = api.accumulate_grads(m32, p32, one, 1)
    g64, l64 = api.accumulate_grads(m64, tree_map(torch.Tensor.double, p32),
                                    one, 1)
    loss_rel = abs(float(l32[0]) - float(l64[0])) / abs(float(l64[0]))
    grad_rel = max(float((a.double() - c).abs().max() / c.abs().max())
                   for a, c in zip(tree_leaves(g32), tree_leaves(g64)))
    check(loss_rel <= 1e-5 and grad_rel <= 1e-4,
          f"[moe] train (d) 2 layers, d_model 256, 64 experts top 8, B=1, "
          f"S=256, f32 against float64: loss rel err {loss_rel:.3e} (<= "
          f"1e-5), gradients max |diff| / max |g| {grad_rel:.3e}, the worst "
          f"of the {len(tree_leaves(g32))} leaves (<= 1e-4)")
    del g32, g64, m32, m64, p32
    torch.cuda.empty_cache()


def encdec_phase(dev, check):
    """``[encdec]``: the encoder-decoder and vision families at full width,
    random weights from a generator seeded 0, bf16 compute, through
    ``models.api.build`` and the serve launcher's ``generate``: ``[lm]``'s
    B=4, S=2048 Zipf prompt (``TokenStream(seed=0).batch_at(0)``) with the
    stream's frames ``[4, 2048, 1024]`` or patches ``[4, 256, 6144]``, 32
    greedy tokens.  seamless-m4t-large-v2 (24 encoder and 24 decoder
    layers, MHA 16/16 of head dim 64) and internvl2-26b (48 layers, GQA
    48/8 of head dim 128, 256 patches before the tokens), each at full
    depth: (a) the flash kernel against its plain version at the path's
    shapes, timed: seamless's decoder ``[4, 2048, 16, 1, 64]`` causal and
    encoder (the same shape) not causal, internvl2's ``[4, 2304, 8, 6,
    128]`` causal; (b) the parameter count against the JAX shapes', and
    the prefill's flash launches (seamless 24 not causal and 24 causal,
    internvl2 48); (c) decode after ``prefill(t)`` against ``prefill(t +
    1)``, the same frames or patches in both, at bf16 and at f32
    (internvl2's f32 weights at 2 layers: at full depth they would take 77
    GB); (d) f32 prefill logits at B=1, 256 tokens (and 256 frames, or the
    256 patches) against a float64 run of the same forward (seamless at
    full depth, internvl2 at 2 layers); (e) seamless training at 2 layers
    (``encdec_train``).  Returns ``{"noncausal": (row, max |err|,
    launches), "vlm": (...)}``: seamless's encoder and internvl2's shapes
    with their prefill's launches."""
    import dataclasses

    import torch

    from repro_torch import configs

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = {}
    for arch, want in (("seamless-m4t-large-v2", 1_773_477_888),
                       ("internvl2-26b", 19_330_363_392)):
        cfg = configs.get(arch)
        g = cfg.n_kv_heads
        front = lm_batch(cfg, dev)
        tokens = front.pop("tokens")
        n_front = front["patches"].shape[1] if "patches" in front else 0
        model = build_lm(cfg, dev, check, "encdec", want)
        launches, noncausal = serve_lm(model, tokens, check, "encdec",
                                       front=front)
        shape = (LM_BATCH, LM_PROMPT + n_front, g, cfg.n_heads // g, cfg.hd)
        row, worst = flash_checks(dev, check, "encdec", shape, (0,))
        if cfg.enc_dec:
            enc = (LM_BATCH, front["frames"].shape[1]) + shape[2:]
            row, worst = flash_checks(dev, check, "encdec", enc, (),
                                      causal=False)
            rows["noncausal"] = (row, worst, noncausal)
        else:
            rows["vlm"] = (row, worst, launches)
        decode_vs_prefill(model, tokens, "bf16", "encdec", check, front)
        del model
        torch.cuda.empty_cache()
        cut = cfg if cfg.enc_dec else dataclasses.replace(cfg, n_layers=2)
        cut = dataclasses.replace(cut, compute_dtype="float32")
        model32 = build_lm(cut, dev, check, "encdec",
                           want if cfg.enc_dec else param_count(cut))
        decode_vs_prefill(model32, tokens, "f32", "encdec", check, front)
        short = {k: v[:1, :256] for k, v in front.items()}
        lg32, _ = model32.prefill({"tokens": tokens[:1, :256], **short})
        with torch.inference_mode():
            lg64 = lm_forward64(model32.module, tokens[:1, :256], short)
        rel = float((lg32.double() - lg64).abs().max() / lg64.abs().max())
        inputs = " and ".join(f"{v.shape[1]} {k}" for k, v in short.items())
        check(rel <= F64_REL and bool(torch.isfinite(lg32).all()),
              f"[encdec] {cut.name} at {cut.n_layers} layers, f32 prefill "
              f"logits (B=1, 256 tokens and {inputs}) vs float64: max |diff| "
              f"/ max |logit| {rel:.3e} <= {F64_REL:.0e}")
        del model32, lg32, lg64
        torch.cuda.empty_cache()
    encdec_train(dev, check)
    log(f"[encdec] phase {time.perf_counter() - t_phase:.1f} s")
    return rows


def encdec_train(dev, check):
    """seamless-m4t-large-v2 training at full width and 2 layers (2 encoder
    and 2 decoder layers): the model and the token stream (B=8, S=2048, its
    frames ``[8, 2048, 1024]``) from ``launch/train.py``'s
    ``build_everything``, 8 microbatches of one row (the config's 16 would
    cut rows in half).  One step's gradients at bf16 compute against f32
    compute on the same parameters and batch: each leaf of each layer
    (the encoder's, the cross blocks' and ``frontend_proj`` included)
    within ``TRAIN_BF16_GRAD_REL``, and every one nonzero."""
    import dataclasses

    import torch

    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    from repro_torch.optim import tree_leaves

    b, s, mbs = 8, 2048, 8
    cfg, model, _, _, stream = ltrain.build_everything(
        "seamless-m4t-large-v2", False, b, s, mbs, 1e-3, False, dev,
        layers=2)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = stream.batch_at(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g16, l16 = api.accumulate_grads(model, params, batch, mbs)
    torch.cuda.synchronize()
    t16 = time.perf_counter() - t0
    g32, l32 = api.accumulate_grads(api.build(dataclasses.replace(
        cfg, compute_dtype="float32"), dev, serve=False), params, batch, mbs)
    rels, still = {}, []
    for (name, a), c in zip(leaf_names(g16), tree_leaves(g32)):
        stacked = name.startswith(("layers/", "encoder/"))
        for i, (x, y) in enumerate(zip(a, c) if stacked else [(a, c)]):
            key = f"{name}[{i}]" if stacked else name
            if float(y.norm()) == 0:
                still.append(key)
            rels[key] = float((x - y).norm() / y.norm())
    worst = max(rels, key=rels.get)
    part = {p: max(v for n, v in rels.items() if p in n)
            for p in ("encoder/", "_x[", "frontend_proj")}
    check(n_params == param_count(cfg) and not still
          and all(v <= TRAIN_BF16_GRAD_REL for v in rels.values()),
          f"[encdec] train {cfg.name} at 2 layers ({n_params:,} f32 "
          f"parameters): one step's gradients (B={b}, S={s}, {s} frames, "
          f"{mbs} microbatches) at bf16 compute against f32 compute, each "
          f"of the {len(rels)} leaf-layers nonzero ({len(still)} zero) and "
          f"within ||g16 - g32|| / ||g32|| <= {TRAIN_BF16_GRAD_REL:.0e}: "
          f"worst {rels[worst]:.3e} ({worst}); worst encoder leaf "
          f"{part['encoder/']:.3e}, cross leaf {part['_x[']:.3e}, "
          f"frontend_proj {part['frontend_proj']:.3e}; losses "
          f"{float(l16.mean()):.4f} (bf16) / {float(l32.mean()):.4f} (f32); "
          f"the bf16 gradients in {t16:.2f} s")
    del g16, g32, params, model, batch
    torch.cuda.empty_cache()


def free_device_memory(tag: str) -> None:
    """Collect garbage, empty the cache and print the device memory still
    allocated, at the start of an LM phase."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    live = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            live[obj.untyped_storage().data_ptr()] = (
                obj.untyped_storage().nbytes(), tuple(obj.shape), obj.dtype)
    top = sorted(live.values(), key=lambda t: t[0])[-3:]
    log(f"[{tag}] device memory still allocated at the phase's start: "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB; "
        f"{sum(t[0] for t in live.values()) / 2**30:.3f} GiB in the "
        f"{len(live)} storages of tensors the collector sees, the largest "
        + ", ".join(f"{n / 2**20:.1f} MiB {list(shape)} {dt}"
                    for n, shape, dt in reversed(top)))


def ssm_bounds(cfg, b, s, n_gen):
    """``(prefill ms, its terms, decode step ms, its terms)``: the least
    time of ``cfg``'s prefill of ``b x s`` tokens and of one decode step
    in bf16.  zamba2's prefill: its products at the bf16 tensor-core rate,
    the SSD's einsums (128-token chunks) in f32 at the f32 rate, the flash
    launches' bounds; a step reads every weight (the tied head the whole
    embedding), the live K/V, the conv tails and the f32 SSD states (read
    and written).  xLSTM's prefill is JAX's: ``s`` sequential steps, each
    reading the layers' weights (not ``up_proj``'s gate half, which the
    port does not multiply) and the f32 states a layer uses (read and
    written); a decode step that and the head."""
    from repro_torch.models import mamba2 as mb
    from repro_torch.models import xlstm as X
    from repro_torch.models import zamba as Z

    d = cfg.d_model
    if cfg.family == "hybrid":
        ng = Z.n_groups(cfg)
        di, n = cfg.ssm_expand * d, cfg.ssm_state
        h, p = di // mb.HEAD_DIM, mb.HEAD_DIM
        mshape = mb.mamba_param_shapes(cfg)
        mm = (cfg.n_layers * (math.prod(mshape["in_proj"])
                              + math.prod(mshape["out_proj"]))
              + ng * sum(math.prod(shape) for name, shape in
                         Z.shared_param_shapes(cfg).items()
                         if not name.startswith("norm")))
        flops = 2 * b * s * mm + 2 * b * d * cfg.vocab
        l = min(128, s)
        nc = -(-s // l)
        ssd = cfg.n_layers * 2 * b * nc * (l * l * n + h * l * l * p
                                           + 2 * l * h * p * n)
        attn = ng * attention_bound(b, s, cfg.n_kv_heads,
                                    cfg.n_heads // cfg.n_kv_heads,
                                    cfg.hd)[0]
        prefill = 1e3 * flops / BF16_OPS_PER_S + 1e3 * ssd / F32_OPS_PER_S \
            + attn
        terms = (f"{flops / 1e12:.2f} TFLOP of bf16 products, "
                 f"{ssd / 1e12:.3f} TFLOP of the SSD's f32 einsums at 67 "
                 f"TFLOP/s, {attn:.4f} ms of flash attention")
        live = s + n_gen // 2
        step = (2 * Z.param_count(cfg)
                + 2 * 2 * ng * b * live * cfg.n_kv_heads * cfg.hd
                + 2 * 2 * cfg.n_layers * b * (cfg.ssm_conv - 1) * (di + 2 * n)
                + 2 * 4 * cfg.n_layers * b * h * p * n)
        return (prefill, terms, 1e3 * step / HBM_BYTES_PER_S,
                f"{step / 1e9:.3f} GB of weights, live K/V, conv tails and "
                f"f32 SSD states")
    di = 2 * d
    h = cfg.n_heads
    dh = di // h
    layer = sum(math.prod(shape) for shape in
                X.layer_param_shapes(cfg).values()) - d * di
    n_s = int(X.slstm_layers_mask(cfg).sum())
    state = 4 * b * h * ((cfg.n_layers - n_s) * (dh * dh + dh)
                         + n_s * (3 * dh + 1))
    core = 2 * cfg.n_layers * layer + 2 * state
    step = core + 2 * cfg.vocab * d
    prefill = 1e3 * s * core / HBM_BYTES_PER_S
    return (prefill, f"{s} sequential steps of {core / 1e6:.1f} MB (bf16 "
            f"layer weights, f32 states read and written)",
            1e3 * step / HBM_BYTES_PER_S,
            f"{step / 1e6:.1f} MB of weights, head and f32 states")


def serve_ssm(model, tokens, check, s=LM_PROMPT):
    """The serve launcher's ``generate`` on ``tokens[:, :s]`` (B=4),
    ``LM_GEN`` greedy tokens, warmed once on 16 tokens; checks the
    tokens and the flash launches of the prefill (one a shared-block call
    for zamba2, none for xLSTM), with every count set to 0 just before;
    prints the prefill and decode walls and tok/s beside their bounds and
    the peak device memory.  Returns the prefill's flash launches and
    ``generate``'s result."""
    import torch

    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch.serve import generate
    from repro_torch.models import zamba as Z

    cfg = model.cfg
    b = LM_BATCH
    generate(model, {"tokens": tokens[:, :16]}, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfa.flash_attention.launches = kfa.flash_attention.noncausal_launches = 0
    res = generate(model, {"tokens": tokens[:, :s]}, LM_GEN)
    launches = kfa.flash_attention.launches
    noncausal = kfa.flash_attention.noncausal_launches
    out = res["tokens"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(out.shape == (b, LM_GEN) and int(out.min()) >= 0
          and int(out.max()) < cfg.vocab,
          f"[ssm] {cfg.name}: generated tokens [{b}, {LM_GEN}] in the "
          f"vocabulary")
    want = Z.n_groups(cfg) if cfg.family == "hybrid" else 0
    check(launches == want and noncausal == 0,
          f"[ssm] {cfg.name}: the flash kernel launched {launches} times in "
          f"the prefill ({want}: one a shared-block call), {noncausal} not "
          f"causal")
    prefill, p_terms, step, s_terms = ssm_bounds(cfg, b, s, LM_GEN)
    steps = LM_GEN - 1
    log(f"[ssm] {cfg.name} prefill: {b * s} tokens a batch of {b} in "
        f"{res['prefill_s'] * 1e3:.1f} ms ({b * s / res['prefill_s']:.0f} "
        f"tok/s); bound {prefill:.2f} ms ({p_terms})")
    log(f"[ssm] {cfg.name} decode: {b * steps} tokens in "
        f"{res['decode_s'] * 1e3:.1f} ms ({b * steps / res['decode_s']:.0f} "
        f"tok/s, {res['decode_s'] * 1e3 / steps:.3f} ms per step); bound "
        f"{step:.3f} ms per step ({s_terms} at 3.35 TB/s); peak {peak:.2f} "
        f"GiB; first tokens {out[0, :8].tolist()}")
    return launches, res


def ssm_decode_and_prefill(model, tokens):
    """The last logits of decode after ``prefill(2048)`` and of
    ``prefill(2049)``."""
    s = LM_PROMPT
    _, cache = model.prefill({"tokens": tokens[:, :s]}, max_len=s + 1)
    lg_dec, _ = model.decode_step(cache, tokens[:, s])
    del cache
    lg_full, _ = model.prefill({"tokens": tokens})
    return lg_dec, lg_full


def ssm_decode_vs_prefill(model, tokens, name, check, reference):
    """zamba2: decode after ``prefill(2048)`` against ``prefill(2049)``.
    The two paths differ (the chunked SSD, 2049 tokens padded to whole
    chunks, against its one-step recurrence; the flash kernel against the
    decode attention; at bf16 the prefill's SSD state rounded into the
    cache, as in JAX), and 54 random layers amplify rounding (the JAX
    test's 2e-3 is for 4 layers): their gap must stay within twice the
    prefill's own rounding error, ``prefill(2049)`` against
    ``reference``, its logits at the next precision on the same weights
    (bf16: f32 compute; f32: a float64 parallel forward)."""
    cfg = model.cfg
    s = LM_PROMPT
    lg_dec, lg_full = ssm_decode_and_prefill(model, tokens)
    gap = float((lg_dec.double() - lg_full.double()).abs().max())
    noise = float((lg_full.double() - reference.double()).abs().max())
    same = bool((lg_dec.argmax(-1) == lg_full.argmax(-1)).all())
    check(gap <= 2 * noise,
          f"[ssm] {cfg.name} decode after prefill({s}) vs prefill({s + 1}), "
          f"{name}: max |diff| {gap:.3e} (max |logit| "
          f"{float(lg_full.float().abs().max()):.3f}) within twice the "
          f"prefill's own {name} rounding error {noise:.3e} (against the "
          f"next precision); greedy tokens equal: {same}")


def xlstm_decode_vs_prefill(model, tokens, served, check, s):
    """xLSTM's prefill is its decode step, replayed: the logits of the
    served run's last decode step (after ``prefill(s)`` and 30 more
    steps) against ``prefill`` of the prompt and the first 31 served
    tokens, bit for bit."""
    import torch

    gen = served["tokens"].shape[1]
    longer = torch.cat([tokens[:, :s], served["tokens"][:, :-1]], 1)
    lg_full, _ = model.prefill({"tokens": longer})
    gap = float((served["logits"].double() - lg_full.double()).abs().max())
    check(torch.equal(served["logits"], lg_full),
          f"[ssm] {model.cfg.name} decode step {gen - 1} after prefill({s}) "
          f"vs prefill({s + gen - 1}) of the served tokens, bf16: bit for "
          f"bit (max |diff| {gap:.3e})")


def tree_as(model, cfg):
    """A serving model of ``cfg`` (another compute dtype) holding
    ``model``'s weights, cast: ``final_norm`` to the parameter dtype, the
    rest to the compute dtype."""
    from repro_torch.models import api
    from repro_torch.models.common import TreeModule, dtype_of

    cdt, pdt = dtype_of(cfg.compute_dtype), dtype_of(cfg.param_dtype)
    tree = {k: ({n: w.to(cdt) for n, w in v.items()} if isinstance(v, dict)
                else v.to(pdt if k == "final_norm" else cdt))
            for k, v in model.module.tree().items()}
    return api.Model(cfg=cfg, module=TreeModule(cfg, tree),
                     device=model.device)


def as_f64(cfg):
    return dataclasses.replace(cfg, compute_dtype="float64",
                               param_dtype="float64")


def ssm_f64(model32, tokens, check):
    """f32 prefill logits of ``model32`` (B=1, 256 tokens) against a
    float64 parallel forward of the family on the same weights (the plain
    functions: ``training_attention``, the SSD dual, the sLSTM loop).
    zamba2: within ``F64_REL``.  xLSTM amplifies rounding (the JAX model's
    own f32 prefill differs from float64 by 41 % of the largest logit at
    12 layers, S = 256, on the CPU), so its f32 error is printed beside
    the f32 parallel forward's; held: the float64 prefill (the decode
    step, replayed) equal to the float64 parallel forward within 1e-9."""
    import torch

    from repro_torch.models import api

    cfg = model32.cfg
    fam = api.family(cfg)
    short = tokens[:1, :256]
    lg32, _ = model32.prefill({"tokens": short})
    m64 = tree_as(model32, as_f64(cfg))
    tree64 = m64.module.tree()
    kw = dict(train=True) if cfg.family == "hybrid" else {}
    with torch.no_grad():
        lg64 = fam.forward(tree64, m64.cfg, short, **kw)[:, -1]
        par32 = fam.forward(model32.module.tree(), cfg, short, **kw)[:, -1]

    def rel(x):
        return float((x.double() - lg64).abs().max() / lg64.abs().max())

    what = (f"[ssm] {cfg.name} at {cfg.n_layers} layers, f32 prefill logits "
            f"(B=1, 256 tokens) vs a float64 parallel forward: max |diff| / "
            f"max |logit| {rel(lg32):.3e}")
    if cfg.family == "hybrid":
        check(rel(lg32) <= F64_REL and bool(torch.isfinite(lg32).all()),
              f"{what} <= {F64_REL:.0e}")
        return
    seq64, _ = m64.prefill({"tokens": short})
    check(rel(seq64) <= 1e-9 and bool(torch.isfinite(lg32).all()),
          f"{what} (the f32 parallel forward's {rel(par32):.3e}: the model "
          f"amplifies rounding); the float64 prefill, the decode step "
          f"replayed, vs the float64 parallel forward {rel(seq64):.3e} <= "
          f"1e-9")


def ssm_long_cache(model, tokens, check):
    """zamba2 at B=1: a prefill of 2048 tokens into a ``SSM_LONG_SLOTS``
    (long_500k's) cache and 4 greedy decode steps, against the same run
    in a 2,080-slot cache: every logit equal (the decode attention reads
    the live slots only).  Prints the peak device memory."""
    import torch

    def run(slots):
        torch.cuda.reset_peak_memory_stats()
        lg, cache = model.prefill({"tokens": tokens[:1, :LM_PROMPT]},
                                  max_len=slots)
        out = [lg]
        for _ in range(4):
            lg, cache = model.decode_step(cache, lg.argmax(-1))
            out.append(lg)
        kv = 2 * cache["k"].numel() * cache["k"].element_size()
        del cache
        torch.cuda.synchronize()
        return torch.stack(out), kv, torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    long, kv, peak = run(SSM_LONG_SLOTS)
    wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    short, _, peak_short = run(LM_PROMPT + LM_GEN)
    check(torch.equal(long, short),
          f"[ssm] {model.cfg.name} B=1, prefill {LM_PROMPT} + 4 decode "
          f"steps in a {SSM_LONG_SLOTS:,}-slot cache ({kv / 1e9:.2f} GB of "
          f"K/V) vs a {LM_PROMPT + LM_GEN:,}-slot one: every logit equal; "
          f"{wall:.2f} s, peak {peak / 2**30:.2f} GiB ({peak_short / 2**30:.2f}"
          f" GiB with the short cache)")


def ssm_train(dev, check, arch, layers, b, s):
    """``arch`` training at full width and ``layers`` layers: the model
    and token stream (B=``b``, S=``s``) from ``launch/train.py``'s
    ``build_everything``, the config's microbatches.  (a) The loss at
    init at bf16 against f32 compute; (b) one step's gradients at bf16
    against f32 compute: every leaf-layer finite, one off the path zero in
    both (xLSTM's mLSTM layers use no recurrent gate weights, its sLSTM
    layers no q or k), the gap printed per leaf and layer (no limit: the
    JAX model's own bf16 gap is 0.13-1.77 of the gradient's norm at the
    CPU tests' configs); (c) at B=1, S=256, the f32 gradients against
    float64; (d) two AdamW steps (``learning_rate=1e-3``,
    ``warmup_steps=1``) on the batch, the first from (b)'s gradients and
    the second through ``make_train_step``: finite, every leaf moved, the
    losses printed (on this Zipf stream the JAX model's loss rises after
    the first step too).  zamba2 holds (a) within 1e-2 and (c) within
    1e-5 (loss) and ``SSM_F64_GRAD``; xLSTM amplifies rounding (see
    ``ssm_f64``), so its (a) and (c) are printed, and (c) holds its
    float64 gradients on the card to the same code on the host within
    1e-6."""
    import torch

    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    from repro_torch.optim import AdamW, apply_updates, tree_leaves, tree_map

    held = arch == "zamba2-2.7b"
    cfg, model, _, _, stream = ltrain.build_everything(
        arch, False, b, s, 0, 1e-3, False, dev, layers=layers)
    mbs = cfg.microbatches
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch = stream.batch_at(0)
    one = {"tokens": batch["tokens"][:1]}
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    m32 = api.build(cfg32, dev, serve=False)
    with torch.no_grad():
        loss0, loss32 = float(model.loss(params, one)), float(
            m32.loss(params, one))
    close = abs(loss0 - loss32) <= 1e-2 * loss32
    check(math.isfinite(loss0) and (close or not held)
          and n_params == api.family(cfg).param_count(cfg),
          f"[ssm] train {cfg.name} at {layers} layers ({n_params:,} f32 "
          f"parameters, {mbs} microbatches): (a) the loss at init "
          f"{loss0:.4f} (bf16 compute) against f32 compute's {loss32:.4f}"
          + (" within 1e-2" if held else f", rel {abs(loss0 - loss32) / loss32:.3e} (printed)")
          + f"; ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g16, l16 = api.accumulate_grads(model, params, batch, mbs)
    torch.cuda.synchronize()
    t16 = time.perf_counter() - t0
    g32, _ = api.accumulate_grads(m32, params, batch, mbs)
    rels, off, finite = {}, [], True
    for (name, a), c in zip(leaf_names(g16), tree_leaves(g32)):
        stacked = name.startswith(("layers/", "mamba/"))
        finite &= bool(torch.isfinite(a).all() and torch.isfinite(c).all())
        for i, (x, y) in enumerate(zip(a, c) if stacked else [(a, c)]):
            key = f"{name}[{i}]" if stacked else name
            if float(y.norm()) == 0:
                off.append((key, float(x.norm())))
            else:
                rels[key] = float((x - y).norm() / y.norm())
    gap = float(math.sqrt(sum(float((x - y).square().sum()) for x, y in zip(
        tree_leaves(g16), tree_leaves(g32)))) / math.sqrt(sum(
            float(y.square().sum()) for y in tree_leaves(g32))))
    worst = sorted(rels, key=rels.get)[-3:]
    check(finite and all(n == 0 for _, n in off),
          f"[ssm] train {cfg.name} (b) one step's gradients (B={b}, S={s}) "
          f"at bf16 against f32 compute: all finite, {len(off)} leaf-layers "
          f"off the path zero in both; gap ||g16 - g32|| / ||g32|| {gap:.3e} "
          f"over the model, per leaf-layer "
          f"{', '.join(f'{k} {rels[k]:.3e}' for k in reversed(worst))} "
          f"(largest), median {sorted(rels.values())[len(rels) // 2]:.3e}; "
          f"the bf16 gradients in {t16:.2f} s")
    del g32

    # (c) at B=1, S=256: f32 against float64; xLSTM's float64 gradients
    # on the card against the same code on the host
    m64 = api.build(as_f64(cfg32), dev, serve=False)
    short = {"tokens": batch["tokens"][:1, :257]}
    p64 = tree_map(torch.Tensor.double, params)
    g64, l64 = api.accumulate_grads(m64, p64, short, 1)
    g32, l32 = api.accumulate_grads(m32, params, short, 1)

    def worst(got, want):
        return max(float((x.double().cpu() - y.cpu()).abs().max()
                         / y.abs().max()) for x, y in zip(
            tree_leaves(got), tree_leaves(want)) if float(y.abs().max()) > 0)

    loss_rel = abs(float(l32[0]) - float(l64[0])) / abs(float(l64[0]))
    grad_rel = worst(g32, g64)
    what = (f"[ssm] train {cfg.name} (c) B=1, S=256, f32 against float64: "
            f"loss rel {loss_rel:.3e}, gradients max |diff| / max |g| "
            f"{grad_rel:.3e} (worst of {len(tree_leaves(g32))} leaves)")
    if held:
        check(loss_rel <= 1e-5 and grad_rel <= SSM_F64_GRAD,
              f"{what} within 1e-5 and {SSM_F64_GRAD:.0e}")
    else:
        cpu = api.build(as_f64(cfg32), "cpu", serve=False)
        g_cpu, l_cpu = api.accumulate_grads(
            cpu, tree_map(lambda w: w.cpu(), p64),
            {"tokens": short["tokens"].cpu()}, 1)
        host_rel = worst(g64, g_cpu)
        check(host_rel <= 1e-6 and abs(float(l64[0]) - float(l_cpu[0]))
              <= 1e-9 * abs(float(l_cpu[0])),
              f"{what} (printed: the model amplifies rounding); float64 on "
              f"the card against the host: gradients {host_rel:.3e} (<= "
              f"1e-6), loss {float(l64[0]):.12f} / {float(l_cpu[0]):.12f}")
        del cpu, g_cpu
    del g32, g64, m64, m32, p64

    # (d) two AdamW steps on the batch: the first from (b)'s gradients,
    # as make_train_step takes it, the second by make_train_step
    opt = AdamW(learning_rate=1e-3, warmup_steps=1)
    state = opt.init(params)
    updates, state = opt.update(g16, state, params)
    p = apply_updates(params, updates)
    del g16, updates
    step_fn = api.make_train_step(model, opt, mbs)
    t0 = time.perf_counter()
    p, state, met = step_fn(p, state, batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    losses = [float(l16.mean()), float(met["loss"])]
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(p))
    moved = all(bool((x != w).any()) for x, w in zip(tree_leaves(p),
                                                      tree_leaves(params)))
    check(finite and moved and all(math.isfinite(x) for x in losses),
          f"[ssm] train {cfg.name} (d) 2 AdamW steps (lr 1e-3) on one batch: "
          f"losses {[round(x, 4) for x in losses]}, no NaN, every leaf "
          f"moved; the second step {secs:.2f} s ({b * s / secs:.0f} "
          f"tokens/s)")
    del p, state, params, model, batch
    torch.cuda.empty_cache()


def ssm_phase(dev, check):
    """``[ssm]``: the SSM and hybrid families at full width and depth,
    random weights from a generator seeded 0, bf16 compute, through
    ``models.api.build`` and the serve launcher's ``generate`` on
    ``[lm]``'s B=4, S=2048 Zipf prompt, 32 greedy tokens.  First the
    device memory earlier phases left is freed and printed.  zamba2-2.7b
    (54 mamba2 layers, the shared MHA block of 32 heads of 80 every 6): (a)
    the flash kernel at ``[4, 2048, 32, 1, 80]`` causal against its plain
    version (bf16 and f32) and timed; (b) the parameter count, serving
    with 9 flash launches a prefill, decode vs prefill at bf16; (c) B=1
    into a 524,288-slot cache against a 2,080-slot one; (d) at f32 compute
    decode vs prefill, and a 6-layer cut's f32 prefill against float64.
    xlstm-125m (12 layers, sLSTM every 4th): serving on the prompt's
    first ``XLSTM_PROMPT`` tokens (its token-by-token prefill's wall),
    decode vs prefill bit for bit, f32 vs float64.  Training: xlstm-125m
    at 4 layers (B=8, S=``XLSTM_TRAIN_SEQ``), zamba2-2.7b at 6 (B=8,
    S=2048).  Returns (row, max |err| of bf16, launches) of the
    flash kernel at D = 80."""
    import torch

    from repro_torch import configs
    from repro_torch.models import api

    free_device_memory("ssm")
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, want in (("zamba2-2.7b", 2_340_466_848),
                       ("xlstm-125m", 123_725_664)):
        cfg = configs.get(arch)
        fam = api.family(cfg)
        tokens = lm_tokens(cfg, dev)
        if cfg.family == "hybrid":
            row, worst = flash_checks(
                dev, check, "ssm", (LM_BATCH, LM_PROMPT, cfg.n_kv_heads,
                                    cfg.n_heads // cfg.n_kv_heads, cfg.hd),
                (0,))
        t0 = time.perf_counter()
        model = api.build(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        n_params = sum(p.numel() for p in model.module.parameters())
        check(n_params == want == fam.param_count(cfg),
              f"[ssm] {cfg.name} at full width, {cfg.n_layers} layers: "
              f"{n_params:,} parameters ({want:,} from the JAX shapes), "
              f"built in {time.perf_counter() - t0:.2f} s")
        prompt = LM_PROMPT if cfg.family == "hybrid" else XLSTM_PROMPT
        launches, served = serve_ssm(model, tokens, check, prompt)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        if cfg.family == "hybrid":
            flash = (row, worst, launches)
            ssm_long_cache(model, tokens, check)
            # the bf16 model's weights at f32 compute: the reference
            ref = tree_as(model, cfg32).prefill({"tokens": tokens})[0]
            ssm_decode_vs_prefill(model, tokens, "bf16", check, ref)
            del ref
            model32 = api.build(cfg32, dev,
                                torch.Generator(device=dev).manual_seed(0))
            with torch.no_grad():
                ref = fam.forward(tree_as(model32, as_f64(cfg32)).module.tree(),
                                  as_f64(cfg32), tokens, train=True)[:, -1]
            ssm_decode_vs_prefill(model32, tokens, "f32", check, ref)
            del model32, ref
            cfg32 = dataclasses.replace(cfg32, n_layers=SSM_F64_LAYERS)
        else:
            xlstm_decode_vs_prefill(model, tokens, served, check, prompt)
        del model, served
        torch.cuda.empty_cache()
        model32 = api.build(cfg32, dev,
                            torch.Generator(device=dev).manual_seed(0))
        ssm_f64(model32, tokens, check)
        del model32
        torch.cuda.empty_cache()
    ssm_train(dev, check, "xlstm-125m", 4, 8, XLSTM_TRAIN_SEQ)
    ssm_train(dev, check, "zamba2-2.7b", SSM_F64_LAYERS, 8, 2048)
    log(f"[ssm] phase {time.perf_counter() - t_phase:.1f} s")
    return flash


def planning_win_blocks(pg, row: int, fused: bool, dynamic=None):
    """The least power-of-two ``win_blocks`` whose tier plan at table row
    ``row`` (the ``row`` densest partitions hot) exists, and that plan
    (with a dynamic graph's overlay counted when ``dynamic`` is given)."""
    from repro_torch.core import partition as PT
    wb = 1
    while True:
        try:
            probe = PT.build_tier_plan(pg, 1 << 62, block_e=BLOCK_E,
                                       win_blocks=wb, fused=fused,
                                       dynamic=dynamic)
            return wb, PT.build_tier_plan(
                pg, int(probe.table[row]["hbm_bytes"]), block_e=BLOCK_E,
                win_blocks=wb, fused=fused, dynamic=dynamic)
        except ValueError:
            wb *= 2


def streaming_plan(pg, fused: bool, dynamic=None):
    """``(row, win_blocks, plan)``: table row 1 (the denser partition hot),
    or row 0 (all cold) where row 1's windows are so large that its budget
    holds every partition (the plan then keeps all hot)."""
    wb, plan = planning_win_blocks(pg, 1, fused, dynamic)
    if len(plan.cold):
        return 1, wb, plan
    return (0,) + planning_win_blocks(pg, 0, fused, dynamic)


def longest_runs(ea):
    """Each partition's longest run of one destination in ``dst_ext``."""
    import numpy as np
    return [int(np.bincount(ea.dst_ext[p][:int(ea.num_edges[p])]).max(
        initial=0)) for p in range(ea.src.shape[0])]


def pagerank_f32_bound(g, iters, dev, damping=0.85):
    """A float64 PageRank of ``g`` (the port's rounds: ``rank * inv_deg``
    pushed along every edge, ``delta + damping * sum``) and a bound on the
    error of any float32 run of it, whatever order each vertex's sum takes:
    per round, the error carried in (``A (inv * e)``), the rounding of each
    message and of ``inv_deg`` (2u), the sum of a vertex's ``n_v`` messages
    in any order (``gamma_{n_v} = n_v u / (1 - n_v u)`` times the sum of
    their magnitudes), and the roundings of ``damping``, ``delta`` and the
    update (3u, u), with 8u of slack on the whole."""
    import torch
    n = g.num_vertices
    src = torch.as_tensor(g.edge_sources(), device=dev)
    dst = torch.as_tensor(g.col, device=dev).long()
    a = torch.sparse_coo_tensor(
        torch.stack([dst, src]), torch.ones(len(src), dtype=torch.float64,
                                            device=dev),
        (n, n)).coalesce().to_sparse_csr()

    def mv(x):
        return (a @ x[:, None]).squeeze(1)

    out_deg = torch.bincount(src, minlength=n).double()
    in_deg = torch.bincount(dst, minlength=n).double()
    inv = torch.where(out_deg > 0, 1.0 / out_deg.clamp(min=1.0), 0.0)
    u = UNIT_ROUNDOFF
    gamma = in_deg * u / (1.0 - in_deg * u)
    delta = (1.0 - damping) / n
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=dev)
    e = torch.full((n,), u / n, dtype=torch.float64, device=dev)
    for _ in range(iters):
        carried, mag = mv(inv * e), mv(inv * (r + e))
        r_next = delta + damping * mv(inv * r)
        e = (1.0 + 8 * u) * (damping * (carried + (gamma + 3 * u)
                                        * (1.0 + 2 * u) * mag)
                             + 3 * u * (damping * mag + delta) + u * r_next)
        r = r_next
    return r.cpu().numpy(), e.cpu().numpy()


def tiered_phase(g, pg, pgs, runs, dev, check):
    """``[tiered]``: the five algorithms with one of the two partitions
    streamed from pinned host memory, on the fused and hybrid backends
    against resident engines of the same backend (bit for bit, equal
    steps, lower peak device memory), BFS and PageRank on the reference
    backend, and the all-cold fused BFS.  Returns each tiered-path
    kernel's launches."""
    import numpy as np
    import torch

    from repro_torch.core.bsp import BSPEngine
    from repro_torch.core.tiered import stream_times
    from repro_torch.kernels import dense_spmv as kds
    from repro_torch.kernels import ell_spmv as kell
    from repro_torch.kernels import fused_superstep as kfs

    counters = (kfs.fused_superstep, kell.ell_spmv, kds.dense_spmv,
                kds.dense_spmv_minplus)
    card = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    plans, rows = {}, {}
    for fused in (True, False):
        for name, graph in (("pg", pg), ("pgs", pgs)):
            rows[fused, name], *plans[fused, name] = streaming_plan(graph,
                                                                    fused)
    wb0, plan0 = planning_win_blocks(pg, 0, True)
    log(f"[tiered] plans {time.perf_counter() - t0:.2f} s; longest "
        f"destination run per partition (fwd) {longest_runs(pg.fwd)}, (rev) "
        f"{longest_runs(pg.rev)}, (CC) {longest_runs(pgs.fwd)}; block_e="
        f"{BLOCK_E}")
    for (fused, name), (wb, plan) in plans.items():
        log(f"[tiered] plan {name} {'fused' if fused else 'edge'} arrays, "
            f"table[{rows[fused, name]}]: win_blocks={wb} (the least power "
            f"of two that plans), hot "
            f"{plan.hot.tolist()} cold {plan.cold.tolist()}, windows fwd "
            f"{plan.fwd.num_windows}"
            + ("" if plan.rev is None else f" rev {plan.rev.num_windows}")
            + f", hbm_bytes {plan.hbm_bytes} (budget "
            f"{plan.hbm_budget_bytes}), host_bytes {plan.host_bytes}, window "
            f"buffers {plan.stream_buffer_bytes}")
        check(len(plan.cold) >= 1 and plan.fwd.num_windows > 1,
              f"[tiered] plan {name}: {len(plan.cold)} partition(s) stream, "
              f"in {plan.fwd.num_windows} windows")
    log(f"[tiered] all-cold plan (table[0], fused arrays): win_blocks={wb0},"
        f" windows fwd {plan0.fwd.num_windows}, hbm_bytes {plan0.hbm_bytes}"
        f", host_bytes {plan0.host_bytes}")

    names = ("bfs_batched", "sssp_batched", "pagerank",
             "betweenness_centrality", "connected_components")
    launches = {fn.__name__: 0 for fn in counters}

    def drive(backend, tiered, algs):
        """Build the engines of one side and run ``algs``: results, steps,
        walls, the peak device bytes over the engine's own baseline, the
        engines and the launches of the tiered-path kernels."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fused = backend == "fused"
        engines = []
        for name in ("pg", "pgs"):
            if name == "pgs" and "connected_components" not in algs:
                engines.append(None)
                continue
            extra = {}
            if tiered:
                wb, plan = plans[fused, name]
                extra = dict(tiered=plan, win_blocks=wb)
            engines.append(BSPEngine(pg if name == "pg" else pgs,
                                     backend=backend, block_e=BLOCK_E,
                                     **extra))
        out, walls = {}, {}
        before = [fn.launches for fn in counters]
        for name in algs:
            got = []
            for _ in range(2):      # the first call builds host layouts
                torch.cuda.synchronize()
                t = time.perf_counter()
                res, steps = runs[name](*engines)
                torch.cuda.synchronize()
                got.append((time.perf_counter() - t, np.asarray(res),
                            None if steps is None else np.asarray(steps)))
            walls[name] = (got[0][0], got[1][0])
            out[name] = got[0][1:]
            if backend != "reference":
                side = "tiered" if tiered else "resident"
                check(np.array_equal(got[0][1], got[1][1], equal_nan=True),
                      f"[tiered] {name} {backend} ({side}): two calls "
                      f"bit-equal")
        used = {fn.__name__: fn.launches - b
                for fn, b in zip(counters, before)}
        peak = torch.cuda.max_memory_allocated() - base
        return out, walls, peak, engines, used

    for backend in ("fused", "hybrid"):
        res, res_walls, res_peak, res_engs, _ = drive(backend, False, names)
        del res_engs
        tie, tie_walls, tie_peak, engs, used = drive(backend, True, names)
        for k, v in used.items():
            launches[k] += v
        eng = engs[0]
        stats = eng.tiered_stats()
        for name in names:
            (a, sa), (b, sb) = res[name], tie[name]
            same = np.array_equal(a, b, equal_nan=True) and (
                sa is None or np.array_equal(sa, sb))
            check(same, f"[tiered] {name} {backend}: tiered bit-equal to "
                  f"resident, equal steps (wall, first call / second: "
                  f"tiered {tie_walls[name][0]:.3f} / "
                  f"{tie_walls[name][1]:.3f} s, resident "
                  f"{res_walls[name][0]:.3f} / {res_walls[name][1]:.3f} s)")
        check(stats["device_arena_bytes"] == eng.tier_plan.hbm_bytes,
              f"[tiered] {backend}: TierPlan.hbm_bytes "
              f"{eng.tier_plan.hbm_bytes} == the engine's device arena "
              f"bytes {stats['device_arena_bytes']}")
        check(tie_peak < res_peak, f"[tiered] {backend}: peak device memory "
              f"of the engines and runs, tiered {tie_peak / 2**20:.1f} MiB < "
              f"resident {res_peak / 2**20:.1f} MiB")
        log(f"[tiered] {backend}: stats {stats}; launches on the tiered "
            f"runs {used}")
        want = (("fused_superstep",) if backend == "fused" else
                ("ell_spmv", "dense_spmv", "dense_spmv_minplus"))
        check(all(used[k] > 0 for k in want), f"[tiered] {backend}: "
              f"{', '.join(want)} launched on windows or hot rows")

        # the stream, timed by events: one PageRank call (20 supersteps)
        if backend == "fused":
            stream, arena = eng._tier_stream, eng._tier[False].arena
        else:
            ht = next(iter(v for k, v in eng._hyb_tier_cache.items()
                           if k[0] == "plus_times" and not k[1]))
            stream, arena = ht.stream, ht.arena
        stream.timing = []
        runs["pagerank"](*engs)
        torch.cuda.synchronize()
        nw = arena.num_windows
        per = [stream_times(stream.timing[i:i + nw])
               for i in range(0, len(stream.timing), nw)]
        stream.timing = None
        copy_ms = float(np.mean([x["copy_ms"] for x in per]))
        comp_ms = float(np.mean([x["compute_ms"] for x in per]))
        wall_ms = float(np.mean([x["wall_ms"] for x in per]))
        overlap = float(np.mean([x["overlap"] for x in per]))
        log(f"[tiered] {backend} pagerank stream, per superstep over "
            f"{len(per)}: {nw} windows, {arena.nbytes} bytes streamed, copy "
            f"{copy_ms:.4f} ms ({arena.nbytes / copy_ms / 1e6:.2f} GB/s), "
            f"window compute {comp_ms:.4f} ms, copy+compute wall "
            f"{wall_ms:.4f} ms, overlap {overlap:.3f} of the shorter; "
            f"{card}")

        # the pinned copies alone, through the two buffers, and in one call
        def copies(stream=stream, arena=arena):
            for _ in stream.windows(arena):
                pass
        ms = cuda_ms(copies, 5)
        big = max(arena.tensors.values(), key=lambda t: t.nbytes)
        dst = torch.empty_like(big, device=dev)
        one_ms = cuda_ms(lambda: dst.copy_(big, non_blocking=True), 5)
        log(f"[tiered] {backend} host-to-device copies from pinned memory: "
            f"the {nw} windows through the buffers {ms:.4f} ms "
            f"({arena.nbytes / ms / 1e6:.2f} GB/s), one {big.nbytes}-byte "
            f"copy {one_ms:.4f} ms ({big.nbytes / one_ms / 1e6:.2f} GB/s); "
            f"{card}")
        del engs, eng, stream, arena, dst, big
        if backend == "hybrid":
            del ht

    # the reference backend: BFS bit for bit, PageRank within its f32 bound
    res, res_walls, _, engs, _ = drive("reference", False,
                                       ("bfs_batched", "pagerank"))
    del engs
    tie, tie_walls, _, engs, _ = drive("reference", True,
                                       ("bfs_batched", "pagerank"))
    del engs
    (a, sa), (b, sb) = res["bfs_batched"], tie["bfs_batched"]
    check(np.array_equal(a, b) and np.array_equal(sa, sb),
          f"[tiered] bfs_batched reference: tiered bit-equal to resident, "
          f"equal steps (second call's wall: tiered "
          f"{tie_walls['bfs_batched'][1]:.3f} s, resident "
          f"{res_walls['bfs_batched'][1]:.3f} s)")
    r64, bound = pagerank_f32_bound(g, PR_ITERS, dev)
    a, b = res["pagerank"][0], tie["pagerank"][0]
    slack_res = float(np.max(np.abs(a - r64) - bound))
    slack_tie = float(np.max(np.abs(b - r64) - bound))
    check(slack_res <= 0 and slack_tie <= 0,
          f"[tiered] pagerank reference: tiered and resident within the f32 "
          f"rounding bound of float64 (any summation order); max rel err "
          f"tiered {max_rel_err(b, r64):.3e}, resident "
          f"{max_rel_err(a, r64):.3e}, bound's max rel "
          f"{float(np.max(bound / np.maximum(r64, 1e-30))):.3e}; tiered vs "
          f"resident max |diff| {float(np.max(np.abs(a - b))):.3e} "
          f"(second call's wall: tiered {tie_walls['pagerank'][1]:.3f} s, "
          f"resident {res_walls['pagerank'][1]:.3f} s)")

    # every partition cold: fused BFS
    before = kfs.fused_superstep.launches
    eng = BSPEngine(pg, backend="fused", block_e=BLOCK_E, tiered=plan0,
                    win_blocks=wb0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    b, sb = runs["bfs_batched"](eng, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches["fused_superstep"] += kfs.fused_superstep.launches - before
    (a, sa) = res["bfs_batched"]
    check(len(eng.tier_plan.hot) == 0 and np.array_equal(a, b)
          and np.array_equal(sa, np.asarray(sb)),
          f"[tiered] bfs_batched fused, all partitions cold: bit-equal to "
          f"the resident reference run, equal steps ({wall:.3f} s wall, "
          f"{eng.tiered_stats()['device_arena_bytes']} device arena bytes, "
          f"{eng.tiered_stats()['host_arena_bytes']} pinned)")
    del eng
    torch.cuda.empty_cache()
    return launches


def host_ms(fn, reps: int) -> float:
    """Mean host-clock time of ``fn`` ending in a synchronize, warmed: the
    cost the serving loop pays between windows, host work included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def serve_phase(g, pg, sources, resident, check):
    """``[serve]``: the chunked loop and continuous batching at RMAT20.

    ``execute(chunk=2)`` on the fused and hybrid engines against phase 3's
    resident runs of the same sources (``resident[backend, alg]``: results
    and steps, bit for bit); one boundary's host costs beside a window's
    device time; ``graph_serve.serve_continuous`` (8 slots, chunk 2, a
    stream of 32: the max- and min-out-degree vertices and 30 seeded ones)
    for {fused, hybrid} x {bfs, sssp} with parity against drain batches,
    then a session of the same stream with the counts set to 0 just before
    its ``drain()``; and one BFS session on the sharded hybrid, a world of
    one, against the single-device drain rows.  Returns the launches of
    the timed sessions."""
    import numpy as np
    import torch

    from repro_torch.algorithms.continuous import continuous_form
    from repro_torch.core.bsp import (BSPEngine, DistributedBSPEngine,
                                      _slot_swap)
    from repro_torch.kernels import dense_spmv as kds
    from repro_torch.kernels import ell_spmv as kell
    from repro_torch.kernels import fused_superstep as kfs
    from repro_torch.kernels import outbox_reduce as kob
    from repro_torch.launch.graph_serve import ServeConfig, serve_continuous
    from repro_torch.runtime import ServeSession, drain_reference

    card = torch.cuda.get_device_name(0)
    leaf = {"bfs": "level", "sssp": "dist"}
    engines = {"fused": BSPEngine(pg, backend="fused", block_e=BLOCK_E),
               "hybrid": BSPEngine(pg, backend="hybrid")}
    for backend, eng in engines.items():
        for alg in ("bfs", "sssp"):
            form = continuous_form(alg)
            state = form.make_slot_state(pg, sources, np.zeros(Q, np.int64))
            for _ in range(2):      # the first call builds the split's tensors
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st, steps_q, info = eng.execute(form.program, state, chunk=2)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            res = form.harvest(pg, st, np.zeros(Q, np.int64))
            want, want_steps = resident[backend, alg]
            check(np.array_equal(res, want)
                  and np.array_equal(steps_q.cpu().numpy(), want_steps),
                  f"[serve] {alg} {backend} execute(chunk=2): bit-equal to "
                  f"the resident run, equal steps {want_steps.tolist()} "
                  f"({info['chunks']} windows, {wall:.3f} s wall, second "
                  f"call)")

    # one boundary's host costs at Q=8 (BFS on the fused engine): the
    # window's first two supersteps; the slot states made on the host and
    # swapped in (their host-to-device copy included), against made on
    # the card (the session's way); one finished row harvested, gathered
    # on the card (the session's way) against on the host; the vote read
    eng, form = engines["fused"], continuous_form("bfs")
    dev = eng.device
    state = form.make_slot_state(pg, sources, np.zeros(Q), device=dev)
    fin = torch.zeros(Q, dtype=torch.bool, device=dev)
    steps_q = torch.zeros(Q, dtype=torch.int32, device=dev)
    admit = torch.zeros(Q, dtype=torch.bool, device=dev)
    admit[0] = True
    one = torch.as_tensor([0], device=dev)
    rows = {}

    def make(where):
        return lambda: rows.update({where: form.make_slot_state(
            pg, sources, np.full(Q, 2), device=dev if where else None)})

    costs = dict(
        window=host_ms(lambda: eng._chunk_call(form.program, 2, state, 0,
                                               fin, steps_q), 3),
        make_host=host_ms(make(False), 3),
        swap_host=host_ms(lambda: _slot_swap(state, rows[False], admit,
                                             fin, steps_q), 5),
        make_card=host_ms(make(True), 5),
        swap_card=host_ms(lambda: _slot_swap(state, rows[True], admit,
                                             fin, steps_q), 5),
        harvest_card=host_ms(lambda: form.harvest(
            pg, {"level": state["level"][one]}, np.zeros(1)), 5),
        harvest_host=host_ms(lambda: np.stack([pg.gather_global(r) for r in
                                               state["level"][one].cpu()
                                               .numpy()]), 5),
        vote=host_ms(lambda: fin.cpu().numpy(), 20))
    log(f"[serve] one boundary at Q=8 (BFS, fused, RMAT20; {card}; host "
        f"clock after a synchronize, ms): a 2-superstep window "
        f"{costs['window']:.3f}; slot states made on the host "
        f"{costs['make_host']:.3f} + swap with its copy "
        f"{costs['swap_host']:.3f}, made on the card {costs['make_card']:.3f}"
        f" + swap {costs['swap_card']:.3f}; one row harvested, gathered on "
        f"the card {costs['harvest_card']:.3f}, on the host "
        f"{costs['harvest_host']:.3f}; vote to host {costs['vote']:.4f}")
    del state, rows

    deg = g.out_degrees()
    stream = np.concatenate([
        [int(np.argmax(deg)), int(np.argmin(deg))],
        np.random.default_rng(SEED).integers(0, g.num_vertices, size=30)])
    counters = {"fused": (kfs.fused_superstep,),
                "hybrid": (kell.ell_spmv, kds.dense_spmv_minplus)}
    launches = {}
    for backend, eng in engines.items():
        for alg in ("bfs", "sssp"):
            cfg = ServeConfig(alg=alg, batch=Q, chunk=2).validate()
            rep = serve_continuous(eng, g, cfg, stream, parity=True)
            check(rep["parity_checked"] == len(stream)
                  and rep["parity_mismatches"] == 0,
                  f"[serve] {alg} {backend}: {rep['parity_checked']} "
                  f"completions bit-equal to their drain rows with equal "
                  f"steps ({rep['parity_mismatches']} mismatches)")
            check(rep["refills"] == len(stream) - Q
                  and rep["min_slot_refills"] >= 1 and rep["retraces"] == 0,
                  f"[serve] {alg} {backend}: refills {rep['refills']} == "
                  f"{len(stream) - Q}, min per slot "
                  f"{rep['min_slot_refills']} >= 1, retraces "
                  f"{rep['retraces']} == 0")
            log(f"[serve] {alg} {backend} ({card}): continuous "
                f"{rep['continuous_qps']:.2f} q/s, p50 "
                f"{rep['continuous_p50_ms']:.1f} ms, p99 "
                f"{rep['continuous_p99_ms']:.1f} ms, {rep['windows']} "
                f"windows, {rep['refills']} refills; drain "
                f"{rep['drain_qps']:.2f} q/s, p50 {rep['drain_p50_ms']:.1f} "
                f"ms, p99 {rep['drain_p99_ms']:.1f} ms")
            # the timed session again, counts set to 0 just before it
            session = ServeSession(eng, alg, slots=Q, chunk=2)
            session.submit(stream)
            for fn in counters[backend]:
                fn.launches = 0
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_reserved()
            t0 = time.perf_counter()
            srep = session.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            mem1 = torch.cuda.memory_reserved()
            used = {fn.__name__: fn.launches for fn in counters[backend]}
            for name, n in used.items():
                launches[name] = launches.get(name, 0) + n
            check(all(n > 0 for n in used.values())
                  and srep["retraces"] == 0,
                  f"[serve] {alg} {backend} session: launches {used}, "
                  f"{srep['windows']} windows in {wall:.3f} s, retraces "
                  f"{srep['retraces']}; memory reserved "
                  f"{mem0 / 2**20:.1f} -> {mem1 / 2**20:.1f} MiB")
    want = drain_reference(engines["fused"], "bfs", stream, Q)
    del engines
    torch.cuda.empty_cache()

    shard = DistributedBSPEngine(pg, backend="hybrid")
    warm = ServeSession(shard, "bfs", slots=Q, chunk=2)
    warm.submit(stream[:2 * Q])
    warm.drain()
    session = ServeSession(shard, "bfs", slots=Q, chunk=2)
    qids = session.submit(stream)
    kob.outbox_reduce.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = session.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {r["query"]: r["result"] for r in session.poll()}
    launches["outbox_reduce"] = kob.outbox_reduce.launches
    check(len(got) == len(stream)
          and all(np.array_equal(got[q], want[j])
                  for j, q in enumerate(qids))
          and kob.outbox_reduce.launches > 0 and rep["retraces"] == 0
          and rep["refills"] == len(stream) - Q,
          f"[serve] bfs on the sharded hybrid (world of one): {len(got)} "
          f"completions bit-equal to the single-device drain rows, "
          f"outbox_reduce launches {kob.outbox_reduce.launches}, "
          f"{rep['windows']} windows, {rep['refills']} refills, retraces "
          f"{rep['retraces']}, {len(stream) / wall:.2f} q/s, p99 "
          f"{rep['latency_p99_ms']:.1f} ms ({wall:.3f} s wall)")
    del shard, warm, session
    torch.cuda.empty_cache()
    return launches


def dynamic_phase(gw, sources, dev, check):
    """``[dynamic]``: dynamic graphs at RMAT18 (``DYN_SCALE``) / P=2 / HIGH
    (SSSP weights).

    A ``DynamicGraph(mutation_capacity=256)`` takes ``edge_stream``'s
    ``DYN_BATCHES`` batches of 256 (churn 0.7, seed 20: ``graph_serve
    --mutate``'s defaults but its 8 batches; ``DYN_SCALE``); the apply
    rate is printed,
    and BFS runs on the fused and
    hybrid dynamic engines after every batch with ``cache_entries()``
    held (no rebuild but at a compaction or a hybrid split rebuild).
    After the stream, with every kernel's count set to 0 just before:
    BFS and SSSP at Q=8 on both engines bit for bit with equal steps
    against fresh engines over the rebuilt graph, PageRank within the f32
    rounding bound of float64 (``pagerank_f32_bound``), an insert-only
    window whose warm BFS and SSSP on the fused engine equal cold runs bit
    for bit in fewer supersteps (the ``bfs_relax`` kind launched), one
    compaction with its pause, and the sharded hybrid (a world of one)
    consuming a batch by compaction, bit for bit with the fused engine,
    and ``graph_serve --mutate``'s ``serve_mutating`` for two rounds on the
    hybrid engine (a cold refresh, then a warm one bit-equal to cold, no
    retrace); the counts are read just after.  Then
    ``ServeSession.mutate`` through ``serve_continuous(mutation_stream=)``
    with parity against drain
    batches, and the ledger's build time.  Returns the dynamic path's
    launches by kernel, the ``bfs_relax`` kind's included."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (bfs_batched, bfs_incremental,
                                        pagerank, sssp_batched,
                                        sssp_incremental)
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.data.graphs import edge_stream
    from repro_torch.kernels import bottomup as kbu
    from repro_torch.kernels import dense_spmv as kds
    from repro_torch.kernels import ell_spmv as kell
    from repro_torch.kernels import fused_superstep as kfs
    from repro_torch.kernels import outbox_reduce as kob
    from repro_torch.launch.graph_serve import (ServeConfig, serve_continuous,
                                                serve_mutating)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    G.EdgeLedger(gw)
    t_ledger = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = DynamicGraph(gw, 2, PT.HIGH, mutation_capacity=256)
    t_dg = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = edge_stream(gw, DYN_BATCHES, 256, churn=0.7, seed=SEED)
    t_stream = time.perf_counter() - t0
    log(f"[dynamic] EdgeLedger of RMAT{DYN_SCALE} ({gw.num_edges} edges) "
        f"{t_ledger:.2f} s; DynamicGraph (partition, ledger, payload) "
        f"{t_dg:.2f} s, delta_slots={dg.delta_slots}, o_max="
        f"{dg.pg.fwd.o_max}; edge_stream {DYN_BATCHES} x 256 "
        f"{t_stream:.2f} s")
    engines = {"fused": BSPEngine(dg, backend="fused", block_e=BLOCK_E),
               "hybrid": BSPEngine(dg, backend="hybrid")}
    for name, eng in engines.items():
        t0 = time.perf_counter()
        bfs_batched(eng, sources)
        sssp_batched(eng, sources)
        log(f"[dynamic] {name} engine's first BFS and SSSP (builds "
            f"included) {time.perf_counter() - t0:.2f} s")

    # the stream: apply rate, then BFS on both engines after each batch
    applied = apply_s = 0.0
    held = True
    for i, batch in enumerate(stream):
        entries = {k: e.cache_entries() for k, e in engines.items()}
        marks = {k: (e.dynamic_rebinds, e.hybrid_dyn_rebuilds)
                 for k, e in engines.items()}
        rep = dg.apply_mutations(batch)
        applied += rep["num_edges"]
        apply_s += rep["apply_ms"] / 1e3
        walls = {}
        for name, eng in engines.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bfs_batched(eng, sources)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            rebuilt = marks[name] != (eng.dynamic_rebinds,
                                      eng.hybrid_dyn_rebuilds)
            if not rebuilt and eng.cache_entries() != entries[name]:
                held = False
        log(f"[dynamic] batch {i}: {rep['inserts']} inserts, "
            f"{rep['deletes']} deletes, apply {rep['apply_ms']:.2f} ms "
            f"({rep['edges_per_sec']:.0f} edges/s), compacted "
            f"{rep['compacted']}; BFS wall fused {walls['fused']:.3f} s, "
            f"hybrid {walls['hybrid']:.3f} s")
    rate = applied / max(apply_s, 1e-9)
    fe, he = engines["fused"], engines["hybrid"]
    check(held, f"[dynamic] no engine rebuilt anything across the "
          f"{DYN_BATCHES} batches but at a compaction or a split rebuild "
          f"(compactions "
          f"{dg.compactions}, fused rebinds {fe.dynamic_rebinds}, hybrid "
          f"rebinds {he.dynamic_rebinds}, hybrid split rebuilds "
          f"{he.hybrid_dyn_rebuilds})")
    log(f"[dynamic] apply rate {rate:.0f} edges/s over {int(applied)} "
        f"edges (host planning and the device writes, "
        f"{apply_s * 1e3:.2f} ms in all)")

    # -- the dynamic path, its kernel counts zeroed just before --------------
    # (the fresh engines' yardstick runs are taken out of the counts)
    counters = (kfs.fused_superstep, kbu.bottomup_scan, kell.ell_spmv,
                kds.dense_spmv, kds.dense_spmv_minplus, kob.outbox_reduce)
    for fn in counters:
        fn.launches = 0
    kfs.fused_superstep.kind_launches.clear()

    def yardstick(run, *args):
        before = [fn.launches for fn in counters]
        out = run(*args)
        for fn, b in zip(counters, before):
            fn.launches = b
        return out

    t0 = time.perf_counter()
    g_mut = dg.mutated_csr()
    fresh_pg = PT.partition(g_mut, 2, PT.HIGH)
    fresh = {"fused": BSPEngine(fresh_pg, backend="fused", block_e=BLOCK_E),
             "hybrid": BSPEngine(fresh_pg, backend="hybrid")}
    log(f"[dynamic] rebuilt graph and fresh engines "
        f"{time.perf_counter() - t0:.2f} s")
    cold = {}
    for name, eng in engines.items():
        for alg, fn in (("bfs", bfs_batched), ("sssp", sssp_batched)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, steps = fn(eng, sources)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want, want_steps = yardstick(fn, fresh[name], sources)
            cold[name, alg] = (res, steps, wall)
            check(np.array_equal(res, want)
                  and np.array_equal(steps, want_steps),
                  f"[dynamic] {alg} {name}: the mutated layout bit-equal to "
                  f"a fresh engine over the rebuilt graph, equal steps "
                  f"{np.asarray(steps).tolist()} ({wall:.3f} s wall)")
    r64, bound = pagerank_f32_bound(g_mut, PR_ITERS, dev)
    for name, eng in engines.items():
        pr = pagerank(eng, PR_ITERS)
        slack = float(np.max(np.abs(pr - r64) - bound))
        check(slack <= 0, f"[dynamic] pagerank {name}: within the f32 "
              f"rounding bound of float64 on the rebuilt graph (max rel "
              f"err {max_rel_err(pr, r64):.3e})")
    del fresh, fresh_pg

    # an insert-only window: warm starts on the fused engine
    mark = dg.mark()
    prev = {alg: cold["fused", alg][0] for alg in ("bfs", "sssp")}
    ins = edge_stream(g_mut, 1, 256, churn=1.0, seed=SEED + 1)[0]
    dg.apply_mutations(ins)
    dirty, monotone = dg.dirty_since(mark)
    check(monotone, "[dynamic] the insert-only window is monotone")
    for alg, warm_fn, cold_fn in (("bfs", bfs_incremental, bfs_batched),
                                  ("sssp", sssp_incremental, sssp_batched)):
        relax0 = kfs.fused_superstep.kind_launches.get("bfs_relax", 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm, wsteps = warm_fn(fe, prev[alg], dirty)
        torch.cuda.synchronize()
        w_wall = time.perf_counter() - t0
        relax = kfs.fused_superstep.kind_launches.get("bfs_relax", 0) - relax0
        t0 = time.perf_counter()
        res, csteps = cold_fn(fe, sources)
        torch.cuda.synchronize()
        c_wall = time.perf_counter() - t0
        check(np.array_equal(warm, res)
              and int(np.max(wsteps)) < int(np.max(csteps))
              and (alg != "bfs" or relax == int(np.max(wsteps))),
              f"[dynamic] warm {alg} (fused): bit-equal to cold, supersteps "
              f"{int(np.max(wsteps))} vs {int(np.max(csteps))}, wall "
              f"{w_wall:.3f} s vs {c_wall:.3f} s cold"
              + (f"; bfs_relax launches {relax}" if alg == "bfs" else ""))

    # one compaction, with its pause; then the sharded hybrid (a world of
    # one) consumes a batch by compaction and launches the outbox kernel
    before, _ = bfs_batched(fe, sources)
    rebinds = fe.dynamic_rebinds
    pause = dg.compact()
    after, _ = bfs_batched(fe, sources)
    check(fe.dynamic_rebinds == rebinds + 1 and np.array_equal(before, after),
          f"[dynamic] compaction: {pause:.1f} ms pause, the fused engine "
          f"rebound once, BFS unchanged")
    compactions = dg.compactions
    dg.apply_mutations(edge_stream(dg.mutated_csr(), 1, 256, churn=0.7,
                                   seed=SEED + 2)[0])
    sh = DistributedBSPEngine(dg, backend="hybrid")
    ob0 = kob.outbox_reduce.launches
    t0 = time.perf_counter()
    got, gsteps = bfs_batched(sh, sources)
    t_sh = time.perf_counter() - t0
    want, wsteps = bfs_batched(fe, sources)
    check(np.array_equal(got, want) and np.array_equal(gsteps, wsteps)
          and kob.outbox_reduce.launches > ob0
          and dg.compactions == compactions + 1,
          f"[dynamic] sharded hybrid (world of one) after its compaction: "
          f"BFS bit-equal to the fused engine, equal steps ({t_sh:.2f} s "
          f"with the compaction and its split; outbox_reduce launches "
          f"{kob.outbox_reduce.launches - ob0})")
    del sh

    # graph_serve --mutate's drain regime (serve_mutating) on the hybrid
    # engine: a mixed round (cold refresh), then an insert-only one (warm
    # refresh), the staleness and re-split votes taken every round
    g_now = dg.mutated_csr()
    rounds = [edge_stream(g_now, 1, 256, churn=0.7, seed=SEED + 4)[0],
              edge_stream(g_now, 1, 256, churn=1.0, seed=SEED + 5)[0]]
    del g_now
    t0 = time.perf_counter()
    rep = serve_mutating(he, dg, "bfs", batches=rounds, batch=Q, standing=Q,
                         query_batches_per_round=1, seed=SEED)
    t_mut = time.perf_counter() - t0
    refreshes = [r["refresh"] for r in rep["per_round"]]
    warm = [r for r in refreshes if r["mode"] == "incremental"]
    check(rep["rounds"] == 2 and rep["retraces"] == 0 and len(warm) == 1
          and all(r["bitwise_equal"] for r in warm),
          f"[dynamic] serve_mutating (hybrid BFS, 2 rounds): refreshes "
          f"{[r['mode'] for r in refreshes]}, the warm one bit-equal to "
          f"cold in {rep['incremental_steps']} vs {rep['cold_steps']} "
          f"supersteps; retraces {rep['retraces']}, compactions so far "
          f"{rep['compactions']} ({rep['compaction_pause_ms']:.1f} ms in "
          f"these rounds), resplits {rep['resplits']}, split rebuilds "
          f"{rep['hybrid_rebuilds']}; batch p50 {rep['batch_p50_ms']:.1f} "
          f"ms, p99 {rep['batch_p99_ms']:.1f} ms ({t_mut:.1f} s)")
    launches = {fn.__name__: fn.launches for fn in counters}
    launches["bfs_relax"] = kfs.fused_superstep.kind_launches.get(
        "bfs_relax", 0)
    log(f"[dynamic] launches on the dynamic path: {launches}")
    check(all(v > 0 for v in launches.values()),
          "[dynamic] every kernel of the dynamic path launched: the fused "
          "kernel (tombstones in its mask, the bfs_relax kind), ell_spmv, "
          "dense_spmv, dense_spmv_minplus and bottomup_scan on the dynamic "
          "hybrid, outbox_reduce on the sharded hybrid")

    # ServeSession.mutate: waves of 16 with a batch between them (32
    # queries: two waves)
    cfg = ServeConfig(alg="sssp", batch=Q, mutate=True,
                      continuous=True).validate()
    wave_stream = edge_stream(dg.mutated_csr(), 2, 256, churn=0.7,
                              seed=SEED + 3)
    rep = serve_continuous(fe, gw, cfg, np.resize(sources, 32), dg=dg,
                           mutation_stream=wave_stream, parity=True)
    check(rep["parity_mismatches"] == 0 and rep["parity_checked"] == 32
          and rep["retraces"] == 0,
          f"[dynamic] ServeSession.mutate: {rep['waves']} waves, "
          f"{rep['parity_checked']} completions bit-equal to drain batches "
          f"with equal steps, retraces {rep['retraces']} "
          f"({rep['continuous_qps']:.1f} q/s continuous vs "
          f"{rep['drain_qps']:.1f} drain)")
    log(f"[dynamic] phase {time.perf_counter() - t_phase:.1f} s")
    del engines, fe, he
    torch.cuda.empty_cache()
    return launches


def tiered_dynamic_phase(gw, sources, dev, check):
    """``[tiered-dynamic]``: ``tiered=`` on a dynamic graph: the weighted
    RMAT20, P=2, HIGH, ``mutation_capacity=256``, ``edge_stream``
    ``DYN_BATCHES`` x 256 at churn 0.7, seed 20 (``[dynamic]``'s stream on
    the main path's graph; at ``[dynamic]``'s RMAT18 the fused plan
    streams both partitions, and the fused engine's hot partition on a
    dynamic graph would go unrun).

    One ``DynamicGraph`` with its payload in pinned host memory feeds, on
    the fused and on the reference backend, a tiered engine (budget
    ``build_tier_plan(..., dynamic=)``'s ``table[1]``: one partition hot
    and one streamed, checked on both backends, ``win_blocks`` the least
    that plans) and a resident one.
    After every batch: BFS at Q=8 on both, bit for bit with equal steps,
    and the tiered engines' ``cache_entries()`` held but at a compaction.
    After the stream: SSSP bit for bit; PageRank within
    ``pagerank_f32_bound`` of float64 (the delta slots sum with atomics on
    the card); the fused kernel launched on the hot partition and every
    window of every superstep; an insert-only window whose warm BFS equals
    cold in fewer supersteps; one forced compaction that re-plans the
    tiers, ``tiered_buffers_made`` growing only then;
    ``TierPlan.hbm_bytes`` equal to the engine's device arena bytes; the
    peak device memory of each tiered engine (and its first run) below
    the resident one's; the hybrid refusing.  Printed: windows, streamed
    bytes, copy GB/s and overlap, and each wall against resident.
    Returns the fused kernel's launches on the tiered engines' runs."""
    import numpy as np
    import torch

    from repro_torch.algorithms import (bfs_batched, bfs_incremental,
                                        pagerank, sssp_batched)
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.core.partition import _delta_slot_bytes
    from repro_torch.core.tiered import stream_times
    from repro_torch.data.graphs import edge_stream
    from repro_torch.kernels import fused_superstep as kfs

    card = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    dg = DynamicGraph(gw, 2, PT.HIGH, mutation_capacity=256, device="cpu",
                      pin=True)
    stream = edge_stream(gw, DYN_BATCHES, 256, churn=0.7, seed=SEED)
    log(f"[tiered-dynamic] DynamicGraph with its payload in pinned host "
        f"memory and the stream {time.perf_counter() - t0:.2f} s; "
        f"delta_slots={dg.delta_slots}, o_max={dg.pg.fwd.o_max}")
    backends = ("fused", "reference")
    launches = 0

    def run(eng, fn, *args):
        """``(fn's result, wall)``; the fused kernel's launches on a tiered
        engine counted (a resident engine is the yardstick)."""
        nonlocal launches
        before = kfs.fused_superstep.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(eng, *args)
        torch.cuda.synchronize()
        if eng.tier_plan is not None:
            launches += kfs.fused_superstep.launches - before
        return out, time.perf_counter() - t

    def same(x, y):
        return all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(x, y))

    tiered, resident, peak, budget = {}, {}, {}, {}
    for b in backends:
        row, wb, plan = streaming_plan(dg.pg, b == "fused", dg)
        budget[b] = (int(plan.hbm_budget_bytes), wb)
        log(f"[tiered-dynamic] plan {b}: table[{row}], win_blocks={wb} (the "
            f"least that plans), hot {plan.hot.tolist()} cold "
            f"{plan.cold.tolist()}, windows fwd {plan.fwd.num_windows}, "
            f"hbm_bytes {plan.hbm_bytes} (budget {plan.hbm_budget_bytes}), "
            f"host_bytes {plan.host_bytes}, window buffers "
            f"{plan.stream_buffer_bytes}")
        for side in ("resident", "tiered"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            m0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            extra = ({} if side == "resident" else
                     dict(tiered=budget[b][0], win_blocks=budget[b][1]))
            eng = BSPEngine(dg, backend=b, block_e=BLOCK_E, **extra)
            run(eng, bfs_batched, sources)
            peak[b, side] = torch.cuda.max_memory_allocated() - m0
            (tiered if side == "tiered" else resident)[b] = eng
            log(f"[tiered-dynamic] {b} {side} engine and its first BFS "
                f"{time.perf_counter() - t0:.2f} s")
        eng = tiered[b]
        check(row == 1 and len(eng.tier_plan.hot) >= 1
              and len(eng.tier_plan.cold) >= 1 and eng.tiered_stats()[
                  "device_arena_bytes"] == eng.tier_plan.hbm_bytes,
              f"[tiered-dynamic] {b}: table[{row}], "
              f"{len(eng.tier_plan.hot)} partition hot and "
              f"{len(eng.tier_plan.cold)} streamed; TierPlan.hbm_bytes {eng.tier_plan.hbm_bytes} == "
              f"the engine's device arena bytes "
              f"{eng.tiered_stats()['device_arena_bytes']}")
        check(peak[b, "tiered"] < peak[b, "resident"],
              f"[tiered-dynamic] {b}: peak device memory of the engine and "
              f"its first BFS, tiered {peak[b, 'tiered'] / 2**20:.1f} MiB < "
              f"resident {peak[b, 'resident'] / 2**20:.1f} MiB")

    # the stream: BFS on both sides after every batch
    walls = {k: [] for k in backends}
    equal = held = True
    compacted = set()
    for i, batch in enumerate(stream):
        entries = {b: tiered[b].cache_entries() for b in backends}
        made = {b: tiered[b].tiered_buffers_made for b in backends}
        rep = dg.apply_mutations(batch)
        if rep["compacted"]:
            compacted.add(i)
        line = []
        for b in backends:
            got, wt = run(tiered[b], bfs_batched, sources)
            want, wr = run(resident[b], bfs_batched, sources)
            equal &= same(got, want)
            walls[b].append((wt, wr))
            if not rep["compacted"] and (
                    tiered[b].cache_entries() != entries[b]
                    or tiered[b].tiered_buffers_made != made[b]):
                held = False
            line.append(f"{b} {wt:.3f} / {wr:.3f} s")
        log(f"[tiered-dynamic] batch {i}: {rep['inserts']} inserts, "
            f"{rep['deletes']} deletes, compacted {rep['compacted']}; BFS "
            f"wall tiered / resident: {', '.join(line)}")
    check(equal, f"[tiered-dynamic] BFS (Q=8) after each of the "
          f"{DYN_BATCHES} batches: tiered bit-equal to resident, equal "
          f"steps, fused and reference")
    check(held, f"[tiered-dynamic] cache_entries() and tiered_buffers_made "
          f"held across the batches but at a compaction (compactions "
          f"{dg.compactions}, rebinds "
          f"{[tiered[b].dynamic_rebinds for b in backends]})")

    # after the stream: SSSP, PageRank, the launches per superstep
    g_mut = dg.mutated_csr()
    r64, bound = pagerank_f32_bound(g_mut, PR_ITERS, dev)
    for b in backends:
        got, wt = run(tiered[b], sssp_batched, sources)
        want, wr = run(resident[b], sssp_batched, sources)
        check(same(got, want), f"[tiered-dynamic] sssp {b}: tiered "
              f"bit-equal to resident, equal steps "
              f"{np.asarray(got[1]).tolist()} (wall {wt:.3f} / {wr:.3f} s)")
        eng = tiered[b]
        stream_ = eng._tier_stream
        stream_.timing = []
        pr, wt = run(eng, pagerank, PR_ITERS)
        stream_.timing, timing = None, stream_.timing
        pr_res, wr = run(resident[b], pagerank, PR_ITERS)
        slack = max(float(np.max(np.abs(x - r64) - bound))
                    for x in (pr, pr_res))
        check(slack <= 0, f"[tiered-dynamic] pagerank {b}: tiered and "
              f"resident within the f32 rounding bound of float64 on the "
              f"mutated graph (max rel err tiered {max_rel_err(pr, r64):.3e},"
              f" resident {max_rel_err(pr_res, r64):.3e}; tiered vs "
              f"resident max |diff| {float(np.max(np.abs(pr - pr_res))):.3e};"
              f" wall {wt:.3f} / {wr:.3f} s)")
        td, plan = eng._tier[False], eng.tier_plan
        nw = len(timing) // PR_ITERS
        streamed = (td.arena.nbytes + sum(c for _, _, c in td.spans)
                    + len(plan.cold) * dg.delta_slots
                    * _delta_slot_bytes(dg.weighted))
        per = [stream_times(timing[i:i + nw])
               for i in range(0, len(timing), nw)]
        copy_ms = float(np.mean([x["copy_ms"] for x in per]))
        log(f"[tiered-dynamic] {b} pagerank stream, per superstep: {nw} "
            f"windows ({plan.fwd.num_windows} base, {len(plan.cold)} "
            f"delta), {streamed} bytes streamed, copy {copy_ms:.4f} ms "
            f"({streamed / copy_ms / 1e6:.2f} GB/s), window compute "
            f"{float(np.mean([x['compute_ms'] for x in per])):.4f} ms, "
            f"overlap {float(np.mean([x['overlap'] for x in per])):.3f}; "
            f"{card}")
        if b == "fused":
            before = launches
            (_, steps), _ = run(eng, bfs_batched, sources)
            want = int(np.max(steps)) * (int(len(plan.hot) > 0)
                                         + plan.fwd.num_windows)
            check(launches - before == want,
                  f"[tiered-dynamic] fused BFS: the fused kernel launched "
                  f"{launches - before} times, once on the hot partition "
                  f"and once on each of the {plan.fwd.num_windows} windows "
                  f"of each of {int(np.max(steps))} supersteps")

    # an insert-only window: warm BFS on the tiered engines
    prev = {b: run(tiered[b], bfs_batched, sources)[0][0] for b in backends}
    mark = dg.mark()
    dg.apply_mutations(edge_stream(g_mut, 1, 256, churn=1.0,
                                   seed=SEED + 1)[0])
    dirty, monotone = dg.dirty_since(mark)
    for b in backends:
        (warm, wsteps), w_wall = run(tiered[b], bfs_incremental, prev[b],
                                     dirty)
        (cold, csteps), c_wall = run(tiered[b], bfs_batched, sources)
        want, _ = run(resident[b], bfs_batched, sources)
        check(monotone and np.array_equal(warm, cold)
              and np.array_equal(cold, want[0])
              and int(np.max(wsteps)) < int(np.max(csteps)),
              f"[tiered-dynamic] warm BFS {b}: bit-equal to cold and to "
              f"resident, supersteps {int(np.max(wsteps))} vs "
              f"{int(np.max(csteps))}, wall {w_wall:.3f} vs {c_wall:.3f} s")

    # one forced compaction re-plans the tiers
    made = {b: tiered[b].tiered_buffers_made for b in backends}
    plans = {b: tiered[b].tier_plan for b in backends}
    pause = dg.compact()
    for b in backends:
        got, wt = run(tiered[b], bfs_batched, sources)
        want, wr = run(resident[b], bfs_batched, sources)
        eng = tiered[b]
        check(same(got, want) and eng.tier_plan is not plans[b]
              and eng.tiered_buffers_made > made[b]
              and eng.tiered_stats()["device_arena_bytes"]
              == eng.tier_plan.hbm_bytes,
              f"[tiered-dynamic] compaction ({pause:.1f} ms pause), {b}: "
              f"re-planned (hot {eng.tier_plan.hot.tolist()}, hbm_bytes "
              f"{eng.tier_plan.hbm_bytes} == device arena bytes), buffers "
              f"made {made[b]} -> {eng.tiered_buffers_made}, BFS bit-equal "
              f"to resident (first run after it {wt:.2f} / {wr:.2f} s)")

    try:
        BSPEngine(dg, backend="hybrid", tiered=budget["fused"][0])
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    check("does not support dynamic graphs" in refused,
          f"[tiered-dynamic] the hybrid backend refuses a tiered dynamic "
          f"graph: {refused[:60]}...")
    for b in backends:
        wt = np.array(walls[b])[[i for i in range(len(stream))
                                 if i not in compacted]]
        log(f"[tiered-dynamic] {b} BFS wall over the {len(wt)} batches "
            f"without a compaction, tiered / resident: mean "
            f"{wt[:, 0].mean():.4f} / {wt[:, 1].mean():.4f} s "
            f"({wt[:, 0].mean() / wt[:, 1].mean():.2f}x); {card}")
    log(f"[tiered-dynamic] phase {time.perf_counter() - t_phase:.1f} s; "
        f"fused launches on the tiered runs {launches}")
    del tiered, resident, dg
    torch.cuda.empty_cache()
    return launches


def train_phase(dev, check):
    """``[train]``: tinyllama-1.1b training at full width (f32 parameters,
    bf16 compute, remat, the config's 4 microbatches), seeded 0: (a) the
    loss at init within 1.5 of ln(vocab); (b) four ``make_train_step``
    steps on one fixed B=8, S=2048 batch with ``AdamW(learning_rate=1e-3,
    warmup_steps=1)``: the loss falls, no parameter is NaN (at 1e-2 the
    first update moves each weight by about its own scale, 0.013-0.022
    here, and the loss climbs after two steps, in the JAX package as in
    the port: ``PERF.md`` §6, the training findings); (c) at 2
    layers, B=1, S=256, f32 compute: the loss and every gradient against a
    float64 run of the same forward and backward; (d) there, the
    gradients at 4 microbatches against 1; (e) the flash route refuses an
    input that requires grad; (f) ``launch/train.py`` for 3 steps at full
    width and ``TRAIN_LAUNCHER_LAYERS`` layers with its checkpoints in a
    temporary directory; (g) a restart
    drill at 2 layers under ``torch.use_deterministic_algorithms``: one
    injected failure, the losses and parameters after resuming bit for bit
    the run's without failures.  Printed: step ms, tokens/s and the step's
    operations bound, peak device memory, checkpoint bytes and save
    seconds."""
    import math
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.launch import train as ltrain
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    from repro_torch.optim import AdamW, tree_leaves, tree_map

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    cfg = configs.get("tinyllama-1.1b")
    model = api.build(cfg, dev, serve=False)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == 1_100_048_384 and all(
        p.dtype == torch.float32 for p in tree_leaves(params)),
          f"[train] {cfg.name}: {n_params:,} f32 parameters, compute "
          f"{cfg.compute_dtype}, remat {cfg.remat}, microbatches "
          f"{cfg.microbatches}")
    b, s = 8, 2048
    batch = api.synth_batch(cfg, api.ShapeSpec("train", "train", s, b),
                            seed=0, device=dev)
    with torch.no_grad():
        loss0 = float(model.loss(params, {"tokens": batch["tokens"][:2]}))
    check(abs(loss0 - math.log(cfg.vocab)) < 1.5,
          f"[train] (a) the loss at init {loss0:.4f}, within 1.5 of "
          f"ln({cfg.vocab}) = {math.log(cfg.vocab):.4f}")

    # (b) four steps on one batch
    opt = AdamW(learning_rate=1e-3, warmup_steps=1)
    step_fn = api.make_train_step(model, opt)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    p = params
    for _ in range(4):
        t = time.perf_counter()
        p, state, met = step_fn(p, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(met["loss"]))
    peak = torch.cuda.max_memory_allocated() - m0
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(p))
    check(losses[-1] < losses[0] and finite,
          f"[train] (b) 4 steps on one batch (B={b}, S={s}): losses "
          f"{[round(x, 4) for x in losses]} fall, no NaN in the parameters")
    tokens = b * s
    n_mm = n_params - cfg.vocab * cfg.d_model       # the embedding gathers
    attn_fwd = 4 * b * s * s * cfg.n_heads * cfg.hd * cfg.n_layers
    # forward, its recompute and the backward (twice a forward's products)
    bound_s = (4 * 2 * n_mm * tokens / BF16_OPS_PER_S
               + 4 * attn_fwd / F32_OPS_PER_S)
    step_ms = float(np.mean(secs[1:])) * 1e3
    log(f"[train] step {step_ms:.1f} ms (steps 2-4; the first "
        f"{secs[0] * 1e3:.1f} ms), {tokens / step_ms * 1e3:.0f} tokens/s; "
        f"operations bound {bound_s * 1e3:.1f} ms (bf16 products at "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, the f32 attention at "
        f"{F32_OPS_PER_S / 1e12:.0f}); peak device memory of the phase "
        f"{peak / 2**30:.2f} GiB; {torch.cuda.get_device_name(0)}")
    del p, state, params, step_fn, batch, met
    torch.cuda.empty_cache()

    # (c) f32 against float64 at 2 layers; (d) 4 microbatches against 1
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    m32 = api.build(cfg2, dev, serve=False)
    m64 = api.build(dataclasses.replace(cfg2, compute_dtype="float64",
                                        param_dtype="float64"), dev,
                    serve=False)
    p32 = m32.init_params(torch.Generator(device=dev).manual_seed(1))
    b2 = api.synth_batch(cfg2, api.ShapeSpec("t", "train", 256, 4), seed=1,
                         device=dev)
    one = {"tokens": b2["tokens"][:1]}
    g32, l32 = api.accumulate_grads(m32, p32, one, 1)
    g64, l64 = api.accumulate_grads(m64, tree_map(torch.Tensor.double, p32),
                                    one, 1)
    loss_rel = abs(float(l32[0]) - float(l64[0])) / abs(float(l64[0]))
    grad_rel = max(float((a.double() - c).abs().max() / c.abs().max())
                   for a, c in zip(tree_leaves(g32), tree_leaves(g64)))
    check(loss_rel <= 1e-5 and grad_rel <= 1e-4,
          f"[train] (c) 2 layers, B=1, S=256, f32 against float64: loss "
          f"rel err {loss_rel:.3e} (<= 1e-5), gradients max |diff| / max "
          f"|g| {grad_rel:.3e}, the worst of the {len(tree_leaves(g32))} "
          f"leaves (<= 1e-4)")
    del g64, m64
    ga, _ = api.accumulate_grads(m32, p32, b2, 4)
    gb, _ = api.accumulate_grads(m32, p32, b2, 1)
    mb_rel = max(float((a - c).abs().max() / c.abs().max())
                 for a, c in zip(tree_leaves(ga), tree_leaves(gb)))
    check(mb_rel <= 1e-4, f"[train] (d) gradients at 4 microbatches "
          f"against 1 (B=4): max |diff| / max |g| {mb_rel:.3e} (<= 1e-4)")
    del ga, gb, g32, p32, m32
    torch.cuda.empty_cache()

    # (e) the flash route refuses a graph
    q = torch.zeros(1, 128, 4, 8, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.zeros(1, 128, 4, 64, device=dev, dtype=torch.bfloat16)
    try:
        attn.chunked_attention(q, kv, kv)
        refused = ""
    except RuntimeError as exc:
        refused = str(exc)
    check("no backward" in refused, f"[train] (e) the flash route refuses "
          f"an input that requires grad: {refused[:60]}...")

    # (f) the launcher at full width and TRAIN_LAUNCHER_LAYERS layers
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rep = ltrain.train(ltrain.build_parser().parse_args(
            ["--arch", cfg.name, "--steps", "3", "--batch", str(b),
             "--seq", str(s), "--microbatches", str(cfg.microbatches),
             "--layers", str(TRAIN_LAUNCHER_LAYERS), "--ckpt-dir", tmp]))
        wall = time.perf_counter() - t0
    ckpts = ", ".join(f"step {st}: {nb / 2**30:.2f} GiB in {sec:.1f} s"
                      for st, nb, sec in rep["checkpoints"])
    check(rep["failures"] == 0 and len(rep["losses"]) == 3
          and bool(np.isfinite(rep["losses"]).all()),
          f"[train] (f) launch/train.py, 3 steps at full width and "
          f"{TRAIN_LAUNCHER_LAYERS} layers: losses "
          f"{[round(x, 4) for x in rep['losses']]}, mean step "
          f"{rep['mean_step_s'] * 1e3:.0f} ms; checkpoints {ckpts}; "
          f"{wall:.1f} s in all")
    del rep
    torch.cuda.empty_cache()

    # (g) the restart drill at 2 layers, deterministic
    drill = {}
    for name, extra in (("clean", []), ("failure", ["--fail-at", "3"])):
        with tempfile.TemporaryDirectory() as tmp:
            drill[name] = ltrain.train(ltrain.build_parser().parse_args(
                ["--arch", cfg.name, "--layers", "2", "--steps", "4",
                 "--batch", "8", "--seq", "256", "--microbatches", "4",
                 "--ckpt-every", "3", "--deterministic", "--ckpt-dir",
                 tmp] + extra))
    a, f = drill["clean"], drill["failure"]
    same = all(torch.equal(x, y) for x, y in zip(
        tree_leaves(a["state"]["params"]), tree_leaves(f["state"]["params"])))
    check(f["failures"] == 1 and a["failures"] == 0
          and f["losses"] == a["losses"] and same,
          f"[train] (g) restart drill, 2 layers, deterministic: one "
          f"injected failure at step 3, resumed from step 3's checkpoint; "
          f"losses {[round(x, 6) for x in f['losses']]} and the parameters "
          f"bit-equal to the run without failures")
    del drill, a, f
    torch.cuda.empty_cache()
    log(f"[train] phase {time.perf_counter() - t_phase:.1f} s")


def robust_phase(g, pg, sources, resident, check, g_drill):
    """``[robust]``: the robustness layer at P=2 / HIGH, Q=8, chunk 2: the
    drills on the unweighted RMAT18 ``g_drill`` (``DYN_SCALE``), the rest at
    RMAT20.

    1. ``graph_serve.run_chaos_drill`` on ``g_drill`` (BFS, fused
       primary with the hybrid fallback, ``ROBUST_ROUNDS`` mutation rounds
       of 256 at churn 0.7, 8 standing queries, batch 8): at least 3
       failures recovered,
       every batch acknowledged, one downgrade, query 0 quarantined as
       ``nonfinite``, mid-run snapshots, rebuilds within the failures, the
       replayed payload checked against the snapshot, the standing results
       not quarantined bit for bit the clean session's; the walls, each
       recovery's seconds, the snapshot bytes and save times.
    2. ``graph_serve.run_corrupt_drill`` on reference, fused and hybrid
       engines over ``g_drill``'s partition (plain push: chunk windows
       never pull) and a dynamic fused engine over it (``DynamicGraph``,
       P=2, HIGH, capacity 256): no false positive clean,
       ``state.corrupt`` detected or masked with every recompute
       recovered, ``exchange.payload`` detected on reference and fused with
       a bit-equal replay and inert on the hybrid, ``checkpoint.torn``
       caught, ``tombstone.flip`` detected or masked and a perturbed
       fixpoint rejected.
    3. ``failures.serve_with_restarts`` over a continuous fused BFS session
       (16 queries, one ``superstep.chunk`` fault): restored mid-stream,
       every completion bit for bit ``drain_reference``'s.
    4. The checked exchange's cost: fused BFS windows of 2 supersteps with
       the guard and without it, CUDA events, the median of 7 pairs in
       turns; the host syncs of a window (both paths warm, and one
       throwaway count first) and of one ``execute`` boundary
       (``torch.cuda.set_sync_debug_mode``); the monitor's ms per window at
       Q=8, beside the copy of the state to the host as float64 that a host
       monitor would need.
    5. The sharded engine as a world of one: on the fused backend a
       checked window with ``exchange.payload`` raises
       ``ExchangeCorruption`` (the tagged partition exchange, checked on a
       world of one as in the JAX package); the sharded hybrid's checked
       windows launch ``outbox_reduce`` and are bit for bit the
       single-device hybrid's with equal steps, poisoned or not (its
       compact exchange carries no slot on a world of one, so the guard is
       inert there, as in the JAX package; ``launch/ft_selftest.py``
       drills it across ranks).

    Every kernel count is set to 0 just before and read just after; the
    fused kernel, ``ell_spmv``, ``dense_spmv_minplus`` and
    ``outbox_reduce`` must launch.  Returns the launches."""
    import argparse
    import statistics
    import tempfile
    import warnings

    import numpy as np
    import torch

    from repro_torch.algorithms.bfs import (BFS_PROGRAM, gather_batch,
                                            multi_source_state)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import (BSPEngine, DistributedBSPEngine,
                                      _ExchangeGuard, _run_chunked_loop)
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.kernels import bottomup as kbu
    from repro_torch.kernels import dense_spmv as kds
    from repro_torch.kernels import ell_spmv as kell
    from repro_torch.kernels import fused_superstep as kfs
    from repro_torch.kernels import outbox_reduce as kob
    from repro_torch.launch import graph_serve as gs
    from repro_torch.runtime import (ExchangeCorruption, FaultInjector,
                                     ServeSession, chaos, drain_reference,
                                     monitor_for, serve_with_restarts)

    card = torch.cuda.get_device_name(0)
    t_phase = time.perf_counter()
    counters = (kfs.fused_superstep, kell.ell_spmv, kds.dense_spmv_minplus,
                kob.outbox_reduce, kbu.bottomup_scan)
    for fn in counters:
        fn.launches = 0
    args = gs.build_parser().parse_args([])
    args = argparse.Namespace(**dict(
        vars(args), device="cuda", alg="bfs", backend="fused", parts=2,
        strategy="high", block_e=BLOCK_E, seed=SEED, batch=Q,
        num_queries=ROBUST_QUERIES, standing=Q,
        mutation_rounds=ROBUST_ROUNDS, mutation_batch=256,
        churn=0.7, checkpoint_every=2))

    # -- 1. fault-tolerant serving through the chaos drill -----------------
    t0 = time.perf_counter()
    out = gs.run_chaos_drill(args, g=g_drill)
    clean, faulty = out["clean"], out["faulty"]
    check(faulty["failures"] >= 3 and faulty["acked"] == args.mutation_rounds
          and len(faulty["downgrades"]) == 1
          and out["quarantined"] == [0]
          and any(r["reason"] == "nonfinite" for r in faulty["quarantined"])
          and faulty["midrun_snapshots"] > 0
          and faulty["retraces"] <= faulty["failures"]
          and faulty["replay_checked"] > 0
          and out["parity"] == Q - 1,
          f"[robust] chaos drill (BFS, fused primary, {faulty['fallback']} "
          f"fallback, {ROBUST_ROUNDS} rounds of 256 at churn 0.7, {Q} "
          f"standing): "
          f"failures {faulty['failures']} at rounds "
          f"{[r.get('round') for r in faulty['restarts']]}, acked "
          f"{faulty['acked']}, downgrades {len(faulty['downgrades'])}, "
          f"quarantined {out['quarantined']} (nonfinite), mid-run "
          f"snapshots {faulty['midrun_snapshots']}, rebuilds "
          f"{faulty['retraces']} <= failures, replayed payloads checked "
          f"{faulty['replay_checked']}, mutated CSR == the log's, "
          f"{out['parity']}/{Q} standing results bit-equal to the clean run")
    log(f"[robust] chaos drill ({card}): clean session "
        f"{clean['wall_s']:.1f} s, faulty {faulty['wall_s']:.1f} s; "
        f"recoveries (rebuild from base + replay + restore) "
        f"{[round(t, 2) for t in faulty['recovery_s']]} s; round snapshots "
        f"{[round(b / 2**20, 1) for b in clean['snapshot_bytes']]} MiB "
        f"saved in "
        f"{[round(t, 1) for t in clean['snapshot_ms']]} ms; drill "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 2. the corruption drill on the drills' graph ------------------------
    t0 = time.perf_counter()
    pg_drill = PT.partition(g_drill, 2, PT.HIGH)
    engines = {b: (g_drill, BSPEngine(pg_drill, backend=b, block_e=BLOCK_E,
                                      direction_switch=False))
               for b in ("reference", "fused", "hybrid")}
    t_dg = time.perf_counter()
    dg = DynamicGraph(g_drill, 2, PT.HIGH,
                      mutation_capacity=args.mutation_batch)
    t_dg = time.perf_counter() - t_dg
    dynamic = (g_drill, dg, BSPEngine(dg, backend="fused", block_e=BLOCK_E,
                                      direction_switch=False))
    out = gs.run_corrupt_drill(args, engines=engines, dynamic=dynamic)
    check(out["detections"] >= 4,
          f"[robust] corruption drill (the three backends and the dynamic "
          f"fused engine at RMAT{DYN_SCALE}): {out['detections']} detected, "
          f"{out['masked']} masked, no false positive (walls "
          f"{ {k: round(v, 1) for k, v in out['walls'].items()} } s, "
          f"DynamicGraph {t_dg:.1f} s, {time.perf_counter() - t0:.1f} s)")
    del dynamic, dg, engines, pg_drill

    # -- 3. serve_with_restarts over a continuous fused BFS session -------
    fe = BSPEngine(pg, backend="fused", block_e=BLOCK_E,
                   direction_switch=False)
    stream = np.random.default_rng(SEED + 1).integers(0, g.num_vertices,
                                                      2 * Q)
    want = drain_reference(fe, "bfs", stream, Q)

    def factory():
        s = ServeSession(fe, "bfs", slots=Q, chunk=2)
        s.submit(stream)
        return s

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        with chaos.active(FaultInjector(
                sites={"superstep.chunk": [{"at": 3}]})):
            session, summary = serve_with_restarts(
                factory, CheckpointManager(td, keep=2), checkpoint_every=2)
    got = {r["query"]: r["result"] for r in session.poll()}
    check(summary["failures"] == 1 and len(got) == len(stream)
          and all(np.array_equal(got[q], want[q]) for q in range(len(stream))),
          f"[robust] serve_with_restarts (fused BFS session, {len(stream)} "
          f"queries, {Q} slots, a superstep.chunk fault at the 4th window): "
          f"{summary['failures']} failure restored at window "
          f"{summary['restarts'][0]['windows']} of {summary['windows']}, "
          f"{len(got)} completions bit-equal to drain_reference "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 4. the checked exchange's and the monitor's cost ------------------
    level = multi_source_state(pg, sources, device="cuda")
    state = {"level": level}
    fin = torch.zeros(Q, dtype=torch.bool, device="cuda")
    steps_q = torch.zeros(Q, dtype=torch.int32, device="cuda")

    def window(checked):
        # a fresh guard a window, as BSPEngine._chunk_call makes
        guard = _ExchangeGuard() if checked else None
        fn = fe._step_fn(BFS_PROGRAM, guard=guard)
        return (*_run_chunked_loop(fn, 2, BFS_PROGRAM.max_steps, state, 0,
                                   fin, steps_q), guard)

    def timed(checked):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        _, _, f, s, guard = window(checked)
        # the boundary's one read: votes, counters and the count
        parts = [f.to(torch.int64), s.to(torch.int64)]
        if checked:
            parts.append(guard.read().reshape(1))
        torch.cat(parts).cpu()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    for checked in (False, True):
        timed(checked)
    times = {False: [], True: []}
    for _ in range(7):
        for checked in (False, True, True, False):
            times[checked].append(timed(checked))

    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    # both paths are warm (timed above); the first count under the debug
    # mode is thrown away: it warned once more than its path syncs when
    # it was the plain window's (3 against 2)
    n_first = syncs(lambda: window(False))
    n_checked = syncs(lambda: window(True))
    n_plain = syncs(lambda: window(False))
    n_boundary = syncs(lambda: fe.execute(BFS_PROGRAM, state, chunk=2,
                                          max_chunks=1))
    mon = monitor_for("bfs", chunk=2)
    snap = dict(state=state, finished=np.zeros(Q, bool),
                steps_q=np.zeros(Q, np.int32), step=0)
    mon.observe(snap)
    mon_ms = []
    host_ms = []
    for i in range(9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mon.observe(dict(snap, step=2 * i + 2))
        mon_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        np.asarray(level.cpu().numpy(), np.float64)
        host_ms.append((time.perf_counter() - t0) * 1e3)
    plain_ms = statistics.median(times[False])
    checked_ms = statistics.median(times[True])
    check(n_checked == n_plain and mon.violations == 0,
          f"[robust] checked exchange ({card}; fused BFS, Q={Q}, a window "
          f"of 2 supersteps and its boundary read, CUDA events, median of "
          f"{len(times[True])}): {checked_ms:.3f} ms checked vs "
          f"{plain_ms:.3f} ms plain ({checked_ms / plain_ms:.3f}x); host "
          f"syncs in the window {n_checked} checked == {n_plain} plain "
          f"(the thrown-away first count {n_first}), "
          f"{n_boundary} in one execute(chunk=2) window with its boundary; "
          f"monitor {statistics.median(mon_ms):.3f} ms a window on the card "
          f"(median of {len(mon_ms)}, no violation) vs "
          f"{statistics.median(host_ms):.3f} ms to copy the state to the "
          f"host as float64")

    # -- 5. the sharded engine as a world of one ---------------------------
    def poisoned():
        return chaos.active(FaultInjector(sites={"exchange.payload": [
            {"step": 0, "flag": True}]}))

    shard = DistributedBSPEngine(pg, backend="fused", block_e=BLOCK_E)
    caught = None
    try:
        with poisoned():
            shard.execute(BFS_PROGRAM, state, chunk=2)
    except ExchangeCorruption as e:
        caught = e
    st, sq, _ = shard.execute(BFS_PROGRAM, state, chunk=2)
    want_res, want_steps = resident["fused", "bfs"]
    check(caught is not None
          and np.array_equal(gather_batch(pg, st["level"]), want_res)
          and np.array_equal(sq.cpu().numpy(), want_steps),
          f"[robust] sharded fused (world of one): exchange.payload "
          f"detected ({caught}); the replay bit-equal to the single-device "
          f"fused run, equal steps")
    shard = DistributedBSPEngine(pg, backend="hybrid")
    before = kob.outbox_reduce.launches
    runs = {}
    for poison in (False, True):
        with poisoned() if poison else contextlib.nullcontext():
            st, sq, info = shard.execute(BFS_PROGRAM, state, chunk=2)
        runs[poison] = (gather_batch(pg, st["level"]), sq.cpu().numpy())
    used = kob.outbox_reduce.launches - before
    want_res, want_steps = resident["hybrid", "bfs"]
    check(used > 0 and all(np.array_equal(r, want_res)
                           and np.array_equal(s, want_steps)
                           for r, s in runs.values()),
          f"[robust] sharded hybrid (world of one): checked windows "
          f"bit-equal to the single-device hybrid with equal steps, clean "
          f"and under exchange.payload (no slot crosses ranks: the guard "
          f"is inert), {info['chunks']} windows, {used} outbox_reduce "
          f"launches")
    del shard, fe, session
    torch.cuda.empty_cache()

    launches = {fn.__name__: fn.launches for fn in counters}
    check(all(launches[n] > 0 for n in ("fused_superstep", "ell_spmv",
                                         "dense_spmv_minplus",
                                         "outbox_reduce")),
          f"[robust] launches in the phase: {launches}")
    log(f"[robust] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def direction_world_phase(check):
    """``[dir]``: ``launch/direction_selftest.py`` as a world of one NCCL
    rank on this card (BFS, SSSP and CC through the sharded engine on
    every backend x {push, pull, auto} against single-device push)."""
    from repro_torch.launch import direction_selftest
    from repro_torch.launch.world import run_world

    t0 = time.perf_counter()
    lines = run_world(direction_selftest._run_rank, 1, device="cuda",
                      timeout=300, args=(8, 4, 4, 13))[0]
    for line in lines:
        log(f"[dir] {line.strip()}")
    check(len(lines) == 3, f"[dir] direction_selftest over a world of one "
          f"NCCL rank: every backend push == pull == auto "
          f"({time.perf_counter() - t0:.1f} s)")


MESH_TRAIN = dict(layers=2, batch=8, seq=2048)   # tinyllama-1.1b, one step
MESH_CELLS = [("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
              ("tinyllama-1.1b", "decode_32k"), ("olmoe-1b-7b", "train_4k"),
              ("zamba2-2.7b", "long_500k"),
              ("totem-rmat", "pagerank_superstep")]


def mesh_phase(check):
    """``[mesh]``: the production-mesh tools on the card.  (a) A world of
    one NCCL rank (``launch/world.py::run_world``) laid out as
    ``make_local_mesh(1, 1)``: one AdamW step of tinyllama-1.1b at full
    width and ``MESH_TRAIN``'s depth (f32 master, bf16 compute) with
    DTensor parameters by ``param_specs`` under ``activation_rules``
    against the plain step: the loss within 1e-6 relative and every
    gradient (AdamW's first moment) and parameter within 1e-6 of its
    leaf's largest gradient.  On one rank every DTensor op runs the plain
    op on the whole tensor, but the mesh's cross entropy sums the token
    losses and divides (``mean`` reduces in its own order), so the loss,
    and through it every gradient, may differ in the last bits; the
    leaves bit for bit are counted.  (b) A full-depth prefill (B=4,
    S=2048, bf16) under the mesh: the flash kernel launched once a layer
    through the custom op (the count zeroed just before it), the logits
    bit for bit the plain prefill's.  (c) Dry-run cells on fake CUDA
    tensors (``launch/dryrun.py::run_cell``, the 256-rank production
    mesh of a fake process group): each ``ok`` with ``temp_bytes > 0``,
    flops > 0 and a dominant roofline term.  Returns the mesh prefill's
    flash launches."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh_selftest
    from repro_torch.launch.world import run_world

    t0 = time.perf_counter()
    got = run_world(mesh_selftest.card_rank, 1, device="cuda", timeout=600,
                    args=("tinyllama-1.1b", MESH_TRAIN["layers"],
                          MESH_TRAIN["batch"], MESH_TRAIN["seq"], LM_BATCH,
                          LM_PROMPT))[0]
    diff, (loss_m, loss_p) = got["compare"], got["loss"]
    check(diff["loss"] <= 1e-6 and diff["grads"] <= 1e-6
          and diff["params"] <= 1e-6,
          f"[mesh] tinyllama-1.1b at {MESH_TRAIN['layers']} layers (B="
          f"{MESH_TRAIN['batch']}, S={MESH_TRAIN['seq']}), one AdamW step on "
          f"a (1, 1) mesh of one NCCL rank against the plain step: loss "
          f"{loss_m:.7f} / {loss_p:.7f} (rel {diff['loss']:.2e}), gradients "
          f"{diff['grads']:.2e}, parameters {diff['params']:.2e} (<= 1e-6); "
          f"{got['bit_equal']} of {got['leaves']} leaves bit for bit; step "
          f"{got['step_s'][0] * 1e3:.1f} ms on the mesh, "
          f"{got['step_s'][1] * 1e3:.1f} ms plain")
    for key, what in (("resume_to_plain", "the (1, 1) mesh's sharded "
                       "checkpoint onto the card alone"),
                      ("resume_to_mesh", "the card's whole checkpoint onto "
                       "the (1, 1) mesh")):
        for name, r in got[key].items():
            check(mesh_selftest.resume_ok(got[key]),
                  f"[mesh] restore_resharded, {what}: {r['equal']} of "
                  f"{r['leaves']} leaves bit for bit; the next step's loss "
                  f"bit for bit the unrestarted step's on {name}: "
                  f"{r['same_loss']}; against the next step on the layout "
                  f"that saved: loss {r['loss'][0]:.7f} / {r['loss'][1]:.7f}"
                  f", max diff {r['compare']} (bounds "
                  f"{mesh_selftest.RESUME_TOL}); step {r['step_s'][0] * 1e3:.1f}"
                  f" / {r['step_s'][1] * 1e3:.1f} ms")
    log(f"[mesh] both resumes (two checkpoints of tinyllama-1.1b at "
        f"{MESH_TRAIN['layers']} layers with AdamW's state, written and "
        f"read): {got['resume_s']:.1f} s")
    launches = got["flash_launches"]
    check(launches == 22 and got["logits_bit_equal"],
          f"[mesh] tinyllama-1.1b full-depth prefill (B={LM_BATCH}, "
          f"S={LM_PROMPT}, bf16) on the mesh: {launches} flash launches "
          f"through the custom op (22 layers), logits bit for bit the plain "
          f"prefill's (max |diff| {got['logits_max_abs']:.3e}); "
          f"{got['prefill_s'] * 1e3:.1f} ms on the mesh, "
          f"{got['plain_prefill_s'] * 1e3:.1f} ms plain")
    log(f"[mesh] the NCCL world of one: {time.perf_counter() - t0:.1f} s")
    for arch, shape in MESH_CELLS:
        t1 = time.perf_counter()
        rec = dryrun.run_cell(arch, shape, "single", "cuda")
        ok = (rec.get("ok") and rec["memory_analysis"]["temp_bytes"] > 0
              and rec["cost_analysis_raw"]["flops"] > 0
              and rec["roofline"]["dominant"] in ("compute", "memory",
                                                  "collective"))
        check(bool(ok), f"[mesh] dry run {dryrun.summary_line(rec)}; "
              f"{time.perf_counter() - t1:.1f} s")
    log(f"[mesh] the phase {time.perf_counter() - t0:.1f} s")
    return launches


def main() -> int:
    # [train]'s restart drill runs cuBLAS under
    # torch.use_deterministic_algorithms, which torch allows only with a
    # fixed workspace configuration, read at the process's first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
                                             outbox_reduce_op)
        from repro_torch.kernels.ref import (SEMIRINGS, bottomup_scan_ref,
                                             dense_spmv_minplus_ref,
                                             dense_spmv_ref, ell_spmv_ref,
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
    clock = PhaseClock()
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

    clock("[build]")

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

    clock("[host] set-up")

    # -- phase 2: kernel vs plain at the main path's shapes -----------------
    rng = np.random.default_rng(SEED)
    kernel_rows = {}
    worst_err = 0.0
    for kind in kfs.KINDS:
        kernel_rows[kind], err = fused_kind_check(kind, pg, blks, rng, dev,
                                                  check)
        worst_err = max(worst_err, err)
        if kind == "bfs_relax":
            relax_err = err
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

    clock("[kernel] kernels against their plain versions")

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
            if name == "bfs_batched":
                rate = sum(bfs_mod.teps(g, lv, wall) for lv in res)
                log(f"[main] bfs_batched {backend}: {rate:.6e} TEPS "
                    f"(teps(): the {Q} queries' traversed edges over the "
                    f"batch's {wall:.3f} s wall)")
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
    del engines, cc_engines, plain_cc, push, push_cc, sides
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

    clock("[main]")

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

    clock("[hybrid]")

    # -- phase 3, tiered: one partition streamed from pinned host memory ---
    for fn in (kfs.fused_superstep, kell.ell_spmv, kds.dense_spmv,
               kds.dense_spmv_minplus):
        fn.launches = 0
    tiered_launches = tiered_phase(g, pg, pgs, runs, dev, check)
    log(f"[tiered] launches on the tiered path: {tiered_launches}")

    clock("[tiered]")

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
    superstep_hook_checks(pg, shards["vote"][0], int(sources[0]),
                          programs["pagerank"], dev, check)
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

    clock("[shard]")

    # -- phase 4b: [serve], the chunked loop and continuous batching ---------
    resident = {(b, alg): (outs[key]["fused"] if b == "fused"
                           else hyb_out["vote", key])
                for b in ("fused", "hybrid")
                for alg, key in (("bfs", "bfs_batched"),
                                 ("sssp", "sssp_batched"))}
    serve_launches = serve_phase(g, pg, sources, resident, check)
    log(f"[serve] launches in the timed sessions: {serve_launches}")

    clock("[serve]")

    # -- phase 4c: [dynamic] mutations, warm starts, compaction; [dir] -------
    # the graph of [dynamic] and of [robust]'s drills: RMAT18 (DYN_SCALE)
    t0 = time.perf_counter()
    g_late = G.rmat(DYN_SCALE, RMAT_MEDIUM.edge_factor, seed=SEED)
    gw_late = g_late.with_uniform_weights(seed=SEED)
    src_late = np.random.default_rng(SEED).choice(
        g_late.num_vertices, size=Q, replace=False)
    log(f"[host] rmat{DYN_SCALE}: V={g_late.num_vertices} "
        f"E={g_late.num_edges}; generated and weighted in "
        f"{time.perf_counter() - t0:.2f} s")
    dyn_launches = dynamic_phase(gw_late, src_late, dev, check)
    clock("[dynamic]")
    direction_world_phase(check)
    clock("[dir]")

    # -- phase 4d: [robust] checkpoints, chaos, the checked exchange -------
    robust_launches = robust_phase(g, pg, sources, resident, check, g_late)
    del g_late, gw_late
    log(f"[robust] launches on the robustness path: {robust_launches}")
    clock("[robust]")

    # -- phase 4e: [tiered-dynamic] tiered= on a dynamic graph ---------------
    tdyn_launches = tiered_dynamic_phase(gw, sources, dev, check)
    clock("[tiered-dynamic]")

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

    # -- phase 5b: [bc-exact] all-sources BC ---------------------------------
    bc_exact_phase(dev, check)
    clock("[bc-exact]")

    # -- phase 6: the sorted segment reduce at RMAT20 ------------------------
    seg_rows, seg_err, seg_launches = segment_reduce_phase(pg, rng, dev,
                                                           check)
    # the graph phases' device memory (the partitions' cached splits, the
    # results kept for [serve]) is not needed past this point
    del (pg, pgs, blks, tcs, tc_graphs, graphs, outs, resident, hyb_out,
         shard_out, yardstick, exact_sums, eng, cc_eng, eng_cc)
    torch.cuda.empty_cache()

    clock("[segment_reduce] and the oracles")

    # -- phase 7: the LM serving path, the dense family at full width -------
    free_device_memory("lm")
    lm_rows = lm_phase(dev, check)
    clock("[lm]")

    # -- phase 7b: [moe] the MoE family, serving and training ---------------
    free_device_memory("moe")
    moe_launches = moe_phase(dev, check)
    log(f"[moe] flash launches per olmoe prefill: {moe_launches}")
    clock("[moe]")

    # -- phase 7c: [encdec] the encoder-decoder and vision families ---------
    free_device_memory("encdec")
    encdec_rows = encdec_phase(dev, check)
    clock("[encdec]")

    # -- phase 7d: [ssm] the SSM and hybrid families ------------------------
    ssm_row = ssm_phase(dev, check)
    clock("[ssm]")

    # -- phase 8: LM training, tinyllama-1.1b at full width -----------------
    free_device_memory("train")
    train_phase(dev, check)
    clock("[train]")

    # -- phase 9: [mesh] DTensor layouts, the flash custom op, the dry run --
    free_device_memory("mesh")
    mesh_launches = mesh_phase(check)
    clock("[mesh]")
    log(f"[time] the script {time.perf_counter() - T_START:.1f} s")

    if check.failed:
        log(f"FAILED {len(check.failed)} check(s):")
        for what in check.failed:
            log("  " + what)
        return 1
    rows = {"fused_superstep": (kernel_rows["bfs"], worst_err),
            "fused_superstep.bfs_relax": (kernel_rows["bfs_relax"],
                                          relax_err),
            "bottomup_scan": (scan_rows["cc"], scan_err),
            "ell_spmv": (hyb_rows["ell_plus_times"], max(
                hyb_rows[f"ell_{sr}"]["err"] for sr in ELL_MODES)),
            "dense_spmv": (hyb_rows["dense_spmv"],
                           hyb_rows["dense_spmv"]["err"]),
            "dense_spmv_minplus": (hyb_rows["dense_spmv_minplus"],
                                   hyb_rows["dense_spmv_minplus"]["err"]),
            "outbox_reduce": (shard_rows["pagerank"], shard_err),
            "segment_reduce": (seg_rows[1, "sum"], seg_err),
            "flash_attention": lm_rows["d64"][:2],
            "flash_attention.d256": lm_rows["d256"][:2],
            "flash_attention.noncausal": encdec_rows["noncausal"][:2],
            "flash_attention.vlm": encdec_rows["vlm"][:2],
            "flash_attention.d80": ssm_row[:2],
            "flash_attention.mesh": lm_rows["d64"][:2]}
    launches.update(
        (name, hyb_launches[name]) for name in ("ell_spmv", "dense_spmv",
                                                "dense_spmv_minplus"))
    launches["outbox_reduce"] = shard_launches["outbox_reduce"]
    launches["segment_reduce"] = seg_launches
    launches["flash_attention"] = lm_rows["d64"][2]
    launches["flash_attention.d256"] = lm_rows["d256"][2]
    launches["flash_attention.noncausal"] = encdec_rows["noncausal"][2]
    launches["flash_attention.vlm"] = encdec_rows["vlm"][2]
    launches["flash_attention.d80"] = ssm_row[2]
    launches["flash_attention.mesh"] = mesh_launches
    launches["fused_superstep.bfs_relax"] = dyn_launches["bfs_relax"]
    launches["fused_superstep"] += tdyn_launches
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
