#!/usr/bin/env python3
"""Time the outbox aggregation kernel (``outbox_reduce``) and the bottom-up
scan kernel (``bottomup_scan``) as they ship beside variants of their
sources, each with one part of its design taken back, at the main path's
RMAT20 shapes (P=2, HIGH, Q=8).

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 scripts/scan_outbox_ablation.py``.  Each variant is a source
under ``src/repro_torch/kernels/csrc/`` with one text substitution:

- ``outbox_reduce.cu`` on the sharded hybrid's boundary arrays of a world
  of one (BFS: min; SSSP: min with the weight added; PageRank: sum):
  - ``query_major``: each edge's 8 queries come from ``x [Qp, x_len]``
    with one 4-byte load each, where the kernel takes one or two 16-byte
    loads from ``xt [x_len, Qp]``;
  - ``scan_per_query``: the segmented scan over threads, the fold over
    warps and their three barriers run once per query, one value each,
    where the kernel runs them once per group of 8 queries with one flag;
  - ``fill_gaps``: the kernel writes the identity into the slots between
    the runs it closes (each warp writes the gaps its lanes found, lane by
    lane), so the output needs no pre-fill, where the kernel stores the
    runs into an output the op pre-fills with ``torch.full``;
- ``bottomup.cu`` on the engine's transposed rows (BFS's early exit, CC's
  min, SSSP's min_plus; the inputs of ``chip_smoke.scan_inputs``):
  - ``query_major``: each slot's 8 queries from ``x [Qp, x_len]``, one
    4-byte load each;
  - ``thread_per_row``: the run blocks' rows one thread each (the row
    plan's lanes set to 1) reading their slots from device memory, where
    the kernel stages a run's slots in shared memory with coalesced loads
    and gives each row the plan's L lanes.

All are built with the port's flags into
``src/repro_torch/kernels/build/ablation/`` and launched through the same
C interfaces on the same inputs.  Every variant reads the same values and
combines them in the same order, so its output must be bit-equal to the
shipped kernel's; the script fails otherwise.  Times are means over 20
launches (CUDA events); the outbox times include the ``torch.full``
pre-fill wherever the variant needs one.  Prints one JSON line per mode,
then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (OUTBOX_MODES, Q, SCAN_MODES, SEED,  # noqa: E402
                        cuda_ms, ell_inputs, scan_inputs)
from repro_torch.algorithms import symmetrize  # noqa: E402
from repro_torch.configs.totem_rmat import RMAT_MEDIUM  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import partition as PT  # noqa: E402
from repro_torch.core.bsp import DistributedBSPEngine  # noqa: E402
from repro_torch.core.hybrid import splits_of  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import bottomup as kbu  # noqa: E402
from repro_torch.kernels import ell_spmv as kell  # noqa: E402
from repro_torch.kernels import outbox_reduce as kob  # noqa: E402
from repro_torch.kernels.ref import SEMIRINGS, identity  # noqa: E402

OUT = _build.BUILD_DIR / "ablation"
OUTBOX_RUNS = ("bfs", "sssp", "pagerank")     # min, min + add, sum

# -- outbox_reduce.cu --------------------------------------------------------
OB_LOAD = """          load_group(xt + static_cast<int64_t>(s) * Qp + q0, nvec, g[e]);
"""
OB_LOAD_MAJOR = """#pragma unroll
          for (int j = 0; j < kGroup; ++j) {
            g[e][j] = q0 + j < Qp
                ? __ldg(xt + static_cast<int64_t>(q0 + j) * X_LEN + s) : 0.0f;
          }
"""
GROUP_SCAN = "    scan_and_close<kMin, kGroup>(r, 0, run_v,"
QUERY_SCAN = """#pragma unroll
    for (int l = 0; l < kGroup; ++l)
    scan_and_close<kMin, 1>(r, l, run_v,"""
PID = "  int* pid = part_id + static_cast<int64_t>(b) * 2;\n"
FILL_GAPS = PID + """
  // The identity into the slots no run reaches: the gap before each run
  // that starts in this block (round 0) and, in the block of the last
  // edge, the slots after it (round 1).  Each warp writes its lanes' gaps
  // one after another, 32 slots a step, for every query.
  for (int round = 0; round < 2; ++round) {
    for (int c0 = 0; c0 < block_e; c0 += kThreads) {
      const int i = c0 + t;
      const int64_t e = e0 + i;
      int lo = 0, hi = 0;
      if (e < E) {
        const int id = s_id[sidx(i)];
        if (round == 0) {
          const int prev = e == 0 ? -1 : (i == 0 ? flat[e - 1]
                                                 : s_id[sidx(i - 1)]);
          if (id != prev) { lo = prev + 1; hi = id; }
        } else if (e == E - 1) {
          lo = id + 1;
          hi = num_slots;
        }
      }
      unsigned pend = __ballot_sync(kFullMask, hi > lo);
      while (pend) {
        const int from = __ffs(pend) - 1;
        pend &= pend - 1;
        const int glo = __shfl_sync(kFullMask, lo, from);
        const int ghi = __shfl_sync(kFullMask, hi, from);
        for (int q = 0; q < Q; ++q) {
          for (int k = glo + r.lane; k < ghi; k += 32) {
            out[static_cast<int64_t>(q) * num_slots + k] = kIdent;
          }
        }
      }
    }
  }
"""
OUTBOX_VARIANTS = {
    "shipped": [],
    "query_major": [(OB_LOAD, OB_LOAD_MAJOR)],
    "scan_per_query": [(GROUP_SCAN, QUERY_SCAN)],
    "fill_gaps": [(PID, FILL_GAPS)],
}

# -- bottomup.cu -------------------------------------------------------------
SC_LOAD = """  const float4* row =
      reinterpret_cast<const float4*>(xt + static_cast<int64_t>(c) * Qp + q0);
  const float4 a = __ldg(row);
  const float4 b = q0 + 4 < Qp ? __ldg(row + 1)
                               : make_float4(CUDART_INF_F, CUDART_INF_F,
                                             CUDART_INF_F, CUDART_INF_F);
  m[0] = a.x; m[1] = a.y; m[2] = a.z; m[3] = a.w;
  m[4] = b.x; m[5] = b.y; m[6] = b.z; m[7] = b.w;
"""
SC_LOAD_MAJOR = """#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    m[j] = q0 + j < Qp ? __ldg(xt + static_cast<int64_t>(q0 + j) * X_LEN + c)
                       : CUDART_INF_F;
  }
"""
STAGE = """  for (int i = tid; i < slots; i += kThreads) {
    s_col[i] = col[base + i];
    if constexpr (kVal) s_val[i] = val[base + i];
  }
"""
EARLY_SLOT = "load_slot<MODE>(m, xt, Qp, q0, s_col[s + k], 0.0f);"
FULL_SLOT = "load_slot<MODE>(m, xt, Qp, q0, s_col[k], kVal ? s_val[k] : 0.0f);"
SCAN_VARIANTS = {
    "shipped": [],
    "query_major": [(SC_LOAD, SC_LOAD_MAJOR)],
    "thread_per_row": [
        (STAGE, "  (void)slots;\n"),
        (EARLY_SLOT, "load_slot<MODE>(m, xt, Qp, q0, col[base + s + k], "
                     "0.0f);"),
        (FULL_SLOT, "load_slot<MODE>(m, xt, Qp, q0, col[base + k], "
                    "kVal ? val[base + k] : 0.0f);")],
}


def build(x_lens: dict) -> dict:
    """Every variant of both sources, built in parallel: ``{(source,
    variant, x_len or None): library}`` (the query-major variants read
    ``x`` with a row stride fixed at build time)."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source, variants in (("outbox_reduce", OUTBOX_VARIANTS),
                             ("bottomup", SCAN_VARIANTS)):
        text = (_build.CSRC / f"{source}.cu").read_text()
        for name, subs in variants.items():
            src = text
            for old, new in subs:
                if src.count(old) != 1:
                    raise SystemExit(f"{source}.cu no longer holds the text "
                                     f"that variant {name!r} replaces")
                src = src.replace(old, new)
            lens = x_lens[source] if name == "query_major" else [None]
            for n in lens:
                prefix = "" if n is None else f"#define X_LEN {n}LL\n"
                tag = f"{source}_{name}" + ("" if n is None else f"_{n}")
                (OUT / f"{tag}.cu").write_text(prefix + src)
                jobs.append(((source, name, n), tag))
    procs = {}
    for key, tag in jobs:
        so = OUT / f"{tag}.so"
        procs[key] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(OUT / f"{tag}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {key} did not build:\n{log}")
        spills = sum(int(w.split()[0]) for w in log.split(",")
                     if w.strip().endswith("bytes spill stores"))
        print(json.dumps({"built": "/".join(map(str, key)),
                          "spill_store_bytes": spills}), flush=True)
        lib = ctypes.CDLL(str(so))
        if key[0] == "outbox_reduce":
            lib.outbox_reduce_launch.argtypes = (
                [ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        else:
            lib.bottomup_scan_launch.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * 7
                + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
        libs[key] = lib
    return libs


def padded_major(x: torch.Tensor, fill: float) -> torch.Tensor:
    """``x [Q, n]`` with ``Qp - Q`` rows of ``fill`` below: the query-major
    variants read rows up to Qp."""
    qp = -(-x.shape[0] // 4) * 4
    pad = torch.full((qp - x.shape[0], x.shape[1]), fill, device=x.device)
    return torch.cat([x, pad]).contiguous()


def outbox_launcher(lib, combine, wop, xt, src, flat, w, num_slots, prefill):
    """A launch as ``kob.outbox_reduce`` makes it; ``prefill`` fills the
    output with the identity first (``torch.full``), else it is
    ``torch.empty``."""
    e = src.shape[0]
    nb = -(-e // kob.BLOCK_E)
    dev = src.device
    qp = -(-Q // 4) * 4
    part_id = torch.empty((nb, 2), dtype=torch.int32, device=dev)
    part_val = torch.empty((Q, nb, 2), dtype=torch.float32, device=dev)

    def launch():
        out = (torch.full((Q, num_slots), identity(combine), device=dev)
               if prefill else torch.empty((Q, num_slots), device=dev))
        rc = lib.outbox_reduce_launch(
            int(combine == "min"), kob.WEIGHT_OPS[wop], xt.data_ptr(),
            src.data_ptr(), flat.data_ptr(),
            w.data_ptr() if wop is not None else None, out.data_ptr(),
            part_id.data_ptr(), part_val.data_ptr(), Q, qp, e, nb,
            kob.BLOCK_E, num_slots, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
        return out
    return launch


def scan_launcher(lib, mode, x, xt, plan):
    """A launch as ``kbu.bottomup_scan`` makes it on the rows of ``x``
    (``chip_smoke.scan_inputs``) and their plan (tensors)."""
    semiring, early = mode
    v = x["row_ptr"].shape[0] - 1
    dev = xt.device
    qp = -(-Q // 4) * 4
    y = torch.empty((Q, v), dtype=torch.float32, device=dev)
    cnt = torch.empty((Q, v), dtype=torch.int32, device=dev)
    parts = max(plan.num_partials, 1) * qp
    part_y = torch.empty(parts, dtype=torch.float32, device=dev)
    part_f = torch.empty(parts, dtype=torch.int32, device=dev)

    def launch():
        rc = lib.bottomup_scan_launch(
            kbu.MODES[(semiring, early)], x["row_ptr"].data_ptr(),
            x["col"].data_ptr(),
            None if x["val"] is None else x["val"].data_ptr(), xt.data_ptr(),
            y.data_ptr(), cnt.data_ptr(), plan.blocks.data_ptr(),
            plan.blocks.shape[0], plan.long_rows.data_ptr(),
            plan.long_rows.shape[0], part_y.data_ptr(), part_f.data_ptr(),
            Q, qp, v, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
        return y, cnt
    return launch


def main() -> int:
    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = G.rmat(RMAT_MEDIUM.scale, RMAT_MEDIUM.edge_factor, seed=SEED)
    pg = PT.partition(g.with_uniform_weights(seed=SEED), 2, PT.HIGH,
                      include_reverse=True)
    pgs = PT.partition(symmetrize(g), 2, PT.HIGH)
    tcs = {"fwd": (pg, PT.build_transposed_csc(pg.fwd, pg.v_max)),
           "cc": (pgs, PT.build_transposed_csc(pgs.fwd, pgs.v_max))}
    eng = DistributedBSPEngine(pg, backend="hybrid")
    ks = [r["k_dense"] for r in eng.hybrid_plan()["per_shard"]]
    algos = {m: importlib.import_module(f"repro_torch.algorithms.{m}")
             for m in ("bfs", "sssp", "pagerank")}
    progs = {"bfs": algos["bfs"].BFS_PROGRAM,
             "sssp": algos["sssp"].SSSP_PROGRAM,
             "pagerank": algos["pagerank"].make_pagerank_program(
                 g.num_vertices)}
    shds = {}
    for name in OUTBOX_RUNS:
        _, rev, combine, _, semiring = OUTBOX_MODES[name]
        shds[name] = splits_of(pg).shard_split(
            1, ks, rev, semiring, progs[name].edge_msg.use_weight,
            combine == "min")
    x_lens = {"outbox_reduce": sorted({s.n_max for s in shds.values()}),
              "bottomup": sorted({p.num_parts * p.v_max
                                  for p, _ in tcs.values()})}
    libs = build(x_lens)
    rng = np.random.default_rng(SEED)
    ok = True

    for name in OUTBOX_RUNS:
        _, _, combine, wop, semiring = OUTBOX_MODES[name]
        shd = shds[name]
        b_src, b_flat, b_w = shd.boundary(0)
        src = torch.as_tensor(b_src, device=dev)
        flat = torch.as_tensor(b_flat, device=dev)
        w = torch.as_tensor(b_w, device=dev) if wop is not None else None
        fill = SEMIRINGS[semiring][1]
        x = ell_inputs(semiring, shd.n_max, rng, dev)
        xt = kell.query_minor(x, fill)
        xmaj = padded_major(x, fill)
        row = {"kernel": "outbox_reduce", "mode": name, "edges": len(b_src),
               "slots": shd.num_slots,
               "query_minor_copy_ms": cuda_ms(lambda: kell.query_minor(
                   x, fill), 20)}
        want = None
        for variant in OUTBOX_VARIANTS:
            key = ("outbox_reduce", variant,
                   shd.n_max if variant == "query_major" else None)
            run = outbox_launcher(
                libs[key], combine, wop,
                xmaj if variant == "query_major" else xt, src, flat, w,
                shd.num_slots, prefill=variant != "fill_gaps")
            got = run().clone()
            want = got if want is None else want
            same = torch.equal(got, want)
            ok &= same
            row[f"{variant}_ms"] = cuda_ms(run, 20)
            row[f"{variant}_bit_equal"] = same
        row["prefill_ms"] = cuda_ms(lambda: torch.full(
            (Q, shd.num_slots), identity(combine), device=dev), 20)
        print(json.dumps(row), flush=True)
        del x, xt, xmaj, src, flat, w, want, got

    for mode, (semiring, early) in SCAN_MODES.items():
        which = "cc" if mode == "cc" else "fwd"
        tpg, tc = tcs[which]
        x = scan_inputs(mode, tpg, tc, rng, dev)
        plan = kell.row_plan(tc.row_ptr)
        plans = {"shipped": plan.to(dev)}
        blocks = plan.blocks.copy()
        blocks[blocks[:, 2] > 0, 2] = 1                 # a thread per row
        plans["thread_per_row"] = plan._replace(blocks=blocks).to(dev)
        xt = kell.query_minor(x["x"], math.inf)
        xmaj = padded_major(x["x"], math.inf)
        row = {"kernel": "bottomup_scan", "mode": mode,
               "nnz": int(tc.nnz), "rows": int(tc.row_ptr.shape[0] - 1),
               "query_minor_copy_ms": cuda_ms(lambda: kell.query_minor(
                   x["x"], math.inf), 20)}
        want = None
        for variant in SCAN_VARIANTS:
            key = ("bottomup", variant,
                   tpg.num_parts * tpg.v_max if variant == "query_major"
                   else None)
            run = scan_launcher(libs[key], (semiring, early), x,
                                xmaj if variant == "query_major" else xt,
                                plans.get(variant, plans["shipped"]))
            got = tuple(t.clone() for t in run())
            want = got if want is None else want
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            ok &= same
            row[f"{variant}_ms"] = cuda_ms(run, 20)
            row[f"{variant}_bit_equal"] = same
        print(json.dumps(row), flush=True)
        del x, xt, xmaj, want, got
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
