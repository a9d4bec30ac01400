#!/usr/bin/env python3
"""Time the min-plus dense stage (``dense_spmv_minplus``) and the sorted
segment reduce (``segment_reduce``) as they ship, beside variants of the
segment-reduce source and, with ``--parent DIR``, another checkout's
sources of both.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 scripts/minplus_segment_ablation.py [--parent DIR]``.

- ``dense_spmv.cu`` at the hybrid backend's RMAT20 dense block shape (M =
  Q = 8, K = N = |H| = 2816; ``a`` 70 % non-edges, as in
  ``scripts/dense_ablation.py``, whose launchers this script uses): this
  tree's min-plus product beside its plus-times product on the same
  ``a`` (zeros where the min-plus ``a`` holds +inf), and the parent's two.
  The min-plus results are held bit for bit to the plain version, the
  plus-times ones to their f32 rounding bound of float64.
- ``segment_reduce.cu`` on partition 0's sorted forward ``dst_ext`` at
  RMAT20 / P=2 / HIGH (the ids ``chip_smoke.py``'s ``[segment_reduce]``
  uses; about a minute of numpy set-up), messages from the seed, at Q=1
  and Q=8, sum and min.  Each variant is the source with one text
  substitution:
  - ``ipt16``: 16 edges a thread (2048-edge blocks; another sum order);
  - ``ticket_merge``: no second kernel; the last block to finish (an
    integer ticket after ``__threadfence``) merges the partials in block
    order;
  - ``scalar``: 4-byte loads everywhere, as for E % 4 != 0;
  - ``cached``: the loads through the caches' default policy
    (``__ldg``), not streaming (``__ldcs``, evict-first);
  - ``row_loads``: each row's loads issued just before its walk, not the
    whole group's first;
  - ``no_stores``: the kernel stores no run into the output (its
    partials still go to the merge): what the scattered stores into the
    pre-filled output cost.  Timing only; its output is wrong and not
    checked;
  and ``parent``, the parent checkout's source.  Each is launched through
  its C interface (the parent's takes per-row partial ids, so every
  variant gets ``[Q, nb, 2]`` of scratch) after the identity pre-fill the
  wrapper makes, which the times include.  Min bit for bit to the plain
  version, sum within its f32 bound of float64 for its block size, and
  every variant with the shipped order (all but ``ipt16``) bit for bit to
  the shipped kernel; the script fails otherwise.

Prints one JSON line per kernel, variant and shape, in two rounds: the
median of 20 launches with the L2 flushed before each (``cold``: a 256 MB
write; ``cold_clean``: the write and a read), the mean of 50 back-to-back
launches with the host ahead (``warm``) and of 20 paced by the host
(``warm_host_paced``), with the bytes bound; then the card's name and
power limit.  Built with the port's flags into
``src/repro_torch/kernels/build/ablation/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from chip_smoke import (FLUSH_BYTES, HBM_BYTES_PER_S, SEED,  # noqa: E402
                        cuda_ms, cuda_ms_ahead, cuda_ms_cold,
                        dense_bound_ms, outbox_sum_depth, within_f32_bound)
from dense_ablation import K, M, N, launchers, plus_depth  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import segment_reduce as ksr  # noqa: E402
from repro_torch.kernels.ref import (dense_spmv_minplus_ref,  # noqa: E402
                                     identity, segment_reduce_ref)

OUT = _build.BUILD_DIR / "ablation"
CSRC = _build.CSRC.relative_to(ROOT)
QS = (1, 8)

IPT = "constexpr int kIpt = 8; "
TICKET = "constexpr unsigned kFullMask = 0xffffffffu;\n"
TICKET_DECL = TICKET + "__device__ unsigned g_merge_ticket = 0;\n"
KERNEL_END = "  }\n}\n\n// Merge the blocks' first/last runs"
TICKET_TAIL = """  }

  // The last block to finish merges the partials in block order.
  __shared__ bool s_last;
  __threadfence();
  __syncthreads();
  if (t == 0) {
    s_last = atomicAdd(&g_merge_ticket, 1u) == static_cast<unsigned>(nb - 1);
  }
  __syncthreads();
  if (!s_last) return;
  const int n2 = 2 * nb;
  for (int i = t; i < n2; i += kThreads) {
    const int run = __ldcg(part_id + i);
    if (i > 0 && __ldcg(part_id + i - 1) == run) continue;
    int end = i + 1;
    while (end < n2 && __ldcg(part_id + end) == run) ++end;
    for (int q = 0; q < Q; ++q) {
      const float* vals = part_val + static_cast<int64_t>(q) * n2;
      float v = __ldcg(vals + i);
      for (int j = i + 1; j < end; ++j) v = combine<kMin>(v, __ldcg(vals + j));
      out[static_cast<int64_t>(q) * num_segments + run] = v;
    }
  }
  if (t == 0) g_merge_ticket = 0u;   // ready for the next launch
}

// Merge the blocks' first/last runs"""
MERGE_LAUNCH = """  const int n2 = 2 * nb;
  const dim3 grid((n2 + kMergeThreads - 1) / kMergeThreads, min(Q, 65535));
  merge_partials_kernel<kMin><<<grid, kMergeThreads, 0, st>>>(
      part_id, part_val, out, n2, Q, num_segments);
  return cudaGetLastError();"""
VEC = "const bool vec = E % 4 == 0 &&"
STREAM = [("__ldcs(reinterpret_cast<const int4*>(p))",
           "__ldg(reinterpret_cast<const int4*>(p))"),
          ("__ldcs(reinterpret_cast<const float4*>(p))",
           "__ldg(reinterpret_cast<const float4*>(p))"),
          ("? __ldcs(v + e + c)", "? __ldg(v + e + c)")]
LOADS_FIRST = """    float m[L][kIpt];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      if (L == 1 || q0 + j < Q) {
        load_edges<kVec>(msgs + static_cast<int64_t>(q0 + j) * E, et, E,
                         kIdent, m[j]);
      } else {
#pragma unroll
        for (int k = 0; k < kIpt; ++k) m[j][k] = kIdent;
      }
    }
    float run_v[L], head_v[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int q = q0 + j;
"""
ROW_LOADS = """    float run_v[L], head_v[L];
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int q = q0 + j;
      float m[1][kIpt];
      if (L == 1 || q < Q) {
        load_edges<kVec>(msgs + static_cast<int64_t>(q) * E, et, E, kIdent,
                         m[0]);
      } else {
#pragma unroll
        for (int k = 0; k < kIpt; ++k) m[0][k] = kIdent;
      }
"""
ROW_USE = [("combine<kMin>(kIdent, m[j][0])", "combine<kMin>(kIdent, m[0][0])"),
           ("rv = m[j][k];", "rv = m[0][k];"),
           ("combine<kMin>(rv, m[j][k])", "combine<kMin>(rv, m[0][k])")]
STORES = [("            out[static_cast<int64_t>(q) * num_segments + id[k - 1]]"
           " = rv;", "            if (rv == 0.5f) out[0] = rv;"),
          ("          out[static_cast<int64_t>(q) * num_segments + run] = "
           "val[j];", "          if (val[j] == 0.5f) out[0] = val[j];")]
SEGMENT_VARIANTS = {   # name -> (substitutions, edges a block, checked)
    "shipped": ([], ksr.BLOCK_E, True),
    "ipt16": ([(IPT, "constexpr int kIpt = 16;")], 2 * ksr.BLOCK_E, True),
    "ticket_merge": ([(TICKET, TICKET_DECL), (KERNEL_END, TICKET_TAIL),
                      (MERGE_LAUNCH, "  return cudaSuccess;")], ksr.BLOCK_E,
                     True),
    "scalar": ([(VEC, "const bool vec = false && E % 4 == 0 &&")],
               ksr.BLOCK_E, True),
    "cached": (STREAM, ksr.BLOCK_E, True),
    "row_loads": ([(LOADS_FIRST, ROW_LOADS)] + ROW_USE, ksr.BLOCK_E, True),
    "no_stores": (STORES, ksr.BLOCK_E, False),
}


def variant_sources(parent) -> dict:
    """``{name: (source text, edges a block or None)}``: the shipped
    sources, the segment-reduce variants and the parent's sources."""
    seg = (ROOT / CSRC / "segment_reduce.cu").read_text()
    sources = {"dense": ((ROOT / CSRC / "dense_spmv.cu").read_text(), None)}
    for name, (subs, block_e, _) in SEGMENT_VARIANTS.items():
        text = seg
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{old!r} is no longer in "
                                 f"segment_reduce.cu once")
            text = text.replace(old, new)
        sources[f"segment {name}"] = (text, block_e)
    if parent is not None:
        psrc = Path(parent) / CSRC
        sources["dense parent"] = ((psrc / "dense_spmv.cu").read_text(), None)
        sources["segment parent"] = (
            (psrc / "segment_reduce.cu").read_text(), ksr.BLOCK_E)
    return sources


def build(sources: dict) -> dict:
    """Each source built in parallel: ``{name: library}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, _) in sources.items():
        stem = name.replace(" ", "_")
        (OUT / f"{stem}.cu").write_text(text)
        so = OUT / f"{stem}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(OUT / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{name!r} did not build:\n{log}")
        spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                                log))
        print(json.dumps({"built": name, "spill_store_bytes": spills}),
              flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def segment_launcher(lib, msgs, ids, num_segments, combine, block_e):
    """A call of ``lib``'s segment reduce as the wrapper makes it: the
    identity pre-fill, then the launch (partials scratch held)."""
    q, e = msgs.shape
    nb = -(-e // block_e)
    part_id = torch.empty(q * nb * 2, dtype=torch.int32, device=msgs.device)
    part_val = torch.empty(q * nb * 2, dtype=torch.float32,
                           device=msgs.device)
    fn = lib.segment_reduce_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int, ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        out = torch.full((q, num_segments), identity(combine),
                         dtype=torch.float32, device=msgs.device)
        rc = fn(int(combine == "min"), msgs.data_ptr(), ids.data_ptr(),
                out.data_ptr(), part_id.data_ptr(), part_val.data_ptr(), q,
                e, nb, block_e, num_segments, stream)
        if rc:
            raise RuntimeError(f"segment_reduce_launch failed ({rc})")
        return out
    return run


def segment_ids():
    """Partition 0's sorted forward ``dst_ext`` at RMAT20 / P=2 / HIGH and
    the segment count (``chip_smoke.segment_reduce_phase``'s ids)."""
    from repro_torch.configs.totem_rmat import RMAT_MEDIUM
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT

    g = G.rmat(RMAT_MEDIUM.scale, RMAT_MEDIUM.edge_factor, seed=SEED)
    pg = PT.partition(g.with_uniform_weights(seed=SEED), 2, PT.HIGH)
    n = int(pg.fwd.num_edges[0])
    return np.sort(pg.fwd.dst_ext[0, :n]).astype(np.int32), pg.seg_count


def timings(run, flush, flush_clean) -> dict:
    return {"cold_ms": cuda_ms_cold(run, 20, flush),
            "cold_clean_ms": cuda_ms_cold(run, 20, flush_clean),
            "warm_ms": cuda_ms_ahead(run, 50),
            "warm_host_paced_ms": cuda_ms(run, 20)}


def dense_runs(libs, dev) -> tuple:
    """``({name: (run, checks)}, all checks passed)`` for the dense
    libraries."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand(M, K, device=dev, generator=gen)
    a = torch.rand(K, N, device=dev, generator=gen)
    a = torch.where(torch.rand(K, N, device=dev, generator=gen) < 0.7, 0.0, a)
    xi = torch.where(x < 0.2, torch.inf, x)
    ai = torch.where(a == 0, torch.inf, a)
    exact = x.double() @ a.double()
    want = dense_spmv_minplus_ref(xi, ai)
    bound = dense_bound_ms(M, K, N)
    runs, ok = {}, True
    for name in ("dense", "dense parent"):
        if name not in libs:
            continue
        plus, minplus = launchers(libs[name], x, a, xi, ai)
        got = minplus()
        same = torch.equal(got, want) and torch.equal(minplus(), got)
        depth = plus_depth()
        good = within_f32_bound(plus(), exact, exact, depth)
        ok &= same and good
        runs[f"{name} min_plus"] = (minplus, dict(
            bit_equal_plain_and_relaunch=same, bound_ms=bound))
        runs[f"{name} plus_times"] = (plus, dict(
            within_bound=good, bound_roundings=depth, bound_ms=bound))
    return runs, ok


def segment_runs(libs, sources, dev) -> tuple:
    """``({name: (run, checks)}, all checks passed)`` for the segment
    variants at each Q and combine."""
    ids_np, seg = segment_ids()
    e = len(ids_np)
    ids = torch.as_tensor(ids_np, device=dev)
    rng = np.random.default_rng(SEED)
    runs, ok = {}, True
    for q in QS:
        msgs = torch.as_tensor(rng.normal(size=(q, e)).astype(np.float32),
                               device=dev)
        bound = 1e3 * (4 * e + 4 * q * e + 4 * q * seg) / HBM_BYTES_PER_S
        for combine in ("sum", "min"):
            want = segment_reduce_ref(msgs, ids.long(), seg, combine)
            if combine == "sum":
                exact = segment_reduce_ref(msgs.double(), ids.long(), seg,
                                           "sum")
                mag = segment_reduce_ref(msgs.double().abs(), ids.long(),
                                         seg, "sum")
            shipped = None
            for name, lib in libs.items():
                if not name.startswith("segment"):
                    continue
                block_e = sources[name][1]
                run = segment_launcher(lib, msgs, ids, seg, combine, block_e)
                got = run()
                checks = {"relaunch_bit_equal": torch.equal(run(), got),
                          "bound_ms": bound}
                if not SEGMENT_VARIANTS.get(name.split(" ", 1)[1],
                                            (0, 0, True))[2]:
                    runs[f"{name} Q={q} {combine}"] = (run, dict(
                        bound_ms=bound, checked=False))
                    continue
                if combine == "min":
                    checks["bit_equal_plain"] = torch.equal(got, want)
                else:
                    depth = outbox_sum_depth(ids_np, block_e) - 1
                    checks["within_bound"] = within_f32_bound(got, exact,
                                                              mag, depth)
                    checks["bound_roundings"] = depth
                if name == "segment shipped":
                    shipped = got
                elif block_e == ksr.BLOCK_E:
                    checks["bit_equal_shipped"] = torch.equal(got, shipped)
                ok &= all(v for k, v in checks.items()
                          if isinstance(v, bool))
                runs[f"{name} Q={q} {combine}"] = (run, checks)
            del want
            if combine == "sum":
                del exact, mag
    return runs, ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another checkout whose "
                        "dense_spmv.cu and segment_reduce.cu are timed "
                        "beside this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 2
    sources = variant_sources(args.parent)
    libs = build(sources)
    dev = torch.device("cuda")
    runs, ok = dense_runs(libs, dev)
    seg_runs, seg_ok = segment_runs(libs, sources, dev)
    runs.update(seg_runs)
    ok &= seg_ok
    scratch = torch.empty(FLUSH_BYTES // 4, device=dev)

    def flush():
        scratch.fill_(1.0)

    def flush_clean():
        scratch.fill_(1.0)
        scratch.sum()

    for rnd in range(2):
        for name, (run, checks) in runs.items():
            print(json.dumps({"round": rnd, "variant": name,
                              **timings(run, flush, flush_clean), **checks}),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    print("ALL CHECKS PASSED" if ok else "SOME CHECK FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
