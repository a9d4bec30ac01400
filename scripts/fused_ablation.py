#!/usr/bin/env python3
"""Time the fused-superstep kernel as it ships beside variants of its
source, each with one part of its design taken back, at the main path's
RMAT20 shapes (P=2, HIGH, ``block_e=1024``, Q=8), for all six message
kinds.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 scripts/fused_ablation.py``.  Each variant is the source
``src/repro_torch/kernels/csrc/fused_superstep.cu`` with one text
substitution:

- ``scalar_loads``: each edge's 8 queries of a gathered array are taken
  with one 4-byte load each from the same query-minor state, where the
  kernel takes two 16-byte loads (the layout without vector loads);
- ``scan_per_query``: the segmented scan over threads, the fold over warps
  and their three barriers run once per query, one value each, where the
  kernel runs them once per group of 8 queries with one flag;
- ``query_minor_acc``: the accumulator is ``[Pl, seg, Qp]`` and a run's 8
  queries go out in two 16-byte stores, where the kernel stores each query
  into ``[Q, Pl, seg]``; the op would then transpose it, which is timed
  apart;
- ``batch_x2``: a thread issues the loads of twice as many edges before
  it forms their messages (8, 4 and 2 edges for 1, 2 and 3 gathered
  arrays; the kernel's first build), where the kernel issues 4, 2 and 1.

All are built with the port's flags into
``src/repro_torch/kernels/build/ablation/`` and launched through the same
C interface on the same inputs (``chip_smoke.kernel_inputs``).  They read
the same values and add them in the same order, so every variant must be
bit-equal to the kernel; the script fails otherwise.  Prints one JSON line
per kind with the mean time over 20 launches (CUDA events) of the
query-minor copy of the state, the kernel and each variant (and the
transpose of ``query_minor_acc``), then each variant's global loads by
form and its barriers in its SASS (``cuobjdump -sass``), then the card's
name and power limit.
"""
from __future__ import annotations

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

from chip_smoke import (BLOCK_E, Q, SEED, cuda_ms,  # noqa: E402
                        kernel_inputs)
from repro_torch.configs.totem_rmat import RMAT_MEDIUM  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import partition as PT  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import fused_superstep as kfs  # noqa: E402
from repro_torch.kernels.ref import identity  # noqa: E402

SOURCE = _build.CSRC / "fused_superstep.cu"
OUT = _build.BUILD_DIR / "ablation"

VECTOR_LOAD = """  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4 lo = __ldg(r4);
  const float4 hi = nvec > 1 ? __ldg(r4 + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
"""
SCALAR_LOAD = """#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    v[j] = (j < 4 || nvec > 1) ? __ldg(row + j) : 0.0f;
  }
"""
GROUP_SCAN = "    scan_and_close<kMin, kGroup>(r, 0, run_v,"
QUERY_SCAN = """#pragma unroll
    for (int l = 0; l < kGroup; ++l)
    scan_and_close<kMin, 1>(r, l, run_v,"""
ACC_INDEX = "  return (static_cast<int64_t>(q) * Pl + p) * seg + id;\n"
ACC_INDEX_QM = "  return (static_cast<int64_t>(p) * seg + id) * Qp + q;\n"
STORE = """#pragma unroll
  for (int j = 0; j < L; ++j) {
    if (q + j < Q) acc[acc_at(q + j, p, id, Pl, seg, Qp)] = v[j];
  }
"""
STORE_QM = """  if constexpr (L == kGroup) {
    float4* dst = reinterpret_cast<float4*>(acc + acc_at(q, p, id, Pl, seg,
                                                         Qp));
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    if (Qp - q >= 8) dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
""" + STORE + "  }\n"
BATCH = "kBatch = kGather == 1 ? 4 : (kGather == 2 ? 2 : 1);"
BATCH_X2 = "kBatch = kGather == 1 ? 8 : (kGather == 2 ? 4 : 2);"
VARIANTS = {
    "kernel": [],
    "scalar_loads": [(VECTOR_LOAD, SCALAR_LOAD)],
    "scan_per_query": [(GROUP_SCAN, QUERY_SCAN)],
    "query_minor_acc": [(ACC_INDEX, ACC_INDEX_QM), (STORE, STORE_QM)],
    "batch_x2": [(BATCH, BATCH_X2)],
}


def build() -> dict:
    """Every variant, built in parallel: ``{name: (library, .so path)}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise SystemExit(f"{name}: the text to replace is no longer "
                                 f"in {SOURCE.name} once:\n{old}")
            src = src.replace(old, new)
        (OUT / f"fused_{name}.cu").write_text(src)
        so = OUT / f"fused_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(OUT / f"fused_{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.fused_superstep_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
            + [ctypes.c_void_p])
        libs[name] = (lib, so)
    return libs


def sass_counts(so: Path) -> dict:
    """Global loads by form (``LDG.E.128...`` 16 bytes, ``LDG.E...`` 4)
    and block barriers in the library's SASS, over all its kernels."""
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)],
                          capture_output=True, text=True,
                          timeout=300).stdout
    ops = re.findall(r"\b(LDG\.[A-Z0-9.]+|BAR\.SYNC)", sass)
    return {op: ops.count(op) for op in sorted(set(ops))}


def launcher(lib, kind, x, vt, seg, qm_acc):
    """A launch of ``lib`` as ``kfs.fused_superstep`` makes it; with
    ``qm_acc`` the accumulator is ``[Pl, seg, Qp]``."""
    spec = kfs.KINDS[kind]
    pl, k, v, qp = vt.shape
    e_pad = x["src"].shape[1]
    nb = e_pad // BLOCK_E
    dev = vt.device
    shape = (pl, seg, qp) if qm_acc else (Q, pl, seg)
    acc = torch.empty(shape, dtype=torch.float32, device=dev)
    part_id = torch.empty((pl, nb, 2), dtype=torch.int32, device=dev)
    part_val = torch.empty((Q, pl, nb, 2), dtype=torch.float32, device=dev)
    weight = x["weight"] if spec.use_weight else None

    def launch():
        acc.fill_(identity(spec.combine))
        rc = lib.fused_superstep_launch(
            spec.code, vt.data_ptr(), x["scal"].data_ptr(),
            x["src"].data_ptr(), x["local"].data_ptr(), x["mask"].data_ptr(),
            None if weight is None else weight.data_ptr(),
            x["base"].data_ptr(), acc.data_ptr(), part_id.data_ptr(),
            part_val.data_ptr(), Q, qp, pl, k, v, x["scal"].shape[-1], e_pad,
            nb, BLOCK_E, seg, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
        return acc
    return launch


def main() -> int:
    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 2
    libs = build()
    g = G.rmat(RMAT_MEDIUM.scale, RMAT_MEDIUM.edge_factor, seed=SEED)
    pg = PT.partition(g.with_uniform_weights(seed=SEED), 2, PT.HIGH,
                      include_reverse=True)
    blks = {d: PT.build_block_metadata(getattr(pg, d), block_e=BLOCK_E)
            for d in ("fwd", "rev")}
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    ok = True
    for kind in kfs.KINDS:
        blk = blks["rev" if kind == "bc_bwd" else "fwd"]
        x = kernel_inputs(kind, pg, blk, rng, dev)

        def copy(x=x):
            return kfs.query_minor_state(x["vstate"])

        vt = copy()
        runs = {name: launcher(lib, kind, x, vt, pg.seg_count,
                               name == "query_minor_acc")
                for name, (lib, _) in libs.items()}
        want = runs["kernel"]().clone()
        row = {"kind": kind, "copy_ms": cuda_ms(copy, 20)}
        for name, run in runs.items():
            got = run()
            if name == "query_minor_acc":
                got = got[..., :Q].permute(2, 0, 1)
            same = torch.equal(got, want)
            ok &= same
            row[f"{name}_ms"] = cuda_ms(run, 20)
            row[f"{name}_bit_equal"] = same
        acc_qm = runs["query_minor_acc"]()

        def transpose(acc_qm=acc_qm):
            return acc_qm[..., :Q].permute(2, 0, 1).contiguous()

        row["transpose_ms"] = cuda_ms(transpose, 20)
        print(json.dumps(row), flush=True)
        del x, vt, runs, want, acc_qm
        torch.cuda.empty_cache()
    for name, (_, so) in libs.items():
        print(json.dumps({"variant": name, **sass_counts(so)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
