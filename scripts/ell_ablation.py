#!/usr/bin/env python3
"""Time the sparse-stage kernel (``ell_spmv``) on query-minor ``x``, as it
ships, beside a variant of its source that reads ``x`` query-major, at the
hybrid backend's RMAT20 split.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 scripts/ell_ablation.py``.  The variant is the source
``src/repro_torch/kernels/csrc/ell_spmv.cu`` with one text substitution:
each slot loads its 8 queries from ``x [Q, x_len]`` (one 4-byte load per
query, 8 sectors) where the kernel takes one or two 16-byte loads from one
sector of ``xt [x_len, Qp]``.  Both are built with the port's flags into
``src/repro_torch/kernels/build/ablation/`` and launched through the same C
interface on the split's rows and row plan, as the engine launches the
kernel.  The two read the same values in the same order, so their outputs
must be bit-equal; the script fails otherwise.  Prints one JSON line per
semiring with the mean time over 20 launches (CUDA events) of the
query-minor copy of ``x``, the kernel on it and the variant on ``x``, then
the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import ELL_MODES, Q, SEED, cuda_ms, ell_inputs  # noqa: E402
from repro_torch.configs.totem_rmat import RMAT_MEDIUM  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import partition as PT  # noqa: E402
from repro_torch.core.bsp import BSPEngine  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ell_spmv as kell  # noqa: E402
from repro_torch.kernels.ref import SEMIRINGS  # noqa: E402

SOURCE = _build.CSRC / "ell_spmv.cu"
OUT = _build.BUILD_DIR / "ablation"
MINOR_LOAD = """  const float4* row =
      reinterpret_cast<const float4*>(xt + static_cast<int64_t>(c) * Qp + q0);
"""
MAJOR_LOAD = """#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    if (q0 + j < Qp) {
      acc[j] = combine<MODE>(
          acc[j], edge<MODE>(__ldg(xt + (q0 + j) * X_LEN + c), w));
    }
  }
  return;
""" + MINOR_LOAD


def build(x_len: int) -> dict:
    """The kernel and its query-major variant (row stride ``x_len``),
    built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    if text.count(MINOR_LOAD) != 1:
        raise SystemExit(f"the query-minor load is no longer in "
                         f"{SOURCE.name}")
    variants = {"minor": text,
                "major": f"#define X_LEN {x_len}LL\n"
                         + text.replace(MINOR_LOAD, MAJOR_LOAD)}
    procs = {}
    for name, src in variants.items():
        (OUT / f"ell_{name}.cu").write_text(src)
        so = OUT / f"ell_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(OUT / f"ell_{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.ell_spmv_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 6
            + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        libs[name] = lib
    return libs


def launcher(lib, semiring, arrs, xt, qp):
    """A launch of ``lib`` on the split's rows as ``kell.ell_spmv`` makes
    it; ``xt`` has ``qp`` queries per row (query-minor) or is ``x``."""
    rp, col, val, plan = arrs["row_ptr"], arrs["col"], arrs["val"], \
        arrs["plan"]
    v = rp.shape[0] - 1
    y = torch.empty((Q, v), dtype=torch.float32, device=xt.device)
    partials = torch.empty(max(plan.num_partials, 1) * qp,
                           dtype=torch.float32, device=xt.device)
    mode = kell.MODES[semiring]

    def launch():
        rc = lib.ell_spmv_launch(
            mode, rp.data_ptr(), col.data_ptr(),
            None if semiring == "min" else val.data_ptr(), xt.data_ptr(),
            y.data_ptr(), plan.blocks.data_ptr(), plan.blocks.shape[0],
            plan.long_rows.data_ptr(), plan.long_rows.shape[0],
            partials.data_ptr(), Q, qp, v,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc})")
        return y
    return launch


def main() -> int:
    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 2
    n = 2 ** RMAT_MEDIUM.scale
    libs = build(n)
    g = G.rmat(RMAT_MEDIUM.scale, RMAT_MEDIUM.edge_factor, seed=SEED)
    assert g.num_vertices == n
    pg = PT.partition(g.with_uniform_weights(seed=SEED), 2, PT.HIGH,
                      include_reverse=True)
    hyb = BSPEngine(pg, backend="hybrid")
    algos = {m: importlib.import_module(f"repro_torch.algorithms.{m}")
             for m in ("bfs", "sssp", "pagerank")}
    programs = {"bfs": algos["bfs"].BFS_PROGRAM,
                "sssp": algos["sssp"].SSSP_PROGRAM,
                "pagerank": algos["pagerank"].make_pagerank_program(n)}
    rng = np.random.default_rng(SEED)
    ok = True
    for semiring, name in ELL_MODES.items():
        _, arrs = hyb.hybrid_for(programs[name])
        x = ell_inputs(semiring, n, rng, torch.device("cuda"))

        def copy(x=x, fill=SEMIRINGS[semiring][1]):
            return kell.query_minor(x, fill)

        xt = copy()
        minor = launcher(libs["minor"], semiring, arrs, xt, xt.shape[1])
        major = launcher(libs["major"], semiring, arrs, x, Q)
        same = torch.equal(minor().clone(), major())
        ok &= same
        row = {"semiring": semiring, "nnz": int(arrs["col"].numel()),
               "query_minor_copy_ms": cuda_ms(copy, 20),
               "kernel_query_minor_ms": cuda_ms(minor, 20),
               "kernel_query_major_ms": cuda_ms(major, 20),
               "bit_equal": same}
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
