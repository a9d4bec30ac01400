#!/usr/bin/env python3
"""Time the dense-stage kernel (``dense_spmv``) as it ships beside variants
of its source with other K slices, and ``torch.matmul``, at the hybrid
backend's RMAT20 dense block shape (M = Q = 8, K = N = |H| = 2816).

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 scripts/dense_ablation.py``.  Each variant is the source
``src/repro_torch/kernels/csrc/dense_spmv.cu`` with one text substitution
of ``kWarpRows``, the rows a warp adds (a block's slice is 8 of them):
``rows16`` (128-row slices, 22 x 22 = 484 blocks: two waves at two blocks
per SM) and ``rows48`` (384-row slices, 22 x 8 = 176 blocks), beside the
kernel's 32 (256-row slices, 242 blocks: one wave).  All are built with the
port's flags into ``src/repro_torch/kernels/build/ablation/`` and launched
through the same C interface on ``x`` and ``a`` made from a seed (``a``
70 % zeros, as a dense block of a scale-free graph is mostly).  Each
variant is held to its own f32 rounding bound of float64 (its slices give
another summation order, so the variants are not bit-equal to each other);
the script fails otherwise.

``--parent DIR`` also builds ``DIR``'s ``dense_spmv.cu`` (another
checkout, such as the parent commit's) and times its ``dense_spmv`` and
``dense_spmv_minplus`` beside this tree's, through each source's own C
interface: the min-plus results must be bit-equal (a min is exact in any
order) and to the plain version.

Prints one JSON line per variant and for ``torch.matmul`` (f32, TF32 off),
in two rounds: the median time of 20 launches with the L2 flushed before
each (``cold``: a 256 MB write, the L2 left dirty; ``cold_clean``: the
write and a read, the L2 left clean), the mean of 50 back-to-back launches
with the host ahead (``warm``) and of 20 paced by the host
(``warm_host_paced``, as ``chip_smoke.cuda_ms`` times), then the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import (FLUSH_BYTES, SEED,  # noqa: E402
                        cuda_ms, cuda_ms_ahead, cuda_ms_cold,
                        within_f32_bound)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ref import dense_spmv_minplus_ref  # noqa: E402

SOURCE = _build.CSRC / "dense_spmv.cu"
OUT = _build.BUILD_DIR / "ablation"
ROWS = "constexpr int kWarpRows = 32;"
VARIANTS = {"kernel": 32, "rows16": 16, "rows48": 48}
M, K, N = 8, 2816, 2816


def build(parent) -> dict:
    """Every variant (and ``parent``'s source, if given), built in
    parallel: ``{name: library}``."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    if text.count(ROWS) != 1:
        raise SystemExit(f"{ROWS!r} is no longer in {SOURCE.name} once")
    sources = {name: text.replace(ROWS, f"constexpr int kWarpRows = {rows};")
               for name, rows in VARIANTS.items()}
    if parent is not None:
        sources["parent"] = (Path(parent) / SOURCE.relative_to(ROOT)
                             ).read_text()
    procs = {}
    for name, src in sources.items():
        (OUT / f"dense_{name}.cu").write_text(src)
        so = OUT / f"dense_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
             str(OUT / f"dense_{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _ok(rc: int, out: torch.Tensor) -> torch.Tensor:
    if rc:
        raise RuntimeError(f"launch failed ({rc})")
    return out


def launchers(lib, x, a, xi, ai):
    """``(plus_times, min_plus)`` launches of ``lib`` through its own C
    interface.  Plus-times is one launch with tickets; min-plus is the same
    (this tree) or, where the library has ``dense_spmv_minplus_slices``
    (the design before), a partial per 128-row slice and a tree kernel."""
    dev = x.device
    stream = torch.cuda.current_stream().cuda_stream
    y, ym = torch.empty(M, N, device=dev), torch.empty(M, N, device=dev)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    lib.dense_spmv_partials.argtypes = [cint] * 3
    lib.dense_spmv_partials.restype = ctypes.c_longlong
    scratch = (torch.empty(lib.dense_spmv_partials(M, K, N), device=dev),
               torch.zeros(64, dtype=torch.int32, device=dev))
    mscratch = scratch
    if hasattr(lib, "dense_spmv_minplus_slices"):
        lib.dense_spmv_minplus_slices.argtypes = [cint]
        mscratch = (torch.empty(lib.dense_spmv_minplus_slices(K) * M * N,
                                device=dev),)
    for fn, held in ((lib.dense_spmv_launch, scratch),
                     (lib.dense_spmv_minplus_launch, mscratch)):
        fn.argtypes = [ptr] * (3 + len(held)) + [cint] * 3 + [ptr]

    def plus():    # the closure holds the scratch tensors the kernel writes
        return _ok(lib.dense_spmv_launch(
            x.data_ptr(), a.data_ptr(), *(t.data_ptr() for t in scratch),
            y.data_ptr(), M, K, N, stream), y)

    def minplus():
        return _ok(lib.dense_spmv_minplus_launch(
            xi.data_ptr(), ai.data_ptr(), *(t.data_ptr() for t in mscratch),
            ym.data_ptr(), M, K, N, stream), ym)
    return plus, minplus


def plus_depth(rows=32) -> int:
    """Roundings of the plus-times sum at K: ``rows`` products in a lane,
    the 8 warps, the 256-row slices in order and the product."""
    return rows + 8 + -(-K // (8 * rows)) + 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another checkout whose "
                        "dense_spmv.cu is timed beside this tree's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build(args.parent)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand(M, K, device=dev, generator=gen)
    a = torch.rand(K, N, device=dev, generator=gen)
    a = torch.where(torch.rand(K, N, device=dev, generator=gen) < 0.7, 0.0, a)
    xi = torch.where(x < 0.2, torch.inf, x)
    ai = torch.where(a == 0, torch.inf, a)
    exact = x.double() @ a.double()
    want_mp = dense_spmv_minplus_ref(xi, ai)
    scratch = torch.empty(FLUSH_BYTES // 4, device=dev)

    def flush():
        scratch.fill_(1.0)

    def flush_clean():
        scratch.fill_(1.0)
        scratch.sum()

    runs, ok = {}, True
    for name, lib in libs.items():
        plus, minplus = launchers(lib, x, a, xi, ai)
        depth = plus_depth(VARIANTS.get(name, 32))
        good = within_f32_bound(plus(), exact, exact, depth)
        runs[name] = (plus, dict(within_bound=good, bound_roundings=depth))
        if name in ("kernel", "parent"):
            same = torch.equal(minplus(), want_mp)
            good &= same
            runs[f"{name} min_plus"] = (minplus, dict(bit_equal=same))
        ok &= good
    runs["torch.matmul"] = (lambda: torch.matmul(x, a), {})
    for rnd in range(2):
        for name, (run, checks) in runs.items():
            row = {"round": rnd, "variant": name,
                   "cold_ms": cuda_ms_cold(run, 20, flush),
                   "cold_clean_ms": cuda_ms_cold(run, 20, flush_clean),
                   "warm_ms": cuda_ms_ahead(run, 50),
                   "warm_host_paced_ms": cuda_ms(run, 20), **checks}
            if "min_plus" not in name:
                row["max_rel_err"] = float(((run().double() - exact).abs()
                                            / exact.abs().clamp_min(1e-30))
                                           .max())
            print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
