#!/usr/bin/env python3
"""Time the bf16 flash-attention kernel beside variants of its own source
with one part taken out, to see which part holds it back.

Run from the root of a checkout on a machine with one CUDA card and nvcc:
``python3 scripts/flash_ablation.py``.  Each variant is the source
``src/repro_torch/kernels/csrc/flash_attention.cu`` with one text
substitution, built with the port's flags into
``src/repro_torch/kernels/build/ablation/`` and launched through the same C
interface.  Variants that drop work give wrong outputs; only their times
mean anything.  Two variants are wrong on purpose, to show what the bf16
check of ``chip_smoke.py`` catches: the last key tile of every block
dropped, and the softmax scale 1 % off.  Prints one JSON line per shape
with each variant's mean time over 20 launches (CUDA events), TFLOP/s, its
largest |error| against the plain version and that error over the rounding
bound the check holds the kernel to (``chip_smoke.bf16_bound_ratio``; at
most 1 passes) and over the fixed limit it replaced (1e-2 absolute plus
1e-2 relative), and the time of ``scaled_dot_product_attention`` on the
same inputs, then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import bf16_bound_ratio  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

SOURCE = _build.CSRC / "flash_attention.cu"
OUT = _build.BUILD_DIR / "ablation"
# variant -> (text in the source, its replacement); None: the source as is
VARIANTS = {
    "kernel": None,
    "no exponentials": (
        "s[i] = whole ? ex2(__fmaf_rn(s[i], scale_log2, -mi)) "
        ": ex2(s[i] - mi);", "s[i] = s[i] - mi;"),
    "no P V": ("        wgmma_rs<kSub>(acc[sub], pa[kk],",
               "        if (it < 0) wgmma_rs<kSub>(acc[sub], pa[kk],"),
    "no turns": ('asm volatile("bar.sync %0, 256;\\n" :: "r"(id) : "memory");',
                 "(void)id;"),
    "3 stages": ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
    "one block per SM": ("__launch_bounds__(Geo<D>::kThreads, D > 64 ? 1 : 2)",
                         "__launch_bounds__(Geo<D>::kThreads, 1)"),
    # wrong on purpose
    "last key tile dropped": (
        "const int tiles = (k_hi - k_first + kKeys - 1) / kKeys;",
        "const int tiles = max((k_hi - k_first + kKeys - 1) / kKeys - 1, 1);"),
    "scale 1 % off": ("      scale * kLog2e);",
                      "      scale * 1.01f * kLog2e);"),
}
# (B, S, G, R, D, causal): tinyllama-1.1b's prefill layer, then non-causal
SHAPES = [(4, 2048, 4, 8, 64, 1), (4, 2048, 4, 8, 64, 0)]


def build() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, sub in VARIANTS.items():
        src = text
        if sub is not None:
            if sub[0] not in text:
                raise SystemExit(f"variant {name!r}: its text is no longer "
                                 f"in {SOURCE.name}")
            src = text.replace(sub[0], sub[1])
        stem = name.replace(" ", "_")
        (OUT / f"{stem}.cu").write_text(src)
        procs[name] = (OUT / f"{stem}.so", subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"{stem}.so"),
             str(OUT / f"{stem}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(path))
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, ctypes.c_void_p])
        libs[name] = lib
    return libs


def cuda_ms(fn, reps: int = 20) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("this script needs a CUDA card", file=sys.stderr)
        return 2
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(20)
    for b, s, g, r, d, causal in SHAPES:
        q = torch.randn(b, s, g, r, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, g, d, generator=gen, device="cuda").bfloat16()
        o = torch.empty_like(q)
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * d * pairs * b * g * r
        row = {"shape": [b, s, g, r, d], "causal": bool(causal)}
        want = flash_attention_ref(q, k, v, causal=bool(causal))
        for name, lib in libs.items():
            def launch(lib=lib):
                rc = lib.flash_attention_launch(
                    1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), b, s, g, r, d, causal, 0, d ** -0.5,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            launch()
            err = float((o.float() - want.float()).abs().max())
            ratio = bf16_bound_ratio(o, want, q, k, v, 0, bool(causal))
            ms = cuda_ms(launch)
            old = float(((o.float() - want.float()).abs()
                         / (1e-2 + 1e-2 * want.float().abs())).max())
            row[name] = {"ms": ms, "tflops": flops / ms / 1e9,
                         "max_abs_err": err, "err_over_bound": ratio,
                         "err_over_1e-2": old}
        qh = q.reshape(b, s, g * r, d).transpose(1, 2).contiguous()
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=bool(causal), enable_gqa=True))
        row["scaled_dot_product_attention"] = {"ms": ms,
                                               "tflops": flops / ms / 1e9}
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
