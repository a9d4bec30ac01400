"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes one shared
library, loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds).  Libraries go to ``kernels/build/`` (git-ignored), named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused.  Nothing is built when this module is imported: a
kernel is built at its first launch, or ahead of it by :func:`build_all`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.runtime import tracing

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# No fast-math: BC's backward message divides, and the min kinds are held
# bit for bit against the plain version.  -fmad=false keeps mul+add pairs
# rounded as written.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The ``nvcc`` on PATH, else the one under ``$CUDA_HOME``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME; "
                           "the CUDA toolkit is needed to build the kernels")
    return path


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def sources() -> Tuple[str, ...]:
    """The names of every CUDA source under ``csrc/``."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def build_all(names: Iterable[str]) -> Dict[str, Tuple[Path, str]]:
    """Build every named source that is not built yet, one ``nvcc`` each,
    all started together.  Returns ``{name: (library, compiler log)}``; the
    log holds ``-Xptxas -v``'s register, shared-memory and spill report.
    It is kept beside the library, so a library built earlier returns the
    log of its build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Tuple[Path, str]] = {}
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            kept = out.with_suffix(".log")
            done[name] = (out, kept.read_text() if kept.exists() else "")
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        running[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (out, tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)      # atomic: a reader never sees half a file
        done[name] = (out, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        built = not library_path(name).exists()
        with tracing.span("kernels.load", built=int(built)):
            path, _ = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
        tracing.count("kernels.built", int(built))
        _loaded[name] = lib
    return lib


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 dev: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``dev``: what
    a kernel's C interface takes."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
