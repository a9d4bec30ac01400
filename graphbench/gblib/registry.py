"""Find a cell's pieces by the names ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own under the benchmark's folder, so a later change
adds a cell, a mix or a metric by adding files only:

- ``BENCHMARK.json`` (at the checkout's root): the cells, the
  configurations' files and the metrics;
- ``graphbench/traffic/<mix>.json``: a traffic mix, naming its driver;
- ``graphbench/drivers/<driver>.py``: the closed-loop client of an entry;
- ``graphbench/metrics/<metric>.py``: one reader per per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_DIR = "graphbench"


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def config(root: Path, bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def traffic(root: Path, name: str) -> dict:
    path = Path(root) / BENCH_DIR / "traffic" / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no traffic mix {name!r}: {path} is missing")
    return json.loads(path.read_text())


def _module(path: Path, kind: str) -> ModuleType:
    if not path.exists():
        raise KeyError(f"no {kind} {path.stem!r}: {path} is missing")
    tag = re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(f"graphbench_{kind}_{tag}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(root: Path, name: str) -> ModuleType:
    return _module(Path(root) / BENCH_DIR / "drivers" / f"{name}.py",
                   "driver")


def metric_reader(root: Path, name: str) -> ModuleType:
    """The module of ``metrics/<name>.py``; its ``read(run)`` returns the
    metric's value or None where the run holds nothing to read."""
    return _module(Path(root) / BENCH_DIR / "metrics" / f"{name}.py",
                   "metric")


def cell_metrics(bench: dict, section: str, cell: str):
    """The ``section`` metrics (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, or list no cells at all."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]
