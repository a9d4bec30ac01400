"""Fixtures of the benchmark's CPU tests: a temporary checkout holding a
copy of the benchmark, the program beside it, and the cells cut to a scale
a test can run on the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "graphbench"
TINY_SCALE = 8

sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(REPO / "src"))


def make_root(tmp: Path, scale: int = TINY_SCALE) -> Path:
    """A checkout in ``tmp``: ``BENCHMARK.json``, a copy of the benchmark's
    folder with every configuration cut to ``scale`` and every batch to
    eight roots, and ``src`` linked to the program."""
    root = tmp / "checkout"
    shutil.copytree(BENCH, root / "graphbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    (root / "src").symlink_to(REPO / "src")
    for cfg in (root / "graphbench" / "configs").glob("*.json"):
        data = json.loads(cfg.read_text())
        data["generator"]["scale"] = scale
        cfg.write_text(json.dumps(data))
    for mix in (root / "graphbench" / "traffic").glob("*.json"):
        data = json.loads(mix.read_text())
        if "roots_per_batch" in data:
            data["roots_per_batch"] = min(data["roots_per_batch"], 8)
        data["warmup_batches"] = 1
        if "pool_batches" in data:
            data["pool_batches"] = 3
        mix.write_text(json.dumps(data))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
