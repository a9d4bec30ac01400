"""A later change adds a configuration, a cell and a per-layer metric as
files only: the harness finds them by name."""
from __future__ import annotations

import json
import shutil

from test_graphbench_faults import run_cell


def test_new_config_cell_and_metric_found_by_name(tiny_root, capsys):
    bench_dir = tiny_root / "graphbench"
    shutil.copy(bench_dir / "configs" / "totem-uniform20.json",
                bench_dir / "configs" / "fixture-uniform8.json")
    (bench_dir / "metrics" / "fixture_metric.py").write_text(
        "def read(run):\n"
        "    return 42.0 if run['config']['generator']['kind'] == "
        "'uniform' else None\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "fixture-uniform8", "source": "a test fixture",
        "file": "graphbench/configs/fixture-uniform8.json", "reduced": [],
        "why": "a test fixture"})
    bench["workloads"].append({
        "name": "fixture.bfs64", "config": "fixture-uniform8",
        "traffic": "bfs64", "chips": 1, "why": "a test fixture"})
    bench["per_layer"].append({
        "name": "fixture_metric", "unit": "1", "better": "higher",
        "source": "host_clock", "layer": "fixture", "moves": "teps",
        "workloads": ["fixture.bfs64"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = run_cell(tiny_root, "fixture.bfs64", capsys, trace=1)
    assert result["correct"] is True
    assert result["metrics"]["fixture_metric"] == {"value": 42.0,
                                                   "unit": "1"}
    # the cells already there do not report it
    result = run_cell(tiny_root, "rmat20.bfs64", capsys, trace=1)
    assert "fixture_metric" not in result["metrics"]
