"""What a run loads: nothing whose top-level module name is ``jax``,
``jaxlib``, ``flax`` or ``repro`` (the JAX package; compared whole, so the
port ``repro_torch`` passes), and a plain reference that loads nothing of
the program."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
import types
from pathlib import Path

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the yardstick: the reference, the generators, the arithmetic and the
# trace reader may import only these
PLAIN = {"__future__", "bisect", "collections", "math", "statistics",
         "typing", "numpy", "torch"}

RUN_AND_LIST = """
import importlib.util, json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
spec = importlib.util.spec_from_file_location("run", root / "graphbench" / "run.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
rc = mod.main(["--workload", sys.argv[2], "--seed", "5", "--seconds", "0.2",
               "--trace", "0"], root=root, device="cpu",
              t_start=time.perf_counter())
print(json.dumps({"rc": rc, "top": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _fresh_python(code, *args):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(Path.home())}
    out = subprocess.run([sys.executable, "-c", code, *map(str, args)],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    for cell in ("rmat20.sssp64", "rmat20.bfs64"):
        last = json.loads(_fresh_python(RUN_AND_LIST, tiny_root, cell)[-1])
        assert last["rc"] == 0
        assert "repro_torch" in last["top"]
        assert not FORBIDDEN & set(last["top"]), last["top"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import gblib.reference, gblib.generators, gblib.yardstick, "
            "gblib.trace; print(sorted({m.split('.')[0] for m in "
            "sys.modules}))")
    top = _fresh_python(code, BENCH)[-1]
    assert "repro_torch" not in top and "'repro'" not in top
    for name in ("reference", "generators", "yardstick", "trace"):
        tree = ast.parse((BENCH / "gblib" / f"{name}.py").read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            assert {m.split(".")[0] for m in mods} <= PLAIN, (name, mods)


def test_a_run_refuses_when_jax_is_loaded(tiny_root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    import importlib.util
    import time

    spec = importlib.util.spec_from_file_location(
        "graphbench_run_jax", tiny_root / "graphbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rc = mod.main(["--workload", "rmat20.bfs64", "--seed", "1", "--seconds",
                   "0.1", "--trace", "0"], root=tiny_root, device="cpu",
                  t_start=time.perf_counter())
    assert rc == 3
    assert capsys.readouterr().out == ""


def test_no_result_without_the_program(tiny_root):
    """A checkout holding only BENCHMARK.json and the benchmark's folder
    prints no result and exits non-zero."""
    (tiny_root / "src").unlink()
    code = RUN_AND_LIST.replace('print(json.dumps({"rc": rc, ',
                                'print(json.dumps({"rc": rc, "x": 0, ')
    out = subprocess.run([sys.executable, "-c", code, str(tiny_root),
                          "rmat20.bfs64"], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin"})
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["rc"] == 2
    assert out.stdout.count("{") == 1      # only this line, no result

