"""The plain reference agrees with the program (on the CPU, where the
program runs its kernels' plain versions) at scale 10, for the entries the
cells drive, on the hybrid engine the cells configure."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from gblib import generators, reference

CFG = {"generator": {"kind": "rmat", "scale": 10, "edge_factor": 16,
                     "a": 0.57, "b": 0.19, "c": 0.19},
       "weights": {"kind": "uniform", "low": 0.0, "high": 1.0}}


@pytest.fixture(scope="module")
def both():
    from repro_torch.core import graph as G
    from repro_torch.core import partition as PT
    from repro_torch.core.bsp import BSPEngine

    g = generators.make_graph(CFG, 2**31 + 30, "cpu")
    n = g["n"]
    csr = G.from_edge_list(g["src"].numpy().copy(), g["dst"].numpy().copy(),
                           n, weights=g["weight"].numpy().copy())
    pg = PT.partition(csr, 2, PT.HIGH)
    engine = BSPEngine(pg, backend="hybrid", device="cpu")
    deg = torch.bincount(g["src"], minlength=n)
    roots = np.random.default_rng(1).choice(
        torch.nonzero(deg > 0).flatten().numpy(), 16, replace=False)
    return g, engine, roots


def test_sssp_bit_for_bit(both):
    from repro_torch.algorithms import sssp_batched

    g, engine, roots = both
    got, _ = sssp_batched(engine, roots)
    want = reference.sssp_distances(g["src"], g["dst"], g["weight"], g["n"],
                                    roots)
    assert torch.equal(torch.as_tensor(got), want)
    assert int(torch.isfinite(want).sum()) > 16     # the roots reach others


def test_bfs_bit_for_bit(both):
    from repro_torch.algorithms import bfs_batched

    g, engine, roots = both
    got, _ = bfs_batched(engine, roots)
    want = reference.bfs_levels(g["src"], g["dst"], g["n"], roots)
    assert torch.equal(torch.as_tensor(got), want)
    assert float(want[torch.isfinite(want)].max()) >= 3


def test_controls_fail_where_precision_matters(both):
    """The TF32 control moves SSSP distances and leaves BFS levels
    (integers) as they are."""
    g, _, roots = both
    args = (g["src"], g["dst"], g["weight"], g["n"], roots)
    f32 = reference.sssp_distances(*args)
    tf32 = reference.sssp_distances(*args, control=True)
    assert int((f32 != tf32).sum()) > 0
    levels = reference.bfs_levels(g["src"], g["dst"], g["n"], roots)
    assert torch.equal(levels, reference.bfs_levels(
        g["src"], g["dst"], g["n"], roots, control=True))


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12,
                      float("inf"), -3.0 - 2**-10], dtype=torch.float32)
    got = reference.round_tf32(x)
    want = torch.tensor([1.0, 1.0, 1.0 + 4 * 2**-11, 1.0, float("inf"),
                         -3.0], dtype=torch.float32)
    # ties to even: 1 + 2**-11 is halfway between 1 and 1 + 2**-10
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell,fails", [("rmat20.sssp64", True),
                                        ("uniform20.sssp64", True),
                                        ("rmat20.bfs64", False)])
def test_cell_controls(tiny_root, cell, fails):
    """``control.py``'s readings through each cell's own comparison, at
    scale 8 on the CPU: the TF32 control fails the SSSP cells;
    BFS levels are integers that TF32 holds exactly, so no control of lower
    precision can fail that cell."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "graphbench_control", tiny_root / "graphbench" / "control.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for seed in (1, 2, 3):
        out = mod.control_reading(tiny_root, cell, seed, "cpu")
        assert out["correct"] is (not fails), out
