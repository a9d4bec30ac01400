"""The benchmark's generators: one graph per seed, and the configured
quadrant rates."""
from __future__ import annotations

import torch

from gblib import generators

RMAT = {"generator": {"kind": "rmat", "scale": 10, "edge_factor": 16,
                      "a": 0.57, "b": 0.19, "c": 0.19},
        "weights": {"kind": "uniform", "low": 0.0, "high": 1.0}}
UNIFORM = {"generator": {"kind": "uniform", "scale": 10, "edge_factor": 16},
           "weights": {"kind": "uniform", "low": 0.0, "high": 1.0}}


def test_same_seed_same_graph_other_seed_other_graph():
    for cfg in (RMAT, UNIFORM):
        a = generators.make_graph(cfg, 2**31 + 7, "cpu")
        b = generators.make_graph(cfg, 2**31 + 7, "cpu")
        c = generators.make_graph(cfg, 2**31 + 8, "cpu")
        for key in ("src", "dst", "weight"):
            assert torch.equal(a[key], b[key])
        assert not torch.equal(a["src"], c["src"])
        assert a["n"] == 1024 and a["src"].shape == (16 * 1024,)
        assert a["src"].dtype == torch.int64
        assert a["weight"].dtype == torch.float32


def test_rmat_quadrant_rates():
    """Each bit of (src, dst) falls in quadrant a, b, c or d at the
    configured rates: the top bits of 2**14 edges, within 4 sigma."""
    g = generators.make_graph(RMAT, 11, "cpu")
    top = 1 << 9
    s_bit = (g["src"] >= top).double()
    d_bit = (g["dst"] >= top).double()
    m = g["src"].numel()
    rates = {"a": ((1 - s_bit) * (1 - d_bit)).mean(),
             "b": ((1 - s_bit) * d_bit).mean(),
             "c": (s_bit * (1 - d_bit)).mean(), "d": (s_bit * d_bit).mean()}
    want = {"a": 0.57, "b": 0.19, "c": 0.19, "d": 0.05}
    for k, p in want.items():
        sigma = (p * (1 - p) / m) ** 0.5
        assert abs(float(rates[k]) - p) < 4 * sigma, (k, rates[k])


def test_uniform_endpoints_and_weights_in_range():
    g = generators.make_graph(UNIFORM, 3, "cpu")
    n = g["n"]
    for key in ("src", "dst"):
        assert int(g[key].min()) >= 0 and int(g[key].max()) < n
        # uniform: each half of the ids holds about half of the endpoints
        low = float((g[key] < n // 2).double().mean())
        assert abs(low - 0.5) < 4 * (0.25 / g[key].numel()) ** 0.5
    w = g["weight"]
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0
    assert abs(float(w.mean()) - 0.5) < 0.02
