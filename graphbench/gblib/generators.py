"""The benchmark's graphs, drawn on the device from a seed.

Frozen copy of the arithmetic of ``src/repro_torch/core/graph.py``'s ``rmat``
and ``uniform`` (the TOTEM paper's RMAT and UNIFORM graphs, Table 2), written
in PyTorch so that a scale-20 graph is drawn on the card in milliseconds
instead of numpy's 15-28 s.  RMAT is the R-MAT recursion (Chakrabarti et al.
2004) with Graph500's default probabilities, directed and not relabelled, as
the paper's graphs are (not Graph500's undirected, permuted graph): for each
of ``scale`` bits of every edge, the source bit is 1 with probability
``c + d`` and the destination bit is 1 with probability ``b / (a + b)`` after
a 0 source bit and ``d / (c + d)`` after a 1.  No vertex is relabelled and no
edge removed (duplicates and self loops stay), as in the copied functions.
Edge weights are uniform in ``[low, high)``, the rule of Graph500's kernel 3.

Only ``torch`` is imported: the plain reference reads the same arrays.
"""
from __future__ import annotations

from typing import Dict

import torch


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any whole
    number; taken modulo 2**64)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def rmat_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               gen: torch.Generator, device):
    """``(src, dst)`` int64 ``[n * edge_factor]`` of a directed RMAT graph
    with ``n = 2**scale`` vertices."""
    m = (1 << scale) * edge_factor
    ab = a + b
    a_frac = a / ab
    c_frac = c / (1.0 - ab)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        src_bit = torch.rand(m, generator=gen, device=device) > ab
        thresh = torch.where(src_bit, c_frac, a_frac)
        dst_bit = torch.rand(m, generator=gen, device=device) > thresh
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return src, dst


def uniform_edges(scale: int, edge_factor: int, gen: torch.Generator,
                  device):
    """``(src, dst)`` int64 of an Erdos-Renyi-style graph: both endpoints of
    each of ``n * edge_factor`` edges uniform over ``[0, n)``."""
    n = 1 << scale
    m = n * edge_factor
    src = torch.randint(0, n, (m,), generator=gen, device=device)
    dst = torch.randint(0, n, (m,), generator=gen, device=device)
    return src, dst


def make_graph(cfg: dict, seed: int, device) -> Dict[str, object]:
    """The configuration's graph from ``seed``: ``{"n", "src", "dst",
    "weight"}`` with int64 endpoints and float32 weights on ``device``."""
    spec = cfg["generator"]
    gen = generator(seed, device)
    if spec["kind"] == "rmat":
        src, dst = rmat_edges(spec["scale"], spec["edge_factor"], spec["a"],
                              spec["b"], spec["c"], gen, device)
    elif spec["kind"] == "uniform":
        src, dst = uniform_edges(spec["scale"], spec["edge_factor"], gen,
                                 device)
    else:
        raise ValueError(f"unknown generator kind {spec['kind']!r}")
    wspec = cfg["weights"]
    if wspec["kind"] != "uniform":
        raise ValueError(f"unknown weight kind {wspec['kind']!r}")
    lo, hi = float(wspec["low"]), float(wspec["high"])
    weight = torch.rand(src.shape[0], generator=gen, device=device,
                        dtype=torch.float32) * (hi - lo) + lo
    return {"n": 1 << spec["scale"], "src": src, "dst": dst,
            "weight": weight}
