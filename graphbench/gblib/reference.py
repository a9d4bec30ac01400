"""The plain reference: BFS and SSSP over the generated edge list.

Straightforward PyTorch over the ``(src, dst, weight)`` arrays that
``generators.make_graph`` drew, on whatever device they lie: no CSR, no
partition, no split, no kernel, and nothing of the program under test (it
imports only ``torch``).  The semantics are those of the program's entries
and of their numpy oracles (``bfs_reference`` and ``sssp_reference`` in
``src/repro_torch/algorithms/{bfs,sssp}.py``), which these follow:

- BFS levels: the hop count from the root, ``inf`` where unreached.
- SSSP distances: the least fixpoint of ``d[v] = min(d[v], d[u] + w)`` in
  float32, ``inf`` where unreached.  Each candidate is one float32 addition
  of the source's distance and the edge weight, and min is exact, so every
  correct float32 Bellman-Ford reaches this fixpoint bit for bit, whatever
  order it relaxes the edges in.

Every function works on ``[S, n]`` blocks of ``rows`` query rows at a time,
so a batch fits beside ``[rows, E]`` messages.

``round_tf32`` and the ``control=True`` paths are the precision control: the
same computation with every value that enters an addition rounded to TF32
(10 explicit mantissa bits), the sum kept in float32, as a TF32 tensor core
computes.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to nearest even at TF32's 10 explicit
    mantissa bits; ``inf`` and ``nan`` pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def _blocks(roots: Sequence[int], rows: int):
    roots = [int(r) for r in roots]
    for i in range(0, len(roots), rows):
        yield roots[i:i + rows]


def _start(n: int, roots, device) -> torch.Tensor:
    x = torch.full((len(roots), n), math.inf, dtype=torch.float32,
                   device=device)
    x[torch.arange(len(roots), device=device),
      torch.as_tensor(roots, dtype=torch.int64, device=device)] = 0.0
    return x


def bfs_levels(src: torch.Tensor, dst: torch.Tensor, n: int,
               roots: Sequence[int], rows: int = 8,
               control: bool = False) -> torch.Tensor:
    """``[len(roots), n]`` float32 BFS levels, level by level: each round
    every vertex on the frontier sends ``level + 1`` along its out-edges
    and unvisited vertices take the least value they get.  With
    ``control`` the levels sent are rounded to TF32 (which holds every
    integer up to 2**11 exactly)."""
    out = []
    for block in _blocks(roots, rows):
        level = _start(n, block, src.device)
        idx = dst.expand(len(block), -1)
        d = 0
        while True:
            sent = (round_tf32(level) if control else level)[:, src]
            cand = torch.where(sent == d, sent + 1.0, math.inf)
            got = torch.full_like(level, math.inf).scatter_reduce_(
                1, idx, cand, "amin")
            newly = torch.isinf(level) & torch.isfinite(got)
            if not bool(newly.any()):
                break
            level = torch.where(newly, got, level)
            d += 1
        out.append(level)
    return torch.cat(out)


def sssp_distances(src: torch.Tensor, dst: torch.Tensor,
                   weight: torch.Tensor, n: int, roots: Sequence[int],
                   rows: int = 8, control: bool = False) -> torch.Tensor:
    """``[len(roots), n]`` float32 shortest distances by Bellman-Ford:
    every round relaxes every edge, until no distance falls.  With
    ``control`` the weights and each round's source distances are rounded
    to TF32 before the addition."""
    w = round_tf32(weight) if control else weight
    out = []
    for block in _blocks(roots, rows):
        dist = _start(n, block, src.device)
        idx = dst.expand(len(block), -1)
        while True:
            x = round_tf32(dist) if control else dist
            cand = x[:, src] + w
            new = dist.clone().scatter_reduce_(1, idx, cand, "amin")
            if torch.equal(new, dist):
                break
            dist = new
        out.append(dist)
    return torch.cat(out)

