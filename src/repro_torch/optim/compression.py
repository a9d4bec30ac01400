"""int8 gradient compression with error feedback (port of
``repro.optim.compression``).

Each tensor is flattened, padded to whole blocks of ``BLOCK`` values, and
stored as int8 with one f32 scale per block (the block's largest
magnitude over 127); values round half to even, as ``jnp.round`` does.
:class:`CompressedAllReduce` sums the int8 payload over a
``torch.distributed`` group as int32, shares the mean of the scales, and
carries each rank's quantization residual into its next call (error
feedback, Karimireddy et al. 2019).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_map

BLOCK = 256


def _blocked(x: torch.Tensor) -> Tuple[torch.Tensor, tuple]:
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), (tuple(x.shape), x.numel())


@torch.no_grad()
def compress_int8(x: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, tuple]:
    """``(int8 values [nb, BLOCK], f32 scales [nb, 1], (shape, size))``."""
    blocks, meta = _blocked(x.float())
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    # torch.round rounds half to even, as jnp.round does
    q = torch.round(blocks / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale, meta


@torch.no_grad()
def decompress_int8(q: torch.Tensor, scale: torch.Tensor, meta: tuple,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    shape, size = meta
    out = (q.float() * scale).reshape(-1)[:size]
    return out.reshape(shape).to(dtype)


class CompressedAllReduce(NamedTuple):
    """Error-feedback int8 sum over ``group`` (a ``torch.distributed``
    process group; None is the default group, or a world of one when no
    group was initialised)."""

    group: Optional[Any] = None

    def init_error(self, grads):
        return tree_map(torch.zeros_like, grads)

    def _world(self) -> int:
        if self.group is None and not dist.is_initialized():
            return 1
        return dist.get_world_size(self.group)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        if self._world() > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    @torch.no_grad()
    def __call__(self, grads, error):
        """``(summed gradients, new error)``: every rank gets the same
        dequantized sum."""
        n = torch.tensor(float(self._world()))

        def one(g, e):
            g32 = g.float() + e.float()
            q, s, meta = compress_int8(g32)
            new_e = (g32 - decompress_int8(q, s, meta)).to(e.dtype)
            # int8 on the wire, summed as int32 so shards cannot overflow
            summed = self._sum(q.to(torch.int32))
            s_sum = self._sum(s.clone())         # a conservative shared scale
            deq = (summed.float() * (s_sum / n.to(s.device))).reshape(-1)
            return deq[:meta[1]].reshape(meta[0]).to(g.dtype), new_e

        return _split(tree_map(one, grads, error))


def _split(pairs):
    """A tree of ``(a, b)`` leaves -> ``(tree of a, tree of b)``."""
    if isinstance(pairs, dict):
        firsts, seconds = {}, {}
        for k in sorted(pairs):
            firsts[k], seconds[k] = _split(pairs[k])
        return firsts, seconds
    return pairs
