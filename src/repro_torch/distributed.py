"""The sharded engine's process group: the counterpart of the JAX package's
mesh axis and its collectives (``shard_map`` with ``all_to_all``, ``psum``).

A :class:`ShardGroup` is one rank's view of the world that the sharded
engine (``core/bsp.py::DistributedBSPEngine``) runs over: its rank, the
world size and the device the rank computes on, and the three collectives
a superstep and a run need.  ``group=None`` is a world of one: no process
group is needed and every collective is the identity, so one process runs
all partitions on one device through the same code path.

Several ranks need an initialised ``torch.distributed`` process group:
gloo with CPU devices (the tests' multi-process worlds), NCCL with one CUDA
device per rank.  A gloo group with a CUDA device raises: nothing stages
the wire through the host quietly.  NCCL takes no bool, so the global vote
is an int32 sum of not-done flags, and bool leaves travel as uint8.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["ShardGroup"]


class ShardGroup:
    """Rank, world size, device and collectives of one shard.

    ``group`` is a ``torch.distributed`` process group (``dist.group.WORLD``
    or one from ``dist.new_group``) or None for a world of one.  ``device``
    is the rank's device: ``cuda`` unless named, as for the engines.
    """

    def __init__(self, group=None, device: DeviceLike = None):
        dev = torch.device("cuda" if device is None else device)
        self.group = group
        if group is None:
            self.rank, self.world_size, backend = 0, 1, None
        else:
            if not dist.is_initialized():
                raise RuntimeError(
                    "a ShardGroup over a process group needs "
                    "torch.distributed.init_process_group first; pass "
                    "group=None for a world of one")
            self.rank = dist.get_rank(group)
            self.world_size = dist.get_world_size(group)
            backend = str(dist.get_backend(group)).lower()
            if backend == "gloo" and dev.type == "cuda":
                raise ValueError(
                    "a gloo group moves CPU tensors; the sharded engine "
                    "does not stage CUDA tensors through the host: use "
                    "NCCL for cards, or device='cpu' with gloo")
            if backend == "nccl" and dev.type != "cuda":
                raise ValueError(f"an NCCL group needs CUDA devices, got "
                                 f"{dev}")
        self.backend = backend
        self.device = resolve_device(dev)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x [S, ...]`` peer-major (row ``t`` goes to rank ``t``) -> the
        rows received, ``[S, ...]`` (row ``u`` came from rank ``u``)."""
        if x.shape[0] != self.world_size:
            raise ValueError(f"all_to_all needs a leading peer axis of "
                             f"{self.world_size}, got {tuple(x.shape)}")
        if self.world_size == 1:
            return x
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def all_true(self, fin: torch.Tensor) -> torch.Tensor:
        """Global AND of the per-query votes ``fin [Q]`` bool."""
        if self.world_size == 1:
            return fin
        not_done = (~fin).to(torch.int32)
        dist.all_reduce(not_done, op=dist.ReduceOp.SUM, group=self.group)
        return not_done == 0

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ranks (every rank gets the sum)."""
        if self.world_size == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Concatenate every rank's ``x`` along ``dim`` in rank order (the
        shards' partition slices back into the global state)."""
        if self.world_size == 1:
            return x
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(self.world_size)]
        dist.all_gather(parts, wire.contiguous(), group=self.group)
        out = torch.cat(parts, dim=dim)
        return out.to(torch.bool) if x.dtype == torch.bool else out
