"""Per-rank costs of a run under a mesh, counted below DTensor: operations,
collective bytes by kind and live bytes.

The counterpart of ``benchmarks/hlo_analysis.py::collective_bytes`` (and of
the per-device ``cost_analysis()`` and ``memory_analysis()`` the JAX dry run
reads).  ``LocalCounter`` is a ``TorchDispatchMode`` that hands every op on
DTensors back to DTensor (``NotImplemented``) and so sees the ops DTensor
runs on each rank's local shards, the collectives of its redistributions
included; a mode above DTensor would see the global op (a ``[4096, 4096]
@ [4096, 11008]`` product where the rank multiplies ``[256, 4096] @ [4096,
688]``).  Enter it inside ``FakeTensorMode`` to count a run of fake
tensors.  DTensor's sharding propagation also runs ops, on fake tensors of
the global shapes, to learn an output's shape; those are not counted.

- **Operations**: ``torch.utils.flop_counter``'s formula for the op (the
  products, attention and the flash custom op), else one a result
  element for an elementwise op and one an input element for a
  ``scatter_reduce`` (XLA's cost analysis counts elementwise work too).
- **Collectives**: every ``_c10d_functional`` op, its operand bytes by
  ``hlo_analysis``'s rule: all-gather = output / group (the input),
  reduce-scatter = output × group (the input), the rest = output.  Eager
  PyTorch runs every layer and microbatch, so there are no loop
  multipliers.
- **Live bytes**: each new storage an op makes counts from its first
  tensor to the death of its last; ``peak`` is the most alive at once.
  Storages that existed before the counter (the arguments) and views of
  them are not counted.
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd")
# op name prefix → (kind, whether the operand is the input)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", True),
    "reduce_scatter_tensor": ("reduce-scatter", True),
    "all_reduce": ("all-reduce", False),
    "all_to_all_single": ("all-to-all", False),
    "broadcast": ("all-reduce", False),
}


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def _in_shape_propagation(depth: int = 16) -> bool:
    """Whether DTensor's sharding propagation is running the op on global
    fake tensors (``_propagate_tensor_meta*`` on the stack)."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class LocalCounter(TorchDispatchMode):
    """Counts the ops that run on local tensors while it is active:
    ``flops``, ``matmul_flops``, ``bytes_accessed`` (each op's tensor
    inputs and outputs), ``collectives`` (operand bytes by kind) and
    ``calls`` (by kind), ``live`` and ``peak`` bytes.  ``scale`` multiplies
    what is counted from then on (a step the caller replays)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.matmul_flops = 0
        self.bytes_accessed = 0
        self.collectives: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.calls: Counter = Counter()
        self.live = 0
        self.peak = 0
        self.scale = 1
        self._storages: Dict[int, list] = {}

    # -- dispatch -------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        self._count(func, args, kwargs, out, ins, outs)
        self._track(ins, outs)
        return out

    def _count(self, func, args, kwargs, out, ins, outs) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        if ns in _NAMESPACES:
            name = func._opname
            for prefix, (kind, by_input) in _COLLECTIVES.items():
                if name.startswith(prefix):
                    n = _bytes(ins[:1] if by_input else outs)
                    self.collectives[kind] += n * self.scale
                    self.calls[kind] += 1
                    return
            return
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n * self.scale
            self.matmul_flops += n * self.scale
        elif torch.Tag.pointwise in func.tags:
            self.flops += sum(t.numel() for t in outs) * self.scale
        elif packet is torch.ops.aten.scatter_reduce:
            self.flops += args[3].numel() * self.scale
        if torch.Tag.view_copy not in func.tags and not func.is_view:
            self.bytes_accessed += (_bytes(ins) + _bytes(outs)) * self.scale

    # -- live bytes -----------------------------------------------------------
    def _track(self, ins, outs) -> None:
        seen_in = {_key(t) for t in ins}
        for t in outs:
            key = _key(t)
            entry = self._storages.get(key)
            if entry is None:
                if key in seen_in:          # a view or in-place result of
                    continue                # storage made before counting
                entry = self._storages[key] = [
                    t.untyped_storage().nbytes(), 0]
                self.live += entry[0]
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def summary(self) -> Dict[str, object]:
        """The counts as plain numbers; ``collective_bytes`` adds
        ``total``."""
        cb = dict(self.collectives)
        cb["total"] = sum(cb[k] for k in KINDS)
        return {"flops": float(self.flops),
                "matmul_flops": float(self.matmul_flops),
                "bytes_accessed": float(self.bytes_accessed),
                "collective_bytes": cb,
                "collective_calls": dict(self.calls),
                "peak_bytes": int(self.peak)}
