"""Production meshes as ``torch.distributed`` device meshes.

The counterpart of ``repro/launch/mesh.py``.  A mesh is made over the world
that exists (the process group of ``torchrun``, ``launch/world.py`` or a
fake group of the dry run), so the production meshes need 256 or 512 ranks
and raise naming the world size otherwise, as ``jax.make_mesh`` raises
without the devices.  Functions, not module constants: importing this
module touches no process group.  The device type is ``cuda`` unless the
caller names ``cpu``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def world_size() -> int:
    """Ranks in the default process group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _make(shape: Sequence[int], axes: Tuple[str, ...],
          device: str) -> DeviceMesh:
    need = math.prod(shape)
    have = world_size()
    if have != need:
        raise ValueError(
            f"a mesh of shape {tuple(shape)} over {axes} needs {need} ranks; "
            f"the world has {have} (start one rank per device, e.g. "
            f"torchrun --nproc-per-node, or a fake process group for a dry "
            f"run)")
    return init_device_mesh(device, tuple(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cuda") -> DeviceMesh:
    """``(16, 16)`` over ``("data", "model")``, or with ``multi_pod``
    ``(2, 16, 16)`` over ``("pod", "data", "model")``."""
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return _make(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device: str = "cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over a small world (tests, one card)."""
    return _make((data, model), ("data", "model"), device)


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """The (super-)data-parallel axes: ``('pod', 'data')`` or
    ``('data',)``."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
