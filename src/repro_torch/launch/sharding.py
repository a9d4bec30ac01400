"""Sharding rules: logical activation axes and parameter specs, as DTensor
placements.

The counterpart of ``repro/launch/sharding.py``.  The models annotate
activations with *logical* names ("batch", "ffn", ...); under
``activation_rules`` this module resolves them to mesh axes and
``constrain`` redistributes a DTensor to them.  Parameters are sharded by
leaf name, as in JAX:

  - column-parallel weights (wq/wk/wv/w_gate/w_up/moe_w1): last dim → model
  - row-parallel weights (wo/w_down/moe_w2): contracted dim → model
  - embeddings / lm head: vocab dim → model
  - everything big additionally FSDP-shards over the data(+pod) axes
  - MoE expert stacks: expert dim → model (expert parallelism)

A spec is JAX's ``PartitionSpec`` as a tuple: one entry per tensor dim,
``None``, a mesh axis name, or a tuple of axis names, so it compares with
``tuple(PartitionSpec)``.  ``placements`` turns it into DTensor
placements: a dim that takes several axes is ``Shard(dim)`` on each of
them, in mesh order, which is JAX's major-to-minor order.

A mesh here is a ``DeviceMesh``, or a mapping of axis names to sizes
(enough for the specs, which read only the sizes).  What the layers do
with DTensors under these rules (gathers where DTensor has no strategy)
is ``models/dist.py``'s.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import (Dict, Mapping, Optional, Sequence, Tuple, Union)

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.models.common import opt_enabled
from repro_torch.models.dist import GradLayout, register_strategies

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

_state = threading.local()


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _axes_of(mesh) -> Tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _axes_of(mesh) if a in ("pod", "data"))


def _entry(axes: Tuple[str, ...]) -> Entry:
    """A spec entry as ``tuple(PartitionSpec)`` gives it: one axis by its
    name, several as a tuple."""
    return axes[0] if len(axes) == 1 else tuple(axes)


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> Tuple:
    """The DTensor placements of ``spec``: ``Shard(d)`` on every mesh dim
    that tensor dim ``d`` names, ``Replicate()`` on the others.  Raises
    when a dim names its axes out of mesh order or an axis twice."""
    names = _axes_of(mesh)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        order = [names.index(a) for a in _entry_axes(entry)]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {dim} names {entry} out of "
                             f"mesh order {names}")
        for i in order:
            if out[i] != Replicate():
                raise ValueError(f"spec {spec} names axis {names[i]} twice")
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a ``shape`` tensor laid out by ``spec``
    (every sharded dim divides: the specs shard only where it does)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = math.prod(sizes[a] for a in _entry_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide "
                             f"over {entry} ({n})")
        out[dim] //= n
    return tuple(out)


# ---------------------------------------------------------------------------
# Activation rules
# ---------------------------------------------------------------------------

def _rules() -> Optional[dict]:
    return getattr(_state, "rules", None)


def active_mesh():
    """The mesh of the enclosing ``activation_rules`` (None outside)."""
    return getattr(_state, "mesh", None) if _rules() is not None else None


@contextlib.contextmanager
def activation_rules(mesh, *, seq_sharded: bool = False):
    """Install logical-axis → mesh-axis rules for the enclosed run.  Plain
    tensors meeting DTensors there count as replicated
    (``implicit_replication``): positions, masks and scalars."""
    register_strategies()
    batch = fsdp_axes(mesh)
    rules = {
        "batch": batch,
        "heads": ("model",),
        "ffn": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "expert_cap": batch,
        "seq": ("model",) if seq_sharded else None,
        "kv_len": None,
        "embed": None,
    }
    prev = _rules()
    prev_mesh = getattr(_state, "mesh", None)
    _state.rules = rules
    _state.mesh = mesh
    try:
        with implicit_replication():
            yield
    finally:
        _state.rules = prev
        _state.mesh = prev_mesh


def data_shard_count() -> int:
    """Shards on the data(+pod) axes of the active mesh (1 when no rules
    are installed)."""
    mesh = active_mesh()
    if mesh is None:
        return 1
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in fsdp_axes(mesh))


def resolve(shape: Sequence[int], names: Sequence[Optional[str]],
            rules: Optional[dict] = None, mesh=None) -> Spec:
    """The spec ``constrain`` gives a ``shape`` tensor named ``names``:
    each name's axes where their size divides the dim, else None."""
    rules = _rules() if rules is None else rules
    mesh = active_mesh() if mesh is None else mesh
    sizes = axis_sizes(mesh)
    spec = []
    for dim, n in zip(shape, names):
        axes = rules.get(n) if n else None
        if axes:
            size = math.prod(sizes[a] for a in axes)
            axes = axes if dim % size == 0 else None
        spec.append(_entry(axes) if axes else None)
    return tuple(spec)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]):
    """Redistribute the DTensor ``x`` to the layout its logical ``names``
    resolve to, and its gradient too (JAX's ``with_sharding_constraint``,
    whose transpose constrains the cotangent alike).  Outside
    ``activation_rules``, or for a plain tensor, ``x`` itself; a DTensor
    already laid out so that needs no gradient, itself too."""
    mesh = active_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(resolve(x.shape, names), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = GradLayout.apply(x, want)
    return x


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

_COL_NAMES = ("wq", "wk", "wv", "w_gate", "w_up", "moe_w1", "in_proj",
              "patch_proj", "frame_proj")
_ROW_NAMES = ("wo", "w_down", "moe_w2", "out_proj")
_VOCAB_NAMES = ("embed", "lm_head")
_EXPERT_NAMES = ("moe_w1", "moe_w2", "moe_wg")


def _leaf_spec(path: str, ndim: int, shape, fsdp_axes: Tuple[str, ...],
               mesh, fsdp_min_size: int = 1 << 20) -> Spec:
    sizes = axis_sizes(mesh)
    name = path.split("/")[-1]
    big = math.prod(shape) >= fsdp_min_size
    is_expert = any(name.startswith(e) for e in _EXPERT_NAMES)
    spec: list = [None] * ndim

    def put(dim: int, axes) -> bool:
        """Assign mesh axes to dim if the size divides evenly."""
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        size = math.prod(sizes[a] for a in axes_t)
        if shape[dim] % size == 0 and spec[dim] is None:
            spec[dim] = axes_t if len(axes_t) > 1 else axes_t[0]
            return True
        return False

    if any(name == v for v in _VOCAB_NAMES):
        # [V, D] or [D, V]: shard the larger (vocab) dim on model.
        last2 = list(shape[-2:])
        vdim = last2.index(max(last2)) + ndim - 2
        other = ndim - 1 if vdim == ndim - 2 else ndim - 2
        put(vdim, "model")
        if big:
            put(other, fsdp_axes)
        return tuple(spec)

    if is_expert and ndim >= 3:
        # [L, E, ...]: expert parallelism on the E axis.
        put(1, "model")
        if big and ndim >= 4:
            put(2, fsdp_axes)
        return tuple(spec)

    if any(name.startswith(c) for c in _COL_NAMES) and ndim >= 2:
        put(ndim - 1, "model")
        if big:
            put(ndim - 2, fsdp_axes)
        return tuple(spec)
    if any(name.startswith(r) for r in _ROW_NAMES) and ndim >= 2:
        put(ndim - 2, "model")
        if big:
            put(ndim - 1, fsdp_axes)
        return tuple(spec)
    # norms / biases / small tensors: replicated (still FSDP the huge ones).
    if big and ndim >= 2:
        put(ndim - 1, fsdp_axes) or put(ndim - 2, fsdp_axes)
    return tuple(spec)


def param_specs(params_shape, mesh):
    """The spec tree of a params tree (nested dicts whose leaves have a
    ``shape``: tensors, meta tensors or ``TensorSpec``s)."""
    fsdp = fsdp_axes(mesh)

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        shape = tuple(tree.shape)
        return _leaf_spec(prefix, len(shape), shape, fsdp, mesh)

    return walk(params_shape)


def batch_specs(batch_shape, mesh):
    """Inputs: the leading batch dim sharded over pod+data when it divides
    (long_500k's global batch of 1 stays replicated)."""
    fsdp = fsdp_axes(mesh)
    sizes = axis_sizes(mesh)
    size = math.prod(sizes[a] for a in fsdp)

    def leaf(x):
        shape = tuple(x.shape)
        if len(shape) and shape[0] % size == 0:
            return (_entry(fsdp),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return tree_map_specs(leaf, batch_shape)


def tree_map_specs(fn, tree):
    """``fn`` over the leaves of a nested dict (kept in its key order)."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def named(tree, specs, mesh):
    """Distribute each tensor of ``tree`` over ``mesh`` by its spec in
    ``specs`` (a tree of the same keys): a tree of DTensors.  Each rank
    must pass the same values (the shards are cut from rank 0's)."""
    if isinstance(tree, dict):
        return {k: named(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, placements(specs, mesh))


def distribute_module(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Replace each parameter of a serving module by a DTensor laid out
    by ``param_specs`` of its tree path: a ``TreeModule``'s keys are the
    JAX paths (``layers.wq`` stacked ``[L, ...]``); a ``Transformer``'s
    per-layer ``layers.<i>.wq`` takes the stacked leaf's spec without its
    L entry.  A ``meta`` parameter becomes an uninitialised DTensor on the
    mesh's device (``empty_dtensor``).  In place; returns ``module``."""
    sizes = axis_sizes(mesh)
    fsdp = fsdp_axes(mesh)
    for name, p in list(module.named_parameters()):
        parts = name.split(".")
        shape = tuple(p.shape)
        if len(parts) >= 3 and parts[1].isdigit():
            # one layer of a stack: the stacked leaf's spec, L dropped
            n_stack = len(getattr(module, parts[0]))
            spec = _leaf_spec("/" + "/".join([parts[0]] + parts[2:]),
                              len(shape) + 1, (n_stack,) + shape, fsdp,
                              sizes)
            if spec[0] is not None:
                raise ValueError(f"{name}: a stack's spec shards its layer "
                                 f"axis ({spec})")
            spec = spec[1:]
        else:
            spec = _leaf_spec("/" + "/".join(parts), len(shape), shape, fsdp,
                              sizes)
        owner = module.get_submodule(".".join(parts[:-1]))
        if p.is_meta:
            t = empty_dtensor(shape, p.dtype, spec, mesh, mesh.device_type)
        else:
            t = distribute_tensor(p.data, mesh, placements(spec, mesh))
        setattr(owner, parts[-1],
                torch.nn.Parameter(t, requires_grad=p.requires_grad))
    return module


def cache_specs(cache_shape, mesh, seq_shard: Optional[bool] = None):
    """Decode caches (JAX's ``launch/dryrun.py::_cache_specs``): the batch
    dim (1, after the leading layer or group axis) over data(+pod) when it
    divides; with ``seq_shard`` (``REPRO_OPTS=cache_seq_shard``: split-KV
    decode) the sequence dim of ``[L, B, S, G, hd]`` caches over model,
    else the kv-head dim (-2) over model when it divides, else the last
    dim.  A Python int (the cache's ``len``) and a 0-dim leaf take
    ``()``; a leaf is anything with a ``shape``, or a ``torch.Size``."""
    if seq_shard is None:
        seq_shard = opt_enabled("cache_seq_shard")
    fsdp = fsdp_axes(mesh)
    sizes = axis_sizes(mesh)
    n_data = math.prod(sizes[a] for a in fsdp)
    n_model = sizes["model"]

    def leaf(x):
        shape = tuple(x) if isinstance(x, torch.Size) else tuple(
            getattr(x, "shape", ()))
        if len(shape) == 0:
            return ()
        spec: list = [None] * len(shape)
        bdim = 1 if len(shape) >= 2 else 0
        if shape[bdim] % n_data == 0:
            spec[bdim] = _entry(fsdp)
        if seq_shard and len(shape) >= 5 and shape[2] % n_model == 0:
            spec[2] = "model"
        elif len(shape) >= 4 and shape[-2] % n_model == 0:
            spec[-2] = "model"
        elif len(shape) >= 3 and shape[-1] % n_model == 0:
            spec[-1] = "model"
        return tuple(spec)

    return tree_map_specs(leaf, cache_shape)


def empty_dtensor(shape: Sequence[int], dtype: torch.dtype, spec: Spec,
                  mesh, device) -> torch.Tensor:
    """An uninitialised DTensor of global ``shape`` laid out by ``spec``,
    each rank allocating only its shard (under ``FakeTensorMode``: a fake
    one, nothing allocated)."""
    shape = tuple(shape)
    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                        device=device)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))

