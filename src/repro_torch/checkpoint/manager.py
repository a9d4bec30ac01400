"""Atomic checkpoints with a checksum per leaf and an asynchronous save.

- **Atomicity**: write ``step_N.npz.tmp``, then ``os.replace`` it: a crash
  mid-save never leaves a torn file under the published name, and
  ``latest_step()`` only sees complete checkpoints (those with a
  manifest).
- **Asynchronous save**: every leaf is copied to the host before
  ``save_tree`` returns (a device tensor's copy synchronizes with its
  stream); the disk write runs on a background thread, so the caller
  loses only the copy time.
- **Integrity**: the manifest holds a CRC32 of each leaf's bytes;
  ``restore_tree(verify=True)`` refuses a leaf whose bytes disagree
  (:class:`CheckpointCorruption`).
- **Elastic restore**: leaves are stored whole (one array each inside an
  ``.npz``), or as shards with their offsets, so a snapshot taken on a
  world of N ranks restores on a world of M and on any mesh
  (:func:`restore_resharded`).
- **Retention**: the newest ``keep`` checkpoints stay.

Port of ``repro.checkpoint.manager``, on the same format on disk: the
``.npz`` per step, the ``.json`` manifest, the per-leaf CRC32 over the
same bytes, the same leaf names (``_flatten``'s paths with ``/`` stored as
``|``).  A checkpoint written by either package restores in the other.
Leaves are tensors (any device) or numpy arrays; a restore gives each
leaf ``like``'s type, and a tensor leaf ``like``'s device and dtype.

**Sharded checkpoints** (``sharded=True``: a tree of DTensors, as
``launch/train.py --production-mesh`` lays it out; each rank of the
process group makes its manager on the same directory and calls it at the
same points).  Each step is still one checkpoint, written once: rank r
writes ``step_N.rank<r>.npz`` and its manifest with the local shards of
which it holds the first replica (its coordinate 0 on every mesh dim that
does not shard the leaf) and, on rank 0, the plain leaves.  Each manifest
records the world that wrote it and, for each shard, the leaf's global
shape and the shard's global offset and shape.  A step is complete when
every rank's manifest is there.

**Restore into any layout.**  A restore reads, for each leaf of ``like``,
the region this rank holds in ``like``'s layout (the whole leaf for a
plain tensor or array, the local shard of a DTensor), from the saved
pieces that overlap it: a whole checkpoint's leaves, or the shards of a
sharded one written on any mesh and world.  No rank reads a shard it does
not overlap, so none holds a whole sharded leaf that its layout shards.
A sharded checkpoint written before the manifests recorded offsets
restores only into the mesh and layout that saved it.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard


class CheckpointCorruption(RuntimeError):
    """A restored leaf's bytes disagree with its manifest checksum.

    Not retryable (reading the same torn file again cannot succeed): the
    caller falls back to an older snapshot or recomputes.
    """


def _flatten(tree, prefix=""):
    """Flatten with the JAX package's leaf order and names (dicts sorted by
    key, sequences and named tuples by position)."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)) or hasattr(tree, "_fields"):
        items = tree._asdict().items() if hasattr(tree, "_asdict") else \
            enumerate(tree)
        for k, v in items:
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(like, flat: dict, prefix=""):
    """``like``'s structure with each leaf read from ``flat`` by its
    ``_flatten`` name (``_region``'s part of the leaf): a DTensor leaf of
    ``like`` gives a DTensor of its layout, a tensor leaf a tensor on its
    device with its dtype, any other leaf the stored array."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], flat, f"{prefix}{k}/") for k in like}
    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, flat, f"{prefix}{k}/")
                            for k, v in like._asdict().items()))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    arr = flat[prefix.rstrip("/") or "_"]
    if isinstance(like, DTensor):               # this rank's shard
        local = like.to_local()
        out = torch.as_tensor(np.asarray(arr), device=local.device).to(
            like.dtype)
        return DTensor.from_local(out, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(arr), device=like.device).to(
            like.dtype)
    return arr


def _region(leaf) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(global offset, shape)`` of the part of ``leaf`` this rank holds:
    a DTensor's local shard (DTensor's split: each mesh dim that shards a
    tensor dim cuts what the dims before it left in ``ceil`` chunks), all
    of any other leaf."""
    if not isinstance(leaf, DTensor):
        shape = tuple(np.shape(leaf))
        return (0,) * len(shape), shape
    shape, off = list(leaf.shape), [0] * leaf.dim()
    coord = leaf.device_mesh.get_coordinate()
    for i, p in enumerate(leaf.placements):
        if isinstance(p, Shard):
            d, n = p.dim, leaf.device_mesh.size(i)
            chunk = -(-shape[d] // n)
            start = min(coord[i] * chunk, shape[d])
            off[d] += start
            shape[d] = min(chunk, shape[d] - start)
        elif not p.is_replicate():
            raise ValueError(f"cannot hold a leaf laid out {leaf.placements}")
    if tuple(shape) != tuple(leaf.to_local().shape):
        raise ValueError(f"DTensor of {tuple(leaf.shape)} laid out "
                         f"{leaf.placements}: local shard "
                         f"{tuple(leaf.to_local().shape)}, expected "
                         f"{tuple(shape)}")
    return tuple(off), tuple(shape)


def _overlap(off, shape, p_off, p_shape):
    """The slices of a target region ``(off, shape)`` and of a saved piece
    ``(p_off, p_shape)`` that cover their common part, or None."""
    lo = [max(a, b) for a, b in zip(off, p_off)]
    hi = [min(a + n, b + m) for a, n, b, m in zip(off, shape, p_off,
                                                  p_shape)]
    if any(h <= l for l, h in zip(lo, hi)):
        return None
    return (tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, off)),
            tuple(slice(l - b, h - b) for l, h, b in zip(lo, hi, p_off)))


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        raise TypeError("a DTensor leaf needs CheckpointManager(sharded=True)")
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _writer(leaf) -> int:
    """The rank that writes ``leaf``'s shard held by this rank: the one at
    this rank's coordinates on the mesh dims that shard the leaf and at 0
    on the others (rank 0 for a plain leaf)."""
    if not isinstance(leaf, DTensor):
        return 0
    if any(not (isinstance(p, Shard) or p.is_replicate())
           for p in leaf.placements):
        raise ValueError(f"cannot save a leaf laid out {leaf.placements}")
    coord = leaf.device_mesh.get_coordinate()
    idx = tuple(c if isinstance(p, Shard) else 0
                for c, p in zip(coord, leaf.placements))
    return int(leaf.device_mesh.mesh[idx])


def _crc(arr: np.ndarray) -> int:
    return int(zlib.crc32(np.ascontiguousarray(arr).tobytes()))


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 sharded: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        # this rank and the world's size when every rank writes its shards
        self.rank = dist.get_rank() if sharded else None
        self.world = dist.get_world_size() if sharded else None
        self._thread: Optional[threading.Thread] = None
        # (step, bytes written, seconds from save_tree's call to the file's
        # publication) of every save
        self.save_log: list = []

    # -- save ---------------------------------------------------------------

    def save_tree(self, step: int, tree: Any,
                  extra: Optional[dict] = None,
                  blocking: bool = True) -> Path:
        """Persist a tree (dicts, sequences, named tuples) of tensors and
        arrays.

        The generic entry point: serving snapshots (vertex state,
        per-query step counters, finished votes, dynamic-graph payloads)
        and train states alike; ``save`` wraps it in the train-shaped
        ``{"params", "opt_state"}`` tree.  ``extra`` lands in the manifest
        JSON (small host metadata: replay cursors, round indices) and
        reads back via :meth:`manifest_extra`.
        """
        self.wait()
        t0 = time.perf_counter()
        flat = _flatten(tree)
        if "" in flat:                       # bare-leaf tree
            flat = {"_": flat.pop("")}
        # every leaf this rank writes on the host before the writer
        # thread starts
        shards = None
        if self.rank is None:
            host = {k: _host(v) for k, v in flat.items()}
        else:
            mine = {k: v for k, v in flat.items() if _writer(v) == self.rank}
            host = {k: v.to_local().detach().cpu().numpy()
                    if isinstance(v, DTensor) else _host(v)
                    for k, v in mine.items()}
            shards = {k: {"shape": list(np.shape(v)),
                          "offset": list(_region(v)[0]),
                          "local": list(host[k].shape),
                          "dtype": host[k].dtype.str}
                      for k, v in mine.items()}
        # Per-leaf CRCs into the manifest, taken before the chaos site
        # below, so an injected tear always mismatches its checksum.
        checksums = {k: _crc(v) for k, v in host.items()}
        from repro_torch.runtime import chaos  # a light import, on use
        if chaos.visit("checkpoint.torn", step=int(step)) and host:
            torn_key = sorted(host)[0]
            torn = np.ascontiguousarray(host[torn_key]).copy()
            torn.view(np.uint8)[0] ^= 0x7F
            host[torn_key] = torn
        manifest = {"step": step, "leaves": sorted(host),
                    "checksums": checksums, "extra": extra or {}}
        if shards is not None:
            manifest.update(world=self.world, shards=shards)

        def write():
            final = self._path(step, "npz")
            tmp = final.with_name(final.name + ".tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **{k.replace("/", "|"): v
                               for k, v in host.items()})
            os.replace(tmp, final)       # atomic publish
            man = self._path(step, "json")
            tmp = man.with_name(man.name + ".tmp")
            tmp.write_text(json.dumps(manifest))
            os.replace(tmp, man)
            self.save_log.append((step, final.stat().st_size,
                                  time.perf_counter() - t0))
            self._gc(step)

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return self._path(step, "npz")

    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[dict] = None, blocking: bool = True) -> Path:
        """Train-shaped adapter over :meth:`save_tree`."""
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        return self.save_tree(step, tree, extra=extra, blocking=blocking)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _file(self, step: int, ext: str, rank: Optional[int]) -> Path:
        """A step's file of ``rank`` (of a whole checkpoint, for None)."""
        tag = "" if rank is None else f".rank{rank:05d}"
        return self.dir / f"step_{step:08d}{tag}.{ext}"

    def _path(self, step: int, ext: str) -> Path:
        """A step's file of this rank."""
        return self._file(step, ext, self.rank)

    def _steps(self) -> list:
        """The steps of which this rank's file is there, oldest first."""
        tag = "" if self.rank is None else rf"\.rank{self.rank:05d}"
        pat = re.compile(rf"step_(\d{{8}}){tag}\.npz")
        return sorted(int(m.group(1)) for f in self.dir.glob("step_*.npz")
                      if (m := pat.fullmatch(f.name)))

    def _gc(self, step: int):
        for old in self._steps()[: -self.keep]:
            self._path(old, "npz").unlink(missing_ok=True)
            self._path(old, "json").unlink(missing_ok=True)
        if self.rank == 0:
            # files of ranks a larger world left: of this step (a rerun
            # after a resume on fewer ranks) and of the steps dropped
            keep = set(self._steps())
            pat = re.compile(r"step_(\d{8})\.rank(\d{5})\.(npz|json)")
            for f in self.dir.glob("step_*.rank*"):
                m = pat.fullmatch(f.name)
                if m and int(m.group(2)) >= self.world and (
                        int(m.group(1)) == step
                        or int(m.group(1)) not in keep):
                    f.unlink(missing_ok=True)

    # -- restore --------------------------------------------------------------

    def _head(self, step: int) -> Optional[Tuple[Optional[int], dict]]:
        """``(None, manifest)`` of a whole checkpoint of ``step``, ``(0,
        rank 0's manifest)`` of a sharded one, or None."""
        for rank in (None, 0):
            path = self._file(step, "json", rank)
            if path.exists():
                return rank, json.loads(path.read_text())
        return None

    def _saved_world(self, manifest: dict) -> int:
        """The world that wrote a sharded checkpoint: its manifests' record
        (one written before they kept it restores only into its own layout,
        so on this manager's world)."""
        return int(manifest.get("world", self.world or 1))

    def latest_step(self) -> Optional[int]:
        """The newest complete step, whole or sharded, of whatever world
        wrote it (a sharded manager's ranks must all call it: it waits for
        the others' writes)."""
        self.wait()
        if self.rank is not None:
            dist.barrier()
        pat = re.compile(r"step_(\d{8})(\.rank00000)?\.json")
        found = sorted({int(m.group(1)) for f in self.dir.glob("step_*.json")
                        if (m := pat.fullmatch(f.name))})
        valid = []
        for s in found:
            rank, manifest = self._head(s)
            ranks = ([None] if rank is None
                     else range(self._saved_world(manifest)))
            if all(self._file(s, "npz", r).exists()
                   and self._file(s, "json", r).exists() for r in ranks):
                valid.append(s)
        return valid[-1] if valid else None

    def restore_tree(self, like: Any, step: Optional[int] = None,
                     verify: bool = True) -> Tuple[int, Any]:
        """Restore a tree into the structure and layout of ``like``: a
        DTensor leaf comes back as a DTensor of its mesh and placements, a
        tensor leaf on its device with its dtype, from a whole or a sharded
        checkpoint written on any world and mesh (the module docstring).

        ``verify=True`` (the default) checksums every loaded piece against
        the manifest CRCs and raises :class:`CheckpointCorruption` on a
        mismatch: a torn write never silently warm-starts a corrupted
        state.  Manifests without ``checksums`` load unverified.
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        head = None if step is None else self._head(step)
        if head is None:
            raise FileNotFoundError(f"no checkpoint "
                                    f"{'' if step is None else step} in "
                                    f"{self.dir}")
        leaves = _flatten(like)
        if "" in leaves:
            leaves = {"_": leaves.pop("")}
        rank, manifest = head
        if rank is None:                              # whole leaves
            flat = self._read(step, None, verify, list(leaves))
            for name, leaf in leaves.items():
                if isinstance(leaf, DTensor):
                    off, shape = _region(leaf)
                    flat[name] = flat[name][tuple(
                        slice(o, o + n) for o, n in zip(off, shape))]
        elif "shards" in manifest:
            flat = self._read_shards(step, manifest, leaves, verify)
        else:
            flat = self._read_own_layout(step, leaves, verify)
        return step, _unflatten(like, flat)

    def _read_shards(self, step: int, manifest: dict, leaves: dict,
                     verify: bool) -> Dict[str, np.ndarray]:
        """Each leaf's region (``_region``: a plain leaf whole) from the
        saved shards that overlap it, read from the ranks that wrote
        them."""
        pieces: Dict[str, list] = {}
        for r in range(self._saved_world(manifest)):
            man = (manifest if r == 0 else json.loads(
                self._file(step, "json", r).read_text()))
            for name, rec in man["shards"].items():
                pieces.setdefault(name, []).append((r, rec))
        missing = [n for n in leaves if n not in pieces]
        if missing:
            raise KeyError(
                f"checkpoint step {step} in {self.dir} lacks leaves "
                f"{missing[:4]} (have {sorted(pieces)[:4]}...) — was the "
                f"snapshot written with a different tree structure?")
        plan, need = {}, {}
        for name, leaf in leaves.items():
            rec0 = pieces[name][0][1]
            shape = tuple(rec0["shape"])
            off, local = (_region(leaf) if isinstance(leaf, DTensor)
                          else ((0,) * len(shape), shape))
            if isinstance(leaf, DTensor) and tuple(leaf.shape) != shape:
                raise ValueError(f"leaf {name}: saved {shape}, restoring "
                                 f"into {tuple(leaf.shape)}")
            cuts = [(r, cut) for r, rec in pieces[name]
                    if (cut := _overlap(off, local, rec["offset"],
                                        rec["local"])) is not None]
            if sum(math.prod(sl.stop - sl.start for sl in c[0])
                   for _, c in cuts) != math.prod(local):
                raise ValueError(f"leaf {name}: the saved shards do not "
                                 f"cover the region {off} + {local}")
            plan[name] = (np.empty(local, dtype=np.dtype(rec0["dtype"])),
                          cuts)
            for r, _ in cuts:
                need.setdefault(r, set()).add(name)
        read = {r: self._read(step, r, verify, sorted(names))
                for r, names in need.items()}
        for name, (out, cuts) in plan.items():
            for r, (dst, src) in cuts:
                out[dst] = read[r][name][src]
        return {name: out for name, (out, _) in plan.items()}

    def _read_own_layout(self, step: int, leaves: dict,
                         verify: bool) -> Dict[str, np.ndarray]:
        """A sharded checkpoint whose manifests record no offsets: each
        leaf from the rank that wrote this rank's shard of it, which only
        the layout that saved it can name."""
        writers = {n: _writer(v) for n, v in leaves.items()}
        flat = {}
        for rank in dict.fromkeys(writers.values()):
            if not self._file(step, "npz", rank).exists():
                raise ValueError(
                    f"checkpoint step {step} in {self.dir} records no shard "
                    f"offsets and has no file of rank {rank}: it restores "
                    f"only into the mesh and layout that saved it")
            flat.update(self._read(step, rank, verify, [
                n for n, w in writers.items() if w == rank]))
        for name, leaf in leaves.items():
            if isinstance(leaf, DTensor) and (
                    tuple(flat[name].shape) != _region(leaf)[1]):
                raise ValueError(
                    f"leaf {name}: saved shard {flat[name].shape}, this "
                    f"layout's {_region(leaf)[1]}: a checkpoint that records "
                    f"no shard offsets restores only into the mesh and "
                    f"layout that saved it")
        return flat

    def _read(self, step: int, rank: Optional[int], verify: bool,
              names: list) -> dict:
        """The leaves of ``rank``'s file of ``step`` (all of the one file
        of a whole checkpoint, for None; else those in ``names``),
        checked against its manifest."""
        path = self._file(step, "npz", rank)
        with np.load(path) as data:
            flat = {k.replace("|", "/"): data[k] for k in data.files
                    if rank is None or k.replace("|", "/") in names}
        if verify:
            manifest = path.with_suffix(".json")
            want = {}
            if manifest.exists():
                want = json.loads(manifest.read_text()).get("checksums", {})
            bad = [k for k, crc in want.items()
                   if k in flat and _crc(flat[k]) != int(crc)]
            if bad:
                raise CheckpointCorruption(
                    f"checkpoint step {step} in {self.dir}: leaves {bad[:4]} "
                    f"fail their manifest CRC — torn or bit-flipped on disk; "
                    f"fall back to an older snapshot or recompute")
        missing = [n for n in names if n not in flat]
        if missing:
            raise KeyError(
                f"checkpoint step {step} in {self.dir} ({path.name}) lacks "
                f"leaves {missing[:4]} (have {sorted(flat)[:4]}...) — was "
                f"the snapshot written with a different tree structure?")
        return flat

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[int, Any]:
        """Restore into the structure of ``like`` ({"params":..,
        "opt_state":..}).  Adapter over :meth:`restore_tree`."""
        return self.restore_tree(like, step)

    def manifest_extra(self, step: Optional[int] = None) -> dict:
        """Host metadata saved alongside a snapshot (replay cursor, round)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        head = None if step is None else self._head(step)
        if head is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return head[1].get("extra", {})


def restore_resharded(manager: CheckpointManager, like: Any, mesh,
                      spec_tree=None, step: Optional[int] = None):
    """Elastic restore: place the checkpoint's leaves under ``mesh``.

    With a ``DeviceMesh`` (the JAX package's form), ``spec_tree`` mirrors
    ``like`` with a spec per leaf (``launch/sharding.py``'s JAX-form
    tuples; None, for a leaf, a subtree or the whole tree, replicates what
    it stands for): each leaf comes back as a DTensor of
    ``like``'s global shape and dtype laid out by
    ``sharding.placements``, each rank reading only its shard's region.
    The checkpoint may be whole or sharded, written on any mesh and world.

    With a :class:`~repro_torch.distributed.ShardGroup` (``spec_tree``
    unused), every leaf comes back whole as a tensor on the group's
    device: the port's sharded engine takes the global state on every rank
    and slices its own partitions.
    """
    from repro_torch.distributed import ShardGroup

    if isinstance(mesh, ShardGroup):
        step, tree = manager.restore(like, step)

        def place(x):
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            if hasattr(x, "_fields"):
                return type(x)(*(place(v) for v in x))
            if isinstance(x, (tuple, list)):
                return type(x)(place(v) for v in x)
            return torch.as_tensor(x, device=mesh.device)

        return step, place(tree)

    from repro_torch.launch import sharding as shd

    dev = torch.device(mesh.device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def target(x, spec):
        if isinstance(x, dict):
            return {k: target(v, None if spec is None else spec[k])
                    for k, v in x.items()}
        if isinstance(x, (tuple, list)) or hasattr(x, "_fields"):
            items = [target(v, None if spec is None else spec[i])
                     for i, v in enumerate(x)]
            return type(x)(*items) if hasattr(x, "_fields") else type(x)(
                items)
        dtype = (x.dtype if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.asarray(x)).dtype)
        shape = tuple(np.shape(x))
        return shd.empty_dtensor(shape, dtype, (None,) * len(shape)
                                 if spec is None else tuple(spec), mesh, dev)

    return manager.restore_tree(target(like, spec_tree), step)
