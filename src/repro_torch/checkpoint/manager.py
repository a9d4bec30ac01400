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
  ``.npz``), so a snapshot taken on a world of N ranks restores on a
  world of M (:func:`restore_resharded`).
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
does not shard the leaf) and, on rank 0, the plain leaves.  A step is
complete when every rank's manifest is there.  A restore reads each
rank's shards back from the rank that wrote them (``DTensor.from_local``)
into ``like``'s layout, which must be the layout that saved them; no
rank ever holds a whole leaf.  This is the extension the JAX package's
manager describes for a multi-host pod (each host its shard slice).
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional, Tuple

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
    ``_flatten`` name: a tensor leaf of ``like`` gives a tensor on its
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
        if tuple(arr.shape) != tuple(local.shape):
            raise ValueError(
                f"leaf {prefix.rstrip('/')}: saved shard {arr.shape}, this "
                f"layout's {tuple(local.shape)}: restore into the mesh and "
                f"layout that saved it")
        out = torch.as_tensor(np.asarray(arr), device=local.device).to(
            like.dtype)
        return DTensor.from_local(out, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(np.asarray(arr), device=like.device).to(
            like.dtype)
    return arr


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
        if self.rank is None:
            host = {k: _host(v) for k, v in flat.items()}
        else:
            host = {k: v.to_local().detach().cpu().numpy()
                    if isinstance(v, DTensor) else _host(v)
                    for k, v in flat.items() if _writer(v) == self.rank}
        # Per-leaf CRCs into the manifest, taken before the chaos site
        # below, so an injected tear always mismatches its checksum.
        checksums = {k: _crc(v) for k, v in host.items()}
        from repro_torch.runtime import chaos  # a light import, on use
        if chaos.visit("checkpoint.torn", step=int(step)) and host:
            torn_key = sorted(host)[0]
            torn = np.ascontiguousarray(host[torn_key]).copy()
            torn.view(np.uint8)[0] ^= 0x7F
            host[torn_key] = torn

        def write():
            final = self._path(step, "npz")
            tmp = final.with_name(final.name + ".tmp")
            with open(tmp, "wb") as f:
                np.savez(f, **{k.replace("/", "|"): v
                               for k, v in host.items()})
            os.replace(tmp, final)       # atomic publish
            self._path(step, "json").write_text(json.dumps(
                {"step": step, "leaves": sorted(host),
                 "checksums": checksums, "extra": extra or {}}))
            self.save_log.append((step, final.stat().st_size,
                                  time.perf_counter() - t0))
            self._gc()

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

    def _path(self, step: int, ext: str, rank: Optional[int] = None
              ) -> Path:
        """A step's file of this rank (of ``rank``'s in a sharded
        checkpoint)."""
        rank = self.rank if rank is None else rank
        tag = "" if rank is None else f".rank{rank:05d}"
        return self.dir / f"step_{step:08d}{tag}.{ext}"

    def _steps(self) -> list:
        """The steps of which this rank's file is there, oldest first."""
        tag = "" if self.rank is None else rf"\.rank{self.rank:05d}"
        pat = re.compile(rf"step_(\d{{8}}){tag}\.npz")
        return sorted(int(m.group(1)) for f in self.dir.glob("step_*.npz")
                      if (m := pat.fullmatch(f.name)))

    def _gc(self):
        for old in self._steps()[: -self.keep]:
            self._path(old, "npz").unlink(missing_ok=True)
            self._path(old, "json").unlink(missing_ok=True)

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        """The newest complete step (every rank's manifest there, in a
        sharded checkpoint: every rank must call it, as it waits for the
        others' writes)."""
        self.wait()
        if self.rank is not None:
            dist.barrier()
        ranks = [None] if self.rank is None else range(self.world)
        valid = [s for s in self._steps()
                 if all(self._path(s, "json", r).exists() for r in ranks)]
        return valid[-1] if valid else None

    def restore_tree(self, like: Any, step: Optional[int] = None,
                     verify: bool = True) -> Tuple[int, Any]:
        """Restore a tree into the structure of ``like``; a tensor leaf of
        ``like`` comes back on its device with its dtype.

        ``verify=True`` (the default) checksums every loaded leaf against
        the manifest CRCs and raises :class:`CheckpointCorruption` on a
        mismatch: a torn write never silently warm-starts a corrupted
        state.  Manifests without ``checksums`` load unverified.
        """
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        # each leaf's file: the one file, or the rank's that wrote it
        writers = {n or "_": None if self.rank is None else _writer(v)
                   for n, v in _flatten(like).items()}
        flat = {}
        for rank in dict.fromkeys(writers.values()):
            flat.update(self._read(step, rank, verify, [
                n for n, w in writers.items() if w == rank]))
        return step, _unflatten(like, flat)

    def _read(self, step: int, rank: Optional[int], verify: bool,
              names: list) -> dict:
        """The leaves of ``rank``'s file of ``step`` (all of the one file
        of an unsharded checkpoint, for None; else those in ``names``),
        checked against its manifest."""
        path = self._path(step, "npz", rank)
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
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return json.loads(self._path(step, "json").read_text()).get(
            "extra", {})


def restore_resharded(manager: CheckpointManager, like: Any, group,
                      step: Optional[int] = None):
    """Elastic restore: every leaf as a tensor on ``group``'s device (a
    :class:`~repro_torch.distributed.ShardGroup`).

    The JAX package places the leaves under a mesh's shardings; the port's
    sharded engine takes the global state on every rank and slices its own
    partitions, so restoring onto a world of M ranks is restoring the
    whole tree onto each rank's device, whatever world wrote it.
    """
    step, tree = manager.restore(like, step)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(place(v) for v in x)
        return torch.as_tensor(x, device=group.device)

    return step, place(tree)
