"""Start a world of ranks for the sharded engine: one spawned process per
rank, each in its own ``torch.distributed`` process group.

CUDA ranks (the default) join an NCCL group, rank ``r`` on ``cuda:r``;
CPU ranks, asked for by name (``device="cpu"``), a gloo group.  Nothing tells a process of a cluster here, so the rendezvous
is given explicitly: ``init`` is a ``file://`` or ``tcp://localhost:<port>``
URL (a fresh ``file://`` under a temporary directory when None, so worlds
started side by side never share one).  CUDA ranks find the kernels built:
the parent builds every source once before it starts them.  A rank still
running shortly before the timeout prints its threads' stacks to stderr.
"""
from __future__ import annotations

import faulthandler
import multiprocessing as mp
import queue as queue_mod
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence

from repro_torch.device import resolve_device


def run_world(target: Callable, world: int, *, device: str = "cuda",
              init: Optional[str] = None, timeout: float = 600.0,
              args: Sequence = ()) -> List[object]:
    """Run ``target(group, *args)`` on ``world`` ranks and return each
    rank's result in rank order.  ``group`` is the rank's
    :class:`~repro_torch.distributed.ShardGroup`; ``target`` must be a
    module-level function (it is pickled by name).  Raises on the first
    rank that fails and after ``timeout`` seconds, and stops every process
    it started either way.  CUDA ranks need ``world`` cards: without
    them it raises before it starts any process.
    """
    if device != "cpu":
        import torch

        resolve_device(device)
        if torch.cuda.device_count() < world:
            raise RuntimeError(f"a world of {world} CUDA ranks needs "
                               f"{world} cards, found "
                               f"{torch.cuda.device_count()}")
        from repro_torch.kernels import _build
        _build.build_all(_build.sources())
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        if init is None:
            init = (Path(tmp) / "rendezvous").as_uri()
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(target, rank, world, device, init,
                                   tuple(args), results, timeout))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        got, finished = {}, False
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                try:
                    rank, ok, payload = results.get(timeout=max(left, 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(
                        f"{world - len(got)} of {world} ranks did not finish "
                        f"within {timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
            finished = True
        finally:
            # after a failure the other ranks may wait in a collective
            # forever: stop them at once
            for p in procs:
                if finished:
                    p.join(timeout=60.0)
                if p.is_alive():
                    p.terminate()
                p.join()
    return [got[r] for r in range(world)]


def _rank_main(target, rank, world, device, init, args, results, timeout):
    """One rank: join the group, run ``target``, report to the parent."""
    faulthandler.dump_traceback_later(max(timeout - 10.0, 1.0))
    try:
        import torch
        import torch.distributed as dist

        from repro_torch.distributed import ShardGroup

        torch.set_num_threads(1)
        dev = torch.device("cpu" if device == "cpu" else f"cuda:{rank}")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=init, rank=rank,
                                world_size=world)
        out = target(ShardGroup(dist.group.WORLD, dev), *args)
    except Exception:
        # report first: a peer may wait in a collective, and tearing the
        # group down could wait for it
        results.put((rank, False, traceback.format_exc()))
        return
    finally:
        faulthandler.cancel_dump_traceback_later()
    dist.destroy_process_group()
    results.put((rank, True, out))
