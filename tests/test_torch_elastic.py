"""Elastic restore of the port's checkpoints against the JAX package's
``restore_resharded``, on the CPU, over gloo worlds.

A tree of train-shaped leaves (a weight sharded over ``("data",
"model")``, a vector over ``model``, a matrix whose last dim takes both
axes, a replicated one, AdamW's state with its scalar step) is saved
whole, then:

- restored by JAX's ``restore_resharded`` onto a one-device JAX mesh: the
  global leaves every other restore is held to, bit for bit;
- restored by the port's onto a ``(2, 2)`` mesh of 4 gloo ranks (the
  whole checkpoint), saved there sharded, and that sharded checkpoint
  restored onto a ``(4, 1)`` mesh and into one process (a plain tree and
  through a ``ShardGroup``);
- each rank reads only the saved shards that overlap its own region;
- a checkpoint in the sharded format without shard offsets restores into
  its own layout and refuses another one.

``launch/train.py --production-mesh`` resumes a ``(2, 2)`` run's step-4
checkpoint on a world of 2 (a ``(1, 2)`` mesh): its first step's loss,
which reads only the restored parameters, equals the unrestarted run's
within 1e-5 relative (the mesh test's loss tolerance), the next within
1e-3.  The smoke config computes in bf16, so the model axis is
kept at 2: a different model axis rounds other partial products to bf16
(3.3e-4 relative at step 0 between ``(2, 2)`` and one process), and the
data axis changes only which rank computes a row.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_jaxref  # noqa: F401  (the JAX package, importable)

from repro_torch.checkpoint import CheckpointManager, restore_resharded
from repro_torch.distributed import ShardGroup
from repro_torch.launch.world import run_world
from repro_torch.optim.adamw import AdamWState

SPECS = {"params": {"w": ("data", "model"), "v": ("model",),
                    "b": (None, ("data", "model")), "r": None},
         "opt_state": AdamWState(step=(), mu={"w": ("data", "model")},
                                 nu={"w": (None, "model")})}


def _tree(seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"params": {"w": f(8, 12), "v": f(12), "b": f(3, 8),
                       "r": f(5)},
            "opt_state": AdamWState(step=np.array(3, np.int32),
                                    mu={"w": f(8, 12)}, nu={"w": f(8, 12)})}


def tree_leaves(tree):
    """The leaves: dicts by sorted key, AdamWState by field."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, AdamWState):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _flat(tree):
    return [np.asarray(x) for x in tree_leaves(tree)]


def _torch_tree(tree):
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, AdamWState):
            return AdamWState(*(walk(v) for v in x))
        return torch.as_tensor(x)
    return walk(tree)


def _full(tree):
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, AdamWState):
            return AdamWState(*(walk(v) for v in x))
        return x.full_tensor().numpy()
    return walk(tree)


def _jax_global(path):
    """JAX's ``restore_resharded`` of the whole checkpoint at ``path`` onto
    a one-device mesh, as numpy leaves."""
    import jax
    from jax.sharding import Mesh, PartitionSpec
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.checkpoint.manager import restore_resharded as jrestore

    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))

    def spec(x):
        if isinstance(x, dict):
            return {k: spec(v) for k, v in x.items()}
        if isinstance(x, AdamWState):
            return AdamWState(*(spec(v) for v in x))
        return PartitionSpec() if x is None else PartitionSpec(*x)

    like = _tree(1)
    like = {"params": like["params"],
            "opt_state": dict(like["opt_state"]._asdict())}
    specs = {"params": spec(SPECS["params"]),
             "opt_state": dict(spec(SPECS["opt_state"])._asdict())}
    step, got = jrestore(JManager(path), like, mesh, specs)
    return step, got


def _reads(monkeypatch_target):
    """Record each ``_read`` of a manager: (rank of the file, leaves)."""
    log = []
    orig = CheckpointManager._read

    def spy(self, step, rank, verify, names):
        log.append((rank, tuple(names)))
        return orig(self, step, rank, verify, names)

    monkeypatch_target._read = spy
    return log


def _reshard_rank(group, root):
    """On a world of 4: the whole checkpoint onto a (2, 2) mesh, saved
    sharded at step 5, that checkpoint onto a (4, 1) mesh.  Returns each
    restore's global leaves and this rank's file reads of the (4, 1)
    restore."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                             "model"))
    like = _torch_tree(_tree(1))
    _, on22 = restore_resharded(CheckpointManager(f"{root}/whole"), like,
                                mesh22, SPECS)
    _, replicated = restore_resharded(CheckpointManager(f"{root}/whole"),
                                      like, mesh22)
    out = {"22": _full(on22),
           "22_local": [tuple(x.to_local().shape)
                        for x in tree_leaves(on22)],
           "22_replicated": _full(replicated),
           "22_replicated_placements": {str(x.placements)
                                        for x in tree_leaves(replicated)}}
    mgr = CheckpointManager(f"{root}/sharded", sharded=True)
    mgr.save_tree(5, on22)
    mesh41 = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data",
                                                             "model"))

    class Spy(CheckpointManager):
        pass

    log = _reads(Spy)
    step, on41 = restore_resharded(Spy(f"{root}/sharded", sharded=True),
                                   like, mesh41, SPECS)
    out.update({"41": _full(on41), "step": step, "reads": log,
                "41_placements": [str(x.placements)
                                  for x in tree_leaves(on41)]})
    return out


@pytest.fixture(scope="module")
def resharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    CheckpointManager(root / "whole").save_tree(2, _tree(0))
    out = run_world(_reshard_rank, 4, device="cpu", timeout=300,
                    init=(root / "rdv").as_uri(), args=(str(root),))
    return root, out


def test_whole_checkpoint_onto_a_mesh_equals_jax(resharded):
    root, out = resharded
    step, jgot = _jax_global(root / "whole")
    assert step == 2
    want = _flat(_tree(0))
    jflat = [np.asarray(x) for x in (
        jgot["opt_state"]["step"], jgot["opt_state"]["mu"]["w"],
        jgot["opt_state"]["nu"]["w"], jgot["params"]["b"],
        jgot["params"]["r"], jgot["params"]["v"], jgot["params"]["w"])]
    for a, b in zip(jflat, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for got in (o["22"] for o in out):
        for a, b in zip(_flat(got), jflat):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    # (2, 2): w [8, 12] -> 4 x 6; v -> 6; b's last dim over both -> 2
    assert out[0]["22_local"] == [(), (4, 6), (8, 6), (3, 2), (5,), (6,),
                                  (4, 6)]


def test_default_spec_tree_replicates_every_leaf(resharded):
    _, out = resharded
    for o in out:
        assert o["22_replicated_placements"] == {"(Replicate(), Replicate())"}
        for a, b in zip(_flat(o["22_replicated"]), _flat(_tree(0))):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_sharded_checkpoint_onto_another_mesh(resharded):
    root, out = resharded
    want = _flat(_tree(0))
    files = sorted(p.name for p in (root / "sharded").glob("*.npz"))
    assert files == [f"step_00000005.rank{r:05d}.npz" for r in range(4)]
    man = json.loads((root / "sharded" / "step_00000005.rank00003.json")
                     .read_text())
    assert man["world"] == 4
    assert man["shards"]["params/w"]["offset"] == [4, 6]
    for o in out:
        assert o["step"] == 5
        for a, b in zip(_flat(o["41"]), want):
            assert np.array_equal(a, b)
    assert out[1]["41_placements"][6] == "(Shard(dim=0), Shard(dim=1))"
    # rank r of (4, 1) holds rows 2r, 2r + 1 of w: the (2, 2) shards of
    # rows 0-3 (ranks 0, 1) or 4-7 (ranks 2, 3), never the others
    for r, o in enumerate(out):
        w_from = sorted(rank for rank, names in o["reads"]
                        if "params/w" in names)
        assert w_from == ([0, 1] if r < 2 else [2, 3]), (r, o["reads"])


@pytest.mark.parametrize("via", ["plain", "group"])
def test_sharded_checkpoint_into_one_process(resharded, via):
    root, _ = resharded
    mgr = CheckpointManager(root / "sharded")
    assert mgr.latest_step() == 5
    like = _torch_tree(_tree(1))
    if via == "plain":
        step, got = mgr.restore_tree(like)
    else:
        step, got = restore_resharded(mgr, like, ShardGroup(None, "cpu"))
    assert step == 5
    for a, b in zip(tree_leaves(got), _flat(_tree(0))):
        assert isinstance(a, torch.Tensor)
        assert np.array_equal(a.numpy(), b)


def _legacy_rank(group, root, mesh_shape):
    """Restore the offset-less copy of the sharded checkpoint onto
    ``mesh_shape``; returns the global leaves or the error's text."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", mesh_shape, mesh_dim_names=("data",
                                                              "model"))
    try:
        _, got = restore_resharded(
            CheckpointManager(f"{root}/legacy", sharded=True),
            _torch_tree(_tree(1)), mesh, SPECS)
    except ValueError as exc:
        return str(exc)
    return _full(got)


def test_offsetless_checkpoint_restores_only_its_layout(resharded):
    root, _ = resharded
    legacy = root / "legacy"
    shutil.copytree(root / "sharded", legacy)
    for man in legacy.glob("*.json"):
        rec = json.loads(man.read_text())
        del rec["shards"], rec["world"]
        man.write_text(json.dumps(rec))
    same = run_world(_legacy_rank, 4, device="cpu", timeout=300,
                     init=(root / "rdv_same").as_uri(),
                     args=(str(root), (2, 2)))
    for got in same:
        for a, b in zip(_flat(got), _flat(_tree(0))):
            assert np.array_equal(a, b)
    other = run_world(_legacy_rank, 4, device="cpu", timeout=300,
                      init=(root / "rdv_other").as_uri(),
                      args=(str(root), (4, 1)))
    assert all(isinstance(e, str) and "layout that saved it" in e
               for e in other), other


def _train_rank(group, ckpt_dir, steps, data):
    """``train --production-mesh`` with the production mesh replaced by a
    ``(data, world / data)`` one; returns the losses of the steps it ran."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T

    world = torch.distributed.get_world_size()
    M.make_production_mesh = lambda device="cuda", **_: M.make_local_mesh(
        data, world // data, device=device)
    rep = T.train(T.build_parser().parse_args([
        "--arch", "tinyllama-1.1b", "--smoke", "--production-mesh",
        "--device", "cpu", "--steps", str(steps), "--batch", "4", "--seq",
        "16", "--ckpt-every", "2", "--ckpt-dir", ckpt_dir]))
    return {"losses": rep["losses"], "final_step": rep["final_step"]}


def test_production_mesh_run_resumes_on_another_world(tmp_path):
    ckpt = tmp_path / "ckpt"
    full = run_world(_train_rank, 4, device="cpu", timeout=300,
                     init=(tmp_path / "rdv4").as_uri(),
                     args=(str(ckpt), 6, 2))[0]
    assert len(full["losses"]) == 6
    for f in ckpt.glob("step_00000006.*"):        # resume from step 4
        f.unlink()
    resumed = run_world(_train_rank, 2, device="cpu", timeout=300,
                        init=(tmp_path / "rdv2").as_uri(),
                        args=(str(ckpt), 6, 1))[0]
    assert resumed["final_step"] == 6 and len(resumed["losses"]) == 2
    # step 4's loss reads only the restored parameters; step 5's reads
    # the update from bf16 gradients reduced over another data axis, which
    # AdamW's first steps scale to about lr whatever their size
    np.testing.assert_allclose(resumed["losses"][0], full["losses"][4],
                               rtol=1e-5)
    np.testing.assert_allclose(resumed["losses"][1], full["losses"][5],
                               rtol=1e-3)
    assert sorted(p.name for p in ckpt.glob("step_00000006.*.npz")) == [
        "step_00000006.rank00000.npz", "step_00000006.rank00001.npz"]
    with open(ckpt / "step_00000006.rank00000.json") as f:
        assert json.load(f)["world"] == 2


def test_mesh_selftest_resume_onto_other_layouts(tmp_path):
    """``launch/mesh_selftest.py --resume`` over a ``(2, 2)`` mesh of 4
    gloo ranks (tinyllama's smoke config, bf16 compute): the step's
    sharded checkpoint restored onto ``(4, 1)`` and onto rank 0 alone,
    every leaf bit for bit, each next step's loss bit for bit the same
    layout's step from the saved state and within ``RESUME_TOL`` of the
    next step on ``(2, 2)``."""
    from repro_torch.launch import mesh_selftest

    res = run_world(mesh_selftest.rank_main, 4, device="cpu", timeout=300,
                    init=(tmp_path / "rdv").as_uri(),
                    args=("tinyllama-1.1b", True, None, 4, 32, 2, False,
                          str(tmp_path / "ckpt")))[0]["resume"]
    assert sorted(res) == ["(4, 1)", "one device"]
    for r in res.values():
        assert r["equal"] == r["leaves"] > 0 and r["same_loss"], r
    assert mesh_selftest.resume_ok(res), res
