"""The production-mesh tools of the port (``launch/{mesh,sharding,dryrun,
calculator,collectives}.py``, the models' sharding hints, the
``REPRO_OPTS`` flags and the flash custom op) against the JAX package, on
the CPU.

JAX's specs are computed on ``jax.sharding.AbstractMesh`` (no devices);
the port's on the same axis sizes, and on fake process groups of 256 and
512 ranks (``dryrun.fake_world``, made and destroyed inside each test).
Specs, shard shapes, byte sums, the calculator's terms and the skips must
be equal.  Numerical tolerances:

- a real gloo world of 4 ranks as a ``(2, 2)`` mesh against one process
  (the port) and against JAX's jitted step, f32 compute, with the LM
  tests' training tolerances: the loss within 1e-5 relative, each
  gradient (AdamW's first moment after one step) within 1e-4 of its
  leaf's largest; the updated parameters within 1e-4 of the leaf's
  largest gradient (lr = eps = 1e-3: a first update ``-lr·g/(|g| +
  eps)`` moves by at most the gradient's difference), the prefill's
  logits within 1e-4 (the mesh sums its products in other orders);
- each ``REPRO_OPTS`` flag against JAX with the same flag: the loss within
  1e-5 relative and the gradients within 1e-4 of each leaf's largest (the
  f32 tolerances of ``test_torch_train.py``), bf16 accumulation within
  2e-2 of the largest; ``bf16_stack`` (bf16 compute) the loss within
  2e-2 absolute (``test_torch_train.py``'s bf16 tolerance) and its
  gradients bit for bit the port's without the flag;
- the flash custom op on the CPU: bit for bit its plain version.
"""
import contextlib
import dataclasses
import importlib
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_jaxref  # noqa: F401  (the JAX package, importable)

from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.launch import calculator as tcalc
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import mesh_selftest
from repro_torch.launch import sharding as tshd
from repro_torch.launch.collectives import LocalCounter
from repro_torch.launch.world import run_world
from repro_torch.models import api as tapi
from repro_torch.models.common import ArchConfig
from repro_torch.optim.adamw import AdamW, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = tconfigs.all_ids()
SHAPES = list(tapi.SHAPES)
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _abstract(mesh_name):
    from jax.sharding import AbstractMesh
    sizes = MESHES[mesh_name]
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _jcfg(arch):
    from repro import configs as jconfigs
    return jconfigs.get(arch)


def port_cfg(jcfg, **kw):
    return ArchConfig(**dict(dataclasses.asdict(jcfg), **kw))


def _jspec(p):
    return tuple(p)


def _leaves(tree, prefix=""):
    """``{path: leaf}`` of a nested dict (JAX or port)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _jax_dryrun():
    """``repro.launch.dryrun`` without its import-time ``XLA_FLAGS``."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


@contextlib.contextmanager
def _opts(monkeypatch, flags):
    monkeypatch.setenv("REPRO_OPTS", flags)
    yield


# -- meshes ------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True])
def test_production_meshes_on_fake_worlds(multi):
    world = 512 if multi else 256
    with tdry.fake_world(world):
        mesh = tmesh.make_production_mesh(multi_pod=multi, device="cpu")
        want = MESHES["multi" if multi else "single"]
        assert tuple(mesh.mesh_dim_names) == tuple(want)
        assert tuple(mesh.mesh.shape) == tuple(want.values())
        assert tmesh.data_axes(mesh) == (("pod", "data") if multi
                                         else ("data",))
        assert tshd.axis_sizes(mesh) == want
        # the other production mesh names this world's size
        with pytest.raises(ValueError, match=f"the world has {world}"):
            tmesh.make_production_mesh(multi_pod=not multi, device="cpu")
        local = tmesh.make_local_mesh(world // 16, 16, device="cpu")
        assert tmesh.data_axes(local) == ("data",)


def test_meshes_name_the_world_without_a_group():
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks; the world has 1"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_local_mesh(2, 2, device="cpu")


# -- parameter, batch and cache specs ----------------------------------------

@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh_name):
    """Every leaf of the full config's parameters (the port's from ``meta``
    tensors) and of AdamW's moments: the port's spec equals JAX's, its
    shard shape equals JAX's ``shard_shape``, and the per-rank argument
    bytes (parameters and both moments) equal the sum from JAX's specs."""
    import jax
    from jax.sharding import NamedSharding
    from repro.launch import sharding as jshd
    from repro.models import api as japi
    from repro.optim.adamw import AdamW as JAdamW

    amesh, sizes = _abstract(mesh_name), MESHES[mesh_name]
    jcfg = _jcfg(arch)
    jshape = japi.build(jcfg).params_shape()
    jopt = jax.eval_shape(JAdamW().init, jshape)
    tmodel = tapi.build(tconfigs.get(arch), "meta", serve=False)
    tshape = tmodel.params_shape()
    topt = AdamW().init(tshape)
    got_bytes = want_bytes = 0
    for jtree, ttree in ((jshape, tshape), (jopt.mu, topt.mu),
                         (jopt.nu, topt.nu)):
        jspecs = _leaves(jshd.param_specs(jtree, amesh))
        tspecs = _leaves(tshd.param_specs(ttree, sizes))
        jl, tl = _leaves(jtree), _leaves(ttree)
        assert sorted(jspecs) == sorted(tspecs) == sorted(tl)
        for path, jspec in jspecs.items():
            assert tspecs[path] == _jspec(jspec), path
            shape = tuple(tl[path].shape)
            assert shape == tuple(jl[path].shape), path
            jlocal = NamedSharding(amesh, jspec).shard_shape(shape)
            assert tshd.local_shape(shape, tspecs[path], sizes) == jlocal
            want_bytes += math.prod(jlocal) * jl[path].dtype.itemsize
            got_bytes += math.prod(tshd.local_shape(
                shape, tspecs[path], sizes)) * tl[path].element_size()
    assert got_bytes == want_bytes


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_placements_give_jax_shard_shapes(mesh_name):
    """On the fake production mesh: DTensor's local shape for each spec's
    placements (a dim over ``("pod", "data")`` sharded on both, in mesh
    order) equals JAX's shard shape, for every leaf of deepseek-67b and
    qwen3-moe-235b-a22b (the multi-pod specs shard dims over two axes)."""
    from jax.sharding import NamedSharding
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from jax.sharding import PartitionSpec

    amesh, sizes = _abstract(mesh_name), MESHES[mesh_name]
    seen_pair = False
    with tdry.fake_world(math.prod(sizes.values())):
        mesh = tmesh.make_production_mesh(multi_pod=mesh_name == "multi",
                                          device="cpu")
        for arch in ("deepseek-67b", "qwen3-moe-235b-a22b"):
            tree = tapi.build(tconfigs.get(arch), "meta",
                              serve=False).params_shape()
            shapes = _leaves(tree)
            for path, spec in _leaves(tshd.param_specs(tree, mesh)).items():
                shape = tuple(shapes[path].shape)
                seen_pair |= any(isinstance(e, tuple) for e in spec)
                got, _ = compute_local_shape_and_global_offset(
                    shape, mesh, tshd.placements(spec, mesh))
                want = NamedSharding(amesh, PartitionSpec(*spec))
                assert tuple(got) == want.shard_shape(shape), path
    assert seen_pair == (mesh_name == "multi")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh_name, monkeypatch):
    """``batch_specs`` of every shape's inputs, and the decode shapes'
    ``_cache_specs`` with and without ``cache_seq_shard``, equal JAX's."""
    from repro.launch import sharding as jshd
    from repro.models import api as japi

    jdry = _jax_dryrun()
    amesh, sizes = _abstract(mesh_name), MESHES[mesh_name]
    jcfg, tcfg = _jcfg(arch), tconfigs.get(arch)
    for name in SHAPES:
        jin = japi.input_specs(jcfg, japi.SHAPES[name])
        tin = tapi.input_specs(tcfg, tapi.SHAPES[name])
        if tapi.SHAPES[name].kind != "decode":
            jb = _leaves(jshd.batch_specs(jin, amesh))
            tb = _leaves(tshd.batch_specs(tin, sizes))
            assert {k: _jspec(v) for k, v in jb.items()} == tb
            continue
        jtok = jshd.batch_specs({"t": jin["tokens"]}, amesh)["t"]
        assert tshd.batch_specs({"t": tin["tokens"]}, sizes)["t"] \
            == _jspec(jtok)
        for flags in ("", "cache_seq_shard"):
            monkeypatch.setenv("REPRO_OPTS", flags)
            want = {k: _jspec(v) for k, v in _leaves(
                jdry._cache_specs(jin["cache"], amesh)).items()}
            assert _leaves(tdry._cache_specs(tin["cache"], sizes)) == want


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_input_specs_match_jax(arch, shape):
    """``tokens [B]`` and the cache tree, leaf by leaf, as
    ``jax.eval_shape`` gives them (the cache's ``len`` an int32 scalar);
    built on the ``meta`` device (long_500k's 524,288 slots allocate
    nothing)."""
    from repro.models import api as japi

    want = _leaves(japi.input_specs(_jcfg(arch), japi.SHAPES[shape]))
    got = _leaves(tapi.input_specs(tconfigs.get(arch), tapi.SHAPES[shape]))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(w.dtype), path


def test_decode_synth_batch_matches_jax():
    """A small decode batch: the same numpy draws, cache before tokens."""
    from repro.models import api as japi

    jcfg = _jcfg("zamba2-2.7b").reduced()
    shape = ("t", "decode", 8, 2)
    want = _leaves(japi.synth_batch(jcfg, japi.ShapeSpec(*shape), seed=3))
    got = _leaves(tapi.synth_batch(port_cfg(jcfg), tapi.ShapeSpec(*shape),
                                   seed=3, device="cpu"))
    assert sorted(want) == sorted(got)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].float().numpy(),
                                      np.asarray(w, np.float32))


NAME_CALLS = [(("batch", None, "heads"), (32, 7, 2048)),
              (("batch", None, "heads"), (1, 7, 256)),
              (("batch", None, "ffn"), (64, 3, 5632)),
              (("batch", None, "ffn"), (48, 3, 22016)),
              (("batch", "seq", None), (256, 4096, 2048)),
              (("batch", "seq", None), (1, 4096, 2048)),
              (("batch", "seq", None), (32, 100, 64)),
              (("batch", None, "vocab"), (32, 1, 32000)),
              (("batch", None, "vocab"), (32, 1, 256206)),
              (("expert_cap", "experts", None, None), (16, 64, 40, 2048)),
              (("expert_cap", "experts", None, None), (1, 128, 8, 4096)),
              (("expert_cap", "experts", None, None), (32, 8, 8, 64))]


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_constrain_resolves_like_jax(mesh_name, seq_sharded, monkeypatch):
    """Every logical-name call of the models: the spec the port's
    ``constrain`` resolves equals the one JAX's hands to
    ``with_sharding_constraint``."""
    import jax
    from repro.launch import sharding as jshd

    amesh, sizes = _abstract(mesh_name), MESHES[mesh_name]
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s.spec)
    with jshd.activation_rules(amesh, seq_sharded=seq_sharded):
        want = [tuple(jshd.constrain(jax.ShapeDtypeStruct(shape, "float32"),
                                     names)) for names, shape in NAME_CALLS]
    with tshd.activation_rules(sizes, seq_sharded=seq_sharded):
        got = [tshd.resolve(shape, names) for names, shape in NAME_CALLS]
        assert tshd.data_shard_count() == math.prod(
            v for k, v in sizes.items() if k != "model")
    assert got == want
    assert tshd.data_shard_count() == 1


def test_constrain_outside_rules_is_the_argument():
    x = torch.zeros(2, 3)
    assert tshd.constrain(x, ("batch", None)) is x
    with tshd.activation_rules({"data": 2, "model": 2}):
        assert tshd.constrain(x, ("batch", None)) is x   # a plain tensor


def test_constrain_redistributes_a_dtensor():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with tdry.fake_world(256):
        mesh = tmesh.make_production_mesh(device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = distribute_tensor(torch.empty(32, 64, 2048), mesh,
                                  [Replicate(), Replicate()])
            assert tshd.constrain(x, ("batch", None, "ffn")) is x
            with tshd.activation_rules(mesh):
                y = tshd.constrain(x, ("batch", None, "ffn"))
                assert tuple(y.placements) == (Shard(0), Shard(2))
                assert tshd.constrain(y, ("batch", None, "ffn")) is y
                assert tuple(y.to_local().shape) == (2, 64, 128)


# -- the calculator ----------------------------------------------------------

@pytest.mark.parametrize("chips", [256, 512])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_calculator_matches_jax(arch, shape, chips):
    """The same formulas: flops, HBM, ICI and model flops equal
    ``benchmarks/calculator.py``'s (only the rates differ)."""
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmarks import calculator as jcalc
    from repro.models import api as japi

    want = jcalc.analyze(_jcfg(arch), japi.SHAPES[shape], chips)
    got = tcalc.analyze(tconfigs.get(arch), tapi.SHAPES[shape], chips)
    for k in ("flops", "hbm_bytes", "ici_bytes", "model_flops"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-12)
    assert got.compute_s == got.flops / tcalc.PEAK_FLOPS
    assert got.memory_s == got.hbm_bytes / tcalc.HBM_BW
    assert got.collective_s == got.ici_bytes / tcalc.LINK_BW
    measured = tcalc.analyze(tconfigs.get(arch), tapi.SHAPES[shape], chips,
                             ici_bytes_measured=3.0e12)
    assert measured.ici_bytes == 3.0e12 / chips


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_jax(arch):
    import sys
    sys.path.insert(0, str(ROOT))
    from benchmarks import calculator as jcalc

    assert tcalc.count_params(tconfigs.get(arch)) == jcalc.count_params(
        _jcfg(arch))


# -- the counter -------------------------------------------------------------

def test_counter_counts_local_products_and_collectives():
    """On a fake ``(4, 2)`` mesh: a product counts its local shards' flops
    (not the global op's), and each redistribution its collective's
    operand bytes by JAX's rule, worked out by hand."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)

    with tdry.fake_world(8):
        mesh = tmesh.make_local_mesh(4, 2, device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            x = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(32, 48), mesh,
                                  [Replicate(), Shard(1)])
            with LocalCounter() as c:
                y = x @ w                              # [16, 24] a rank
            assert c.matmul_flops == 2 * 16 * 32 * 24
            assert c.summary()["collective_bytes"]["total"] == 0
            with LocalCounter() as c:                  # all-gather on data
                x.redistribute(mesh, [Replicate(), Replicate()])
            assert c.collectives["all-gather"] == 16 * 32 * 4
            p = torch.distributed.tensor.DTensor.from_local(
                torch.empty(16, 24), mesh, [Shard(0), Partial()],
                run_check=False)
            with LocalCounter() as c:                  # all-reduce on model
                p.redistribute(mesh, [Shard(0), Replicate()])
            assert c.collectives["all-reduce"] == 16 * 24 * 4
            with LocalCounter() as c:                  # reduce-scatter
                p.redistribute(mesh, [Shard(0), Shard(1)])
            assert c.collectives["reduce-scatter"] == 16 * 24 * 4
            from torch.distributed import _functional_collectives as funcol
            with LocalCounter() as c:
                out = funcol.all_to_all_single(torch.empty(8, 6), None, None,
                                               torch.distributed.group.WORLD)
                funcol.wait_tensor(out)
            assert c.collectives["all-to-all"] == 8 * 6 * 4
            assert c.calls["all-to-all"] == 1
            del y


def test_counter_tracks_live_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        arg = torch.empty(1000)
        with LocalCounter() as c:
            a = torch.ones(100)                 # 400 bytes
            b = a.view(10, 10)                  # same storage
            arg.add_(1.0)                       # the argument's storage
            d = torch.ones(50)
            del a, b
            e = torch.ones(300)                 # 1200, after a's 400 died
        assert c.peak == 200 + 1200 and c.live == 200 + 1200
        del d, e
    assert c.live == 0


# -- a real (2, 2) mesh over gloo --------------------------------------------

# (arch, REPRO_OPTS, MoE capacity factor)
CASES = {"dense": ("tinyllama-1.1b", "", 4.0),
         "moe": ("olmoe-1b-7b", "moe_local", 4.0),
         "moe_drop": ("olmoe-1b-7b", "moe_local", 0.5),
         "ssm": ("xlstm-125m", "", 4.0),
         "hybrid": ("zamba2-2.7b", "", 4.0)}


def _mesh_rank(group, arch, overrides):
    from repro_torch.launch import mesh as M
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **overrides)
    mesh = M.make_local_mesh(2, 2, device="cpu")
    got = mesh_selftest.mesh_case(cfg, group.device, 4, 16, mesh)
    if torch.distributed.get_rank():
        return None
    return got


@pytest.mark.parametrize("family", list(CASES))
def test_gloo_mesh_matches_one_device_and_jax(family, monkeypatch, tmp_path):
    """The train step (one AdamW step) and the prefill of the family's smoke
    config on a ``(2, 2)`` mesh of 4 gloo ranks against the port in one
    process and JAX's jitted step (f32 compute).  The MoE cases run with
    ``moe_local``: each of the mesh's 2 data shards routes its own rows
    against its own capacity, held against one process and JAX with
    ``data_shard_count`` 2; at capacity factor 0.5 choices overflow, so a
    wrong per-shard capacity or split of the rows shows."""
    import jax
    import repro.launch.sharding as jshd
    from repro.models import api as japi
    from repro.optim import adamw as jadamw

    arch, flags, capacity = CASES[family]
    monkeypatch.setenv("REPRO_OPTS", flags)
    overrides = dict(compute_dtype="float32", moe_capacity_factor=capacity)
    got = run_world(_mesh_rank, 4, device="cpu", timeout=300,
                    init=(tmp_path / "rdv").as_uri(),
                    args=(arch, overrides))[0]
    if flags == "moe_local":             # the mesh's data shards, here
        monkeypatch.setattr(tshd, "data_shard_count", lambda: 2)
        monkeypatch.setattr(jshd, "data_shard_count", lambda: 2)
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), **overrides)
    plain = mesh_selftest.mesh_case(cfg, torch.device("cpu"), 4, 16)
    diff = mesh_selftest.compare({"mesh": got, "plain": plain})
    assert diff["loss"] <= 1e-5 and diff["logits"] <= 1e-4, diff
    assert diff["grads"] <= 1e-4 and diff["params"] <= 1e-4, diff
    # JAX's step on the same parameters and batch
    from repro import configs as jconfigs
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), **overrides)
    tm = tapi.build(cfg, "cpu", serve=False)
    tp = tm.init_params(torch.Generator().manual_seed(0))
    jp = _np_tree(tp)
    batch = japi.synth_batch(jcfg, japi.ShapeSpec("t", "train", 16, 4),
                             seed=1)
    jopt = jadamw.AdamW(learning_rate=mesh_selftest.EPS, warmup_steps=1,
                        eps=mesh_selftest.EPS)
    jnew, jstate, jmet = jax.jit(japi.make_train_step(japi.build(jcfg),
                                                      jopt))(
        jp, jopt.init(jp), batch)
    jres = {"loss": np.asarray(jmet["loss"]),
            "params": [np.asarray(w, np.float32)
                       for w in jax.tree.leaves(jnew)],
            "mu": [np.asarray(m, np.float32)
                   for m in jax.tree.leaves(jstate.mu)]}
    diff = mesh_selftest.compare({"mesh": got, "plain": jres})
    assert diff["loss"] <= 1e-5, diff
    assert diff["grads"] <= 1e-4 and diff["params"] <= 1e-4, diff


def _train_rank(group, ckpt_dir):
    """``train --production-mesh`` on this rank with the production mesh
    replaced by a ``(2, 2)`` one (the world has 4 ranks, not 256): six
    steps, a checkpoint every two, once clean and once with a failure
    before step 3 (restored from step 2).  Then the clean run's last
    checkpoint restored into its layout.  Rank 0 returns each run's
    losses and final parameters, the restored leaves that equal the saved
    ones, and the bytes the last checkpoint holds against its tree's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import mesh as M
    from repro_torch.launch import train as T

    M.make_production_mesh = lambda device="cuda", **_: M.make_local_mesh(
        2, 2, device=device)
    out = {}
    for run, fail in (("clean", []), ("failed", ["--fail-at", "3"])):
        rep = T.train(T.build_parser().parse_args([
            "--arch", "tinyllama-1.1b", "--smoke", "--production-mesh",
            "--device", "cpu", "--steps", "6", "--batch", "4", "--seq",
            "16", "--ckpt-every", "2", "--deterministic",
            "--ckpt-dir", f"{ckpt_dir}/{run}"] + fail))
        out[run] = {"losses": rep["losses"], "failures": rep["failures"],
                    "params": [p.full_tensor().numpy() for p in
                               tree_leaves(rep["state"]["params"])]}
    state = rep["state"]
    step, got = CheckpointManager(f"{ckpt_dir}/failed",
                                  sharded=True).restore_tree(state)
    def leaves(st):
        opt = st["opt_state"]
        return (tree_leaves(st["params"]) + [opt.step]
                + tree_leaves(opt.mu) + tree_leaves(opt.nu))

    saved, restored = leaves(state), leaves(got)
    out["equal"] = sum(
        int(type(a) is type(b) and torch.equal(a.to_local(), b.to_local())
            and a.placements == b.placements and a.shape == b.shape)
        if hasattr(a, "placements") else int(torch.equal(a, b))
        for a, b in zip(saved, restored))
    out["leaves"] = len(saved)
    out["step"] = step
    if torch.distributed.get_rank():
        return None
    files = sorted(Path(ckpt_dir, "failed").glob(f"step_{step:08d}.*.npz"))
    out["files"] = [f.name for f in files]
    out["saved_bytes"] = 0
    for f in files:
        with np.load(f) as data:
            out["saved_bytes"] += sum(data[k].nbytes for k in data.files)
    out["tree_bytes"] = sum(math.prod(x.shape) * x.element_size()
                            for x in saved)
    return out


def test_gloo_mesh_train_checkpoints_restore_and_step(tmp_path):
    """``train --production-mesh`` over a ``(2, 2)`` mesh of 4 gloo ranks
    keeps one sharded checkpoint a step: each shard written once (the
    files hold exactly the tree's bytes, not a copy a rank), restored
    into its layout bit for bit, and a run that fails before step 3
    restores step 2 and ends with the clean run's losses and parameters
    bit for bit (gloo on the CPU is deterministic)."""
    out = run_world(_train_rank, 4, device="cpu", timeout=300,
                    init=(tmp_path / "rdv").as_uri(),
                    args=(str(tmp_path / "ckpt"),))[0]
    assert out["step"] == 6 and out["equal"] == out["leaves"], out["equal"]
    assert out["files"] == [f"step_00000006.rank{r:05d}.npz"
                            for r in range(4)]
    assert out["saved_bytes"] == out["tree_bytes"]
    clean, failed = out["clean"], out["failed"]
    assert clean["failures"] == 0 and failed["failures"] == 1
    assert failed["losses"] == clean["losses"]
    assert len(clean["losses"]) == 6
    for a, b in zip(failed["params"], clean["params"]):
        assert np.array_equal(a, b)


# -- REPRO_OPTS ---------------------------------------------------------------

@pytest.mark.parametrize("flag", ["bf16_stack", "remat_dots", "grad_bf16",
                                  "seq_shard", "moe_local"])
def test_opts_flags_match_jax(flag, monkeypatch):
    """One train step's loss and gradients (through ``make_train_step``'s
    accumulator) with the flag set in both packages.  ``moe_local`` with
    two data shards (``data_shard_count`` 2 in both), on the MoE model at
    a capacity factor that drops choices: each shard's own capacity."""
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi
    from repro_torch import convert

    monkeypatch.setenv("REPRO_OPTS", flag)
    arch = "olmoe-1b-7b" if flag == "moe_local" else "tinyllama-1.1b"
    dtype = "bfloat16" if flag == "bf16_stack" else "float32"
    jcfg = dataclasses.replace(_jcfg(arch).reduced(), compute_dtype=dtype,
                               moe_capacity_factor=0.5, microbatches=2)
    if flag == "moe_local":
        import repro.launch.sharding as jshd
        monkeypatch.setattr(jshd, "data_shard_count", lambda: 2)
        monkeypatch.setattr(tshd, "data_shard_count", lambda: 2)
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.key(3))
    tm = tapi.build(port_cfg(jcfg), "cpu", serve=False)
    tp = convert.train_params(jax.tree.map(np.asarray, jp), "cpu")
    batch = japi.synth_batch(jcfg, japi.ShapeSpec("t", "train", 16, 4),
                             seed=4)
    tb = tapi.synth_batch(tm.cfg, tapi.ShapeSpec("t", "train", 16, 4),
                          seed=4, device="cpu")

    def jgrads(params):
        def mb(i):
            return jax.tree.map(lambda x: x.reshape(2, 2, *x.shape[1:])[i],
                                batch)
        acc = jnp.bfloat16 if flag == "grad_bf16" else jnp.float32
        total, losses = None, []
        for i in range(2):
            loss, g = jax.value_and_grad(jm.loss)(params, mb(i))
            g = jax.tree.map(lambda a: a.astype(acc), g)
            total = g if total is None else jax.tree.map(
                lambda a, b: a + b, total, g)
            losses.append(float(loss))
        return jax.tree.map(lambda a: a / 2, total), losses

    want, wloss = jgrads(jp)
    got, gloss = tapi.accumulate_grads(tm, tp, tb, 2)
    if flag == "bf16_stack":
        # bf16 compute: the loss within test_torch_train.py's 2e-2; the
        # gradients bit for bit the port's without the flag (a slice of
        # the cast stack is the cast slice)
        np.testing.assert_allclose([float(x) for x in gloss], wloss,
                                   atol=2e-2)
        monkeypatch.setenv("REPRO_OPTS", "")
        plain, _ = tapi.accumulate_grads(tm, tp, tb, 2)
        for g, w in zip(tree_leaves(got), tree_leaves(plain)):
            assert torch.equal(g, w)
        return
    np.testing.assert_allclose([float(x) for x in gloss], wloss, rtol=1e-5)
    tol = 2e-2 if flag == "grad_bf16" else 1e-4
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        assert g.dtype == (torch.bfloat16 if flag == "grad_bf16"
                           else torch.float32)
        assert np.abs(g.float().numpy() - w).max() <= tol * max(
            np.abs(w).max(), 1e-30)


def test_moe_local_capacity_is_per_shard(monkeypatch):
    """With two data shards each half of the tokens routes against its
    own capacity: the routing equals routing each half alone."""
    from repro_torch.models import moe

    cfg = port_cfg(_jcfg("olmoe-1b-7b").reduced(), moe_capacity_factor=0.5)
    logits = torch.randn(64, cfg.moe_experts,
                         generator=torch.Generator().manual_seed(1))
    both = moe.route(logits, cfg, shards=2)
    for z in range(2):
        half = moe.route(logits[32 * z:32 * (z + 1)], cfg)
        assert both.capacity == half.capacity
        assert torch.equal(both.slot[32 * z:32 * (z + 1)], half.slot)
    monkeypatch.setenv("REPRO_OPTS", "moe_local")
    monkeypatch.setattr(tshd, "data_shard_count", lambda: 2)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    lp = {k: torch.randn(shape, generator=torch.Generator().manual_seed(3))
          * 0.1 for k, shape in moe.moe_layer_params(cfg).items()}
    whole = moe.moe_ffn(x, lp, cfg)
    monkeypatch.setenv("REPRO_OPTS", "")
    halves = torch.cat([moe.moe_ffn(x[i:i + 1], lp, cfg) for i in range(2)])
    torch.testing.assert_close(whole, halves, rtol=1e-6, atol=1e-6)


def test_donate_updates_in_place_bit_for_bit(monkeypatch):
    cfg = dataclasses.replace(tconfigs.get_smoke("tinyllama-1.1b"),
                              compute_dtype="float32")
    tm = tapi.build(cfg, "cpu", serve=False)
    batch = tapi.synth_batch(cfg, tapi.ShapeSpec("t", "train", 16, 4),
                             device="cpu")
    opt = AdamW(learning_rate=1e-2, warmup_steps=1)
    step = tapi.make_train_step(tm, opt)
    p0 = tm.init_params(torch.Generator().manual_seed(5))
    want, wstate, _ = step(p0, opt.init(p0), batch)
    monkeypatch.setenv("REPRO_OPTS", "donate")
    p1 = tm.init_params(torch.Generator().manual_seed(5))
    s1 = opt.init(p1)
    got, gstate, _ = step(p1, s1, batch)
    assert got is p1 and gstate.mu is s1.mu
    for a, b in zip(tree_leaves(got) + tree_leaves(gstate.nu),
                    tree_leaves(want) + tree_leaves(wstate.nu)):
        assert torch.equal(a, b)


# -- the dry run -------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [(a, s) for a, s in
                                        __import__("repro_torch.launch.dryrun",
                                                   fromlist=["x"]).all_cells()])
def test_should_skip_matches_jax(arch, shape):
    jdry = _jax_dryrun()
    if arch == "totem-rmat":
        assert (arch, shape) in jdry.all_cells()
        return
    assert tdry.should_skip(tconfigs.get(arch), shape) == jdry.should_skip(
        _jcfg(arch), shape)


def _artifact_checks(rec):
    """``tests/test_dryrun_artifacts.py``'s checks of a cell."""
    assert rec.get("ok"), rec.get("error", "")[-500:]
    ma = rec["memory_analysis"]
    assert ma["temp_bytes"] > 0
    assert rec["cost_analysis_raw"]["flops"] > 0
    if rec["arch"] != "totem-rmat":
        rf = rec["roofline"]
        assert rf["compute_s"] > 0 and rf["memory_s"] > 0
        assert rf["dominant"] in ("compute", "memory", "collective")


SMOKE_CELLS = [(a, k) for a in ("tinyllama-1.1b", "olmoe-1b-7b",
                                "xlstm-125m", "zamba2-2.7b",
                                "seamless-m4t-large-v2", "internvl2-26b")
               for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("arch,kind", SMOKE_CELLS)
def test_run_cell_on_a_small_fake_mesh(arch, kind):
    """Smoke configs on a fake ``(2, 2)`` mesh: JAX's record keys and the
    artifact checks; a deep stack's extrapolation from two depths equals
    the whole trace's flops and collective bytes."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), microbatches=2)
    if kind != "decode" and cfg.family != "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=4 * tdry.period(cfg))
    shape = tapi.ShapeSpec(f"{kind}_t", kind, 32, 4)
    rec = tdry.run_cell(arch, shape.name, "single", "cpu", cfg=cfg,
                        shape=shape, mesh_shape=(2, 2))
    _artifact_checks(rec)
    for key in ("arch", "shape", "mesh", "ok", "opts", "chips", "trace_s",
                "memory_analysis", "cost_analysis_raw", "collective_bytes",
                "collective_by_depth", "depth_multipliers", "roofline",
                "total_s"):
        assert key in rec, key
    assert set(rec["memory_analysis"]) >= {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_estimate_gib"}
    assert rec["chips"] == 4
    if kind == "decode":
        assert rec["memory_analysis"]["alias_bytes"] > 0   # the cache
    if cfg.family == "ssm" and kind == "prefill":
        assert rec["replayed_steps"] == 32
    if len(rec["traced_depths"]) > 1:
        whole = tdry.run_cell(arch, shape.name, "single", "cpu", cfg=cfg,
                              shape=shape, mesh_shape=(2, 2), whole=True)
        # a train step's microbatch is traced once and counted for each
        # (its accumulator's fill and division with it): within 2e-2
        rel = 1e-9 if kind != "train" else 2e-2
        for k in ("flops", "matmul_flops"):
            assert rec["cost_analysis_raw"][k] == pytest.approx(
                whole["cost_analysis_raw"][k], rel=rel), k
        for k, v in whole["collective_bytes"].items():
            assert rec["collective_bytes"][k] == pytest.approx(
                v, rel=rel, abs=1.0), k
        assert rec["memory_analysis"]["argument_bytes"] == \
            whole["memory_analysis"]["argument_bytes"]


def test_run_cell_full_size_and_the_graph_cell():
    """A full-size cell on the production mesh (tinyllama-1.1b's decode
    step against a 32,768-slot cache) and the PageRank superstep over 256
    partitions: the artifact checks, the roofline from the global
    collective count, the exchange an all-to-all."""
    rec = tdry.run_cell("tinyllama-1.1b", "decode_32k", "single", "cpu")
    _artifact_checks(rec)
    assert rec["chips"] == 256 and rec["traced_depths"] == [1, 2]
    total = rec["collective_bytes"]["total"]
    assert rec["roofline"]["ici_bytes"] == pytest.approx(total)
    graph = tdry.run_cell("totem-rmat", "pagerank_superstep", "single",
                          "cpu")
    _artifact_checks(graph)
    assert graph["collective_bytes"]["all-to-all"] == 256 * 262144 * 4
    skipped = tdry.run_cell("tinyllama-1.1b", "long_500k", "single", "cpu")
    assert skipped["ok"] and "sub-quadratic" in skipped["skipped"]


@pytest.mark.parametrize("flag", ["serve_bf16", "cache_seq_shard",
                                  "graph_bf16_msgs", "donate"])
def test_dry_run_flags_change_their_records(flag, monkeypatch):
    """Each of the dry run's own flags moves the number it is about."""
    def cell(kind, flags, arch="tinyllama-1.1b"):
        monkeypatch.setenv("REPRO_OPTS", flags)
        cfg = tconfigs.get_smoke(arch)
        shape = tapi.ShapeSpec(f"{kind}_t", kind, 64, 4)
        return tdry.run_cell(arch, shape.name, "single", "cpu", cfg=cfg,
                             shape=shape, mesh_shape=(2, 2), whole=True)

    if flag == "graph_bf16_msgs":
        a = tdry.run_cell("totem-rmat", "pagerank_superstep", "single", "cpu")
        monkeypatch.setenv("REPRO_OPTS", flag)
        b = tdry.run_cell("totem-rmat", "pagerank_superstep", "single", "cpu")
        assert b["memory_analysis"]["temp_bytes"] < \
            a["memory_analysis"]["temp_bytes"]
        assert b["collective_bytes"]["all-to-all"] * 2 == \
            a["collective_bytes"]["all-to-all"]
        return
    kind = {"serve_bf16": "prefill", "cache_seq_shard": "decode",
            "donate": "train"}[flag]
    a, b = cell(kind, ""), cell(kind, flag)
    ma, mb = a["memory_analysis"], b["memory_analysis"]
    if flag == "serve_bf16":
        assert mb["argument_bytes"] < ma["argument_bytes"]
    elif flag == "cache_seq_shard":
        assert b["collective_bytes"] != a["collective_bytes"]
    else:
        assert mb["alias_bytes"] > ma["alias_bytes"]
        assert mb["temp_bytes"] < ma["temp_bytes"]


# -- the flash custom op -----------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5),
                                           (False, 0)])
def test_flash_op_on_the_cpu_is_its_plain_version(causal, window):
    g = torch.Generator().manual_seed(7)
    q = torch.randn(2, 24, 2, 3, 16, generator=g)
    k = torch.randn(2, 24, 2, 16, generator=g)
    v = torch.randn(2, 24, 2, 16, generator=g)
    got = torch.ops.repro_torch.flash_attention(q, k, v, causal, window)
    want = flash_attention_ref(q, k, v, causal=causal, window=window)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention(q, k, v)


def test_flash_op_fake_shape_and_flops():
    """Under fake tensors the op returns q's shape and makes nothing but
    its output (no ``[S, S]`` scores); the flop counter reads the bound's
    operation count: 68.8 GFLOP at ``[4, 2048, 4, 8, 64]`` causal."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    with FakeTensorMode():
        q = torch.empty(4, 2048, 4, 8, 64, dtype=torch.bfloat16)
        k = torch.empty(4, 2048, 4, 64, dtype=torch.bfloat16)
        with LocalCounter() as c:
            out = torch.ops.repro_torch.flash_attention(q, k, k, True, 0)
        assert out.shape == q.shape and out.dtype == q.dtype
        assert c.peak == out.numel() * 2
        assert c.flops == kfa.attention_flops(4, 2048, 4, 8, 64)
        with FlopCounterMode(display=False) as fc:
            torch.ops.repro_torch.flash_attention(q, k, k, True, 0)
    assert fc.get_total_flops() == kfa.attention_flops(4, 2048, 4, 8, 64)
    assert round(fc.get_total_flops() / 1e9, 1) == 68.8
    assert kfa.attention_flops(1, 8, 1, 1, 4, causal=False) == 4 * 4 * 64
    assert kfa.attention_flops(1, 8, 1, 1, 4, window=2) == 4 * 4 * 15


def test_flash_op_sharding_rule_on_a_fake_mesh():
    """Batch or KV-group sharded inputs stay sharded through the op (no
    collective); a sequence-sharded q is gathered first (S stays whole)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    with tdry.fake_world(4):
        mesh = tmesh.make_local_mesh(2, 2, device="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            def dist(t, pl):
                return distribute_tensor(t, mesh, pl)

            q = torch.empty(4, 16, 2, 2, 8)
            kv = torch.empty(4, 16, 2, 8)
            for pl in ([Shard(0), Replicate()], [Shard(0), Shard(2)],
                       [Replicate(), Shard(2)]):
                with LocalCounter() as c:
                    out = torch.ops.repro_torch.flash_attention(
                        dist(q, pl), dist(kv, pl), dist(kv, pl), True, 0)
                assert tuple(out.placements) == tuple(pl)
                assert c.summary()["collective_bytes"]["total"] == 0
            with LocalCounter() as c:
                out = torch.ops.repro_torch.flash_attention(
                    dist(q, [Shard(1), Replicate()]),
                    dist(kv, [Replicate(), Replicate()]),
                    dist(kv, [Replicate(), Replicate()]), True, 0)
            assert all(not (isinstance(p, Shard) and p.dim == 1)
                       for p in out.placements)
            assert c.summary()["collective_bytes"]["total"] > 0
