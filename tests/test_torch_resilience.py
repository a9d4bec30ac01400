"""The port's robustness layer against the JAX package's, on the CPU:
fault injection, checkpoints, restart loops, fault-tolerant serving, the
drills and the elastic resume.

Graphs: the ``graph_serve --smoke`` sizes (``rmat(8, 8, seed=1)``, 4
partitions under HIGH, 3 mutation rounds of 32 edges at churn 0.7, 4
standing queries, batches of 4) for the serving runs; ``rmat(7, 8,
seed=0)`` over 2 partitions elsewhere.

- ``FaultInjector`` specs fire at the same visits as JAX's, with the same
  fired logs.
- A checkpoint written by either package's manager restores in the
  other's (float, int and bool leaves, nested trees); a torn one raises
  ``CheckpointCorruption`` in both; tensor leaves come back on ``like``'s
  device with its dtype.
- ``chunked_refresh``, ``serve_fault_tolerant`` (clean and under the
  chaos drill's injector) and ``serve_with_restarts`` equal JAX's: results
  bit for bit, and the reports' failures, acked batches, snapshots,
  downgrades and quarantined queries; the ``--corrupt`` drill prints
  JAX's lines.
- ``DynamicGraph.snapshot()`` leaves equal JAX's.
- ``launch/ft_selftest.py`` over gloo worlds 2 -> 1 and 4 -> 2.
- Injected flips never alias live state: after a flipped window the
  dynamic payload and the caller's carry keep their bytes.
- Both restart loops re-raise a failed CUDA kernel at once.
"""
import argparse
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import JEngine, JG, JPT, jbfs

from repro_torch.checkpoint import (CheckpointCorruption, CheckpointManager,
                                    restore_resharded)
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import BSPEngine
from repro_torch.core.dynamic import DynamicGraph
from repro_torch.data.graphs import edge_stream
from repro_torch.distributed import ShardGroup
from repro_torch.launch import graph_serve as tgs
from repro_torch.runtime import (ExchangeCorruption, FaultInjector,
                                 ServeSession, WorkerFailure, chaos,
                                 drain_reference, run_with_restarts,
                                 serve_with_restarts)

trt = importlib.import_module("repro_torch.runtime")

tbfs = importlib.import_module("repro_torch.algorithms.bfs")
jrt = importlib.import_module("repro.runtime")
jchaos = importlib.import_module("repro.runtime.chaos")
jckpt = importlib.import_module("repro.checkpoint.manager")
jgs = importlib.import_module("repro.launch.graph_serve")
jdyn = importlib.import_module("repro.core.dynamic")
jdata = importlib.import_module("repro.data.graphs")

KW = {"reference": {}, "fused": dict(fused=True, block_e=128),
      "hybrid": dict(backend="hybrid")}


def _smoke_args(**over):
    """``graph_serve --smoke``'s arguments (the port's parser, shrunk as
    its ``main`` shrinks them) on the CPU."""
    args = tgs.build_parser().parse_args(["--smoke", "--device", "cpu"])
    args.scale, args.batch, args.num_queries = 8, 4, 12
    args.mutation_batch, args.mutation_rounds, args.standing = 32, 3, 4
    for k, v in over.items():
        setattr(args, k, v)
    return args


def _jax_args(args):
    out = argparse.Namespace(**vars(args))
    del out.device
    return out


@pytest.fixture(scope="module")
def small():
    tg, jg = TG.rmat(7, 8, seed=0), JG.rmat(7, 8, seed=0)
    return tg, jg, JPT.partition(jg, 2, "high"), TPT.partition(tg, 2, "high")


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

SPECS = {
    "at": {"superstep.chunk": [{"at": 2}]},
    "ctx": {"serve.round": [{"round": 1}], "kernel.dispatch":
            [{"round": 2}, {"round": 2}]},
    "shard": {"worker.chunk": [{"shard": 1}], "exchange": [{"shard": 0}]},
    "flags": {"query.poison": [{"round": r, "flag": True}
                               for r in range(3)],
              "state.corrupt": [{"step": 4, "flag": True}]},
}
VISITS = ([("superstep.chunk", {"step": 2 * i, "chunk": i})
           for i in range(4)]
          + [("serve.round", {"round": r}) for r in range(3)]
          + [("kernel.dispatch", {"round": r, "backend": "fused"})
             for r in (0, 2, 2, 2)]
          + [("worker.chunk", {"step": 0, "shards": (0, 1)}),
             ("exchange", {"shard": 1}), ("exchange", {"shard": 0})]
          + [("query.poison", {"round": r}) for r in range(4)]
          + [("state.corrupt", {"step": s}) for s in (0, 4, 4)])


def _drive(reg, injector):
    """Every visit of VISITS through one package's registry: the flags
    returned and the faults raised, in order."""
    out = []
    with reg.active(injector):
        for site, ctx in VISITS:
            try:
                out.append((site, reg.visit(site, **ctx)))
            except Exception as e:              # noqa: BLE001 — recorded
                out.append((site, type(e).__name__, str(e)))
        log = list(reg.registry.fired_log)
    return out, log


@pytest.mark.parametrize("case", sorted(SPECS))
def test_fault_injector_fires_at_the_same_visits_as_jax(case):
    inj = FaultInjector(sites={k: [dict(s) for s in v]
                               for k, v in SPECS[case].items()})
    jinj = jrt.FaultInjector(sites={k: [dict(s) for s in v]
                                    for k, v in SPECS[case].items()})
    got, log = _drive(chaos, inj)
    want, jlog = _drive(jchaos, jinj)
    assert got == want and log == jlog
    assert inj.site_fired == jinj.site_fired and inj.site_fired
    assert chaos.registry.counts == {} and not chaos.registry.armed


def test_maybe_fail_and_visit_without_injector():
    inj = FaultInjector(fail_at_steps={3})
    inj.maybe_fail(2)
    with pytest.raises(WorkerFailure, match="step 3"):
        inj.maybe_fail(3)
    inj.maybe_fail(3)                         # each step fires once
    assert chaos.visit("serve.round", round=0) is False
    assert chaos.registry.counts == {}        # unarmed visits count nothing


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"state": {"level": rng.standard_normal((3, 2, 5)).astype(
                np.float32), "active": rng.random((3, 2, 5)) < 0.5},
            "steps_q": np.arange(3, dtype=np.int32),
            "ids": rng.integers(0, 1 << 40, size=4),
            "pair": (np.float64(2.5) * np.ones(2), np.zeros(3, np.int8))}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    like = _tree(np.random.default_rng(1))
    mgrs = {"port": CheckpointManager(tmp_path), "jax":
            jckpt.CheckpointManager(tmp_path)}
    mgrs[writer].save_tree(7, tree, extra={"round": 2})
    reader = mgrs["jax" if writer == "port" else "port"]
    assert reader.latest_step() == 7
    assert reader.manifest_extra() == {"round": 2}
    step, got = reader.restore_tree(like)
    assert step == 7
    flat, want = jckpt._flatten(got), jckpt._flatten(tree)
    assert flat.keys() == want.keys()
    for k in want:
        assert np.asarray(flat[k]).dtype == want[k].dtype, k
        np.testing.assert_array_equal(np.asarray(flat[k]), want[k])
    # the same bytes and checksums on disk, whoever wrote them
    other = tmp_path / "other"
    (jckpt.CheckpointManager(other) if writer == "port"
     else CheckpointManager(other)).save_tree(7, tree, extra={"round": 2})
    assert ((tmp_path / "step_00000007.json").read_text()
            == (other / "step_00000007.json").read_text())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_checkpoint_raises_in_both(tmp_path, writer):
    tree = {"state": np.random.default_rng(0).standard_normal(64).astype(
        np.float32)}
    if writer == "port":
        mgr, reg, inj = CheckpointManager(tmp_path), chaos, FaultInjector
    else:
        mgr, reg, inj = (jckpt.CheckpointManager(tmp_path), jchaos,
                         jrt.FaultInjector)
    mgr.save_tree(0, tree)
    with reg.active(inj(sites={"checkpoint.torn": [{"step": 1,
                                                    "flag": True}]})):
        mgr.save_tree(1, tree)
    for reader, exc in ((CheckpointManager(tmp_path), CheckpointCorruption),
                        (jckpt.CheckpointManager(tmp_path),
                         jckpt.CheckpointCorruption)):
        with pytest.raises(exc, match="fail their manifest CRC"):
            reader.restore_tree(tree)
        _, torn = reader.restore_tree(tree, verify=False)
        assert not np.array_equal(torn["state"], tree["state"])
        _, good = reader.restore_tree(tree, step=0)
        np.testing.assert_array_equal(good["state"], tree["state"])


def test_tensor_leaves_restore_with_like_device_and_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "fin": torch.tensor([True, False]),
            "n": torch.tensor([3, 4], dtype=torch.int32)}
    for step in range(3):                     # keep=2 drops step 0
        mgr.save_tree(step, tree, blocking=False)
    assert mgr.latest_step() == 2
    assert sorted(p.name for p in tmp_path.glob("*.npz")) == [
        "step_00000001.npz", "step_00000002.npz"]
    like = {"x": torch.zeros(2, 3, dtype=torch.float64),
            "fin": torch.zeros(2, dtype=torch.bool), "n": np.zeros(2)}
    _, got = mgr.restore_tree(like)
    assert got["x"].dtype == torch.float64 and torch.equal(
        got["x"], tree["x"].double())
    assert got["fin"].dtype == torch.bool and torch.equal(got["fin"],
                                                          tree["fin"])
    assert isinstance(got["n"], np.ndarray) and got["n"].dtype == np.int32
    _, placed = restore_resharded(mgr, like, ShardGroup(None, "cpu"))
    assert all(isinstance(v, torch.Tensor) for v in placed.values())
    assert placed["n"].dtype == torch.int32
    with pytest.raises(KeyError, match="lacks leaves"):
        mgr.restore_tree({"y": like["x"]})


# ---------------------------------------------------------------------------
# restart loops
# ---------------------------------------------------------------------------

def _step_fn(injector):
    def step_fn(step, state):
        injector.maybe_fail(step)
        return {"x": state["x"] + float(step)}, {"step": step}
    return step_fn


def test_run_with_restarts_equals_jax(tmp_path):
    got, summary = run_with_restarts(
        _step_fn(FaultInjector(fail_at_steps={3, 7})), {"x": torch.zeros(4)},
        10, CheckpointManager(tmp_path / "port"), checkpoint_every=2)
    want, jsummary = jrt.run_with_restarts(
        _step_fn(jrt.FaultInjector(fail_at_steps={3, 7})),
        {"x": np.zeros(4, np.float32)}, 10,
        jckpt.CheckpointManager(tmp_path / "jax"), checkpoint_every=2)
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want["x"]))
    assert summary["failures"] == jsummary["failures"] == 2
    assert summary["final_step"] == jsummary["final_step"] == 10
    assert ([r["step"] for r in summary["restarts"]]
            == [r["step"] for r in jsummary["restarts"]])


@pytest.mark.parametrize("loop", ["run", "serve"])
def test_restart_loops_reraise_kernel_failures(tmp_path, loop):
    """A CUDA error never burns the retry budget, whatever the
    whitelist."""
    calls = []

    def boom(*_):
        calls.append(1)
        raise torch.AcceleratorError("CUDA error: an illegal memory access "
                                     "was encountered")

    class Session:
        windows = 0
        step = staticmethod(boom)

        def snapshot(self, manager, step, blocking=True):
            manager.save_tree(step, {"w": np.zeros(1)}, blocking=blocking)

        def restore(self, manager):
            pass

    mgr = CheckpointManager(tmp_path)
    with pytest.raises(torch.AcceleratorError, match="illegal memory"):
        if loop == "run":
            run_with_restarts(boom, {"x": np.zeros(1)}, 4, mgr,
                              retryable=(Exception,))
        else:
            serve_with_restarts(Session, mgr, retryable=(Exception,))
    assert calls == [1]


def test_serve_with_restarts_resumes_mid_stream(small, tmp_path):
    """A continuous fused BFS session with one ``superstep.chunk`` fault:
    rebuilt and restored from its last snapshot mid-stream, every
    completion bit for bit ``drain_reference``'s and JAX's."""
    tg, _, jp, tp = small
    sources = np.random.default_rng(4).integers(0, tg.num_vertices, 12)
    eng = BSPEngine(tp, device="cpu", **KW["fused"])
    want = drain_reference(eng, "bfs", sources, 4)

    def run(rt, make, engine, mgr_cls, reg, path):
        def factory():
            s = make(engine, "bfs", slots=4, chunk=2)
            s.submit(sources)
            return s

        inj = rt.FaultInjector(sites={"superstep.chunk": [{"at": 3}]})
        with reg.active(inj):
            session, summary = rt.serve_with_restarts(
                factory, mgr_cls(path), checkpoint_every=1)
        res = {r["query"]: r["result"] for r in session.poll()}
        return np.stack([res[q] for q in range(len(sources))]), summary

    got, summary = run(trt, ServeSession, eng, CheckpointManager, chaos,
                       tmp_path / "port")
    jgot, jsummary = run(jrt, jrt.ServeSession, JEngine(jp, **KW["fused"]),
                         jckpt.CheckpointManager, jchaos, tmp_path / "jax")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jgot)
    assert summary["failures"] == jsummary["failures"] == 1
    assert summary["windows"] == jsummary["windows"]
    assert ([r["windows"] for r in summary["restarts"]]
            == [r["windows"] for r in jsummary["restarts"]])


# ---------------------------------------------------------------------------
# fault-tolerant serving and the drills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alg", ["bfs", "sssp"])
@pytest.mark.parametrize("backend", sorted(KW))
def test_chunked_refresh_equals_jax(backend, alg):
    tg, jg = TG.rmat(8, 8, seed=1), JG.rmat(8, 8, seed=1)
    if alg == "sssp":
        tg, jg = tg.with_uniform_weights(seed=2), jg.with_uniform_weights(
            seed=2)
    eng = BSPEngine(TPT.partition(tg, 4, "high"), device="cpu",
                    **KW[backend])
    jeng = JEngine(JPT.partition(jg, 4, "high"), **KW[backend])
    sources = np.random.default_rng(1).integers(0, tg.num_vertices, (4, 1))
    got, steps, info = tgs.chunked_refresh(eng, alg, sources, chunk=2)
    want, jsteps, jinfo = jgs.chunked_refresh(jeng, alg, sources, chunk=2)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(steps, jsteps)
    assert (info["chunks"], info["final_step"]) == (jinfo["chunks"],
                                                   jinfo["final_step"])
    inj = FaultInjector(sites={"query.poison": [{"round": 0, "flag": True}]})
    with chaos.active(inj):
        poisoned, _, _ = tgs.chunked_refresh(eng, alg, sources, chunk=2)
    assert np.isnan(poisoned[0]).all()
    np.testing.assert_array_equal(poisoned[1:], got[1:])


def _chaos_injector(cls, rounds=3):
    return cls(sites={
        "serve.round": [{"round": 1}],
        "superstep.chunk": [{"round": 1, "chunk": 1}],
        "mutation.scatter": [{"index": 2}],
        "kernel.dispatch": [{"round": 2}, {"round": 2}],
        "query.poison": [{"round": r, "flag": True} for r in range(rounds)],
    })


@pytest.mark.parametrize("backend", ["fused", "hybrid"])
@pytest.mark.parametrize("faulty", [False, True])
def test_serve_fault_tolerant_equals_jax(tmp_path, backend, faulty):
    args = _smoke_args(backend=backend)
    runs = []
    for mod, ckpt, reg, inj_cls, a in (
            (tgs, CheckpointManager, chaos, FaultInjector, args),
            (jgs, jckpt.CheckpointManager, jchaos, jrt.FaultInjector,
             _jax_args(args))):
        name = mod.__name__.split(".")[0]
        kw = {}
        if faulty:
            kw = dict(midrun_manager=ckpt(tmp_path / f"{name}_mid"),
                      hard_limit_s=0.0)
        with reg.active(*([_chaos_injector(inj_cls)] if faulty else [])):
            runs.append(mod.serve_fault_tolerant(
                a, ckpt(tmp_path / name, keep=3), **kw))
    (rep, res, quar), (jrep, jres, jquar) = runs
    np.testing.assert_array_equal(res, jres)
    assert quar == jquar == ({0} if faulty else set())
    # (stragglers are timed by the watchdog's clock: not compared)
    for key in ("rounds", "acked", "snapshots", "failures",
                "midrun_snapshots"):
        assert rep[key] == jrep[key], key
    # the port counts what its engines build, JAX its jit caches: held to
    # the drill's bounds, not to each other
    assert rep["retraces"] <= rep["failures"]
    assert faulty or rep["retraces"] == jrep["retraces"] == 0
    assert len(rep["downgrades"]) == len(jrep["downgrades"]) == int(faulty)
    assert rep["quarantined"] == jrep["quarantined"]
    assert ([r.get("round") for r in rep["restarts"]]
            == [r.get("round") for r in jrep["restarts"]])
    assert rep["fallback"] == "reference"     # on the CPU, as in JAX
    assert len(rep["recovery_s"]) == rep["failures"]
    assert len(rep["snapshot_bytes"]) == rep["snapshots"] == 3
    assert set(jrep) <= set(rep)


def test_chaos_drill_reports(capsys):
    out = tgs.run_chaos_drill(_smoke_args())
    text = capsys.readouterr().out
    assert out["faulty"]["failures"] >= 3 and out["quarantined"] == [0]
    assert out["parity"] == 3
    assert "chaos parity: 3/4 standing queries bitwise identical" in text


def test_corrupt_drill_prints_the_lines_of_jax(capsys):
    """Each line of the drill equal to JAX's, the temporary checkpoint
    directory aside."""
    def lines():
        return [line.split(" in /")[0]
                for line in capsys.readouterr().out.splitlines()]

    out = tgs.run_corrupt_drill(_smoke_args())
    got = lines()
    jgs.run_corrupt_drill(_jax_args(_smoke_args()))
    want = lines()
    assert got == want[:len(got)] and len(want) == len(got) + 1
    assert want[-1] == "CORRUPT OK"
    assert (out["detections"], out["masked"]) == (6, 2)


def test_dynamic_snapshot_leaves_equal_jax():
    """The payload leaves after the same stream equal JAX's.  Their shapes
    agree (the JAX package pads each batch's *writes* to the mutation
    capacity, not the payload); the index leaves are int64 in the port,
    where they index tensors, and int32 in JAX, so values are compared."""
    g, jg = TG.rmat(8, 8, seed=1), JG.rmat(8, 8, seed=1)
    dg = DynamicGraph(g, 4, "high", mutation_capacity=32,
                      include_reverse=True, device="cpu")
    jdg = jdyn.DynamicGraph(jg, 4, "high", mutation_capacity=32,
                            include_reverse=True)
    for b, jb in zip(edge_stream(g, 3, 32, churn=0.7, seed=1),
                     jdata.edge_stream(jg, 3, 32, churn=0.7, seed=1)):
        dg.apply_mutations(b)
        jdg.apply_mutations(jb)
    tree, extra = dg.snapshot()
    jtree, jextra = jdg.snapshot()
    assert extra == jextra == dict(cursor=3, version=0, log_floor=0)
    flat, jflat = jckpt._flatten(tree), jckpt._flatten(jtree)
    assert flat.keys() == jflat.keys()
    for k, v in flat.items():
        want = np.asarray(jflat[k])
        assert tuple(v.shape) == want.shape, k
        np.testing.assert_array_equal(v.numpy(), want)


# ---------------------------------------------------------------------------
# flips never alias live state
# ---------------------------------------------------------------------------

def test_flipped_windows_leave_live_state_unchanged(small):
    """``tombstone.flip`` flips a copy of the mask, ``state.corrupt`` a copy
    of the state and ``exchange.payload`` a copy of the wire: the dynamic
    payload and the carry the caller holds keep their bytes."""
    tg, _, _, tp = small
    dg = DynamicGraph(tg, 2, "high", mutation_capacity=32, device="cpu")
    dg.apply_mutations(edge_stream(tg, 1, 32, churn=0.5, seed=0)[0])
    payload0 = {k: v.clone() for k, v in dg.payload().items()}
    state = {"level": torch.as_tensor(tbfs.multi_source_state(dg.pg, [1]))}
    state0 = state["level"].clone()
    eng = BSPEngine(dg, device="cpu", backend="reference")
    inj = FaultInjector(sites={"tombstone.flip": [{"step": 0,
                                                   "flag": True}]})
    with chaos.active(inj):
        eng.execute(tbfs.BFS_PROGRAM, state, chunk=2)
    assert inj.site_fired
    for k, v in dg.payload().items():
        assert torch.equal(v, payload0[k]), k
    assert torch.equal(state["level"], state0)

    static = BSPEngine(tp, device="cpu", **KW["fused"])
    carry = {"level": torch.as_tensor(tbfs.multi_source_state(tp, [1, 2]))}
    carry0 = carry["level"].clone()
    inj = FaultInjector(sites={"state.corrupt": [{"step": 0, "flag": True}],
                               "exchange.payload": [{"step": 0,
                                                     "flag": True}]})
    with chaos.active(inj), pytest.raises(ExchangeCorruption):
        static.execute(tbfs.BFS_PROGRAM, carry, chunk=2)
    assert torch.equal(carry["level"], carry0)


# ---------------------------------------------------------------------------
# elastic resume over gloo worlds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("worlds", [(2, 1), (4, 2)])
def test_ft_selftest_over_gloo_worlds(tmp_path, capsys, worlds):
    from repro_torch.launch import ft_selftest

    assert ft_selftest.main(["--world", str(worlds[0]), "--resume-world",
                             str(worlds[1]), "--device", "cpu", "--ckpt",
                             str(tmp_path), "--timeout", "300"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-2] == f"FT RESUME OK devices={worlds[0]}->{worlds[1]} step=2"
    assert out[-1] == "FT SELFTEST OK"
