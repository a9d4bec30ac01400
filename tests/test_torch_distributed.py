"""The port's sharded engine against the JAX package's, on the CPU.

**World of one, in this process.**  ``DistributedBSPEngine(pg,
device="cpu")`` (``group=None``) against the JAX ``DistributedBSPEngine``
on a one-device mesh holding every partition, for the reference, fused and
hybrid backends and the five algorithms, on the same graph, partition and
sources.  Tolerances, those of ``test_torch_engine_hybrid.py``:

- BFS, SSSP, CC: results bit for bit with equal steps, and
  ``last_direction_stats`` equal as integers;
- PageRank ``rtol=1e-6``, BC ``rtol=1e-6, atol=1e-9`` with equal steps
  (the f32 reassociation of the two packages' sums at scale 8);
- ``hybrid_plan()`` equal (per-shard records with ``t_comm``).

Also the single-partition graph (an empty outbox) and the engine's
validation errors.

**Worlds of 2 and 4 gloo ranks.**  The port's self-tests
(``repro_torch.launch.hybrid_selftest`` and ``launch.selftest``) run as
subprocesses with ``--device cpu`` and a ``file://`` rendezvous under
``tmp_path``; both save their results, held here against the JAX
single-device reference engine: min results bit for bit with equal steps,
PageRank ``rtol=1e-5, atol=1e-8`` and BC ``rtol=1e-4, atol=1e-4``, the JAX
``hybrid_selftest``'s tolerances (the sums reassociate across shards); and
the hybrid's min results bit for bit equal to the port's world of one.
"""
import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_jaxref import (JA, JG, JPT, engine_case, jax_engine, jbc,
                               jcc, jpr)

from repro_torch.algorithms import cc as tcc
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.core.bsp import DistributedBSPEngine
from repro_torch.distributed import ShardGroup

JDist = importlib.import_module("repro.core.bsp").DistributedBSPEngine
talg = importlib.import_module("repro_torch.algorithms")
tbc = importlib.import_module("repro_torch.algorithms.bc")
tpr = importlib.import_module("repro_torch.algorithms.pagerank")

SRC = Path(__file__).resolve().parents[1] / "src"
SCALE = 8
SOURCES = [0, 5, 17]
PR_ITERS = 10
CASES = [("rmat", 2, "high", "reference"), ("rmat", 2, "high", "fused"),
         ("rmat", 2, "high", "hybrid"), ("uniform", 4, "rand", "hybrid")]


def _mesh():
    return jax.make_mesh((1,), ("parts",))


def _engine(package, pg, backend):
    if package == "jax":
        return JDist(pg, _mesh(), backend=backend)
    return DistributedBSPEngine(pg, device="cpu", backend=backend)


def _stats(engine):
    s = engine.last_direction_stats
    return None if s is None else {k: np.asarray(v) for k, v in s.items()}


def _run_all(package, pg, pgs, backend):
    """The five algorithms (BFS and SSSP batched over SOURCES) on one
    package's world-of-one engine: ``{name: (result, steps, stats)}``."""
    a = JA if package == "jax" else talg
    pr = jpr if package == "jax" else tpr
    bc = jbc if package == "jax" else tbc
    eng, eng_cc = _engine(package, pg, backend), _engine(package, pgs,
                                                         backend)
    out = {}
    for name, run in (("bfs", lambda: a.bfs_batched(eng, SOURCES)),
                      ("sssp", lambda: a.sssp_batched(eng, SOURCES)),
                      ("bc", lambda: bc.betweenness_centrality(eng, 3))):
        res, steps = run()
        out[name] = (np.asarray(res), np.asarray(steps), _stats(eng))
    res, steps = a.connected_components(eng_cc)
    out["cc"] = (np.asarray(res), np.asarray(steps), _stats(eng_cc))
    out["pagerank"] = (pr.pagerank_distributed(eng, PR_ITERS), None, None)
    out["plan"] = eng.hybrid_plan()
    return out


@pytest.fixture(scope="module", params=CASES, ids=lambda c: "-".join(
    map(str, c)))
def runs(request):
    kind, parts, strategy, backend = request.param
    _, jp, tp = engine_case(kind, parts, strategy, scale=SCALE,
                            weighted=True, include_reverse=True)
    _, jps, tps = engine_case(kind, parts, strategy, scale=SCALE,
                              symmetric=True)
    return {"jax": _run_all("jax", jp, jps, backend),
            "port": _run_all("port", tp, tps, backend)}


def test_min_results_steps_and_directions_equal_jax(runs):
    for name in ("bfs", "sssp", "cc"):
        (jr, js, jst), (tr, ts, tst) = runs["jax"][name], runs["port"][name]
        np.testing.assert_array_equal(tr, jr, err_msg=name)
        np.testing.assert_array_equal(ts, js, err_msg=name)
        assert (jst is None) == (tst is None), name
        if jst is not None:
            for key in ("direction", "edges_examined", "switches"):
                np.testing.assert_array_equal(tst[key], jst[key],
                                              err_msg=f"{name} {key}")


def test_sum_results_within_f32_of_jax(runs):
    np.testing.assert_allclose(runs["port"]["pagerank"][0],
                               runs["jax"]["pagerank"][0], rtol=1e-6)
    (jr, js, _), (tr, ts, _) = runs["jax"]["bc"], runs["port"]["bc"]
    np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(ts, js)


def test_hybrid_plan_equal_jax(runs):
    assert runs["port"]["plan"] == runs["jax"]["plan"]


def test_single_partition_has_an_empty_outbox():
    _, jp, tp = engine_case("rmat", 1, "rand", scale=SCALE, weighted=True)
    assert float(tp.beta_with_reduction) == 0.0
    for alg in ("bfs_batched", "sssp_batched"):
        want, jsteps = getattr(JA, alg)(_engine("jax", jp, "hybrid"),
                                        SOURCES)
        eng = _engine("port", tp, "hybrid")
        got, steps = getattr(talg, alg)(eng, SOURCES)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(steps, jsteps)
    cfg, arrs = eng.hybrid_for(importlib.import_module(
        "repro_torch.algorithms.sssp").SSSP_PROGRAM)
    assert not cfg.has_boundary and "b_src" not in arrs


def test_validation_errors():
    from repro_torch.algorithms.bfs import BFS_PROGRAM

    pg = TPT.partition(TG.rmat(6, 4, seed=1), 2, TPT.RAND,
                       include_reverse=True)
    three = ShardGroup(None, "cpu")
    three.world_size = 3
    with pytest.raises(ValueError, match="must divide over the world size"):
        DistributedBSPEngine(pg, three)
    with pytest.raises(ValueError, match="single-device only"):
        DistributedBSPEngine(pg, device="cpu", tiered=1 << 20)
    eng = DistributedBSPEngine(pg, device="cpu")
    for bad in ({"level": torch.zeros(1, 3, pg.v_max)},
                {"level": torch.zeros(1, 2, pg.v_max),
                 "seen": torch.zeros(1)}):
        with pytest.raises(ValueError, match="expected \\[Q, num_parts=2"):
            eng.execute(BFS_PROGRAM, bad)
    with pytest.raises(ValueError, match="inconsistent with the group"):
        eng._exchange(torch.zeros(1, 2, 3, 4))
    # chunked windows are ported: they validate the state as execute()
    # does, and take their chaos sites' context (item 13)
    with pytest.raises(ValueError, match="expected \\[Q, num_parts=2"):
        eng.execute(BFS_PROGRAM, {"level": torch.zeros(1, 3, pg.v_max)},
                    chunk=2)
    out, _, info = eng.execute(
        BFS_PROGRAM, {"level": torch.zeros(1, 2, pg.v_max)}, chunk=2,
        chaos_ctx={})
    assert torch.equal(out["level"], torch.zeros(1, 2, pg.v_max))
    assert info["finished"].tolist() == [True]


def test_gloo_group_of_one_refuses_cuda_and_runs_cpu(tmp_path):
    pg = TPT.partition(TG.rmat(7, 4, seed=1).with_uniform_weights(seed=2),
                       2, TPT.HIGH, include_reverse=True)
    dist.init_process_group("gloo", init_method=(tmp_path / "rdv").as_uri(),
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="gloo"):
            ShardGroup(dist.group.WORLD, "cuda")
        eng = DistributedBSPEngine(pg, dist.group.WORLD, device="cpu",
                                   backend="hybrid")
        assert (eng.group.rank, eng.group.world_size) == (0, 1)
        got = talg.sssp_batched(eng, SOURCES)
    finally:
        dist.destroy_process_group()
    want = talg.sssp_batched(DistributedBSPEngine(pg, device="cpu",
                                                  backend="hybrid"), SOURCES)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# gloo worlds of 2 and 4 ranks, in subprocesses
# ---------------------------------------------------------------------------

# launch/hybrid_selftest.py's graph, cut to this file's scale
SELFTEST = dict(scale=SCALE, edge_factor=4, parts=4, seed=13)


def _launch(module, world, tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC), os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", module, "--world", str(world),
           "--device", "cpu", "--init", (tmp_path / "rendezvous").as_uri(), "--timeout", "240",
           *args]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def references():
    """Per strategy: the JAX single-device reference engine's results, and
    the min results of the port's world of one."""
    c = SELFTEST
    jg = JG.rmat(c["scale"], c["edge_factor"], seed=c["seed"])
    jgw, jgs = jg.with_uniform_weights(seed=1), jcc.symmetrize(jg)
    tg = TG.rmat(c["scale"], c["edge_factor"], seed=c["seed"])
    tgw, tgs = tg.with_uniform_weights(seed=1), tcc.symmetrize(tg)
    out = {}
    for strategy in ("rand", "high", "low"):
        jeng = jax_engine(JPT.partition(jgw, c["parts"], strategy,
                                        include_reverse=True))
        lv, lsteps = JA.bfs(jeng, 0)
        bc, bsteps = jbc.betweenness_centrality(jeng, 0)
        want = dict(bfs=lv, bfs_steps=lsteps, sssp=JA.sssp(jeng, 0)[0],
                    pagerank=JA.pagerank(jeng, num_iterations=10), bc=bc,
                    bc_steps=bsteps, cc=JA.connected_components(jax_engine(
                        JPT.partition(jgs, c["parts"], strategy)))[0])
        teng = DistributedBSPEngine(TPT.partition(
            tgw, c["parts"], strategy, include_reverse=True), device="cpu",
            backend="hybrid")
        one = dict(bfs=talg.bfs(teng, 0)[0], sssp=talg.sssp(teng, 0)[0],
                   cc=talg.connected_components(DistributedBSPEngine(
                       TPT.partition(tgs, c["parts"], strategy),
                       device="cpu", backend="hybrid"))[0])
        out[strategy] = (want, one)
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_hybrid_matches_jax_reference(world, tmp_path,
                                                 references):
    path = tmp_path / "results.npz"
    stdout = _launch("repro_torch.launch.hybrid_selftest", world, tmp_path,
                     "--scale", str(SELFTEST["scale"]), "--edge-factor",
                     str(SELFTEST["edge_factor"]), "--parts",
                     str(SELFTEST["parts"]), "--seed", str(SELFTEST["seed"]),
                     "--out", str(path))
    assert "HYBRID SELFTEST OK" in stdout
    got = np.load(path)
    for strategy, (want, one) in references.items():
        def res(name):
            return got[f"{strategy}/{name}"]

        for name in ("bfs", "sssp", "cc"):
            np.testing.assert_array_equal(res(name), want[name],
                                          err_msg=f"{strategy} {name}")
            np.testing.assert_array_equal(res(name), one[name],
                                          err_msg=f"{strategy} {name} w1")
        assert int(res("bfs_steps")) == want["bfs_steps"]
        assert int(res("bc_steps")) == want["bc_steps"]
        np.testing.assert_allclose(res("pagerank"), want["pagerank"],
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(res("bc"), want["bc"], rtol=1e-4,
                                   atol=1e-4)


def _rank_one_fails(group):
    """A world target: rank 1 raises while rank 0 waits in a collective."""
    if group.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    group.all_true(torch.zeros(1, dtype=torch.bool))


def test_world_reports_a_failed_rank_at_once():
    from repro_torch.launch.world import run_world

    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_world(_rank_one_fails, 2, device="cpu", timeout=120)
    assert time.monotonic() - start < 60


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_world_reference_and_fused_match_local(world, tmp_path):
    path = tmp_path / "results.npz"
    stdout = _launch("repro_torch.launch.selftest", world, tmp_path,
                     "--scale", str(SCALE), "--out", str(path))
    assert "SELFTEST OK" in stdout
    got = np.load(path)
    # launch/selftest.py's graph: one partition per rank
    jeng = jax_engine(JPT.partition(JG.rmat(SCALE, 8, seed=7), world,
                                    "high"))
    lv, steps = JA.bfs(jeng, 0)
    pr = JA.pagerank(jeng, num_iterations=PR_ITERS)
    for backend in ("reference", "fused"):
        np.testing.assert_array_equal(got[f"{backend}/bfs"], lv,
                                      err_msg=backend)
        assert int(got[f"{backend}/bfs_steps"]) == steps, backend
        np.testing.assert_allclose(got[f"{backend}/pagerank"], pr,
                                   rtol=1e-5, atol=1e-8, err_msg=backend)
