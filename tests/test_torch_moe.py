"""The port's MoE layer (``models/moe.py``) against the JAX package's, on
the CPU.

Inputs are numpy draws from a seed; the expert weights are the JAX model's
own (``init_params`` from ``key(seed)``, one layer's slice).  Configs:
olmoe-1b-7b's and qwen3-moe-235b-a22b's ``SMOKE_CONFIG`` (8 experts, top
2, d_model 64, d_ff 128), at the config's capacity factor 1.25 and at 0.5,
where choices drop (asserted).

Routing is compared exactly: expert indices, ``keep`` and slots equal
JAX's (the JAX lines of ``repro/models/moe.py::moe_ffn`` with one data
shard, run here on the same logits), gates within 1e-6 relative (the two
softmaxes round their exponentials apart).  Ties: a zero router makes every
expert tie; ``jax.lax.top_k`` then takes experts 0..k-1, and so must the
port (``torch.topk`` does not), with the same tokens dropped past
capacity, checked through both packages' ``moe_ffn``.

Outputs: f32 ``rtol = atol = 1e-4``; bf16 ``tests/test_torch_lm.py``'s
``TOL`` (atol 0.1, rtol 0.05; the two round activations at different
places).
"""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_jaxref  # noqa: F401  (the JAX package, importable)

from repro_torch import configs as tconfigs
from repro_torch.models import moe as tmoe
from repro_torch.models.common import ArchConfig

ROOT = Path(__file__).resolve().parents[1]
JMOE = importlib.import_module("repro.models.moe")
JCFGS = {name: importlib.import_module(f"repro.configs.{name}").SMOKE_CONFIG
         for name in ("olmoe_1b_7b", "qwen3_moe_235b_a22b")}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.05, atol=0.1)}


def port_cfg(jcfg, **kw):
    return ArchConfig(**dict(dataclasses.asdict(jcfg), **kw))


def layer_params(jcfg, seed):
    """Layer 0's MoE leaves of the JAX model's ``init_params``: numpy f32."""
    import jax
    from repro.models import api as japi

    params = japi.build(jcfg).init(jax.random.key(seed))
    return {k: np.array(params["layers"][k][0], np.float32)
            for k in ("moe_wg", "moe_w1", "moe_w2")}


def jax_routing(logits, jcfg):
    """The routing lines of the JAX ``moe_ffn`` (one data shard) on
    ``logits [T, E]``: ``(gates, expert_idx, keep, slot, capacity)``."""
    import jax
    import jax.numpy as jnp

    t, e, k = logits.shape[0], jcfg.moe_experts, jcfg.moe_top_k
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    gates, idx = jax.lax.top_k(probs, k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    c = JMOE.capacity(t, jcfg)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = onehot.reshape(1, t * k, e)
    pos_flat = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.take_along_axis(pos_flat.reshape(t, k, e), idx[..., None],
                              axis=-1)[..., 0]
    keep = pos < c
    slot = jnp.where(keep, pos, c)
    return tuple(np.asarray(a) for a in (gates, idx, keep, slot)) + (c,)


def assert_same_routing(logits, jcfg):
    got = tmoe.route(torch.as_tensor(logits), port_cfg(jcfg))
    gates, idx, keep, slot, c = jax_routing(logits, jcfg)
    assert got.capacity == c
    np.testing.assert_array_equal(got.expert.numpy(), idx)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    np.testing.assert_array_equal(got.slot.numpy(), slot)
    np.testing.assert_allclose(got.gates.numpy(), gates, rtol=1e-6)
    return got


def run_both(jcfg, x, lp, dtype):
    """``moe_ffn`` of both packages on ``x [B, S, D]`` with ``lp`` (numpy
    f32), the weights cast to ``dtype`` as each model's layer casts them."""
    import jax.numpy as jnp

    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    want = JMOE.moe_ffn(jnp.asarray(x, jdt),
                        {k: jnp.asarray(v, jdt) for k, v in lp.items()},
                        jcfg)
    got = tmoe.moe_ffn(torch.as_tensor(x).to(tdt),
                       {k: torch.as_tensor(v).to(tdt)
                        for k, v in lp.items()}, port_cfg(jcfg))
    assert got.dtype == tdt and got.shape == x.shape
    return got.float().numpy(), np.asarray(want, np.float32)


def _arch(module_name):
    return next(a for a, m in tconfigs.ARCH_IDS.items() if m == module_name)


@pytest.mark.parametrize("tokens", [1, 4, 7, 31, 32, 33, 100, 1000, 8192])
@pytest.mark.parametrize("name", list(JCFGS))
@pytest.mark.parametrize("factor", [1.25, 0.5, 8.0])
def test_capacity_matches_jax(tokens, name, factor):
    """The smoke and the full configs (64 and 128 experts, top 8)."""
    jfull = importlib.import_module(f"repro.configs.{name}").CONFIG
    for jcfg, cfg in ((JCFGS[name], port_cfg(JCFGS[name])),
                      (jfull, tconfigs.get(_arch(name)))):
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=factor)
        cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
        assert tmoe.capacity(tokens, cfg) == JMOE.capacity(tokens, jcfg)


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("name", list(JCFGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_routing_matches_jax_on_the_same_logits(name, factor, seed):
    jcfg = dataclasses.replace(JCFGS[name], moe_capacity_factor=factor)
    logits = np.random.default_rng(seed).normal(
        size=(96, jcfg.moe_experts)).astype(np.float32) * 2
    r = assert_same_routing(logits, jcfg)
    if factor == 0.5:
        assert not bool(r.keep.all())       # choices dropped past capacity


@pytest.mark.parametrize("name", list(JCFGS))
def test_ties_go_to_the_lower_experts_as_in_jax(name):
    """Every expert ties: each token takes experts 0..k-1, gates 1/k; past
    capacity the later tokens drop, exactly as in JAX, routing and
    outputs."""
    jcfg = JCFGS[name]
    k = jcfg.moe_top_k
    t = 24                                   # capacity 8 < 24
    r = assert_same_routing(np.zeros((t, jcfg.moe_experts), np.float32),
                            jcfg)
    assert r.capacity == 8
    np.testing.assert_array_equal(r.expert.numpy(),
                                  np.tile(np.arange(k), (t, 1)))
    np.testing.assert_array_equal(r.keep.numpy(),
                                  np.arange(t)[:, None].repeat(k, 1) < 8)
    lp = layer_params(jcfg, seed=3)
    lp["moe_wg"] = np.zeros_like(lp["moe_wg"])
    x = np.random.default_rng(4).normal(size=(2, t // 2, jcfg.d_model)
                                        ).astype(np.float32)
    got, want = run_both(jcfg, x, lp, "float32")
    np.testing.assert_allclose(got, want, **TOL["float32"])
    dropped = got.reshape(t, -1)[8:]
    assert not dropped.any()                 # no expert kept these tokens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("name", list(JCFGS))
def test_moe_ffn_matches_jax(name, factor, dtype):
    jcfg = dataclasses.replace(JCFGS[name], moe_capacity_factor=factor)
    lp = layer_params(jcfg, seed=5)
    x = np.random.default_rng(6).normal(size=(2, 24, jcfg.d_model)).astype(
        np.float32)
    got, want = run_both(jcfg, x, lp, dtype)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if factor == 0.5:                        # choices dropped
        xt = torch.as_tensor(x).reshape(-1, jcfg.d_model)
        r = tmoe.route(tmoe.router_logits(
            xt, torch.as_tensor(lp["moe_wg"])), port_cfg(jcfg))
        assert not bool(r.keep.all())


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_gradients_match_jax(factor):
    """Through the assignment, the gather and the top-k values: the
    gradients of ``sum(moe_ffn(x)^2)`` to x and every leaf, the router's
    included, against ``jax.grad`` at f32, with and without drops."""
    import jax
    import jax.numpy as jnp

    jcfg = dataclasses.replace(JCFGS["olmoe_1b_7b"],
                               moe_capacity_factor=factor)
    lp = layer_params(jcfg, seed=7)
    x = np.random.default_rng(8).normal(size=(2, 24, jcfg.d_model)).astype(
        np.float32)

    def jloss(x, lp):
        return jnp.sum(JMOE.moe_ffn(x, lp, jcfg) ** 2)

    jgx, jglp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in lp.items()})
    tlp = {k: torch.as_tensor(v).requires_grad_() for k, v in lp.items()}
    tx = torch.as_tensor(x).requires_grad_()
    tmoe.moe_ffn(tx, tlp, port_cfg(jcfg)).square().sum().backward()
    for got, want in [(tx.grad, jgx)] + [(tlp[k].grad, jglp[k])
                                         for k in lp]:
        want = np.asarray(want)
        assert bool(got.abs().sum() > 0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_load_balance_loss_and_load_stats_match_jax(seed):
    import jax.numpy as jnp

    jcfg = JCFGS["qwen3_moe_235b_a22b"]
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(64, jcfg.moe_experts)).astype(np.float32)
    idx = rng.integers(0, jcfg.moe_experts, (64, jcfg.moe_top_k))
    want = JMOE.load_balance_loss(jnp.asarray(logits), jnp.asarray(idx),
                                  jcfg.moe_experts)
    got = tmoe.load_balance_loss(torch.as_tensor(logits),
                                 torch.as_tensor(idx), jcfg.moe_experts)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want = JMOE.expert_load_stats(jnp.asarray(logits), jcfg)
    got = tmoe.expert_load_stats(torch.as_tensor(logits), port_cfg(jcfg))
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_allclose(float(got["max_over_mean"]),
                               float(want["max_over_mean"]), rtol=1e-6)
    # ties: a zero router loads experts 0..k-1 only, as in JAX
    zero = np.zeros_like(logits)
    want = np.asarray(JMOE.expert_load_stats(jnp.asarray(zero), jcfg)[
        "counts"])
    got = tmoe.expert_load_stats(torch.as_tensor(zero), port_cfg(jcfg))
    np.testing.assert_array_equal(got["counts"].numpy(), want)
    assert want[:jcfg.moe_top_k].sum() == 64 * jcfg.moe_top_k


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-235b-a22b",
                                  "gemma3-4b", "deepseek-67b",
                                  "command-r-plus-104b", "tinyllama-1.1b"])
def test_configs_equal_jax_field_by_field(arch):
    from repro import configs as jconfigs

    for get, jget in ((tconfigs.get, jconfigs.get),
                      (tconfigs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))


@pytest.mark.parametrize("launcher,extra", [
    ("serve", ["--prompt-len", "16", "--gen", "4", "--layers", "2"]),
    ("train", ["--steps", "2", "--batch", "2", "--seq", "16"])])
def test_launchers_run_olmoe_on_the_cpu(launcher, extra, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if launcher == "train":
        extra = extra + ["--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch",
         "olmoe-1b-7b", "--smoke", "--device", "cpu"] + extra,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "arch=olmoe-1b-7b-smoke" in out.stdout
    assert launcher == "train" or "layers=2" in out.stdout
    assert ("decode:  12 tok" if launcher == "serve"
            else "done: final loss") in out.stdout
