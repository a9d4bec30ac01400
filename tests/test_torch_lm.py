"""The port's LM serving path on the CPU against the JAX package's.

The same JAX parameters (``init_params`` from ``key(seed)``) go into both
models through ``convert.lm_params``; the same prompt goes through
``prefill`` and four greedy ``decode_step``s (both sides fed the JAX
model's tokens, so the comparison continues past a near-tie).  Configs:
tinyllama reduced with GQA and an untied head (``CONFIG.reduced(
n_kv_heads=2, tie_embeddings=False)``), its ``SMOKE_CONFIG`` (tied head,
no grouping), a gemma3-style 5:1 local/global pattern (layer windows
below the prompt length), and the ``SMOKE_CONFIG``s of olmoe-1b-7b and
qwen3-moe-235b-a22b (MoE layers, 8 experts top 2, tokens dropped past
capacity in the prefill as in JAX) and gemma3-4b (2:1 local/global).

Tolerances.  f32 compute: ``rtol = atol = 1e-4`` on logits and caches
(measured max |diff| about 2e-6).  bf16 compute: ``atol = 0.1, rtol =
0.05``.  Measured over four seeds of the GQA and local/global configs:
max |diff| 0.07 on logits of magnitude 2-3, a few bf16 ulps.  The two
sides round at different places: XLA on the CPU rounds each step of
``silu`` (``1 / (1 + exp(-x))``) to bf16, and PyTorch rounds it once.
Greedy tokens are equal except where the JAX model's two top logits lie
within twice that tolerance.
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
from repro_torch import convert
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import serve
from repro_torch.launch import train as ltrain
from repro_torch.models import api as tapi
from repro_torch.models.common import ArchConfig

ROOT = Path(__file__).resolve().parents[1]
JC = importlib.import_module("repro.configs.tinyllama_1_1b")
JSMOKE = {name: importlib.import_module(f"repro.configs.{name}").SMOKE_CONFIG
          for name in ("olmoe_1b_7b", "qwen3_moe_235b_a22b", "gemma3_4b")}

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.05, atol=0.1)}
CFGS = {
    "gqa-untied": JC.CONFIG.reduced(n_kv_heads=2, tie_embeddings=False),
    "smoke-tied": JC.SMOKE_CONFIG,
    "local-global": JC.CONFIG.reduced(n_kv_heads=2, tie_embeddings=False,
                                      n_layers=6, local_window=8,
                                      local_global_ratio=5),
    "olmoe-smoke": JSMOKE["olmoe_1b_7b"],
    "qwen3-moe-smoke": JSMOKE["qwen3_moe_235b_a22b"],
    "gemma3-smoke": JSMOKE["gemma3_4b"],
}


def port_cfg(jcfg, **kw):
    return ArchConfig(**dict(dataclasses.asdict(jcfg), **kw))


def jax_model(jcfg, seed):
    import jax
    from repro.models import api as japi

    model = japi.build(jcfg)
    return model, model.init(jax.random.key(seed))


def port_model(jcfg, params):
    cfg = port_cfg(jcfg)
    model = tapi.build(cfg, "cpu")
    model.module.load_state_dict(convert.lm_params(params, cfg))
    return model


def f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float32)


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 1)])
def test_token_stream_matches_jax(seed, step):
    from repro.data.tokens import TokenStream as JTokenStream

    cfg = JC.CONFIG
    want = np.asarray(JTokenStream(cfg, 3, 50, seed=seed).batch_at(step)[
        "tokens"])
    got = TokenStream(port_cfg(cfg), 3, 50, seed=seed).batch_at(step)[
        "tokens"]
    assert got.dtype == torch.int32 and got.shape == (3, 51)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["gqa-untied", "smoke-tied",
                                  "qwen3-moe-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(name, dtype):
    """JAX pytree → module state → back: every weight equals the JAX one,
    rounded to the dtype the module stores it in, in the ``[in, out]``
    layout; the final norm stays f32."""
    jcfg = dataclasses.replace(CFGS[name], compute_dtype=dtype)
    _, params = jax_model(jcfg, seed=2)
    model = port_model(jcfg, params)
    state = model.module.state_dict()
    cdt = getattr(torch, dtype)

    def want(x, dt=cdt):
        return torch.as_tensor(np.array(x, np.float32)).to(dt)

    assert torch.equal(state["embed"], want(params["embed"]))
    assert torch.equal(state["final_norm"],
                       want(params["final_norm"], torch.float32))
    for name_, stack in params["layers"].items():
        for i in range(jcfg.n_layers):
            got = state[f"layers.{i}.{name_}"]
            assert got.dtype == cdt
            assert torch.equal(got, want(np.asarray(stack)[i]))
    assert ("lm_head" in state) == (not jcfg.tie_embeddings)
    if not jcfg.tie_embeddings:
        assert torch.equal(state["lm_head"], want(params["lm_head"]))
    cfg = port_cfg(jcfg)
    with pytest.raises(ValueError, match="tie_embeddings"):
        convert.lm_params(dict(params, lm_head=params["embed"].T)
                          if jcfg.tie_embeddings else
                          {k: v for k, v in params.items()
                           if k != "lm_head"}, cfg)
    with pytest.raises(ValueError, match="shape"):
        convert.lm_params(params, dataclasses.replace(cfg, d_ff=cfg.d_ff * 2))
    if cfg.is_moe:
        # the stacked experts [L, E, ...] are checked against cfg
        assert state["layers.0.moe_w1"].shape == (
            cfg.moe_experts, cfg.d_model, 2 * cfg.d_ff)
        with pytest.raises(ValueError, match="moe_wg: shape"):
            convert.lm_params(params, dataclasses.replace(
                cfg, moe_experts=cfg.moe_experts * 2))
    # a dense config given MoE leaves, or the other way round
    with pytest.raises(ValueError, match="layer leaves"):
        convert.lm_params(params, dataclasses.replace(
            cfg, moe_experts=0 if cfg.is_moe else 8,
            moe_top_k=0 if cfg.is_moe else 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_match_jax(name, dtype):
    import jax.numpy as jnp

    jcfg = dataclasses.replace(CFGS[name], compute_dtype=dtype)
    jm, params = jax_model(jcfg, seed=1)
    tm = port_model(jcfg, params)
    tol = TOL[dtype]
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 33)).astype(
        np.int32)
    jl, jc = jm.prefill(params, {"tokens": jnp.asarray(toks[:, :32])},
                        max_len=40)
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks[:, :32])},
                        max_len=40)
    assert tl.shape == (2, jcfg.vocab) and tl.dtype == getattr(torch, dtype)
    assert tc["k"].shape == tuple(jc["k"].shape) and tc["len"] == 32
    # An MoE model at bf16: a token whose k-th and (k+1)-th router
    # probabilities lie within the two packages' bf16 rounding of the
    # activations (a gap of 2.8e-4 at layer 1, token 16, here) may take
    # another expert in each, so its k and v diverge after the first MoE
    # layer; the caches are held below it, the logits everywhere.
    layers = 1 if jcfg.is_moe and dtype == "bfloat16" else jcfg.n_layers
    np.testing.assert_allclose(f32(tl), f32(jl), **tol)
    np.testing.assert_allclose(f32(tc["k"][:layers]),
                               f32(jc["k"][:layers]), **tol)
    np.testing.assert_allclose(f32(tc["v"][:layers]),
                               f32(jc["v"][:layers]), **tol)
    token = toks[:, 32]
    for _ in range(4):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(token))
        tl, tc = tm.decode_step(tc, torch.as_tensor(token))
        np.testing.assert_allclose(f32(tl), f32(jl), **tol)
        want = f32(jl)
        jtok, ttok = want.argmax(-1), f32(tl).argmax(-1)
        top2 = np.sort(want, -1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * (
            tol["atol"] + tol["rtol"] * np.abs(top2[:, 1]))
        assert ((jtok == ttok) | near_tie).all()
        token = jtok.astype(np.int32)
    assert tc["len"] == int(jc["len"]) == 36
    np.testing.assert_allclose(f32(tc["k"][:layers]), f32(jc["k"][:layers]),
                               **tol)


def test_decode_matches_prefill_shifted():
    """Within the port: decoding token t after ``prefill(tokens[:, :t])``
    gives the last logits of ``prefill(tokens[:, :t + 1])``
    (``tests/test_models.py``'s check, same tolerance)."""
    cfg = port_cfg(CFGS["gqa-untied"], compute_dtype="float32")
    model = tapi.build(cfg, "cpu", torch.Generator().manual_seed(5))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 9)))
    _, cache = model.prefill({"tokens": toks[:, :8]}, max_len=9)
    lg_b, _ = model.decode_step(cache, toks[:, 8])
    lg_full, _ = model.prefill({"tokens": toks}, max_len=9)
    torch.testing.assert_close(lg_b, lg_full, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="full"):
        model.decode_step(cache, toks[:, 8])


def test_generate_samples_reproducibly_from_its_generator():
    cfg = tconfigs.get_smoke("tinyllama-1.1b")
    model = tapi.build(cfg, "cpu")
    prompt = {"tokens": TokenStream(cfg, 2, 8).batch_at(0)["tokens"][:, :8]}
    runs = [serve.generate(model, prompt, 5, temperature=1.0,
                           generator=torch.Generator().manual_seed(7))
            for _ in range(2)]
    assert runs[0]["tokens"].shape == (2, 5)
    assert torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    greedy = serve.generate(model, prompt, 5)["tokens"]
    logits, _ = model.prefill(prompt, max_len=13)
    assert torch.equal(greedy[:, 0], logits.argmax(-1))


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--prompt-len", "16", "--gen", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "prefill: 64 tok" in out.stdout
    assert "decode:  12 tok" in out.stdout


def test_unported_families_raise_naming_the_roadmap_item(monkeypatch):
    # every family is ported: the SSM and hybrid configs load and build
    for arch, family in (("xlstm-125m", "ssm"), ("zamba2-2.7b", "hybrid")):
        assert tconfigs.get(arch).family == family
    assert tconfigs.get("tinyllama-1.1b").n_layers == 22
    # the encoder-decoder and vision families are ported
    assert tconfigs.get("seamless-m4t-large-v2").enc_dec
    assert tconfigs.get("internvl2-26b").frontend == "vision"
    base = port_cfg(CFGS["gqa-untied"])
    for kw in (dict(family="hybrid", ssm_state=16, attn_every=2),
               dict(family="ssm", slstm_every=2)):
        assert tapi.build(dataclasses.replace(base, **kw), "cpu").module
    # item 15b is ported: decode input specs hold the cache's specs, and
    # the production mesh raises naming the world's size without 256 ranks
    specs = tapi.input_specs(base, tapi.ShapeSpec("t", "decode", 8, 1))
    assert specs["tokens"].shape == (1,)
    assert specs["cache"]["k"].shape == (base.n_layers, 1, 8,
                                         base.n_kv_heads, base.hd)
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        ltrain.build_everything("tinyllama-1.1b", True, 2, 8, 1, 1e-3, True,
                                "cpu")
    for kw in (dict(family="audio", enc_dec=True, frontend="audio"),
               dict(family="vlm", frontend="vision", frontend_len=4)):
        assert tapi.build(dataclasses.replace(base, **kw), "cpu").module
    vision = TokenStream(dataclasses.replace(base, family="vlm",
                                             frontend="vision",
                                             frontend_len=4), 1, 4)
    assert vision.batch_at(0)["patches"].shape == (1, 4, base.d_model)
    # training is ported: the loss of the dense model is finite
    model = tapi.build(base, "cpu")
    loss = model.loss(model.init_params(), {"tokens": TokenStream(
        base, 2, 8).batch_at(0)["tokens"]})
    assert loss.dim() == 0 and torch.isfinite(loss)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.build(base)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])
