"""The port's encoder-decoder (audio) and vision-language families on the
CPU against the JAX package's.

Configs: ``tests/test_models.py``'s ``audio`` (2 layers, an encoder of 2
non-causal layers, cross blocks, 4 KV heads) and ``vlm`` (8 patches
prepended, GQA 4/4) configs, and the ``SMOKE_CONFIG``s of
seamless-m4t-large-v2 and internvl2-26b (4 layers; internvl2's GQA 4/2).
The same JAX parameters (``init_params`` from ``key(seed)``) go into both
packages through ``convert.lm_params`` (serving) or
``convert.train_params`` (training), and the same inputs (``TokenStream``
or ``synth_batch``, drawn from numpy alike) through both.

Tolerances, as ``tests/test_torch_lm.py``'s: f32 compute ``rtol = atol =
1e-4`` on logits and caches; bf16 compute ``atol = 0.1, rtol = 0.05`` (the
packages round at other places: the port's prefill rounds P to bf16 before
P·V, as the Pallas kernel does, the JAX model keeps it in f32).  Loss at
f32 within 1e-5 relative and each gradient within 1e-4 of its largest
magnitude (``tests/test_torch_train.py``'s).  Front-end inputs, parameter
shapes and counts exactly.
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

from repro.models.common import ArchConfig as JArchConfig

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import serve
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as T
from repro_torch.models.common import ArchConfig
from repro_torch.optim import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
SEAMLESS = importlib.import_module("repro.configs.seamless_m4t_large_v2")
INTERNVL = importlib.import_module("repro.configs.internvl2_26b")


def _cfg(family, **kw):
    """``tests/test_models.py``'s ``_cfg``."""
    base = dict(name=f"t-{family}", family=family, n_layers=4, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                microbatches=1, compute_dtype="float32")
    base.update(kw)
    return JArchConfig(**base)


CFGS = {
    "audio": _cfg("audio", n_layers=2, n_kv_heads=4, enc_dec=True,
                  frontend="audio"),
    "vlm": _cfg("vlm", n_kv_heads=4, frontend="vision", frontend_len=8),
    "seamless-smoke": SEAMLESS.SMOKE_CONFIG,
    "internvl2-smoke": INTERNVL.SMOKE_CONFIG,
}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.05, atol=0.1)}
TRAIN = dict(seq=32, batch=4)
FRAMES = 24          # the prefill tests' encoder length


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


def front_inputs(jcfg, b, rng):
    """The prompt's front-end inputs as numpy f32: ``patches [b,
    frontend_len, d]`` (vision) or ``frames [b, FRAMES, d]`` (enc-dec)."""
    out = {}
    if jcfg.frontend == "vision":
        out["patches"] = (rng.normal(size=(b, jcfg.frontend_len,
                                           jcfg.d_model)) * 0.02)
    if jcfg.enc_dec:
        out["frames"] = rng.normal(size=(b, FRAMES, jcfg.d_model)) * 0.02
    return {k: v.astype(np.float32) for k, v in out.items()}


# -- inputs --------------------------------------------------------------

@pytest.mark.parametrize("name", ["seamless-smoke", "internvl2-smoke",
                                  "audio"])
@pytest.mark.parametrize("seed,step,seq", [(0, 0, 50), (3, 2, 9)])
def test_token_stream_front_end_inputs_match_jax(name, seed, step, seq):
    from repro.data.tokens import TokenStream as JTokenStream

    jcfg = CFGS[name]
    want = JTokenStream(jcfg, 3, seq, seed=seed).batch_at(step)
    got = TokenStream(port_cfg(jcfg), 3, seq, seed=seed).batch_at(step)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].dtype == (torch.int32 if key == "tokens"
                                  else torch.float32)
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))
    front = "patches" if jcfg.frontend == "vision" else "frames"
    assert got[front].shape[1] == (jcfg.frontend_len if front == "patches"
                                   else min(seq, 4096))


@pytest.mark.parametrize("name", ["seamless-smoke", "internvl2-smoke"])
@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_synth_batch_front_end_inputs_match_jax(name, kind):
    """``input_specs`` and ``synth_batch``: the same keys, shapes, dtypes
    and draws in JAX's order (sorted keys), frames ``min(S, 4096)`` long to
    train and 4096 to prefill."""
    from repro.models import api as japi

    jcfg = CFGS[name]
    want = japi.synth_batch(jcfg, japi.ShapeSpec("t", kind, **TRAIN),
                            seed=5)
    shape = tapi.ShapeSpec("t", kind, **TRAIN)
    got = tapi.synth_batch(port_cfg(jcfg), shape, seed=5, device="cpu")
    specs = tapi.input_specs(port_cfg(jcfg), shape)
    assert list(got) == sorted(want) == sorted(specs)
    for key, w in want.items():
        assert tuple(got[key].shape) == specs[key].shape == w.shape
        assert got[key].dtype == specs[key].dtype
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(w))
    if jcfg.enc_dec:
        assert got["frames"].shape[1] == (TRAIN["seq"] if kind == "train"
                                          else 4096)
    # decode specs (item 15b): the cache JAX's init_cache(B, S) makes, no
    # cross caches (an encoder's length is not a decode input)
    dec = tapi.input_specs(port_cfg(jcfg), tapi.ShapeSpec("t", "decode", 8, 1))
    assert sorted(dec["cache"]) == ["k", "len", "v"]


# -- parameters ----------------------------------------------------------

@pytest.mark.parametrize("arch,want", [
    ("seamless-m4t-large-v2", 1_773_477_888),
    ("internvl2-26b", 19_330_363_392)])
def test_parameter_shapes_and_counts_match_jax(arch, want):
    """The full configs' module (on the meta device: nothing allocated)
    has every leaf of JAX's ``init_params`` under ``jax.eval_shape``, each
    layer of a stack apart, with the same shape, and no other."""
    import jax
    from repro.models import api as japi
    from repro import configs as jconfigs

    for get, jget in ((tconfigs.get, jconfigs.get),
                      (tconfigs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        shapes = japi.build(jcfg).params_shape()
        jcount = sum(int(np.prod(x.shape))
                     for x in jax.tree.leaves(shapes))
        module = T.Transformer(cfg, torch.device("meta"))
        got = {n: tuple(p.shape) for n, p in module.named_parameters()}
        expect = {}
        for key, leaf in shapes.items():
            if isinstance(leaf, dict):
                for name, x in leaf.items():
                    for i in range(x.shape[0]):
                        expect[f"{key}.{i}.{name}"] = tuple(x.shape[1:])
            else:
                expect[key] = tuple(leaf.shape)
        assert got == expect
        assert sum(p.numel() for p in module.parameters()) == jcount
        if get is tconfigs.get:
            assert jcount == want


@pytest.mark.parametrize("name", ["audio", "vlm", "seamless-smoke"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(name, dtype):
    """JAX pytree → module state: every weight, the encoder's, the cross
    block's and ``frontend_proj`` included, equals the JAX one rounded to
    the dtype the module stores it in; ``final_norm`` and ``enc_norm`` stay
    f32.  A tree whose encoder, ``enc_norm``, ``frontend_proj`` or cross
    leaves do not match the config is refused."""
    jcfg = dataclasses.replace(CFGS[name], compute_dtype=dtype)
    _, params = jax_model(jcfg, seed=2)
    model = port_model(jcfg, params)
    state = model.module.state_dict()
    cdt = getattr(torch, dtype)

    def want(x, dt=cdt):
        return torch.as_tensor(np.array(x, np.float32)).to(dt)

    assert set(state) == set(convert.lm_params(params, port_cfg(jcfg)))
    for key in ("final_norm", "enc_norm"):
        if key in params:
            assert torch.equal(state[key], want(params[key], torch.float32))
    assert torch.equal(state["frontend_proj"], want(params["frontend_proj"]))
    for stack in ("layers", "encoder"):
        for leaf, st in params.get(stack, {}).items():
            for i in range(jcfg.n_layers):
                got = state[f"{stack}.{i}.{leaf}"]
                assert got.dtype == cdt
                assert torch.equal(got, want(np.asarray(st)[i]))
    cfg = port_cfg(jcfg)
    for key in ("frontend_proj", "encoder", "enc_norm"):
        if key in params:
            with pytest.raises(ValueError, match=f"{key} missing"):
                convert.lm_params({k: v for k, v in params.items()
                                   if k != key}, cfg)
    if not cfg.enc_dec:
        with pytest.raises(ValueError, match="encoder given"):
            convert.lm_params(dict(params, encoder=params["layers"]), cfg)
        return
    # a decoder without its cross leaves, and an encoder with them
    plain = {k: v for k, v in params["layers"].items()
             if not k.endswith("_x")}
    with pytest.raises(ValueError, match="layer leaves"):
        convert.lm_params(dict(params, layers=plain), cfg)
    with pytest.raises(ValueError, match="encoder layer leaves"):
        convert.lm_params(dict(params, encoder=params["layers"]), cfg)
    enc = params["encoder"]
    with pytest.raises(ValueError, match="encoder.w_up: shape"):
        convert.lm_params(dict(params, encoder=dict(enc, w_up=enc["w_down"])),
                          cfg)


@pytest.mark.parametrize("name", ["audio", "vlm"])
def test_train_params_are_the_serving_weights(name):
    """``init_train_params`` draws what ``build`` draws into a module (the
    encoder, ``enc_norm`` and ``frontend_proj`` in the module's order), so
    trained parameters load into a serving model; the JAX tree's keys."""
    cfg = port_cfg(CFGS[name])
    served = tapi.build(cfg, "cpu", torch.Generator().manual_seed(4))
    params = served.init_params(torch.Generator().manual_seed(4))
    _, jparams = jax_model(CFGS[name], seed=0)
    assert sorted(params) == sorted(jparams)
    assert sorted(params["layers"]) == sorted(jparams["layers"])
    state = served.module.state_dict()
    loaded = convert.lm_params(params, cfg)
    assert set(loaded) == set(state)
    for key, w in loaded.items():
        assert torch.equal(state[key], w.to(state[key].dtype)), key
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))


# -- cross attention -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,g,r", [(7, 13, 2, 3), (1, 24, 4, 1),
                                         (16, 16, 1, 4)])
def test_cross_attention_matches_jax(sq, skv, g, r, dtype):
    import jax.numpy as jnp
    from repro.models.attention import cross_attention as jcross

    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, g, r, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, g, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, g, 16)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    want = jcross(*(jnp.asarray(a, jdt) for a in (q, k, v)))
    tdt = getattr(torch, dtype)
    got = tattn.cross_attention(*(torch.as_tensor(a).to(tdt)
                                  for a in (q, k, v)))
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(
        rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(f32(got), f32(want), **tol)
    if dtype == "float32":
        # float64 stays float64 (the chip script's yardsticks)
        got64 = tattn.cross_attention(*(torch.as_tensor(a).double()
                                        for a in (q, k, v)))
        assert got64.dtype == torch.float64
        np.testing.assert_allclose(got64.numpy(), f32(want), rtol=1e-5,
                                   atol=1e-6)


def test_chunked_attention_runs_the_plain_version_non_causal():
    """On a CPU tensor ``chunked_attention(causal=False)`` is the JAX
    model's non-causal ``chunked_attention`` (the encoder's attention); the
    window is ignored there, as in JAX."""
    import jax.numpy as jnp
    from repro.models.attention import chunked_attention as jchunked

    rng = np.random.default_rng(1)
    q = rng.normal(size=(2, 24, 2, 1, 16)).astype(np.float32)
    k = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 24, 2, 16)).astype(np.float32)
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=False, q_chunk=8, k_chunk=12)
    for window in (0, 5):
        got = tattn.chunked_attention(*map(torch.as_tensor, (q, k, v)),
                                      causal=False, window=window,
                                      q_chunk=8, k_chunk=12)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# -- serving ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_match_jax(name, dtype):
    """Prefill (logits, ``k``, ``v``, ``xk``, ``xv``, ``len``) and four
    greedy decode steps, both fed the JAX model's tokens."""
    import jax.numpy as jnp

    jcfg = dataclasses.replace(CFGS[name], compute_dtype=dtype)
    jm, params = jax_model(jcfg, seed=1)
    tm = port_model(jcfg, params)
    tol = TOL[dtype]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    front = front_inputs(jcfg, 2, rng)
    n_front = jcfg.frontend_len if jcfg.frontend == "vision" else 0
    jb = {"tokens": jnp.asarray(toks[:, :32]),
          **{k: jnp.asarray(v) for k, v in front.items()}}
    tb = {"tokens": torch.as_tensor(toks[:, :32]),
          **{k: torch.as_tensor(v) for k, v in front.items()}}
    jl, jc = jm.prefill(params, jb, max_len=40 + n_front)
    tl, tc = tm.prefill(tb, max_len=40 + n_front)
    assert tl.shape == (2, jcfg.vocab) and tl.dtype == getattr(torch, dtype)
    assert sorted(k for k in tc) == sorted(jc)
    assert tc["len"] == int(jc["len"]) == 32 + n_front
    np.testing.assert_allclose(f32(tl), f32(jl), **tol)
    for key in [k for k in jc if k != "len"]:
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
        np.testing.assert_allclose(f32(tc[key]), f32(jc[key]), **tol)
    if jcfg.enc_dec:
        assert tc["xk"].shape[2] == FRAMES
    xk = tc.get("xk", torch.zeros(0)).clone()
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
    assert tc["len"] == int(jc["len"]) == 36 + n_front
    for key in ("k", "v"):
        np.testing.assert_allclose(f32(tc[key]), f32(jc[key]), **tol)
    # decode steps read the cross caches and never write them
    assert torch.equal(tc.get("xk", torch.zeros(0)), xk)


@pytest.mark.parametrize("name", ["audio", "vlm"])
def test_decode_matches_prefill_shifted(name):
    """Within the port: decoding token t after ``prefill(tokens[:, :t])``
    gives the last logits of ``prefill(tokens[:, :t + 1])`` with the same
    patches or frames (``tests/test_models.py``'s check and tolerance); a
    VLM cache counts the patches, so it is full at ``S + frontend_len``."""
    cfg = port_cfg(CFGS[name])
    model = tapi.build(cfg, "cpu", torch.Generator().manual_seed(5))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, 256, (2, 9)))
    front = {k: torch.as_tensor(v)
             for k, v in front_inputs(cfg, 2, rng).items()}
    n_front = cfg.frontend_len if cfg.frontend == "vision" else 0
    _, cache = model.prefill({"tokens": toks[:, :8], **front},
                             max_len=9 + n_front)
    assert cache["len"] == 8 + n_front
    lg_b, _ = model.decode_step(cache, toks[:, 8])
    lg_full, _ = model.prefill({"tokens": toks, **front})
    torch.testing.assert_close(lg_b, lg_full, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="full"):
        model.decode_step(cache, toks[:, 8])


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_generate_sizes_the_cache_for_the_prompt_batch(arch):
    """``generate`` takes the whole prompt batch (its patches or frames);
    a VLM's cache holds ``S + gen + frontend_len`` slots, as JAX's
    ``launch/serve.py`` sizes it, so every decode step has a slot."""
    cfg = tconfigs.get_smoke(arch)
    model = tapi.build(cfg, "cpu")
    batch = TokenStream(cfg, 2, 8).batch_at(0)
    prompt = {k: (v[:, :8] if k == "tokens" else v) for k, v in batch.items()}
    out = serve.generate(model, prompt, 5)["tokens"]
    assert out.shape == (2, 5)
    logits, _ = model.prefill(prompt)
    assert torch.equal(out[:, 0], logits.argmax(-1))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
@pytest.mark.parametrize("launcher,extra,expect", [
    ("serve", ["--prompt-len", "16", "--gen", "4"], "decode:  12 tok"),
    ("train", ["--steps", "2", "--batch", "2", "--seq", "16"],
     "done: final loss")])
def test_launchers_run_on_the_cpu(arch, launcher, extra, expect, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if launcher == "train":
        extra = extra + ["--ckpt-dir", str(tmp_path / "ck")]
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{launcher}", "--arch",
         arch, "--smoke", "--device", "cpu"] + extra,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"arch={arch}-smoke" in out.stdout
    assert expect in out.stdout


# -- training --------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_loss_and_gradients_match_jax_at_f32(name):
    """``loss_fn`` and its gradients (the encoder's, the cross blocks' and
    ``frontend_proj``'s included) against ``jax.value_and_grad`` on the
    same parameters and ``synth_batch``."""
    import jax
    from repro.models import api as japi

    jcfg = dataclasses.replace(CFGS[name], compute_dtype="float32")
    jm, jp = jax_model(jcfg, seed=0)
    tm = tapi.build(port_cfg(jcfg), "cpu", serve=False)
    tp = convert.train_params(jax.tree.map(np.asarray, jp), "cpu")
    batch = japi.synth_batch(jcfg, japi.ShapeSpec("t", "train", **TRAIN),
                             seed=1)
    jl, jg = jax.value_and_grad(jm.loss)(jp, batch)
    tb = tapi.synth_batch(tm.cfg, tapi.ShapeSpec("t", "train", **TRAIN),
                          seed=1, device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32
        assert float(np.abs(w).max()) > 0       # every leaf is on the path
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("name", ["audio", "vlm"])
def test_microbatches_cut_the_front_end_inputs(name):
    """``accumulate_grads`` cuts ``frames`` and ``patches`` with the
    tokens: two microbatches give the one-batch gradient of their mean."""
    cfg = port_cfg(CFGS[name])
    model = tapi.build(cfg, "cpu", serve=False)
    params = model.init_params(torch.Generator().manual_seed(2))
    batch = tapi.synth_batch(cfg, tapi.ShapeSpec("t", "train", 16, 4),
                             seed=3, device="cpu")
    one, l1 = tapi.accumulate_grads(model, params, batch, 1)
    two, l2 = tapi.accumulate_grads(model, params, batch, 2)
    torch.testing.assert_close(l2.mean(), l1[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(two), tree_leaves(one)):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
