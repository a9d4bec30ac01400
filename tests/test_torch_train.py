"""The port's LM training path against the JAX package's, on the CPU.

The model is tinyllama-1.1b's ``SMOKE_CONFIG`` (4 layers, d_model 64,
vocab 256, a tied head), its untied GQA variant and olmoe-1b-7b's
``SMOKE_CONFIG`` (MoE layers, 8 experts top 2); the same JAX
parameters go into both packages through ``convert.train_params``, and
the same batches come from ``synth_batch`` (the same numpy draws).

Tolerances:

- ``loss_fn`` and its gradients against ``jax.value_and_grad``: at f32
  compute the loss within 1e-5 relative and each gradient within 1e-4 of
  its largest magnitude (measured: 2e-7 and 1.1e-6); at bf16 compute the
  loss within 2e-2 absolute (measured 7e-4; the two sides round the
  activations at different places);
- ``make_train_step`` against JAX's jitted step at f32 compute: parameters,
  moments and metrics within ``rtol=1e-5`` (``atol`` 1e-5 of each leaf's
  largest magnitude, for the entries near zero), with AdamW's ``eps`` at
  1e-3.  The first update of an entry is ``-lr·g/(|g| + eps)``, so a
  gradient difference ``δg`` moves it by up to ``lr·δg/eps``: gradients
  near zero differ by 3e-9 between the packages (1e-7 of the largest
  gradient, the f32 difference above), which at the default eps of 1e-8
  moves such an entry by up to 0.26·lr, and at 1e-4 by 3e-7 on
  parameters of 1e-2, past 1e-5 relative.  At the default ``eps`` the step is held on
  its metrics and moments, which are linear in the gradients, and the
  update on identical gradients is held by the AdamW test;
- ``AdamW`` and ``global_norm`` on random trees within 1e-6;
- ``compress_int8``: bit for bit; ``CompressedAllReduce`` over a gloo world
  of 2 against numpy within 1e-6 (the same f32 operations);
- a restarted ``launch/train.py`` run equals the run without failures bit
  for bit (the CPU sums in a fixed order).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import test_torch_jaxref  # noqa: F401  (the JAX package, importable)

from repro_torch import convert
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models.common import ArchConfig, cross_entropy_loss
from repro_torch.optim import (AdamW, CompressedAllReduce, apply_updates,
                               compress_int8, decompress_int8, global_norm,
                               tree_leaves)

JC = importlib.import_module("repro.configs.tinyllama_1_1b")
SMOKE = JC.SMOKE_CONFIG
UNTIED = JC.CONFIG.reduced(n_kv_heads=2, tie_embeddings=False)
OLMOE = importlib.import_module("repro.configs.olmoe_1b_7b").SMOKE_CONFIG
TRAIN = dict(seq=32, batch=4)


def _jax():
    import jax
    import jax.numpy as jnp
    from repro.models import api as japi
    from repro.optim import adamw as jadamw
    from repro.optim import compression as jcomp
    return jax, jnp, japi, jadamw, jcomp


def port_cfg(jcfg, **kw):
    return ArchConfig(**dict(dataclasses.asdict(jcfg), **kw))


def _shape(kind="train"):
    return tapi.ShapeSpec("t", kind, TRAIN["seq"], TRAIN["batch"])


def _setup(jcfg, seed=0):
    """``(JAX model, JAX params, port model, port params)``."""
    jax, _, japi, _, _ = _jax()
    jm = japi.build(jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = tapi.build(port_cfg(jcfg), "cpu", serve=False)
    tp = convert.train_params(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _close(got, want, rtol, atol_frac):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_frac * max(np.abs(want).max(), 1e-30))


# -- loss and gradients ------------------------------------------------------

@pytest.mark.parametrize("with_mask", [False, True])
def test_cross_entropy_matches_jax(with_mask):
    _, jnp, _, _, _ = _jax()
    from repro.models.common import cross_entropy_loss as jce

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, size=(3, 5))
    mask = (rng.random((3, 5)) > 0.3).astype(np.float32) if with_mask \
        else None
    want = jce(jnp.asarray(logits), jnp.asarray(labels),
               None if mask is None else jnp.asarray(mask))
    got = cross_entropy_loss(torch.as_tensor(logits),
                             torch.as_tensor(labels),
                             None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name,jcfg", [("smoke", SMOKE),
                                       ("untied", UNTIED),
                                       ("olmoe", OLMOE)])
def test_loss_and_gradients_match_jax_at_f32(name, jcfg):
    jax, _, japi, _, _ = _jax()
    jcfg = dataclasses.replace(jcfg, compute_dtype="float32")
    jm, jp, tm, tp = _setup(jcfg)
    batch = japi.synth_batch(jcfg, japi.ShapeSpec("t", "train", **TRAIN),
                             seed=1)
    jl, jg = jax.value_and_grad(jm.loss)(jp, batch)
    tb = tapi.synth_batch(tm.cfg, _shape(), seed=1, device="cpu")
    np.testing.assert_array_equal(tb["tokens"].numpy(),
                                  np.asarray(batch["tokens"]))
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        assert g.dtype == torch.float32          # f32 leaves, f32 grads
        _close(g, w, 0, 1e-4)


def test_loss_matches_jax_at_bf16():
    jax, _, japi, _, _ = _jax()
    jm, jp, tm, tp = _setup(SMOKE)
    assert SMOKE.compute_dtype == "bfloat16"
    batch = japi.synth_batch(SMOKE, japi.ShapeSpec("t", "train", **TRAIN),
                             seed=2)
    jl = jm.loss(jp, batch)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss = tm.loss(tp, tapi.synth_batch(tm.cfg, _shape(), seed=2,
                                        device="cpu"))
    assert abs(float(loss) - float(jl)) < 2e-2
    grads = torch.autograd.grad(loss, leaves)
    # the bf16 casts are inside the graph; the leaves and grads stay f32
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


def test_remat_leaves_the_gradients_unchanged():
    cfg = port_cfg(SMOKE, compute_dtype="float32")
    out = []
    for remat in (True, False):
        tm = tapi.build(dataclasses.replace(cfg, remat=remat), "cpu",
                        serve=False)
        tp = tm.init_params(torch.Generator().manual_seed(3))
        leaves = [p.requires_grad_() for p in tree_leaves(tp)]
        loss = tm.loss(tp, tapi.synth_batch(tm.cfg, _shape(), seed=3,
                                            device="cpu"))
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window,chunks", [(0, (8, 4)), (5, (16, 8)),
                                           (0, (32, 32))])
def test_training_attention_matches_the_jax_model(window, chunks):
    _, jnp, _, _, _ = _jax()
    from repro.models.attention import chunked_attention as jchunked

    rng = np.random.default_rng(window)
    q = rng.normal(size=(2, 32, 2, 3, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    window=window, q_chunk=chunks[0], k_chunk=chunks[1])
    tq = torch.as_tensor(q).requires_grad_()
    got = tattn.training_attention(tq, torch.as_tensor(k),
                                   torch.as_tensor(v), window=window,
                                   q_chunk=chunks[0], k_chunk=chunks[1])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    got.sum().backward()
    assert tq.grad is not None and torch.isfinite(tq.grad).all()


def test_flash_route_refuses_an_input_that_requires_grad():
    q = torch.zeros(1, 8, 1, 2, 16, requires_grad=True)
    k = torch.zeros(1, 8, 1, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        tattn.chunked_attention(q, k, k)
    with torch.no_grad():
        assert tattn.chunked_attention(q, k, k).shape == q.shape


def test_train_params_are_the_serving_weights():
    """``init_train_params`` draws what ``build`` draws into a module, so
    trained parameters load into a serving model (``convert.lm_params``)."""
    cfg = port_cfg(UNTIED)
    served = tapi.build(cfg, "cpu", torch.Generator().manual_seed(4))
    params = served.init_params(torch.Generator().manual_seed(4))
    state = served.module.state_dict()
    for name, w in convert.lm_params(params, cfg).items():
        assert torch.equal(state[name], w.to(state[name].dtype)), name
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))


def test_synth_batch_matches_jax():
    _, _, japi, _, _ = _jax()
    for kind in ("train", "prefill"):
        want = japi.synth_batch(SMOKE, japi.ShapeSpec("t", kind, **TRAIN),
                                seed=5)
        got = tapi.synth_batch(port_cfg(SMOKE), _shape(kind), seed=5,
                               device="cpu")
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        assert got["tokens"].dtype == torch.int32
    dec = tapi.input_specs(port_cfg(SMOKE), _shape("decode"))   # item 15b
    assert dec["tokens"].shape == (TRAIN["batch"],)


# -- the train step ----------------------------------------------------------

@pytest.mark.parametrize("steps,mb,eps", [(1, 1, 1e-3), (2, 1, 1e-3),
                                          (2, 2, 1e-3), (1, 2, 1e-8)])
def test_train_step_matches_jax(steps, mb, eps):
    jax, _, japi, jadamw, _ = _jax()
    jcfg = dataclasses.replace(UNTIED, compute_dtype="float32")
    jm, jp, tm, tp = _setup(jcfg, seed=6)
    jopt = jadamw.AdamW(learning_rate=1e-2, warmup_steps=2, eps=eps)
    topt = AdamW(learning_rate=1e-2, warmup_steps=2, eps=eps)
    jstep = jax.jit(japi.make_train_step(jm, jopt, microbatches=mb))
    tstep = tapi.make_train_step(tm, topt, microbatches=mb)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        batch = japi.synth_batch(jcfg, japi.ShapeSpec("t", "train", **TRAIN),
                                 seed=10 + i)
        jp, jstate, jmet = jstep(jp, jstate, batch)
        tp, tstate, tmet = tstep(tp, tstate, tapi.synth_batch(
            tm.cfg, _shape(), seed=10 + i, device="cpu"))
        for k in ("loss", "grad_norm_sq"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-5)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert got.dtype == torch.float32 and not got.requires_grad
        if eps > 1e-6:
            _close(got, want, 1e-5, 1e-5)
    assert int(tstate.step) == int(jstate.step) == steps
    for got, want in zip(tree_leaves(tstate.mu) + tree_leaves(tstate.nu),
                         jax.tree.leaves(jstate.mu)
                         + jax.tree.leaves(jstate.nu)):
        _close(got, want, 1e-5, 1e-5)


def test_train_step_matches_jax_on_olmoe():
    """One step of the MoE smoke model (8 experts, top 2; the router's
    gradient through the gates included) against JAX's jitted step."""
    jax, _, japi, jadamw, _ = _jax()
    jcfg = dataclasses.replace(OLMOE, compute_dtype="float32")
    jm, jp, tm, tp = _setup(jcfg, seed=6)
    jopt = jadamw.AdamW(learning_rate=1e-2, warmup_steps=2, eps=1e-3)
    topt = AdamW(learning_rate=1e-2, warmup_steps=2, eps=1e-3)
    batch = japi.synth_batch(jcfg, japi.ShapeSpec("t", "train", **TRAIN),
                             seed=10)
    jp, jstate, jmet = jax.jit(japi.make_train_step(jm, jopt))(
        jp, jopt.init(jp), batch)
    tp, tstate, tmet = tapi.make_train_step(tm, topt)(
        tp, topt.init(tp), tapi.synth_batch(tm.cfg, _shape(), seed=10,
                                            device="cpu"))
    for k in ("loss", "grad_norm_sq"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5)
    assert "moe_wg" in tp["layers"]
    for got, want in zip(tree_leaves(tp) + tree_leaves(tstate.mu),
                         jax.tree.leaves(jp) + jax.tree.leaves(jstate.mu)):
        _close(got, want, 1e-5, 1e-5)


def test_microbatches_give_the_full_batch_gradient():
    cfg = port_cfg(UNTIED, compute_dtype="float32")
    tm = tapi.build(cfg, "cpu", serve=False)
    tp = tm.init_params(torch.Generator().manual_seed(7))
    batch = tapi.synth_batch(cfg, _shape(), seed=7, device="cpu")
    # eps 1e-3: see the tolerances above
    opt = AdamW(learning_rate=1e-2, warmup_steps=1, eps=1e-3)
    outs = [tapi.make_train_step(tm, opt, microbatches=n)(
        tp, opt.init(tp), batch) for n in (1, 2, 4)]
    for p, _, met in outs[1:]:
        for k in ("loss", "grad_norm_sq"):
            np.testing.assert_allclose(float(met[k]), float(outs[0][2][k]),
                                       rtol=1e-5)
        for a, b in zip(tree_leaves(p), tree_leaves(outs[0][0])):
            _close(a, b.numpy(), 1e-5, 1e-5)


# -- the optimizer and compression -------------------------------------------

def _tree(rng, scale=1.0):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32) * scale,
            "layers": {"w": rng.normal(size=(2, 5)).astype(np.float32),
                       "b": rng.normal(size=(7,)).astype(np.float32)}}


@pytest.mark.parametrize("kw", [dict(), dict(clip_norm=None),
                                dict(warmup_steps=1, weight_decay=0.0),
                                dict(clip_norm=0.5, b2=0.999)])
def test_adamw_matches_jax_on_random_trees(kw):
    jax, jnp, _, jadamw, _ = _jax()
    rng = np.random.default_rng(8)
    p_np = _tree(rng)
    jopt, topt = jadamw.AdamW(**kw), AdamW(**kw)
    jp = jax.tree.map(jnp.asarray, p_np)
    tp = convert.train_params(p_np, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(3):
        g_np = _tree(rng, scale=3.0)
        ju, js = jopt.update(jax.tree.map(jnp.asarray, g_np), js, jp)
        tu, ts = topt.update(convert.train_params(g_np, "cpu"), ts, tp)
        jp, tp = jadamw.apply_updates(jp, ju), apply_updates(tp, tu)
        for got, want in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    # the JAX state carried across continues the same run
    ts2 = convert.adamw_state(js, "cpu")
    assert int(ts2.step) == 3
    for got, want in zip(tree_leaves(ts2.mu), tree_leaves(ts.mu)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_global_norm_matches_jax():
    jax, jnp, _, jadamw, _ = _jax()
    t = _tree(np.random.default_rng(9), scale=10.0)
    np.testing.assert_allclose(
        float(global_norm(convert.train_params(t, "cpu"))),
        float(jadamw.global_norm(jax.tree.map(jnp.asarray, t))), rtol=1e-6)


def _compress_both(x):
    _, jnp, _, _, jcomp = _jax()
    jq, js, jmeta = jcomp.compress_int8(jnp.asarray(x))
    tq, ts, tmeta = compress_int8(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (tuple(tmeta[0]), tmeta[1]) == (tuple(jmeta[0]), jmeta[1])
    jd = jcomp.decompress_int8(jq, js, jmeta)
    np.testing.assert_array_equal(
        decompress_int8(tq, ts, tmeta).numpy(), np.asarray(jd))


@pytest.mark.parametrize("shape", [(1,), (255,), (256,), (3, 300), (0,)])
def test_compress_int8_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.normal(size=shape) * 10).astype(np.float32)
    if x.size:
        # exact halves: round half to even on both sides
        x.ravel()[: min(4, x.size)] = [127.0, 0.5, 1.5, -2.5][: min(4,
                                                                    x.size)]
    _compress_both(x)


try:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.integers(0, 2**31 - 1), st.integers(1, 2000))
    def test_compress_int8_bit_for_bit_property(seed, n):
        rng = np.random.default_rng(seed)
        _compress_both((rng.normal(size=n) * rng.uniform(0.1, 100)).astype(
            np.float32))
except ImportError:                      # hypothesis is optional
    pass


def test_error_feedback_converges():
    """Quantized-gradient descent with error feedback still descends
    (``tests/test_substrate.py``'s check, through a world of one)."""
    car = CompressedAllReduce()
    w = torch.tensor([5.0, -5.0, 2.0])
    e = car.init_error(w)
    for _ in range(300):
        deq, e = car(2 * w, e)
        w = w - 0.05 * deq
    assert float(w.abs().max()) < 0.1


def _allreduce_rank(group, grads_np, errs_np):
    car = CompressedAllReduce(group.group)
    g = {k: torch.as_tensor(v[group.rank]) for k, v in grads_np.items()}
    e = {k: torch.as_tensor(v[group.rank]) for k, v in errs_np.items()}
    out, new_e = car(g, e)
    return ({k: v.numpy() for k, v in out.items()},
            {k: v.numpy() for k, v in new_e.items()})


def test_compressed_all_reduce_over_a_gloo_world_of_two():
    from repro_torch.launch.world import run_world

    rng = np.random.default_rng(10)
    grads = {"a": rng.normal(size=(2, 300)).astype(np.float32),
             "b": rng.normal(size=(2, 4, 5)).astype(np.float32) * 50}
    errs = {k: rng.normal(size=v.shape).astype(np.float32) * 1e-3
            for k, v in grads.items()}
    results = run_world(_allreduce_rank, 2, device="cpu", timeout=240,
                        args=(grads, errs))
    for k in grads:
        # numpy: per rank, quantize g + e; sum the ints; mean of scales
        qs, ss, res = [], [], []
        for r in range(2):
            x = (grads[k][r] + errs[k][r]).ravel()
            pad = np.pad(x, (0, (-x.size) % 256)).reshape(-1, 256)
            s = np.abs(pad).max(1, keepdims=True) / np.float32(127.0)
            q = np.round(pad / np.maximum(s, np.float32(1e-12)))
            qs.append(q.astype(np.int32))
            ss.append(s.astype(np.float32))
            res.append(x - (q * s).ravel()[:x.size])
        want = ((qs[0] + qs[1]).astype(np.float32)
                * ((ss[0] + ss[1]) / np.float32(2.0))).ravel()
        want = want[:grads[k][0].size].reshape(grads[k].shape[1:])
        for r in range(2):
            out, new_e = results[r]
            np.testing.assert_allclose(out[k], want, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(new_e[k].ravel(), res[r], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(results[0][0][k], results[1][0][k])


# -- the launcher ------------------------------------------------------------

def _train_args(tmp_path, name, *extra):
    return ttrain.build_parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
         "--seq", "32", "--microbatches", "2", "--ckpt-every", "1",
         "--ckpt-dir", str(tmp_path / name), *extra])


def test_train_restart_reproduces_the_run_without_failures(tmp_path):
    clean = ttrain.train(_train_args(tmp_path, "clean"))
    drill = ttrain.train(_train_args(tmp_path, "drill", "--fail-at", "2"))
    assert clean["failures"] == 0 and drill["failures"] == 1
    assert drill["losses"] == clean["losses"]
    for a, b in zip(tree_leaves(clean["state"]["params"]),
                    tree_leaves(drill["state"]["params"])):
        assert torch.equal(a, b)
    # the loss falls on the stream
    assert clean["losses"][-1] < clean["losses"][0] + 1.0
    assert np.isfinite(clean["losses"]).all()


def test_train_main_runs_three_steps(tmp_path, capsys):
    assert ttrain.main(["--smoke", "--device", "cpu", "--steps", "3",
                        "--batch", "2", "--seq", "16",
                        "--ckpt-dir", str(tmp_path / "ck"),
                        "--deterministic"]) == 0
    out = capsys.readouterr().out
    assert "arch=tinyllama-1.1b-smoke" in out and "done: final loss" in out
    assert not torch.are_deterministic_algorithms_enabled()
    # --production-mesh (item 15b) without 256 ranks: the mesh's error
    with pytest.raises(ValueError, match="needs 256 ranks; the world has 1"):
        ttrain.main(["--smoke", "--device", "cpu", "--production-mesh",
                     "--ckpt-dir", str(tmp_path / "ck2")])
