"""The port's SSM (xLSTM) and hybrid (Zamba2) families and mamba2's SSD on
the CPU against the JAX package's.

Configs: ``tests/test_models.py``'s ``ssm`` (4 layers, sLSTM every 2nd)
and ``hybrid`` (4 mamba2 layers, the shared block every 2nd, state 16)
configs, copied here, and the ``SMOKE_CONFIG``s of xlstm-125m and
zamba2-2.7b.  The same JAX parameters (``init_params`` from ``key(seed)``)
go into both packages through ``convert.lm_params`` (serving) or
``convert.train_params`` (training); inputs are drawn with numpy.

Tolerances, as ``tests/test_torch_encdec.py``'s: f32 compute ``rtol =
atol = 1e-4`` on logits, caches and the SSD; bf16 compute ``rtol = 0.05,
atol = 0.1`` on logits and single blocks (the packages round at other
places: XLA on the CPU rounds some bf16 ops at other points than PyTorch,
and the prefill's flash plain version rounds P to bf16); the loss at f32
within 1e-5 relative and each gradient within ``1e-4 · max|g|``.

bf16 caches carry those rounding differences through 32 recurrent steps
and, for Zamba, through the shared block's attention: measured on these
configs, JAX's own bf16 run differs from its f32 run by up to 1.18 in the
shared block's ``k`` (rms 0.047), and the two packages' bf16 runs by up to
0.83 there, at a few of 10,240 entries (logits by up to 0.13 after four
steps).  So bf16 logits and cache leaves are held to the JAX model's f32
run instead, over the prefill and the four steps together (JAX's own
error moves 2x from step to step): the port's bf16 error against it may
be at most twice JAX's own bf16 error in its largest entry and 1.5 times
in its rms (``within_bf16_noise``): the port at bf16 is as accurate as
the JAX model at bf16.  Greedy tokens are equal but at near-ties.  Cache dtypes exactly: Zamba's ``ssd`` leaf is bf16
after a bf16 prefill and f32 after the first decode step (``ssd_step``
promotes it), its ``conv``, ``k``, ``v`` stay bf16; xLSTM's cache is f32
throughout.  Parameter counts exactly.
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
from repro_torch.models import api as tapi
from repro_torch.models import mamba2 as tmb
from repro_torch.models import xlstm as TX
from repro_torch.models import zamba as TZ
from repro_torch.models.common import ArchConfig
from repro_torch.optim import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
XLSTM = importlib.import_module("repro.configs.xlstm_125m")
ZAMBA = importlib.import_module("repro.configs.zamba2_2_7b")
jmb = importlib.import_module("repro.models.mamba2")
jx = importlib.import_module("repro.models.xlstm")


def _cfg(family, **kw):
    """``tests/test_models.py``'s ``_cfg``."""
    base = dict(name=f"t-{family}", family=family, n_layers=4, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
                microbatches=1, compute_dtype="float32")
    base.update(kw)
    return JArchConfig(**base)


CFGS = {
    "ssm": _cfg("ssm", n_kv_heads=4, d_ff=0, slstm_every=2,
                sub_quadratic=True),
    "hybrid": _cfg("hybrid", n_kv_heads=4, ssm_state=16, attn_every=2,
                   sub_quadratic=True),
    "xlstm-smoke": XLSTM.SMOKE_CONFIG,
    "zamba2-smoke": ZAMBA.SMOKE_CONFIG,
}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.05, atol=0.1)}
TRAIN = dict(seq=32, batch=4)


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


def within_bf16_noise(got, want16, want32):
    """The port's bf16 ``got`` against the JAX model's f32 ``want32``: its
    largest error at most twice, its rms error at most 1.5 times those of
    the JAX model's bf16 ``want16`` (plus 1e-3 for entries JAX computes
    exactly)."""
    got, want16, want32 = f32(got), f32(want16), f32(want32)
    ours, theirs = np.abs(got - want32), np.abs(want16 - want32)
    rms = float(np.sqrt((ours ** 2).mean())), float(np.sqrt(
        (theirs ** 2).mean()))
    return (ours.max() <= 2 * theirs.max() + 1e-3
            and rms[0] <= 1.5 * rms[1] + 1e-3), (ours.max(), theirs.max(),
                                                  rms)


def normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def both(*arrays, dtype="float32"):
    """Each numpy array as a JAX array and a torch tensor of ``dtype``."""
    import jax.numpy as jnp

    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.tensor(a).to(getattr(torch, dtype)) for a in arrays])


def ssd_inputs(rng, b=2, s=32, h=3, p=8, n=4):
    return (normal(rng, b, s, h, p), -np.abs(normal(rng, b, s, h)),
            normal(rng, b, s, n), normal(rng, b, s, n))


# -- mamba2: the SSD ---------------------------------------------------------

def test_segsum_matches_jax():
    rng = np.random.default_rng(0)
    a = -np.abs(normal(rng, 2, 3, 9))
    import jax.numpy as jnp

    want = np.asarray(jmb._segsum(jnp.asarray(a)))
    got = tmb._segsum(torch.as_tensor(a)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all() and not np.isinf(
        got[..., 1, 0]).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_matches_jax(chunk, with_state):
    rng = np.random.default_rng(chunk)
    arrays = list(ssd_inputs(rng))
    init = normal(rng, 2, 3, 8, 4) if with_state else None
    (jxs, ja, jb, jc), (tx, ta, tb, tc) = both(*arrays)
    jinit, tinit = (both(init)[0][0], both(init)[1][0]) if with_state else (
        None, None)
    jy, jf = jmb.ssd(jxs, ja, jb, jc, chunk=chunk, init_state=jinit)
    ty, tf = tmb.ssd(tx, ta, tb, tc, chunk=chunk, init_state=tinit)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL["float32"])
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL["float32"])


def test_ssd_step_matches_jax():
    rng = np.random.default_rng(3)
    arrays = (normal(rng, 2, 3, 8, 4), normal(rng, 2, 3, 8),
              -np.abs(normal(rng, 2, 3)), normal(rng, 2, 4), normal(rng, 2, 4))
    jargs, targs = both(*arrays)
    jy, js = jmb.ssd_step(*jargs)
    ty, ts = tmb.ssd_step(*targs)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("s,chunk", [(32, 8), (30, 8), (7, 128)])
def test_ssd_equals_its_one_step_recurrence(s, chunk):
    """Within the port: the chunked dual against ``ssd_step`` token by
    token from the same initial state, a ragged S (padded past the last
    whole chunk, where JAX asserts) included."""
    rng = np.random.default_rng(s)
    x, a, b, c = (torch.as_tensor(t) for t in ssd_inputs(rng, s=s))
    init = torch.as_tensor(normal(rng, 2, 3, 8, 4))
    y, final = tmb.ssd(x, a, b, c, chunk=chunk, init_state=init)
    st, ys = init, []
    for t in range(s):
        yt, st = tmb.ssd_step(st, x[:, t], a[:, t], b[:, t], c[:, t])
        ys.append(yt)
    assert y.shape == x.shape
    torch.testing.assert_close(y, torch.stack(ys, 1), **TOL["float32"])
    torch.testing.assert_close(final, st, **TOL["float32"])


def test_ssd_gradients_are_finite_and_match_jax():
    """The ``-inf`` above the segment sums' diagonal passes no NaN into
    the gradients; they equal JAX's."""
    import jax

    rng = np.random.default_rng(4)
    arrays = ssd_inputs(rng)
    w = normal(rng, 2, 32, 3, 8)

    def jloss(*args):
        return (jmb.ssd(*args, chunk=8)[0] * w).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*both(*arrays)[0])
    targs = [t.requires_grad_() for t in both(*arrays)[1]]
    loss = (tmb.ssd(*targs, chunk=8)[0] * torch.as_tensor(w)).sum()
    for g, want in zip(torch.autograd.grad(loss, targs), jg):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()))


def mamba_layer(jcfg, seed, dtype):
    """One layer's JAX mamba weights (as ``init_mamba_stack`` draws them,
    ``a_log``, ``d_skip``, the norms and ``dt_bias`` perturbed off their
    constants), in both packages at ``dtype``."""
    import jax

    stack = jmb.init_mamba_stack(jax.random.key(seed), jcfg, 1, np.float32)
    rng = np.random.default_rng(seed)
    lp = {}
    for k, w in stack.items():
        w = np.asarray(w)[0]
        if k in ("a_log", "d_skip", "norm", "ssm_norm", "dt_bias"):
            w = w + 0.1 * normal(rng, *w.shape)
        lp[k] = w
    jl, tl = both(*lp.values(), dtype=dtype)
    return dict(zip(lp, jl)), dict(zip(lp, tl))


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(5)
    (jxs, jw), (tx, tw) = both(normal(rng, 2, 11, 6), normal(rng, 4, 6))
    np.testing.assert_allclose(tmb._causal_conv(tx, tw).numpy(),
                               np.asarray(jmb._causal_conv(jxs, jw)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_matches_jax(dtype):
    """``mamba_block`` in prefill with ``return_state`` (chunk 8 over 24
    tokens), then one step from that state: outputs, conv tail and SSD
    state, with their dtypes (the step's output and state are f32)."""
    jcfg = CFGS["hybrid"]
    cfg = port_cfg(jcfg)
    jlp, tlp = mamba_layer(jcfg, 6, dtype)
    rng = np.random.default_rng(6)
    (jxs, jx1), (tx, tx1) = both(normal(rng, 2, 24, 64), normal(rng, 2, 1, 64),
                                 dtype=dtype)
    tol = TOL[dtype]
    jo, jst = jmb.mamba_block(jxs, jlp, jcfg, chunk=8, return_state=True)
    to, tst = tmb.mamba_block(tx, tlp, cfg, chunk=8, return_state=True)
    for got, want in zip((to, *tst), (jo, *jst)):
        assert got.dtype == getattr(torch, str(want.dtype))
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(f32(got), f32(want), **tol)
    jo, jst = jmb.mamba_block(jx1, jlp, jcfg, state=jst)
    to, tst = tmb.mamba_block(tx1, tlp, cfg, state=tst)
    for got, want in zip((to, *tst), (jo, *jst)):
        assert got.dtype == getattr(torch, str(want.dtype))
        np.testing.assert_allclose(f32(got), f32(want), **tol)


# -- xLSTM cells -------------------------------------------------------------

def test_mlstm_parallel_equals_its_steps():
    """Within the port: the mLSTM by the SSD dual (heads folded into the
    batch) against ``_mlstm_step`` token by token; the final state
    too."""
    cfg = port_cfg(CFGS["ssm"])
    rng = np.random.default_rng(7)
    b, s, h, dh = 2, 20, 4, 8
    v, q, k = (torch.as_tensor(normal(rng, b, s, h, dh)) for _ in range(3))
    ig, fg = (torch.as_tensor(normal(rng, b, s, h)) for _ in range(2))
    hval, state = TX._mlstm_parallel(v, q, k, ig, fg, cfg)
    st = {"C": torch.zeros(b, h, dh, dh), "n": torch.zeros(b, h, dh)}
    hs = []
    for t in range(s):
        ht, st = TX._mlstm_step(v[:, t], q[:, t], k[:, t], ig[:, t],
                                fg[:, t], st)
        hs.append(ht)
    torch.testing.assert_close(hval, torch.stack(hs, 1), **TOL["float32"])
    torch.testing.assert_close(state["C"], st["C"], **TOL["float32"])
    torch.testing.assert_close(state["n"], st["n"], **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_scan_matches_jax(dtype):
    """The sLSTM loop from zero and from a carried state, its f32 outputs
    and carry (the bf16 gates and weights promoted as JAX promotes
    them)."""
    rng = np.random.default_rng(8)
    b, s, h, dh = 2, 9, 4, 8
    arrays = (normal(rng, b, s, h * dh), 2 * normal(rng, b, s, h),
              2 * normal(rng, b, s, h), normal(rng, h, dh),
              normal(rng, h, dh), normal(rng, h, dh))
    (jz_, ji, jf, *jr), (tz, ti, tf, *tr) = both(*arrays, dtype=dtype)
    names = ("r_igate", "r_fgate", "r_zgate")
    jlp, tlp = dict(zip(names, jr)), dict(zip(names, tr))
    jh, jcar = jx._slstm_scan(None, jz_, ji, jf, jlp)
    th, tcar = TX._slstm_scan(tz, ti, tf, tlp)
    jh2, jcar2 = jx._slstm_scan(None, jz_, ji, jf, jlp, init=jcar)
    th2, tcar2 = TX._slstm_scan(tz, ti, tf, tlp, init=tcar)
    for got, want in zip((th, *tcar, th2, *tcar2), (jh, *jcar, jh2, *jcar2)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4,
                                   atol=1e-4)


# -- parameters --------------------------------------------------------------

@pytest.mark.parametrize("arch,want", [("xlstm-125m", 123_725_664),
                                       ("zamba2-2.7b", 2_340_466_848)])
def test_parameter_shapes_and_counts_match_jax(arch, want):
    """The full configs' leaves (``param_spec``: nothing allocated) are
    JAX's ``init_params`` leaves under ``jax.eval_shape``, with the same
    shapes; the smoke configs' too.  The configs equal JAX's."""
    import jax
    from repro import configs as jconfigs
    from repro.models import api as japi

    for get, jget in ((tconfigs.get, jconfigs.get),
                      (tconfigs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        shapes = japi.build(jcfg).params_shape()
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        expect = {".".join(k.key for k in path): tuple(x.shape)
                  for path, x in flat}
        fam = TX if cfg.family == "ssm" else TZ
        got = {".".join(path): tuple(shape)
               for path, shape, _ in fam.param_spec(cfg)}
        assert got == expect
        if get is tconfigs.get:
            assert fam.param_count(cfg) == want == sum(
                int(np.prod(s)) for s in expect.values())


@pytest.mark.parametrize("name", list(CFGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_round_trip(name, dtype):
    """JAX tree → module state: every leaf equals the JAX one rounded to
    the dtype the module stores it in (``final_norm`` stays f32); a tree
    with a leaf missing, one too many or a wrong shape is refused."""
    jcfg = dataclasses.replace(CFGS[name], compute_dtype=dtype)
    _, params = jax_model(jcfg, seed=2)
    cfg = port_cfg(jcfg)
    model = port_model(jcfg, params)
    state = model.module.state_dict()
    cdt = getattr(torch, dtype)
    loaded = convert.lm_params(params, cfg)
    assert set(state) == set(loaded)
    for key, w in loaded.items():
        want_dt = torch.float32 if key == "final_norm" else cdt
        assert state[key].dtype == want_dt
        assert torch.equal(state[key], w.to(want_dt)), key
    stack = "layers" if cfg.family == "ssm" else "mamba"
    leaves = dict(params[stack])
    first = sorted(leaves)[0]
    with pytest.raises(ValueError, match="wants"):
        convert.lm_params(dict(params, **{stack: {
            k: v for k, v in leaves.items() if k != first}}), cfg)
    with pytest.raises(ValueError, match="wants"):
        convert.lm_params(dict(params, extra=params["final_norm"]), cfg)
    with pytest.raises(ValueError, match=f"{stack}.norm: shape"):
        convert.lm_params(dict(params, **{stack: dict(
            leaves, norm=np.asarray(leaves["norm"])[:1])}), cfg)


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_train_params_are_the_serving_weights(name):
    """``init_train_params`` draws what ``build`` draws into its module,
    so trained parameters load into a serving model; the JAX tree's
    keys."""
    cfg = port_cfg(CFGS[name])
    served = tapi.build(cfg, "cpu", torch.Generator().manual_seed(4))
    params = served.init_params(torch.Generator().manual_seed(4))
    _, jparams = jax_model(CFGS[name], seed=0)
    assert sorted(params) == sorted(jparams)
    for key, val in params.items():
        if isinstance(val, dict):
            assert sorted(val) == sorted(jparams[key])
    state = served.module.state_dict()
    loaded = convert.lm_params(params, cfg)
    assert set(loaded) == set(state)
    for key, w in loaded.items():
        assert torch.equal(state[key], w.to(state[key].dtype)), key
    assert all(p.dtype == torch.float32 for p in tree_leaves(params))


# -- serving -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CFGS))
def test_prefill_and_decode_match_jax(name, dtype):
    """Prefill (logits and every cache leaf with its dtype, ``len``) and
    four greedy decode steps, both fed the JAX model's tokens; each
    step's cache leaves and dtypes (Zamba's ``ssd`` f32 from the first
    step on).  At bf16 the cache leaves are held to the JAX model's f32
    run, fed the same tokens (``within_bf16_noise``)."""
    import jax.numpy as jnp

    jcfg = dataclasses.replace(CFGS[name], compute_dtype=dtype)
    jm, params = jax_model(jcfg, seed=1)
    tm = port_model(jcfg, params)
    tol = TOL[dtype]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    prompt = {"tokens": jnp.asarray(toks[:, :32])}
    jl, jc = jm.prefill(params, prompt, max_len=40)
    tl, tc = tm.prefill({"tokens": torch.as_tensor(toks[:, :32])},
                        max_len=40)
    jm32 = None
    if dtype == "bfloat16":
        jm32, _ = jax_model(dataclasses.replace(jcfg,
                                                compute_dtype="float32"), 1)
        jl32, jc32 = jm32.prefill(params, prompt, max_len=40)

    runs = {}          # bf16: key -> [(port, JAX bf16, JAX f32)] per step

    def close(key, got, want):
        if jm32 is None:
            np.testing.assert_allclose(f32(got), f32(want), **tol)
        else:
            runs.setdefault(key, []).append(      # the port's cache is
                (f32(got).copy(), f32(want),          # written in place
                 f32(jl32 if key == "logits" else jc32[key])))

    def same_outputs():
        assert tl.shape == (2, jcfg.vocab) and tl.dtype == getattr(torch,
                                                                   dtype)
        close("logits", tl, jl)
        assert sorted(tc) == sorted(jc)
        assert tc["len"] == int(jc["len"])
        for key in [k for k in jc if k != "len"]:
            assert tc[key].dtype == getattr(torch, str(jc[key].dtype)), key
            assert tuple(tc[key].shape) == tuple(jc[key].shape), key
            close(key, tc[key], jc[key])

    same_outputs()
    assert tc["len"] == 32
    token = toks[:, 32]
    for _ in range(4):
        jl, jc = jm.decode_step(params, jc, jnp.asarray(token))
        tl, tc = tm.decode_step(tc, torch.as_tensor(token))
        if jm32 is not None:
            jl32, jc32 = jm32.decode_step(params, jc32, jnp.asarray(token))
        same_outputs()
        want = f32(jl)
        jtok, ttok = want.argmax(-1), f32(tl).argmax(-1)
        top2 = np.sort(want, -1)[:, -2:]
        near_tie = (top2[:, 1] - top2[:, 0]) <= 2 * (
            tol["atol"] + tol["rtol"] * np.abs(top2[:, 1]))
        assert ((jtok == ttok) | near_tie).all()
        token = jtok.astype(np.int32)
    assert tc["len"] == 36
    if "ssd" in tc:
        assert tc["ssd"].dtype == torch.float32
    for key, steps in runs.items():
        ok, errs = within_bf16_noise(*(np.concatenate([a.ravel() for a in x])
                                       for x in zip(*steps)))
        assert ok, (key, errs)


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_decode_matches_prefill_shifted(name):
    """Within the port: decoding token t after ``prefill(tokens[:, :t])``
    gives the last logits of ``prefill(tokens[:, :t + 1])``: bit for bit
    for xLSTM (the same steps), within ``tests/test_models.py``'s 2e-3
    for Zamba (the chunked SSD against its recurrence, t + 1 = 25 not a
    multiple of the chunk)."""
    cfg = port_cfg(CFGS[name])
    model = tapi.build(cfg, "cpu", torch.Generator().manual_seed(5))
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 25)))
    _, cache = model.prefill({"tokens": toks[:, :24]}, max_len=25)
    lg_b, _ = model.decode_step(cache, toks[:, 24])
    lg_full, _ = model.prefill({"tokens": toks})
    if cfg.family == "ssm":
        assert torch.equal(lg_b, lg_full)
    else:
        torch.testing.assert_close(lg_b, lg_full, rtol=2e-3, atol=2e-3)
        with pytest.raises(ValueError, match="full"):
            model.decode_step(cache, toks[:, 24])


def test_zamba_parallel_equals_sequential():
    """``tests/test_models.py``'s check in the port: the parallel forward
    (SSD chunk 4) against one decode step a token from an empty cache."""
    cfg = port_cfg(CFGS["hybrid"])
    model = tapi.build(cfg, "cpu", torch.Generator().manual_seed(2))
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 8)))
    with torch.inference_mode():
        lp = TZ.forward(model.module.tree(), cfg, toks, ssd_chunk=4)
    cache = model.init_cache(2, 8)
    outs = []
    for i in range(8):
        lg, cache = model.decode_step(cache, toks[:, i])
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), lp, rtol=1e-4,
                               atol=1e-4)


def test_zamba_depth_must_be_a_multiple_of_attn_every():
    cfg = dataclasses.replace(tconfigs.get_smoke("zamba2-2.7b"), n_layers=3)
    with pytest.raises(ValueError, match="attn_every"):
        tapi.build(cfg, "cpu")
    with pytest.raises(ValueError, match="attn_every"):
        tapi.build(cfg, "cpu", serve=False)


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_loss_and_gradients_match_jax_at_f32(name):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    on the same parameters and ``synth_batch``."""
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
    assert np.array_equal(tb["tokens"].numpy(), np.asarray(batch["tokens"]))
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    loss = tm.loss(tp, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w, np.float32)
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert float(np.abs(w).max()) > 0       # every leaf is on the path
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_train_step_lowers_the_loss(name):
    """``make_train_step`` over two microbatches: finite parameters and
    a lower loss on the same batch after three steps."""
    from repro_torch.optim import AdamW

    cfg = port_cfg(CFGS[name])
    model = tapi.build(cfg, "cpu", serve=False)
    params = model.init_params(torch.Generator().manual_seed(3))
    batch = tapi.synth_batch(cfg, tapi.ShapeSpec("t", "train", 16, 4),
                             seed=2, device="cpu")
    opt = AdamW(learning_rate=1e-2, warmup_steps=1)
    step = tapi.make_train_step(model, opt, microbatches=2)
    state, losses = opt.init(params), []
    for _ in range(3):
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
    assert losses[-1] < losses[0]
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(params))


# -- launchers ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b"])
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
