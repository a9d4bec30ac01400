"""The port's attention on the CPU (the flash kernel's plain version,
``ops.flash_attention_op`` and ``models.attention.chunked_attention``)
against the JAX package: ``ops.flash_attention_op`` with its Pallas kernel
in interpret mode, and ``repro.models.attention.chunked_attention``.

Cases: causal, causal with a window, non-causal (and non-causal with a
window, where the Pallas kernel still applies it); GQA with 4 query heads
over 2 KV heads; S of 256 and 512 and 200 (not a multiple of 128; the JAX
kernel runs it as one block); f32 and bf16.  Tolerances are the JAX
tests' (``tests/test_kernels.py``): 2e-3 in f32, 5e-2 in bf16, absolute
and relative.  Both sides keep f32 statistics and, for bf16 inputs, round
P to bf16 before P·V (the Pallas kernel, the port's plain version and its
tensor-core kernel alike), so the bf16 plain version is also held to the
Pallas kernel within the bound that rounding gives: each side rounds
every P value (weight p / l of its row of V) and the output to bf16, each
rounding off by at most 2^-8 relative, so the two differ by at most
``2 * 2^-8 * (|out| + sum p|v| / l)`` (largest difference measured on these
inputs 3.9e-3, at most 0.39 of the bound).  ``chunked_attention`` of the
JAX package keeps
P in f32, so against it the bf16 tolerance stays 5e-2.  The CUDA kernel is
held against the same plain version on the card in
``test_torch_kernel_card.py``.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import jops

from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

jattn = importlib.import_module("repro.models.attention")

TOL = {"float32": 2e-3, "bfloat16": 5e-2}
BF16_UNIT_ROUNDOFF = 2.0 ** -8
MASKS = [(True, 0), (True, 64), (False, 0), (False, 64)]


def qkv(b, h, kv, s, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))


def as_torch(a, dtype):
    return torch.as_tensor(a).to(getattr(torch, dtype))


def as_jax(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a, dtype=getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d", [(256, 64), (512, 128), (200, 64)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_attention_op_matches_jax(causal, window, s, d, dtype):
    q, k, v = qkv(2, 4, 2, s, d, dtype, seed=s + d)
    block = 128 if s % 128 == 0 else s
    want = jops.flash_attention_op(
        *(as_jax(a, dtype) for a in (q, k, v)), causal=causal, window=window,
        block_q=block, block_k=block, interpret=True)
    got = tops.flash_attention_op(*(as_torch(a, dtype) for a in (q, k, v)),
                                  causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("s,d", [(256, 64), (512, 128), (200, 64)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_flash_plain_bf16_rounds_p_as_the_pallas_kernel(causal, window, s,
                                                        d):
    """The plain version's bf16 path rounds P as the Pallas kernel does, so
    the two agree within the rounding bound of P and the output."""
    q, k, v = qkv(2, 4, 2, s, d, "bfloat16", seed=s + d)
    block = 128 if s % 128 == 0 else s
    want = jops.flash_attention_op(
        *(as_jax(a, "bfloat16") for a in (q, k, v)), causal=causal,
        window=window, block_q=block, block_k=block, interpret=True)
    qm, km, vm = (as_torch(a, "bfloat16") for a in (q, k, v))
    b, h, _, _ = qm.shape

    def plain(q, k, v):
        out = tref.flash_attention_ref(
            q.transpose(1, 2).reshape(b, s, 2, h // 2, d), k.transpose(1, 2),
            v.transpose(1, 2), causal=causal, window=window)
        return out.reshape(b, s, h, d).transpose(1, 2).float().numpy()

    got = plain(qm, km, vm)
    mag = plain(qm.float(), km.float(), vm.float().abs())   # sum p|v| / l
    want = np.asarray(want, np.float32)
    limit = 2 * BF16_UNIT_ROUNDOFF * (np.abs(want) + mag)
    assert np.all(np.abs(got - want) <= 1.01 * limit)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunks", [(256, (128, 64)), (200, (100, 40)),
                                      (200, (64, 64))])
@pytest.mark.parametrize("window", [0, 48])
def test_chunked_attention_matches_jax(window, s, chunks, dtype):
    """The model's layout ``[B, S, G, R, D]``.  The JAX function needs
    chunks that divide S; the port's plain version also takes a ragged last
    chunk (200 in chunks of 64), which changes no result."""
    b, g, r, d = 2, 2, 2, 64
    rng = np.random.default_rng(s + window)
    q = rng.normal(size=(b, s, g, r, d)).astype(np.float32)
    k = rng.normal(size=(b, s, g, d)).astype(np.float32)
    v = rng.normal(size=(b, s, g, d)).astype(np.float32)
    jq, jk = (c if s % c == 0 else s for c in chunks)
    want = jattn.chunked_attention(
        *(as_jax(a, dtype) for a in (q, k, v)), window=window, causal=True,
        q_chunk=jq, k_chunk=jk)
    got = tattn.chunked_attention(*(as_torch(a, dtype) for a in (q, k, v)),
                                  window=window, q_chunk=chunks[0],
                                  k_chunk=chunks[1])
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_chunked_attention_ignores_the_window_when_not_causal():
    """As in the JAX function; the kernel contract
    (``ops.flash_attention_op``) applies it."""
    q, k, v = (torch.as_tensor(a) for a in qkv(1, 2, 2, 32, 16, "float32", 1))
    qm = q.transpose(1, 2).reshape(1, 32, 2, 1, 16)
    km, vm = k.transpose(1, 2), v.transpose(1, 2)
    full = tref.flash_attention_ref(qm, km, vm, causal=False)
    got = tattn.chunked_attention(qm, km, vm, window=4, causal=False)
    torch.testing.assert_close(got, full, rtol=0, atol=0)
    windowed = tops.flash_attention_op(q, k, v, causal=False, window=4)
    assert not torch.allclose(windowed, full.reshape(1, 32, 2, 16)
                              .transpose(1, 2))


def test_pick_chunk_matches_jax():
    for s in (1, 7, 64, 200, 2049, 4352):
        for target in (1, 64, 1024, 2048):
            assert tattn.pick_chunk(s, target) == jattn.pick_chunk(s, target)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(5)
    b, g, r, d, smax = 2, 2, 3, 16, 40
    q = rng.normal(size=(b, 1, g, r, d)).astype(np.float32)
    kc = rng.normal(size=(b, smax, g, d)).astype(np.float32)
    vc = rng.normal(size=(b, smax, g, d)).astype(np.float32)
    for cache_len, window in [(1, 0), (17, 0), (40, 0), (17, 5), (3, 8)]:
        want = jattn.decode_attention(
            *(as_jax(a, "float32") for a in (q, kc, vc)),
            cache_len=cache_len, window=window)
        got = tattn.decode_attention(
            *(torch.as_tensor(a) for a in (q, kc, vc)), cache_len=cache_len,
            window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
