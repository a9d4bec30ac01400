"""The port's sorted segment reduce (``ops.segment_reduce_op`` on CPU
tensors, the plain version) against the JAX package's
``ops.segment_reduce_op`` with its Pallas kernel in interpret mode.

Cases: the three ``(e, s)`` shapes of ``tests/test_kernels.py``, the gappy
ids that send the JAX op to its fallback (``max_span`` below the block
span; the port has no span and no fallback), a real RMAT9 partition's
sorted ``dst_ext``, and a leading batch axis.  Tolerances: min bit for bit
(a min is order-free); sum ``rtol=1e-5`` with ``atol=1e-6`` for the sums
that cancel to near zero (the JAX kernel adds a block's messages by a
one-hot contraction, the plain version by a scatter in edge order).  The
CUDA kernel is held against the same plain version on the card in
``test_torch_kernel_card.py``; here its wrapper's partials layout and its
refusals before a launch.
"""
import numpy as np
import pytest
import torch

from test_torch_jaxref import JG, JPT, jops

from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import segment_reduce as ksr


def messages(combine, e, rng):
    return (rng.normal(size=e) if combine == "sum"
            else rng.uniform(0, 100, size=e)).astype(np.float32)


def assert_parity(combine, got, want):
    assert got.shape == want.shape
    if combine == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def jax_reduce(msgs, seg, s, combine, **kw):
    import jax.numpy as jnp

    return np.asarray(jops.segment_reduce_op(
        jnp.asarray(msgs), seg, s, combine=combine, interpret=True, **kw))


@pytest.mark.parametrize("combine", ["sum", "min"])
@pytest.mark.parametrize("e,s", [(100, 10), (2048, 300), (5000, 50)])
def test_segment_reduce_matches_jax(combine, e, s):
    rng = np.random.default_rng(8)
    seg = np.sort(rng.integers(0, s, size=e)).astype(np.int32)
    msgs = messages(combine, e, rng)
    want = jax_reduce(msgs, seg, s, combine, block_e=256)
    got = tops.segment_reduce_op(torch.as_tensor(msgs), seg, s,
                                 combine=combine).numpy()
    assert_parity(combine, got, want)
    empty = np.setdiff1d(np.arange(s), seg)
    assert (got[empty] == (0.0 if combine == "sum" else np.inf)).all()


@pytest.mark.parametrize("combine", ["sum", "min"])
def test_segment_reduce_gappy_ids_match_the_jax_fallback(combine):
    """Ids spread over 10^6 segments exceed ``max_span``: the JAX op takes
    its plain fallback; the port has one path."""
    rng = np.random.default_rng(9)
    seg = np.sort(rng.choice(10**6, size=512, replace=False)).astype(
        np.int32)
    msgs = messages(combine, 512, rng)
    want = jax_reduce(msgs, seg, 10**6, combine, max_span=64)
    got = tops.segment_reduce_op(torch.as_tensor(msgs), seg, 10**6,
                                 combine=combine).numpy()
    assert_parity(combine, got, want)


@pytest.mark.parametrize("combine", ["sum", "min"])
def test_segment_reduce_on_engine_outbox_data(combine):
    """A real partition's sorted ``dst_ext`` (intra destinations, outbox
    slots and the sink), as the BSP engine's compute phase reduces it."""
    pg = JPT.partition(JG.rmat(9, 8, seed=11), 2, JPT.HIGH)
    n_edges = int(pg.fwd.num_edges[0])
    dst = np.sort(pg.fwd.dst_ext[0, :n_edges])
    msgs = messages(combine, n_edges, np.random.default_rng(0))
    want = jax_reduce(msgs, dst, pg.seg_count, combine)
    got = tops.segment_reduce_op(torch.as_tensor(msgs),
                                 torch.as_tensor(dst), pg.seg_count,
                                 combine=combine).numpy()
    assert_parity(combine, got, want)


def test_segment_reduce_leading_axis_reduces_each_row():
    rng = np.random.default_rng(3)
    seg = np.sort(rng.integers(0, 40, size=700)).astype(np.int32)
    msgs = rng.normal(size=(2, 3, 700)).astype(np.float32)
    got = tops.segment_reduce_op(torch.as_tensor(msgs), seg, 40).numpy()
    assert got.shape == (2, 3, 40)
    for i in range(2):
        for j in range(3):
            assert_parity("sum", got[i, j], jax_reduce(msgs[i, j], seg, 40,
                                                       "sum"))


def test_segment_reduce_refuses_ids_it_cannot_reduce():
    msgs = torch.zeros(4)
    with pytest.raises(ValueError, match="sorted"):
        tops.segment_reduce_op(msgs, np.array([0, 2, 1, 3]), 4)
    with pytest.raises(ValueError, match="lie in"):
        tops.segment_reduce_op(msgs, np.array([0, 1, 2, 4]), 4)
    with pytest.raises(ValueError, match="lie in"):
        tops.segment_reduce_op(msgs, np.array([-1, 1, 2, 3]), 4)
    with pytest.raises(ValueError, match=r"\[E\]"):
        tops.segment_reduce_op(msgs, np.array([0, 1, 2]), 4)
    out = tops.segment_reduce_op(torch.zeros(0), np.zeros(0, np.int32), 3,
                                 combine="min")
    assert out.tolist() == [np.inf] * 3


@pytest.mark.parametrize("q,e,nb", [(1, 1, 1), (8, 1024, 1), (8, 1025, 2),
                                    (13, 8388560, 8192)])
def test_segment_kernel_partials_share_their_ids(q, e, nb):
    """The kernel's block partials: one pair of run ids per 1024-edge
    block, shared by the Q rows, beside a pair of values per row."""
    assert ksr.partial_shapes(q, e) == ((nb, 2), (q, nb, 2))


@pytest.mark.parametrize("case,match", [("combine", "combine must be"),
                                        ("device", "CUDA tensor")])
def test_segment_kernel_refuses_before_it_launches(case, match):
    """A bad combine or CPU tensors raise before the library is loaded or
    the launch counted."""
    msgs = torch.zeros(2, 6)
    ids = torch.tensor([0, 0, 1, 1, 2, 4], dtype=torch.int32)
    before = ksr.segment_reduce.launches
    with pytest.raises(ValueError, match=match):
        ksr.segment_reduce(msgs, ids, num_segments=5,
                           combine="max" if case == "combine" else "sum")
    assert ksr.segment_reduce.launches == before
    assert ksr.SOURCE not in _build._loaded
