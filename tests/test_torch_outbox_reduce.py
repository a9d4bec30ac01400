"""The port's outbox aggregation (``ops.outbox_reduce_op`` on CPU tensors,
the plain version) against the JAX package's Pallas kernel in interpret
mode, on the boundary arrays of the JAX ``shard_degree_split``.

Cases: S in {1, 2} shards of P in {2, 4} partitions; sum with no weight and
with ``mul``, min with no weight and with ``add``; Q = 1 and 3; and the
JAX op's reference branch (``max_span`` below the block span).
Tolerances: min results bit for bit (a min is order-free); sums
``rtol=1e-6, atol=0``: the messages are positive, and the two sides add
the few messages of a slot in different orders (a one-hot contraction per
block on the JAX side, a scatter in edge order here).  Every slot no edge
reaches holds the combine identity on both sides.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import engine_case, jops

from repro_torch import convert
from repro_torch.kernels import ops as tops

JH = importlib.import_module("repro.core.hybrid")

SCALE = 8
LAYOUTS = [(2, 1), (2, 2), (4, 1), (4, 2)]          # (P, S)
MODES = [("sum", None), ("sum", "mul"), ("min", None), ("min", "add")]
SEMIRING = {("sum", None): "plus_times", ("sum", "mul"): "plus_times",
            ("min", None): "min", ("min", "add"): "min_plus"}


@pytest.fixture(scope="module", params=LAYOUTS, ids=lambda p: f"P{p[0]}S{p[1]}")
def layout(request):
    parts, shards = request.param
    _, jp, _ = engine_case("rmat", parts, "high", scale=SCALE, weighted=True)
    return jp, shards


def _messages(combine, n, q, rng):
    """Per-vertex messages ``[Q, n + 1]`` with the identity sink last:
    positive values, a third of them +inf under a min."""
    x = rng.uniform(0.5, 1.5, (q, n + 1)).astype(np.float32)
    if combine == "min":
        x[rng.random((q, n + 1)) < 0.3] = np.inf
    x[:, n] = 0.0 if combine == "sum" else np.inf
    return x


@pytest.mark.parametrize("combine,weight_op", MODES,
                         ids=lambda m: str(m))
@pytest.mark.parametrize("max_span,q", [(4096, 1), (4096, 3), (4, 3)],
                         ids=["kernel-Q1", "kernel-Q3", "fallback-Q3"])
def test_outbox_reduce_matches_jax(layout, combine, weight_op, q, max_span):
    jp, shards = layout
    jshd = JH.shard_degree_split(jp, shards, SEMIRING[(combine, weight_op)],
                                 [0] * shards)
    assert jshd.has_boundary
    if max_span < 4096:
        assert jshd.b_span > max_span      # the JAX op takes its fallback
    shd = convert.shard_hybrid_data(jshd)
    rng = np.random.default_rng(q + 10 * shards)
    for s in range(shards):
        x = _messages(combine, shd.n_max, q, rng)
        want = np.asarray(jops.outbox_reduce_op(
            x, jshd.b_src[s], jshd.b_local[s], jshd.b_mask[s],
            jshd.b_base[s],
            jshd.b_weight[s] if weight_op is not None else None,
            num_slots=jshd.num_slots, combine=combine, weight_op=weight_op,
            span=jshd.b_span, block_e=jshd.b_block, max_span=max_span,
            interpret=True))
        src, flat, w = (torch.as_tensor(a) if a is not None else None
                        for a in shd.boundary(s))
        got = tops.outbox_reduce_op(
            torch.as_tensor(x), src, flat, w, num_slots=shd.num_slots,
            combine=combine, weight_op=weight_op).numpy()
        assert got.shape == want.shape == (q, shd.num_slots)
        used = np.zeros(shd.num_slots, dtype=bool)
        used[shd.boundary(s)[1]] = True
        ident = 0.0 if combine == "sum" else np.inf
        assert np.all(got[:, ~used] == ident)
        assert np.all(want[:, ~used] == ident)
        if combine == "min":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_outbox_reduce_op_small_case_and_errors():
    x = torch.tensor([[1.0, 2.0, 4.0]])
    src = torch.tensor([0, 1, 2, 2], dtype=torch.int32)
    flat = torch.tensor([0, 0, 2, 2], dtype=torch.int32)
    w = torch.tensor([1.0, 3.0, 0.5, 2.0])
    got = tops.outbox_reduce_op(x, src, flat, w, num_slots=4, combine="sum",
                                weight_op="mul")
    assert got.tolist() == [[7.0, 0.0, 10.0, 0.0]]
    got = tops.outbox_reduce_op(x, src, flat, w, num_slots=4, combine="min",
                                weight_op="add")
    assert got.tolist() == [[2.0, np.inf, 4.5, np.inf]]
    got = tops.outbox_reduce_op(x, src, flat, w, num_slots=3, combine="min")
    assert got.tolist() == [[1.0, np.inf, 4.0]]       # the weight unread
    with pytest.raises(ValueError, match="needs weight"):
        tops.outbox_reduce_op(x, src, flat, None, num_slots=3,
                              combine="sum", weight_op="mul")
    with pytest.raises(ValueError, match="weight_op"):
        tops.outbox_reduce_op(x, src, flat, w, num_slots=3, combine="sum",
                              weight_op="max")
    with pytest.raises(ValueError, match="combine"):
        tops.outbox_reduce_op(x, src, flat, w, num_slots=3, combine="max")
