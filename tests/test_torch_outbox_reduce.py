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
reaches holds the combine identity on both sides.  The op also reads the
engine's query-minor view of ``x`` (Q in {1, 3, 8, 13}) bit for bit as it
reads ``x``, and the kernel's wrapper refuses what it does not take before
it launches.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import engine_case, jops

from repro_torch import convert
from repro_torch.kernels import ell_spmv as kell
from repro_torch.kernels import ops as tops
from repro_torch.kernels import outbox_reduce as kob

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


@pytest.mark.parametrize("combine,weight_op", MODES, ids=lambda m: str(m))
@pytest.mark.parametrize("q", [1, 3, 8, 13])
def test_outbox_op_reads_a_query_minor_view_as_it_reads_x(combine, weight_op,
                                                          q):
    """The op gives the same outboxes for ``x`` and for the engine's
    query-minor view of it (``ell_spmv.query_minor_view``), whose buffer
    the kernel path takes without another copy."""
    rng = np.random.default_rng(q)
    e, n, num_slots = 900, 120, 300
    flat = torch.as_tensor(np.sort(rng.integers(0, num_slots, e)),
                           dtype=torch.int32)
    src = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
    w = torch.as_tensor(rng.uniform(1.0, 2.0, e), dtype=torch.float32)
    x = torch.as_tensor(_messages(combine, n - 1, q, rng))
    xq = kell.query_minor_view(x, 0.0 if combine == "sum" else np.inf)
    assert not xq.is_contiguous() or q == 1
    base = kell.query_minor_base(xq)
    assert base is not None and base.shape == (n, -(-q // 4) * 4)
    assert kell.query_minor(xq, 0.0).data_ptr() == xq.data_ptr()
    kw = dict(num_slots=num_slots, combine=combine, weight_op=weight_op)
    want = tops.outbox_reduce_op(x, src, flat, w, **kw)
    got = tops.outbox_reduce_op(xq, src, flat, w, **kw)
    assert torch.equal(got, want) and got.shape == (q, num_slots)


def test_outbox_kernel_wrapper_refuses_before_it_launches():
    """``outbox_reduce.outbox_reduce`` checks shapes and types, then the
    device, and raises before anything is built or launched."""
    xt = torch.zeros(10, 4)
    idx = torch.zeros(5, dtype=torch.int32)
    w = torch.ones(5)
    kw = dict(num_slots=3, num_queries=3)
    before = kob.outbox_reduce.launches
    cases = [
        (dict(xt=xt.double()), "float32"),
        (dict(xt=torch.zeros(10, 6)), "multiple of 4"),
        (dict(xt=torch.zeros(10, 4, 2)), "x_len, Qp"),
        (dict(xt=torch.zeros(4, 10).t()), "contiguous"),
        (dict(src=idx.long()), "int32"),
        (dict(flat=idx[:4]), "one \\[E\\] shape"),
        (dict(weight=w[:4], weight_op="mul"), "differ"),
        (dict(weight=None, weight_op="add"), "needs weight"),
        (dict(combine="max"), "combine"),
        (dict(num_queries=5), "holding 5 queries"),
        ({}, "CUDA"),
    ]
    for change, match in cases:
        args = dict(xt=xt, src=idx, flat=idx, weight=w, combine="sum",
                    weight_op=None, **kw)
        args.update(change)
        with pytest.raises(ValueError, match=match):
            kob.outbox_reduce(args.pop("xt"), args.pop("src"),
                              args.pop("flat"), args.pop("weight"), **args)
    assert kob.outbox_reduce.launches == before
