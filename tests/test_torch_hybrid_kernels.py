"""The plain versions of the hybrid backend's three kernels against the JAX
package's Pallas kernels (interpret mode), and the remainder's CSR packing
against the JAX ELL packing.

The same numpy inputs, made from a seed, go through ``repro.kernels.ops``
(``ell_spmv_op`` on the ELL block with its sink column, ``dense_spmv_op``,
``dense_spmv_minplus_op``) and the port's ops on CPU tensors, which take the
plain versions.  Tolerances:

- min and min_plus: bit for bit (a min is exact in any order), +inf
  entries and empty rows included;
- plus_times on dyadic inputs (small integers times powers of two): bit
  for bit, since every product and partial sum is exact in f32 and the
  order cannot matter;
- plus_times on continuous inputs: ``rtol=2e-5``, the f32 reassociation
  bound of a sum of at most 300 non-negative terms (300 * 2^-24 = 1.8e-5),
  as the two sides sum in different orders.

The packing is compared for exact equality (values and dtypes) after
padding each CSR row to ``kmax`` with the sentinel and the ⊗-identity.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import JG, jops

from repro_torch.core import graph as TG
from repro_torch.kernels import dense_spmv as kds
from repro_torch.kernels import ell_spmv as kell
from repro_torch.kernels import ops as tops

jell = importlib.import_module("repro.kernels.ell_spmv")

SEMIRINGS = ["plus_times", "min_plus", "min"]


def random_rows(rng, v, x_len):
    """CSR rows with empty, short and long rows (up to 300 slots)."""
    lengths = rng.choice([0, 0, 1, 2, 3, 7, 20], size=v)
    lengths[[1, v // 2, v - 1]] = [300, 45, 0]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, x_len, size=int(row_ptr[-1])).astype(np.int32)
    return row_ptr, col


def pad_rows(row_ptr, col, val, sentinel, fill):
    """CSR rows padded to the widest with ``sentinel``/``fill``: the ELL
    block ``[V, kmax]``."""
    lengths = np.diff(row_ptr)
    kmax = max(int(lengths.max(initial=0)), 1)
    v = len(lengths)
    ell_col = np.full((v, kmax), sentinel, dtype=np.int32)
    ell_val = np.full((v, kmax), fill, dtype=np.float32)
    rows = np.repeat(np.arange(v), lengths)
    slots = np.arange(len(col)) - np.repeat(row_ptr[:-1], lengths)
    ell_col[rows, slots] = col
    ell_val[rows, slots] = val
    return ell_col, ell_val


def jax_ell(row_ptr, col, val, x, semiring):
    """The JAX kernel on the same rows: ELL block, sink column appended."""
    ident, mul_ident = jell.SEMIRINGS[semiring][2:]
    x_len = x.shape[1]
    ell_col, ell_val = pad_rows(row_ptr, col, val, x_len, mul_ident)
    xs = np.concatenate([x, np.full((x.shape[0], 1), ident, np.float32)], 1)
    return np.asarray(jops.ell_spmv_op(ell_col, ell_val, xs,
                                       semiring=semiring))


def port_ell(row_ptr, col, val, x, semiring):
    return tops.ell_spmv_op(torch.as_tensor(row_ptr), torch.as_tensor(col),
                            torch.as_tensor(val), torch.as_tensor(x),
                            semiring=semiring).numpy()


def ell_inputs(semiring, q, dyadic, seed):
    rng = np.random.default_rng(seed)
    v, x_len = 400, 350
    row_ptr, col = random_rows(rng, v, x_len)
    if dyadic:
        val = rng.integers(1, 8, size=col.shape).astype(np.float32)
        x = (rng.integers(0, 64, (q, x_len)) * 2.0 ** -10).astype(np.float32)
    else:
        val = rng.uniform(0.5, 2.0, size=col.shape).astype(np.float32)
        x = rng.uniform(0, 100, (q, x_len)).astype(np.float32)
    if semiring != "plus_times":
        x[rng.random((q, x_len)) < 0.2] = np.inf
    return row_ptr, col, val, x


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_ell_plain_matches_jax_kernel(semiring, q):
    args = ell_inputs(semiring, q, dyadic=False, seed=q)
    want = jax_ell(*args, semiring)
    got = port_ell(*args, semiring)
    assert got.shape == want.shape == (q, 400)
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    else:
        np.testing.assert_array_equal(got, want)
    # empty rows hold the ⊕-identity
    empty = np.diff(args[0]) == 0
    assert (got[:, empty] == jell.SEMIRINGS[semiring][2]).all()


@pytest.mark.parametrize("q", [1, 3])
def test_ell_plain_sum_is_exact_on_dyadic_inputs(q):
    args = ell_inputs("plus_times", q, dyadic=True, seed=10 + q)
    np.testing.assert_array_equal(port_ell(*args, "plus_times"),
                                  jax_ell(*args, "plus_times"))


def dense_inputs(m, k, n, seed, dyadic):
    rng = np.random.default_rng(seed)
    if dyadic:
        x = (rng.integers(0, 64, (m, k)) * 2.0 ** -8).astype(np.float32)
        a = rng.integers(0, 4, (k, n)).astype(np.float32)
    else:
        x = rng.uniform(0, 1, (m, k)).astype(np.float32)
        a = rng.uniform(0, 2, (k, n)).astype(np.float32)
    a[rng.random((k, n)) < 0.6] = 0.0        # non-edges of the block
    return x, a


SHAPES = [(1, 100, 100), (3, 100, 100), (3, 200, 130), (1, 1, 1)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dense_plain_matches_jax_kernel(m, k, n):
    x, a = dense_inputs(m, k, n, seed=k + n, dyadic=False)
    want = np.asarray(jops.dense_spmv_op(x, a))
    got = tops.dense_spmv_op(torch.as_tensor(x), torch.as_tensor(a)).numpy()
    assert got.shape == (m, n)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-30)
    x, a = dense_inputs(m, k, n, seed=k + n, dyadic=True)
    np.testing.assert_array_equal(
        tops.dense_spmv_op(torch.as_tensor(x), torch.as_tensor(a)).numpy(),
        np.asarray(jops.dense_spmv_op(x, a)))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_dense_minplus_plain_matches_jax_kernel(m, k, n):
    x, a = dense_inputs(m, k, n, seed=k * n, dyadic=False)
    rng = np.random.default_rng(k)
    a = np.where(a == 0.0, np.inf, a).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.inf
    want = np.asarray(jops.dense_spmv_minplus_op(x, a))
    got = tops.dense_spmv_minplus_op(torch.as_tensor(x),
                                     torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_versions():
    """No kernel launches for CPU tensors; the counters stay put."""
    before = (kell.ell_spmv.launches, kds.dense_spmv.launches,
              kds.dense_spmv_minplus.launches)
    args = ell_inputs("min", 2, dyadic=False, seed=0)
    port_ell(*args, "min")
    x, a = dense_inputs(2, 50, 60, seed=0, dyadic=False)
    tops.dense_spmv_op(torch.as_tensor(x), torch.as_tensor(a))
    tops.dense_spmv_minplus_op(torch.as_tensor(x), torch.as_tensor(a))
    assert before == (kell.ell_spmv.launches, kds.dense_spmv.launches,
                      kds.dense_spmv_minplus.launches)
    with pytest.raises(ValueError, match="semiring"):
        port_ell(*args, "max_times")


def _graphs(weighted):
    jg, tg = JG.rmat(8, 8, seed=4), TG.rmat(8, 8, seed=4)
    if weighted:
        jg, tg = (g.with_uniform_weights(seed=5) for g in (jg, tg))
    return jg, tg


POLICIES = [dict(combine="sum"), dict(combine="min"),
            dict(semiring="plus_times"), dict(semiring="min_plus"),
            dict(semiring="min")]


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: "-".join(
    map(str, p.values())))
def test_csr_rows_padded_equal_jax_ell(policy, weighted, transpose):
    jg, tg = _graphs(weighted)
    want_col, want_val, want_kmax = jops.csr_to_ell(jg, transpose=transpose,
                                                    **policy)
    row_ptr, col, val, kmax = tops.csr_to_ell_rows(tg, transpose=transpose,
                                                   **policy)
    assert kmax == want_kmax
    assert row_ptr.dtype == col.dtype == np.int32 and val.dtype == np.float32
    sr = policy.get("semiring") or {"sum": "plus_times",
                                    "min": "min_plus"}[policy["combine"]]
    got_col, got_val = pad_rows(row_ptr, col, val, tg.num_vertices,
                                jell.SEMIRINGS[sr][3])
    np.testing.assert_array_equal(got_col, want_col)
    np.testing.assert_array_equal(got_val, want_val)


def plan_cover(row_ptr, plan):
    """For each row, the number of plan blocks that cover it, and check
    each block against the kernel's geometry."""
    lens = np.diff(row_ptr.astype(np.int64))
    seen = np.zeros(len(lens), dtype=np.int64)
    chunks = {}
    for a, b, c in plan.blocks.tolist():
        if c < 0:                         # chunk b of long row a
            assert lens[a] > kell.BUDGET
            assert 0 <= b * kell.BUDGET < lens[a]
            chunks.setdefault(a, []).append((b, -1 - c))
            continue
        assert a < b <= a + kell.RUN_ROWS
        assert row_ptr[b] - row_ptr[a] <= kell.BUDGET
        assert c & (c - 1) == 0 and 1 <= c <= 32      # lanes: a power of two
        assert -(-lens[a:b].max() // c) <= kell.LANE_RUN
        seen[a:b] += 1
    for r, first in plan.long_rows.tolist():
        got = sorted(chunks.pop(r))
        k = -(-lens[r] // kell.BUDGET)
        assert got == [(i, first + i) for i in range(k)]
        seen[r] += 1
    assert not chunks
    assert plan.num_partials == sum(
        -(-lens[r] // kell.BUDGET) for r, _ in plan.long_rows.tolist())
    return seen


PLAN_CASES = {
    "empty rows": [0] * 1500,
    "budget edges": [0, 1, 31, 32, 33, kell.BUDGET - 1, kell.BUDGET,
                     kell.BUDGET + 1, 0, 5, kell.BUDGET, 0],
    "hub": [3, 70000, 0, 70000, 2],
    "random": None,
}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_row_plan_covers_every_row_once_within_budget(case):
    lens = PLAN_CASES[case]
    if lens is None:
        rng = np.random.default_rng(7)
        lens = np.minimum(rng.zipf(1.7, 20000), 9000)
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    plan = kell.row_plan(row_ptr)
    assert plan.blocks.dtype == plan.long_rows.dtype == np.int32
    np.testing.assert_array_equal(plan_cover(row_ptr, plan), 1)
    # the plan of a CPU tensor is the same
    again = kell.row_plan(torch.as_tensor(row_ptr))
    np.testing.assert_array_equal(again.blocks, plan.blocks)


@pytest.mark.parametrize("semiring", SEMIRINGS)
def test_ell_op_same_with_and_without_plan(semiring):
    row_ptr, col, val, x = ell_inputs(semiring, 3, dyadic=False, seed=4)
    plan = kell.row_plan(row_ptr).to("cpu")
    args = [torch.as_tensor(a) for a in (row_ptr, col, val, x)]
    with_plan = tops.ell_spmv_op(*args, semiring=semiring, plan=plan)
    without = tops.ell_spmv_op(*args, semiring=semiring)
    assert torch.equal(with_plan, without)


@pytest.mark.parametrize("entry", ["op", "kernel"])
def test_a_plan_of_other_rows_raises(entry):
    """The kernel sizes its shared-memory stages by the plan, so a plan
    made from other rows (another shard, a graph split again) is refused
    before anything launches, by the op on any device and by the kernel's
    wrapper."""
    row_ptr, col, val, x = ell_inputs("plus_times", 3, dyadic=False, seed=4)
    args = [torch.as_tensor(a) for a in (row_ptr, col, val, x)]
    fewer_rows = kell.row_plan(row_ptr[:-1])
    fewer_slots = kell.row_plan(np.minimum(row_ptr, row_ptr[-1] - 1))
    for plan in (fewer_rows, fewer_slots):
        with pytest.raises(ValueError, match="does not belong"):
            if entry == "op":
                tops.ell_spmv_op(*args, semiring="plus_times",
                                 plan=plan.to("cpu"))
            else:
                kell.ell_spmv(args[0], args[1], args[2],
                              kell.query_minor(args[3], 0.0), plan.to("cpu"),
                              semiring="plus_times", num_queries=3)


def test_query_minor_pads_with_the_identity():
    x = torch.arange(15, dtype=torch.float32).reshape(3, 5)
    xt = kell.query_minor(x, float("inf"))
    assert xt.shape == (5, 4) and xt.is_contiguous()
    assert torch.equal(xt[:, :3], x.t()) and bool((xt[:, 3] == np.inf).all())
    assert kell.query_minor(x[:1], 0.0).shape == (5, 4)
    assert kell.query_minor(torch.zeros(8, 2), 0.0).shape == (2, 8)


def test_splits_keep_the_row_plan_of_their_rows():
    """``degree_split`` and ``shard_degree_split`` carry the sparse
    kernel's plan of the rows they hold, so ``SplitCache`` keeps it for
    every engine over the graph."""
    from repro_torch.core import hybrid as TH
    from repro_torch.core import partition as TPT

    g = TG.rmat(9, 8, seed=3)
    hg = TH.degree_split(g, 32, semiring="min")
    want = kell.row_plan(hg.ell_row_ptr)
    np.testing.assert_array_equal(hg.ell_plan.blocks, want.blocks)
    np.testing.assert_array_equal(hg.ell_plan.long_rows, want.long_rows)
    pg = TPT.partition(g, 4, TPT.HIGH)
    shd = TH.shard_degree_split(pg, 2, "min", [16, 16])
    for s in range(2):
        want = kell.row_plan(shd.ell_row_ptr[s])
        np.testing.assert_array_equal(shd.ell_plan[s].blocks, want.blocks)
        np.testing.assert_array_equal(plan_cover(shd.ell_row_ptr[s],
                                                 shd.ell_plan[s]), 1)
