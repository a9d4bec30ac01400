"""The port's degree split, planner and two-engine functions against the JAX
package's ``repro.core.hybrid`` and ``repro.core.perf_model``.

- Split: ``degree_split`` for k in {0, 128, V} equals the JAX split array
  for array (perm, inverse, dense block, out-degrees, edge counts), and the
  remainder's CSR rows padded to ``kmax`` with the sentinel and the
  ⊗-identity equal the JAX ELL block (exact equality).
- Planner: candidate ladders, ranked tables, ``choose_k_dense`` and
  ``split_mode`` equal (exact: integers, and floats from the same formula).
- Two-engine functions on one split (the JAX split carried across by
  ``convert.hybrid_graph``): min semirings bit for bit, scanned counts
  equal as integers; plus_times within ``rtol=1e-6``, the f32 reassociation
  of PageRank-sized sums at scale 9, as the two packages sum rows in
  different orders.
"""
import importlib

import numpy as np
import pytest
import torch

from test_torch_jaxref import JG, JPT, assert_same_planner_table, jcc

from repro_torch import convert
from repro_torch.algorithms import cc as tcc
from repro_torch.core import graph as TG
from repro_torch.core import hybrid as TH
from repro_torch.core import partition as TPT
from repro_torch.core import perf_model as tpm

JH = importlib.import_module("repro.core.hybrid")
jpm = importlib.import_module("repro.core.perf_model")

SEMIRINGS = ["plus_times", "min_plus", "min"]


def _graphs(weighted=False, symmetric=False, scale=9):
    jg, tg = JG.rmat(scale, 8, seed=6), TG.rmat(scale, 8, seed=6)
    if weighted:
        jg, tg = (g.with_uniform_weights(seed=2) for g in (jg, tg))
    if symmetric:
        jg, tg = jcc.symmetrize(jg), tcc.symmetrize(tg)
    return jg, tg


def _padded(hg):
    """The port's remainder rows as the JAX ELL block."""
    n = hg.num_vertices
    lengths = np.diff(hg.ell_row_ptr)
    col = np.full((n, hg.kmax), n, dtype=np.int32)
    val = np.full((n, hg.kmax), TH.SEMIRINGS[hg.semiring][2],
                  dtype=np.float32)
    rows = np.repeat(np.arange(n), lengths)
    slots = np.arange(hg.sparse_edges) - np.repeat(hg.ell_row_ptr[:-1],
                                                   lengths)
    col[rows, slots] = hg.ell_col
    val[rows, slots] = hg.ell_val
    return col, val


def assert_same_split(got, want):
    for name in ("perm", "inv_perm", "dense_block", "out_deg"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    for name in ("num_vertices", "num_edges", "k_dense", "dense_edges",
                 "sparse_edges", "semiring", "mode"):
        assert getattr(got, name) == getattr(want, name), name
    col, val = _padded(got)
    np.testing.assert_array_equal(col, want.ell_col)
    np.testing.assert_array_equal(val, want.ell_val)
    assert got.kmax == want.ell_col.shape[1]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("k", [0, 128, 512])
def test_degree_split_equals_jax(k, semiring, weighted):
    jg, tg = _graphs(weighted)
    assert_same_split(TH.degree_split(tg, k, semiring),
                      JH.degree_split(jg, k, semiring))


def test_reverse_split_shares_the_ranking_and_equals_jax():
    jg, tg = _graphs(weighted=True)
    ranking = TH.degree_ranking(tg)
    rev = tg.reverse()
    layout = TH.split_layout(rev, 128, ranking)
    assert_same_split(TH.degree_split(rev, 128, "min_plus", layout),
                      JH.degree_split(jg.reverse(), 128, "min_plus"))
    np.testing.assert_array_equal(TH.edge_max_ranks(tg),
                                  JH.edge_max_ranks(jg))
    with pytest.raises(ValueError, match="k_dense"):
        TH.degree_split(rev, 64, "min_plus", layout)


def test_in_degrees_and_skew_signal_equal_jax():
    jg, tg = _graphs()
    np.testing.assert_array_equal(tg.in_degrees(), jg.in_degrees())
    jp = JPT.partition(jg, 3, JPT.HIGH)
    tp = TPT.partition(tg, 3, TPT.HIGH)
    jb = JPT.build_block_metadata(jp.fwd, block_e=128)
    tb = TPT.build_block_metadata(tp.fwd, block_e=128)
    assert TPT.SPAN_HIST_BINS == JPT.SPAN_HIST_BINS
    np.testing.assert_array_equal(tb.span_histogram(), jb.span_histogram())
    for edge in (129, 513, 4097):
        assert tb.degree_skew(edge) == jb.degree_skew(edge)
    with pytest.raises(ValueError, match="bin edge"):
        tb.degree_skew(100)


def test_planner_tables_equal_jax():
    assert tpm.K_DENSE_CAP == jpm.K_DENSE_CAP
    for n in (64, 128, 1000, 1 << 12, 1 << 20):
        for skewed in (True, False):
            assert tpm.k_dense_candidates(n, skewed) == (
                jpm.k_dense_candidates(n, skewed))
    for density in (1e-6, 0.01, 0.5):
        assert tpm.dense_block_rate(density) == jpm.dense_block_rate(density)
        assert tpm.hybrid_makespan_tpu(1e5, density, 3e6) == (
            jpm.hybrid_makespan_tpu(1e5, density, 3e6, 0.0))
        assert tpm.hybrid_makespan_tpu(
            1e5, density, 3e6, boundary_slots=4e4, num_chips=4,
            bytes_per_edge=12.0, msg_bytes=8.0) == jpm.hybrid_makespan_tpu(
                1e5, density, 3e6, 4e4, num_chips=4, bytes_per_edge=12.0,
                msg_bytes=8.0)
    for symmetric in (False, True):
        jg, tg = _graphs(symmetric=symmetric)
        ranks = TH.edge_max_ranks(tg)
        cands = tpm.k_dense_candidates(tg.num_vertices)
        assert_same_planner_table(
            tpm.rank_k_dense(ranks, tg.num_edges, cands + [7]),
            jpm.rank_k_dense(ranks, tg.num_edges, cands + [7]))
        (k, table), (jk, jtable) = (
            tpm.choose_k_dense(ranks, tg.num_edges, cands),
            jpm.choose_k_dense(ranks, tg.num_edges, cands))
        assert k == jk
        assert_same_planner_table(table, jtable)
        got, want = TH.auto_degree_split(tg), JH.auto_degree_split(jg)
        assert_same_planner_table(got.model_table, want.model_table)
        assert_same_split(got, want)
        plan = TH.plan_degree_split(tg)
        assert (plan["k_dense"], plan["mode"]) == (want.k_dense, want.mode)
        assert plan["table"] == got.model_table
        fixed = TH.plan_degree_split(tg, 7)
        assert fixed["k_dense"] == 7 and 7 in [r["k_dense"]
                                              for r in fixed["table"]]
    for args in ((0, 1024, 10), (1024, 1024, 0), (256, 1024, 10),
                 (256, 1024, 0), (2048, 1024, 5)):
        assert tpm.split_mode(*args) == jpm.split_mode(*args)


def _tensors(hg):
    return (torch.as_tensor(hg.dense_block), torch.as_tensor(hg.ell_row_ptr),
            torch.as_tensor(hg.ell_col), torch.as_tensor(hg.ell_val))


def _values(semiring, q, n, seed):
    rng = np.random.default_rng(seed)
    if semiring == "plus_times":
        return rng.uniform(0, 1, (q, n)).astype(np.float32)
    x = rng.integers(0, 20, (q, n)).astype(np.float32)
    x[rng.random((q, n)) < 0.5] = np.inf
    return x


@pytest.mark.parametrize("q", [1, 3])
@pytest.mark.parametrize("semiring", SEMIRINGS)
@pytest.mark.parametrize("k", [0, 128])
def test_hybrid_spmv_equals_jax(k, semiring, q):
    jg, _ = _graphs(weighted=True)
    jh = JH.degree_split(jg, k, semiring)
    th = convert.hybrid_graph(jh)
    x = _values(semiring, q, jg.num_vertices, seed=k + q)
    want = np.asarray(JH.hybrid_spmv(jh.dense_block, jh.ell_col, jh.ell_val,
                                     x, semiring=semiring, k_dense=k))
    xt = torch.as_tensor(x)
    got = TH.hybrid_spmv(*_tensors(th), xt, semiring=semiring,
                         k_dense=k).numpy()
    if semiring == "plus_times":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-30)
    else:
        np.testing.assert_array_equal(got, want)
    one = TH.hybrid_spmv(*_tensors(th), xt[0], semiring=semiring,
                         k_dense=k).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("semiring,early_exit", [
    ("min_plus", False), ("min", False), ("min", True)])
@pytest.mark.parametrize("k", [0, 128])
def test_hybrid_spmv_scan_equals_jax(k, semiring, early_exit):
    jg, _ = _graphs(weighted=True)
    jh = JH.degree_split(jg, k, semiring)
    th = convert.hybrid_graph(jh)
    n = jg.num_vertices
    rng = np.random.default_rng(k)
    if early_exit:   # the uniform licence: every live message is equal
        x = np.where(rng.random((3, n)) < 0.3, 2.0, np.inf).astype(
            np.float32)
    else:
        x = _values(semiring, 3, n, seed=k)
    skip = rng.random((3, n)) < 0.4
    kreal = (jh.ell_col != n).sum(axis=1).astype(np.int32)
    y_j, cnt_j = JH.hybrid_spmv_scan(
        jh.dense_block, jh.ell_col, jh.ell_val, x, kreal, semiring=semiring,
        k_dense=k, early_exit=early_exit, skip=skip if early_exit else None)
    y_t, cnt_t = TH.hybrid_spmv_scan(
        *_tensors(th), torch.as_tensor(x), semiring=semiring, k_dense=k,
        early_exit=early_exit,
        skip=torch.as_tensor(skip) if early_exit else None)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    y_spmv = TH.hybrid_spmv(*_tensors(th), torch.as_tensor(x),
                            semiring=semiring, k_dense=k)
    assert torch.equal(y_t, y_spmv)


@pytest.mark.parametrize("k", [0, 128, 512])
def test_hybrid_pagerank_equals_jax(k):
    jg, _ = _graphs()
    jh = JH.degree_split(jg, k)
    want = JH.hybrid_pagerank(jh, num_iterations=10)
    got = TH.hybrid_pagerank(convert.hybrid_graph(jh), num_iterations=10,
                             device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="plus_times"):
        TH.hybrid_pagerank(convert.hybrid_graph(
            JH.degree_split(jg, k, "min")), device="cpu")


def test_convert_keeps_the_split():
    jg, tg = _graphs(weighted=True)
    jh = JH.degree_split(jg, 128, "min_plus")
    got, port = convert.hybrid_graph(jh), TH.degree_split(tg, 128,
                                                          "min_plus")
    for name in ("ell_row_ptr", "ell_col", "ell_val", "dense_block"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(port, name), name)
    assert got.kmax == port.kmax and got.mode == port.mode
