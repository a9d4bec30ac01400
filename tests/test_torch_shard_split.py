"""The port's per-shard degree split and sharded planner against the JAX
package's, on the CPU.

Over rmat/uniform graphs x P in {1, 2, 4} x every shard count S dividing P
x RAND/HIGH/LOW: ``shard_plan_inputs`` and ``perf_model.plan_shards`` equal
(records with ``boundary_slots`` and ``t_comm``), and every array of
``shard_degree_split`` equal to the JAX ``ShardHybridData``, the port's CSR
remainder rows padded to ``kmax`` as the JAX ELL block is, and its boundary
edges' flat slot ids equal to the JAX block metadata's ``base + local``
over each shard's real edges.  Everything here
is integer or copied f32 data (the dense block sums multi-edges in edge
order in both), so equality is exact.
"""
import importlib

import numpy as np
import pytest

from test_torch_jaxref import engine_case

from repro_torch.core import hybrid as TH
from repro_torch.core import perf_model as tpm

JH = importlib.import_module("repro.core.hybrid")
jpm = importlib.import_module("repro.core.perf_model")

SCALE = 7
GRID = [(kind, parts, shards, strategy)
        for kind in ("rmat", "uniform") for parts in (1, 2, 4)
        for shards in (1, 2, 4) if parts % shards == 0
        for strategy in ("rand", "high", "low")]
# (semiring, use_reverse, use_weights, direction_switch)
SPLITS = [("plus_times", False, True, False), ("min_plus", False, True, True),
          ("min", False, False, True), ("plus_times", True, False, False),
          ("min_plus", True, True, True)]
MUL_IDENT = {"plus_times": 1.0, "min_plus": 0.0, "min": 0.0}


def _padded_rows(shd):
    """The port's CSR remainder as the JAX ``[S, n_max, kmax]`` block."""
    n, k = shd.n_max, shd.kmax
    col = np.full((shd.num_shards, n, k), n, dtype=np.int32)
    val = np.full((shd.num_shards, n, k), MUL_IDENT[shd.semiring],
                  dtype=np.float32)
    for s in range(shd.num_shards):
        lens = np.diff(shd.ell_row_ptr[s])
        rows = np.repeat(np.arange(n), lens)
        slots = np.arange(len(rows)) - np.repeat(shd.ell_row_ptr[s][:-1], lens)
        col[s, rows, slots] = shd.ell_col[s]
        val[s, rows, slots] = shd.ell_val[s]
    return col, val


def assert_same_shard_split(got, want):
    for name in ("semiring", "num_shards", "parts_per_shard", "v_max",
                 "num_parts", "o_max", "k_dense", "n_max", "num_slots",
                 "wire_width", "has_boundary", "has_remote"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("n_vert", "dense", "slot", "hid", "send_idx", "recv_ids",
                 "loc_idx", "loc_ids", "push_src", "push_dst", "push_w"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
            assert a.shape == b.shape, name
    col, val = _padded_rows(got)
    assert got.kmax == want.ell_col.shape[2]
    np.testing.assert_array_equal(col, want.ell_col)
    np.testing.assert_array_equal(val, want.ell_val)
    # each exchanged value's source partition is the one whose outbox row
    # its flat index lies in
    pl, per_part = got.parts_per_shard, got.num_parts * got.o_max
    shard_of = np.arange(got.num_shards)
    real = got.send_idx < got.num_slots
    want_src = shard_of[:, None, None] * pl + got.send_idx // per_part
    np.testing.assert_array_equal(got.recv_src.transpose(1, 0, 2),
                                  np.where(real, want_src, -1))
    real = got.loc_idx < got.num_slots
    np.testing.assert_array_equal(
        got.loc_src, np.where(real, shard_of[:, None] * pl
                              + got.loc_idx // per_part, -1))
    # the kernel's flat ids are the JAX block metadata's base + local
    flat = (np.repeat(want.b_base, want.b_block, axis=1) + want.b_local)
    assert (got.b_weight is None) == (want.b_weight is None)
    for s in range(got.num_shards):
        src, f, w = got.boundary(s)
        c = int(want.b_mask[s].sum())
        assert len(src) == c and np.all(want.b_mask[s, :c] == 1)
        np.testing.assert_array_equal(src, want.b_src[s, :c])
        np.testing.assert_array_equal(f, flat[s, :c])
        if w is not None:
            np.testing.assert_array_equal(w, want.b_weight[s, :c])
        # past each shard's prefix, only the sinks
        assert np.all(got.b_src[s, c:] == got.n_max)
        assert np.all(got.b_flat[s, c:] == got.num_slots)


@pytest.mark.parametrize("kind,parts,shards,strategy", GRID,
                         ids=lambda x: str(x))
def test_shard_split_and_plan_equal_jax(kind, parts, shards, strategy):
    _, jp, tp = engine_case(kind, parts, strategy, scale=SCALE,
                            weighted=True, include_reverse=True)
    got_in = TH.shard_plan_inputs(tp, shards)
    want_in = JH.shard_plan_inputs(jp, shards)
    for a, b in zip(got_in[0], want_in[0]):
        np.testing.assert_array_equal(a, b)
    assert got_in[1:] == want_in[1:]
    ranks, edges, slots, nverts = got_in
    cands = [tpm.k_dense_candidates(n) for n in nverts]
    for k in (None, 128):
        plan = tpm.plan_shards(ranks, edges, slots, cands, k_dense=k)
        assert plan == jpm.plan_shards(ranks, edges, slots, cands,
                                       k_dense=k)
    ks = [rec["k_dense"] for rec in plan["per_shard"]]
    for semiring, rev, weights, switch in SPLITS:
        got = TH.shard_degree_split(tp, shards, semiring, ks,
                                    use_reverse=rev, use_weights=weights,
                                    direction_switch=switch)
        want = JH.shard_degree_split(jp, shards, semiring, ks,
                                     use_reverse=rev, use_weights=weights,
                                     direction_switch=switch)
        assert_same_shard_split(got, want)


def test_split_cache_matches_direct_build():
    _, _, tp = engine_case("rmat", 4, "high", scale=SCALE, weighted=True,
                           include_reverse=True)
    cache = TH.splits_of(tp)
    plan = cache.shard_plan(2, None, 1024)
    ks = [rec["k_dense"] for rec in plan["per_shard"]]
    for semiring, rev, weights, switch in SPLITS:
        got = cache.shard_split(2, ks, rev, semiring, weights, switch)
        assert got is cache.shard_split(2, ks, rev, semiring, weights, switch)
        want = TH.shard_degree_split(tp, 2, semiring, ks, use_reverse=rev,
                                     use_weights=weights,
                                     direction_switch=switch)
        col, val = _padded_rows(want)
        np.testing.assert_array_equal(_padded_rows(got)[0], col)
        np.testing.assert_array_equal(_padded_rows(got)[1], val)
        np.testing.assert_array_equal(got.recv_src, want.recv_src)
        np.testing.assert_array_equal(got.loc_src, want.loc_src)


def test_use_reverse_without_reverse_edges_raises():
    _, jp, tp = engine_case("rmat", 2, "rand", scale=SCALE)
    for mod, pg in ((TH, tp), (JH, jp)):
        with pytest.raises(ValueError, match="include_reverse=True"):
            mod.shard_degree_split(pg, 2, "plus_times", [0, 0],
                                   use_reverse=True)
