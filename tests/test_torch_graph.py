"""The port's host graph layer is the JAX package's, array for array.

``repro_torch.core.graph``/``partition`` are numpy copies; the same seed must
give array-equal graphs, partitions and fused-block metadata (tolerance:
exact equality, including dtypes).  The port's CSC in-edge rows, padded
to the widest row, must be the JAX package's transposed ELL block.
"""
import dataclasses

import numpy as np
import pytest

from test_torch_jaxref import JG, JPT

from repro_torch import convert
from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT


def _assert_same(a, b, path="root"):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{path}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(b):
            if not f.compare:   # a cache, not part of the value
                continue
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _graphs(kind, scale=8):
    if kind == "rmat":
        return JG.rmat(scale, 8, seed=3), TG.rmat(scale, 8, seed=3)
    return JG.uniform(scale, 8, seed=3), TG.uniform(scale, 8, seed=3)


@pytest.mark.parametrize("kind", ["rmat", "uniform"])
def test_generators_are_array_equal(kind):
    jg, tg = _graphs(kind)
    _assert_same(jg, tg)
    _assert_same(jg.with_uniform_weights(seed=7),
                 tg.with_uniform_weights(seed=7))
    _assert_same(jg.reverse(), tg.reverse())


def test_from_edge_list_dedup_is_array_equal():
    rng = np.random.default_rng(0)
    src = rng.integers(0, 50, 400)
    dst = rng.integers(0, 50, 400)
    _assert_same(JG.from_edge_list(src, dst, 50, dedup=True),
                 TG.from_edge_list(src, dst, 50, dedup=True))
    with pytest.raises(ValueError, match="vertex ids"):
        TG.from_edge_list(np.array([0, 60]), np.array([1, 2]), 50)


@pytest.mark.parametrize("kind", ["rmat", "uniform"])
@pytest.mark.parametrize("num_parts", [1, 2, 3])
@pytest.mark.parametrize("strategy", ["rand", "high", "low"])
def test_partition_and_blocks_are_array_equal(kind, num_parts, strategy):
    jg, tg = _graphs(kind)
    jg = jg.with_uniform_weights(seed=1)
    tg = tg.with_uniform_weights(seed=1)
    jp = JPT.partition(jg, num_parts, strategy, include_reverse=True)
    tp = TPT.partition(tg, num_parts, strategy, include_reverse=True)
    _assert_same(jp, tp)
    for block_e in (128, 256):
        for d in ("fwd", "rev"):
            jb = JPT.build_block_metadata(getattr(jp, d), block_e=block_e)
            tb = TPT.build_block_metadata(getattr(tp, d), block_e=block_e)
            _assert_same(jb, tb)
            # and the converter carries the JAX objects over unchanged
            _assert_same(convert.block_metadata(jb), tb)
    _assert_same(convert.partitioned_graph(jp), tp)


@pytest.mark.parametrize("frac", [0.5, 0.7])
def test_cpu_edge_fraction_split_is_array_equal(frac):
    jg, tg = _graphs("rmat")
    _assert_same(JPT.partition(jg, 2, JPT.HIGH, cpu_edge_fraction=frac),
                 TPT.partition(tg, 2, TPT.HIGH, cpu_edge_fraction=frac))


def test_block_ids_are_non_decreasing_per_partition():
    """The kernel's reduction relies on it: base + local never decreases
    along a partition row, padding included."""
    tg = TG.rmat(9, 8, seed=11)
    for strategy in TPT.STRATEGIES:
        pg = TPT.partition(tg, 3, strategy)
        blk = TPT.build_block_metadata(pg.fwd, block_e=128)
        ids = np.repeat(blk.base, blk.block_e, axis=1) + blk.local
        assert (np.diff(ids, axis=1) >= 0).all()
        assert ids.max() < pg.seg_count


def csc_as_ell(tc, num_parts, v_max):
    """Pad each CSC row to ``kmax`` slots with the sentinel ``v_max`` (local
    ids, weight 0): the JAX package's ``TransposedEll`` block."""
    kreal = tc.kreal.ravel().astype(np.int64)
    rows = np.repeat(np.arange(num_parts * v_max), kreal)
    slots = np.arange(tc.nnz) - np.repeat(tc.row_ptr[:-1].astype(np.int64),
                                          kreal)
    col = np.full((num_parts * v_max, tc.kmax), v_max, np.int32)
    col[rows, slots] = tc.col - (rows // v_max) * v_max
    val = None
    if tc.val is not None:
        val = np.zeros((num_parts * v_max, tc.kmax), np.float32)
        val[rows, slots] = tc.val
        val = val.reshape(num_parts, v_max, tc.kmax)
    return col.reshape(num_parts, v_max, tc.kmax), val


@pytest.mark.parametrize("kind", ["rmat", "uniform"])
@pytest.mark.parametrize("num_parts", [1, 2, 3])
@pytest.mark.parametrize("strategy", ["rand", "high", "low"])
@pytest.mark.parametrize("weighted", [False, True])
def test_transposed_rows_are_the_jax_ell_rows(kind, num_parts, strategy,
                                              weighted):
    jg, tg = _graphs(kind)
    if weighted:
        jg, tg = jg.with_uniform_weights(seed=1), tg.with_uniform_weights(
            seed=1)
    jp = JPT.partition(jg, num_parts, strategy)
    tp = TPT.partition(tg, num_parts, strategy)
    jt = JPT.build_transposed_ell(jp.fwd, jp.v_max)
    tc = TPT.build_transposed_csc(tp.fwd, tp.v_max)
    col, val = csc_as_ell(tc, num_parts, tp.v_max)
    _assert_same(jt.col, col)
    _assert_same(jt.val, val)
    for name in ("kreal", "deg_out", "deg_bnd", "kmax"):
        _assert_same(getattr(jt, name), getattr(tc, name), name)
    assert tc.row_ptr[-1] == tc.nnz == tc.col.shape[0]
