"""The CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor ``repro``, so it also runs where only the
port is installed: ``python -m pytest -q -m gpu tests/test_torch_kernel_card.py``.
Without a card its tests skip (the kernel has no CPU mode); the helpers
below also feed ``test_torch_fused_superstep.py``'s CPU parity tests.

Tolerances: the min kinds (bfs, sssp, cc) bit for bit, a min is order-free;
the sum kinds (pagerank, bc_fwd, bc_bwd) ``rtol=1e-6, atol=1e-9``, the f32
reassociation bound ``tests/test_fused_superstep.py`` uses between fused
and reference.  Two launches on the same inputs are bit-equal (the kernel's
sums take a fixed order).  The bottom-up scan bit for bit in every mode
(a min is order-free, and its counts are integers).  The hybrid kernels:
``ell_spmv`` (min, min_plus) and ``dense_spmv_minplus`` bit for bit;
``ell_spmv`` (plus_times) and ``dense_spmv`` within their own f32 rounding
bound of a float64 evaluation (``depth * 2^-24 * sum|terms|``, the depth
from the kernel's fixed summation tree), since the plain version sums with
atomics in no fixed order; two launches bit-equal.  The outbox kernel:
min modes bit for bit, sums bit for bit on dyadic messages (exact in any
order) and within its f32 rounding bound of float64 on continuous ones;
two launches bit-equal.
"""
import math

import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.kernels import bottomup as kbu
from repro_torch.kernels import dense_spmv as kds
from repro_torch.kernels import ell_spmv as kell
from repro_torch.kernels import fused_superstep as kfs
from repro_torch.kernels import outbox_reduce as kob
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

KINDS = ["bfs", "sssp", "cc", "pagerank", "bc_fwd", "bc_bwd"]


def port_program(kind, n):
    """The port's program whose EdgeMessage has device kind ``kind``."""
    def alg(name):   # the package re-exports functions named like modules
        return importlib.import_module(f"repro_torch.algorithms.{name}")

    return {
        "bfs": lambda: alg("bfs").BFS_PROGRAM,
        "sssp": lambda: alg("sssp").SSSP_PROGRAM,
        "cc": lambda: alg("cc").CC_PROGRAM,
        "pagerank": lambda: alg("pagerank").make_pagerank_program(n),
        "bc_fwd": lambda: alg("bc").FORWARD_PROGRAM,
        "bc_bwd": lambda: alg("bc").BACKWARD_PROGRAM,
    }[kind]()


def make_inputs(kind, q, pl, v_max, rng):
    """(vstate [Q, Pl, K, v_max], scal [Q, Pl, S]) with values that exercise
    every branch of the kind's message: frontier and non-frontier levels,
    +inf, inactive sources, zero sigma."""
    shape = (q, pl, v_max)
    levels = rng.choice(np.array([0.0, 1.0, 2.0, 3.0, np.inf], np.float32),
                        size=shape)
    active = (rng.random(shape) < 0.5).astype(np.float32)
    consts = []
    if kind == "bfs":
        cols = [levels]
    elif kind == "sssp":
        dist = rng.uniform(0, 50, shape).astype(np.float32)
        dist[rng.random(shape) < 0.2] = np.inf
        cols = [dist, active]
    elif kind == "cc":
        cols = [rng.integers(0, 10 * v_max, shape).astype(np.float32), active]
    elif kind == "pagerank":
        # Dyadic ranks and inverse degrees: every product and every partial
        # sum is exact in f32, so any two summation orders agree.  With
        # continuous values a hub of a few hundred edges differs by ~1e-6
        # relative between orders: the reassociation the engine tests bound
        # at the algorithm level.
        cols = [rng.integers(0, 64, shape).astype(np.float32) * 2.0 ** -16,
                2.0 ** -rng.integers(0, 5, shape).astype(np.float32)]
    elif kind == "bc_fwd":
        cols = [levels, rng.integers(1, 20, shape).astype(np.float32)]
    else:
        sigma = rng.integers(0, 20, shape).astype(np.float32)
        cols = [levels, sigma, rng.random(shape, dtype=np.float32) * 4]
        consts = [np.full((q, pl), 4.0, np.float32)]
    vstate = np.stack(cols, axis=2)
    scal = np.stack([np.full((q, pl), 1.0, np.float32)] + consts, axis=2)
    return vstate, scal


def port_op(tprog, vstate, scal, blk, dst_ext, seg, device="cpu"):
    """The port's ``fused_superstep_op`` on numpy inputs."""
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    spec = tprog.edge_msg
    weight = put(blk.weight, torch.float32) if spec.use_weight else None
    return tops.fused_superstep_op(
        spec, put(vstate, torch.float32), weight, put(scal, torch.float32),
        put(blk.src, torch.int32), put(blk.local, torch.int32),
        put(blk.mask, torch.int32), put(blk.base, torch.int32),
        put(dst_ext, torch.int64), num_segments=seg, combine=tprog.combine,
        block_e=blk.block_e)


# (semiring, early_exit, skip) cases of the bottom-up scan
SCAN_MODES = [("min", False, False), ("min", True, False), ("min", True, True),
              ("min_plus", False, False)]


def scan_inputs(semiring, early_exit, q, rng, *, v=600, x_len=500):
    """CSR rows for ``ops.bottomup_scan_op`` with empty rows, short rows,
    and rows longer than one warp step (40, 130, 300 slots), plus
    ``(x [Q, x_len], skip [Q, v])``.  With early exit every live message of
    a query holds one value (the frontier-uniform licence); else the
    messages vary and a fifth of them are +inf."""
    lengths = rng.choice([0, 0, 1, 2, 3, 5, 8, 13], size=v)
    lengths[[3, 50, 51, 400]] = [40, 130, 300, 33]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = rng.integers(0, x_len, size=int(row_ptr[-1])).astype(np.int32)
    val = (rng.uniform(0.5, 2.0, size=col.shape).astype(np.float32)
           if semiring == "min_plus" else None)
    if early_exit:
        live = rng.random((q, x_len)) < rng.choice([0.02, 0.2, 0.6], (q, 1))
        x = np.where(live, 3.0, np.inf).astype(np.float32)
    else:
        x = rng.uniform(0, 100, (q, x_len)).astype(np.float32)
        x[rng.random((q, x_len)) < 0.2] = np.inf
    skip = rng.random((q, v)) < 0.3
    return row_ptr, col, val, x, skip


def port_scan(row_ptr, col, val, x, skip, semiring, early_exit,
              device="cpu"):
    """The port's ``bottomup_scan_op`` on numpy inputs, as numpy."""
    def put(a, dtype):
        return (None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), dtype=dtype, device=device))

    y, scanned = tops.bottomup_scan_op(
        put(row_ptr, torch.int32), put(col, torch.int32),
        put(val, torch.float32), put(x, torch.float32), semiring=semiring,
        early_exit=early_exit, skip=put(skip, torch.bool))
    return y.cpu().numpy(), scanned.cpu().numpy()


def assert_parity(combine, got, want):
    if combine == "min":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("parts,strategy,block_e", [
    (1, "rand", 128), (2, "high", 256), (3, "low", 1024)])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(cuda, kind, parts, strategy, block_e):
    tg = TG.rmat(10, 8, seed=5).with_uniform_weights(seed=2)
    tp = TPT.partition(tg, parts, strategy, include_reverse=True)
    ea = tp.rev if kind == "bc_bwd" else tp.fwd
    blk = TPT.build_block_metadata(ea, block_e=block_e)
    tprog = port_program(kind, tp.num_vertices)
    vstate, scal = make_inputs(kind, 3, parts, tp.v_max,
                               np.random.default_rng(1))
    seg = tp.seg_count
    before = kfs.fused_superstep.launches
    got = port_op(tprog, vstate, scal, blk, ea.dst_ext, seg, cuda)
    again = port_op(tprog, vstate, scal, blk, ea.dst_ext, seg, cuda)
    torch.cuda.synchronize()
    assert kfs.fused_superstep.launches == before + 2
    want = port_op(tprog, vstate, scal, blk, ea.dst_ext, seg).numpy()
    assert_parity(tprog.combine, got.cpu().numpy(), want)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_engine_fused_matches_reference_on_card(cuda):
    from repro_torch.algorithms import (bfs_batched, connected_components,
                                        pagerank, symmetrize)
    from repro_torch.core.bsp import BSPEngine

    g = TG.rmat(11, 8, seed=4)
    pg = TPT.partition(g, 3, TPT.HIGH)
    # plain push: one fused launch per superstep
    ref = BSPEngine(pg, device=cuda, direction_switch=False)
    fus = BSPEngine(pg, fused=True, block_e=256, device=cuda,
                    direction_switch=False)
    kfs.fused_superstep.launches = 0
    lr, sr = bfs_batched(ref, [0, 9, 99])
    lf, sf = bfs_batched(fus, [0, 9, 99])
    assert kfs.fused_superstep.launches == int(sf.max())
    np.testing.assert_array_equal(lr, lf)
    np.testing.assert_array_equal(sr, sf)
    np.testing.assert_allclose(pagerank(ref, 10), pagerank(fus, 10),
                               rtol=1e-6, atol=1e-9)
    pgs = TPT.partition(symmetrize(g), 3, TPT.LOW)
    cr, _ = connected_components(BSPEngine(pgs, device=cuda))
    cf, _ = connected_components(BSPEngine(pgs, fused=True, device=cuda))
    np.testing.assert_array_equal(cr, cf)


@pytest.mark.gpu
@pytest.mark.parametrize("semiring,early_exit,skip", SCAN_MODES)
@pytest.mark.parametrize("q", [1, 5])
def test_bottomup_kernel_matches_plain_on_card(cuda, semiring, early_exit,
                                               skip, q):
    rng = np.random.default_rng(q)
    row_ptr, col, val, x, skip_mask = scan_inputs(semiring, early_exit, q,
                                                  rng)
    skip_mask = skip_mask if skip else None
    before = kbu.bottomup_scan.launches
    got = port_scan(row_ptr, col, val, x, skip_mask, semiring, early_exit,
                    cuda)
    assert kbu.bottomup_scan.launches == before + 1
    want = port_scan(row_ptr, col, val, x, skip_mask, semiring, early_exit)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("direction", ["auto", "pull"])
def test_engine_directions_match_push_on_card(cuda, direction):
    """Both backends, voting or forced to pull, against plain push on the
    reference backend: bit for bit with equal steps; the scan kernel
    launches in every pull superstep."""
    from repro_torch.algorithms import (bfs_batched, connected_components,
                                        sssp_batched, symmetrize)
    from repro_torch.core.bsp import BSPEngine

    g = TG.rmat(11, 8, seed=4).with_uniform_weights(seed=3)
    pg = TPT.partition(g, 2, TPT.HIGH)
    pgs = TPT.partition(symmetrize(g), 2, TPT.RAND)
    push = BSPEngine(pg, device=cuda, direction_switch=False)
    push_s = BSPEngine(pgs, device=cuda, direction_switch=False)
    kbu.bottomup_scan.launches = 0
    for backend in ("reference", "fused"):
        eng = BSPEngine(pg, backend=backend, block_e=256, device=cuda,
                        direction=direction)
        eng_s = BSPEngine(pgs, backend=backend, block_e=256, device=cuda,
                          direction=direction)
        for run in (lambda e: bfs_batched(e, [0, 9, 99]),
                    lambda e: sssp_batched(e, [0, 9])):
            (a, sa), (b, sb) = run(push), run(eng)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(sa, sb)
        (la, sa), (lb, sb) = (connected_components(push_s),
                              connected_components(eng_s))
        np.testing.assert_array_equal(la, lb)
        assert sa == sb
    assert kbu.bottomup_scan.launches > 0


def ell_sum_depth(kmax):
    """Roundings on the longest path of ``ell_spmv``'s sum of a row of up
    to ``kmax`` slots: a run of 128, the warp and block trees (5 + 4), the
    segments in order, and the product (``csrc/ell_spmv.cu``)."""
    return 128 + 9 + math.ceil(kmax / (512 * 128)) + 1


def dense_sum_depth(k):
    """Roundings of ``dense_spmv``'s sum over ``k``: a slice of 128, the
    pairwise tree over the slices and the product (``csrc/dense_spmv.cu``)."""
    return 128 + math.ceil(math.log2(max(math.ceil(k / 128), 1))) + 1


def within_f32_bound(got, exact, mag, depth):
    """|got - exact| <= depth * 2^-24 * sum|terms| everywhere."""
    slack = (got.double() - exact).abs() - 1.01 * depth * 2.0 ** -24 * mag
    return bool((slack <= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "min"])
@pytest.mark.parametrize("q", [1, 3, 9])
def test_ell_kernel_matches_plain_on_card(cuda, semiring, q):
    """Rows of every length class: empty, a thread's (<= 32), a warp's
    (<= 4096), a block's, and a hub of more than one 65,536-slot segment."""
    rng = np.random.default_rng(q)
    lengths = rng.choice([0, 0, 1, 5, 32, 33, 200], size=3000)
    lengths[[3, 50, 51, 400, 2999]] = [4096, 4097, 9000, 70000, 140000]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    x_len = 5000
    col = rng.integers(0, x_len, size=int(row_ptr[-1])).astype(np.int32)
    val = rng.uniform(0.5, 2.0, size=col.shape).astype(np.float32)
    x = rng.uniform(0, 1, (q, x_len)).astype(np.float32)
    if semiring != "plus_times":
        x[rng.random((q, x_len)) < 0.2] = np.inf
    args = [torch.as_tensor(a, device=cuda) for a in (row_ptr, col, val, x)]
    before = kell.ell_spmv.launches
    got = tops.ell_spmv_op(*args, semiring=semiring)
    again = tops.ell_spmv_op(*args, semiring=semiring)
    torch.cuda.synchronize()
    assert kell.ell_spmv.launches == before + 2
    assert torch.equal(got, again)
    if semiring == "plus_times":
        rp, c, v, xx = args
        exact = tref.ell_spmv_ref(rp, c, v.double(), xx.double(), semiring)
        mag = tref.ell_spmv_ref(rp, c, v.double().abs(),
                                xx.double().abs(), semiring)
        assert within_f32_bound(got, exact, mag,
                                ell_sum_depth(int(lengths.max())))
    else:
        assert torch.equal(got, tref.ell_spmv_ref(*args, semiring))


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "min"])
def test_ell_kernel_without_slots_gives_the_identity_on_card(cuda, semiring):
    """A remainder with no slot at all (a shard whose intra edges all lie
    in its dense block): every row is the ⊕-identity, as in the plain
    version."""
    row_ptr = torch.zeros(9, dtype=torch.int32, device=cuda)
    col = torch.zeros(0, dtype=torch.int32, device=cuda)
    val = torch.zeros(0, dtype=torch.float32, device=cuda)
    x = torch.rand(3, 8, device=cuda)
    got = tops.ell_spmv_op(row_ptr, col, val, x, semiring=semiring)
    want = tref.ell_spmv_ref(row_ptr, col, val, x, semiring)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 100, 100), (3, 300, 257),
                                   (8, 2816, 2816), (11, 129, 513)])
def test_dense_kernels_match_plain_on_card(cuda, m, k, n):
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.uniform(0, 1, (m, k)).astype(np.float32),
                        device=cuda)
    a = rng.uniform(0, 2, (k, n)).astype(np.float32)
    a[rng.random((k, n)) < 0.7] = 0.0
    a = torch.as_tensor(a, device=cuda)
    before = (kds.dense_spmv.launches, kds.dense_spmv_minplus.launches)
    got, again = tops.dense_spmv_op(x, a), tops.dense_spmv_op(x, a)
    exact = tref.dense_spmv_ref(x.double(), a.double())
    assert within_f32_bound(got, exact, exact, dense_sum_depth(k))
    assert torch.equal(got, again)
    a_inf = torch.where(a == 0, torch.inf, a)
    x_inf = torch.where(x < 0.2, torch.inf, x)
    got = tops.dense_spmv_minplus_op(x_inf, a_inf)
    assert torch.equal(got, tref.dense_spmv_minplus_ref(x_inf, a_inf))
    torch.cuda.synchronize()
    assert (kds.dense_spmv.launches, kds.dense_spmv_minplus.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.gpu
def test_engine_hybrid_matches_reference_on_card(cuda):
    """The hybrid backend (|H| = 256, so both stages run; vote on, forced
    pull, no vote) against plain push on the reference backend: min
    algorithms bit for bit with equal steps, PageRank within ``rtol=1e-6``;
    the three hybrid kernels launch."""
    from repro_torch.algorithms import (bfs_batched, connected_components,
                                        pagerank, sssp_batched, symmetrize)
    from repro_torch.core.bsp import BSPEngine

    g = TG.rmat(11, 8, seed=4).with_uniform_weights(seed=3)
    pg = TPT.partition(g, 2, TPT.HIGH)
    pgs = TPT.partition(symmetrize(g), 2, TPT.RAND)
    ref = BSPEngine(pg, device=cuda, direction_switch=False)
    counters = (kell.ell_spmv, kds.dense_spmv, kds.dense_spmv_minplus)
    for fn in counters:
        fn.launches = 0
    for kw in (dict(), dict(direction="pull"), dict(direction_switch=False)):
        hyb = BSPEngine(pg, backend="hybrid", device=cuda,
                        hybrid_k_dense=256, **kw)
        assert hyb.hybrid_plan()["mode"] == "hybrid"
        for run in (lambda e: bfs_batched(e, [0, 9, 99]),
                    lambda e: sssp_batched(e, [0, 9])):
            (a, sa), (b, sb) = run(ref), run(hyb)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(sa, sb)
        (la, sa), (lb, sb) = (
            connected_components(BSPEngine(pgs, device=cuda)),
            connected_components(BSPEngine(pgs, backend="hybrid",
                                           device=cuda, hybrid_k_dense=256,
                                           **kw)))
        np.testing.assert_array_equal(la, lb)
        assert sa == sb
    np.testing.assert_allclose(pagerank(ref, 10), pagerank(hyb, 10),
                               rtol=1e-6, atol=1e-9)
    assert all(fn.launches > 0 for fn in counters)


# (combine, weight_op) modes of the outbox kernel on the sharded path
OUTBOX_MODES = [("sum", None), ("sum", "mul"), ("min", None), ("min", "add")]


def outbox_inputs(e, num_slots, q, x_len, combine, rng, dyadic=True):
    """Boundary edges sorted by slot, with a hub slot spanning many
    1024-edge blocks, a slot whose every message is the identity, and a
    ragged last block; messages ``x [Q, x_len]`` (dyadic: every partial sum
    exact) and weights."""
    hub, dead = num_slots // 2, num_slots // 3
    others = rng.integers(0, num_slots, e - 6000)
    others[others == dead] = dead + 1
    flat = np.sort(np.concatenate([others, np.full(5000, hub),
                                   np.full(1000, dead)])).astype(np.int32)
    src = rng.integers(0, x_len - 1, e).astype(np.int32)
    src[flat == dead] = x_len - 1           # the identity column
    if dyadic:
        x = rng.integers(0, 64, (q, x_len)) * 2.0 ** -10
        w = 2.0 ** -rng.integers(0, 5, e)
    else:
        x = rng.uniform(0.5, 1.5, (q, x_len))
        w = rng.uniform(1.0, 64.0, e)
    if combine == "min":
        x[rng.random((q, x_len)) < 0.2] = np.inf
    x[:, x_len - 1] = 0.0 if combine == "sum" else np.inf
    return src, flat, x.astype(np.float32), w.astype(np.float32), dead


def outbox_sum_depth(flat, block_e=kob.BLOCK_E):
    """Roundings on the longest path of the kernel's sum: a thread's run,
    the warp scan (5) and warp fold (4), a carry, two per block a slot's
    run touches in the merge, and the message's product
    (``csrc/outbox_reduce.cu``)."""
    nb = -(-len(flat) // block_e)
    first = flat[::block_e]
    last = flat[np.minimum(np.arange(1, nb + 1) * block_e, len(flat)) - 1]
    spans = np.bincount(np.concatenate([first, last[last != first]])).max()
    return block_e // 128 + 5 + 4 + 1 + 2 * int(spans) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("combine,weight_op", OUTBOX_MODES)
@pytest.mark.parametrize("q,e", [(1, 6001), (3, 20480), (8, 37777)])
def test_outbox_kernel_matches_plain_on_card(cuda, combine, weight_op, q, e):
    rng = np.random.default_rng(e + q)
    num_slots, x_len = 4000, 3001
    src, flat, x, w, dead = outbox_inputs(e, num_slots, q, x_len, combine,
                                          rng)
    args = [torch.as_tensor(a, device=cuda) for a in (x, src, flat, w)]
    kw = dict(num_slots=num_slots, combine=combine, weight_op=weight_op)
    before = kob.outbox_reduce.launches
    got = tops.outbox_reduce_op(*args, **kw)
    again = tops.outbox_reduce_op(*args, **kw)
    want = tref.outbox_reduce_ref(*args, **kw)
    torch.cuda.synchronize()
    assert kob.outbox_reduce.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    ident = 0.0 if combine == "sum" else math.inf
    assert bool((got[:, dead] == ident).all())
    unused = np.setdiff1d(np.arange(num_slots), flat)
    assert bool((got[:, torch.as_tensor(unused, device=cuda)] == ident).all())


@pytest.mark.gpu
@pytest.mark.parametrize("weight_op", [None, "mul"])
def test_outbox_kernel_sums_within_f32_bound_on_card(cuda, weight_op):
    rng = np.random.default_rng(7)
    num_slots, x_len = 5000, 4001
    src, flat, x, w, _ = outbox_inputs(60000, num_slots, 8, x_len, "sum", rng,
                                       dyadic=False)
    x, src, flat, w = (torch.as_tensor(a, device=cuda)
                       for a in (x, src, flat, w))
    kw = dict(num_slots=num_slots, combine="sum", weight_op=weight_op)
    got = tops.outbox_reduce_op(x, src, flat, w, **kw)
    assert torch.equal(got, tops.outbox_reduce_op(x, src, flat, w, **kw))
    exact = tref.outbox_reduce_ref(x.double(), src, flat, w.double(), **kw)
    assert within_f32_bound(got, exact, exact,
                            outbox_sum_depth(flat.cpu().numpy()))


@pytest.mark.gpu
def test_outbox_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.zeros(2, 10, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        kob.outbox_reduce(x, idx.long(), idx, None, num_slots=3,
                          combine="sum")
    with pytest.raises(ValueError, match="needs weight"):
        kob.outbox_reduce(x, idx, idx, None, num_slots=3, combine="min",
                          weight_op="add")
    with pytest.raises(ValueError, match="CUDA"):
        kob.outbox_reduce(x.cpu(), idx, idx, None, num_slots=3,
                          combine="sum")
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = kob.outbox_reduce.launches
    out = kob.outbox_reduce(x, empty, empty, None, num_slots=3,
                            combine="min")
    assert bool((out == math.inf).all()) and out.shape == (2, 3)
    assert kob.outbox_reduce.launches == before


@pytest.mark.gpu
def test_engine_sharded_hybrid_matches_reference_on_card(cuda):
    """The sharded engine at a world of one (P=2 and P=4 on one card)
    against plain push on the reference backend: min algorithms bit for
    bit with equal steps, PageRank within ``rtol=1e-6``; the outbox kernel
    launches."""
    from repro_torch.algorithms import (bfs_batched, pagerank,
                                        pagerank_distributed, sssp_batched)
    from repro_torch.core.bsp import BSPEngine, DistributedBSPEngine

    g = TG.rmat(11, 8, seed=4).with_uniform_weights(seed=3)
    kob.outbox_reduce.launches = 0
    for parts in (2, 4):
        pg = TPT.partition(g, parts, TPT.HIGH, include_reverse=True)
        ref = BSPEngine(pg, device=cuda, direction_switch=False)
        for backend in ("hybrid", "fused", "reference"):
            eng = DistributedBSPEngine(pg, device=cuda, backend=backend)
            for run in (lambda e: bfs_batched(e, [0, 9, 99]),
                        lambda e: sssp_batched(e, [0, 9])):
                (a, sa), (b, sb) = run(ref), run(eng)
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(sa, sb)
            np.testing.assert_allclose(pagerank(ref, 10),
                                       pagerank_distributed(eng, 10),
                                       rtol=1e-6, atol=1e-9)
    assert kob.outbox_reduce.launches > 0
