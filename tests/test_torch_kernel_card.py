"""The CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor ``repro``, so it also runs where only the
port is installed: ``python -m pytest -q -m gpu tests/test_torch_kernel_card.py``.
Without a card its tests skip (the kernel has no CPU mode); the helpers
below also feed ``test_torch_fused_superstep.py``'s CPU parity tests.

Tolerances: the min kinds (bfs, sssp, cc, bfs_relax) bit for bit, a min is
order-free;
the sum kinds (pagerank, bc_fwd, bc_bwd) ``rtol=1e-6, atol=1e-9``, the f32
reassociation bound ``tests/test_fused_superstep.py`` uses between fused
and reference.  Two launches on the same inputs are bit-equal (the kernel's
sums take a fixed order).  The bottom-up scan bit for bit in every mode
(a min is order-free, and its counts are integers).  The hybrid kernels:
``ell_spmv`` (min, min_plus) and ``dense_spmv_minplus`` bit for bit;
``ell_spmv`` (plus_times) and ``dense_spmv`` within their own f32 rounding
bound of a float64 evaluation (``depth * 2^-24 * sum|terms|``, the depth
from the kernel's fixed summation tree: for ``ell_spmv`` the row plan's
lane runs and chunks, ``ell_sum_depth``), since the plain version sums with
atomics in no fixed order; two launches bit-equal, with the split's plan
and with the plan built by the op.  The outbox kernel:
min modes bit for bit, sums bit for bit on dyadic messages (exact in any
order) and within its f32 rounding bound of float64 on continuous ones;
two launches bit-equal.  The segment-reduce kernel: the outbox kernel's
rules.  The flash-attention kernel against its plain version (the
double-chunked online softmax, f32 matmuls without TF32): f32
``rtol=1e-4, atol=1e-5`` (both keep f32 statistics; the sums over D and
over the keys take other orders); bf16 within the bound of its design
(``within_bf16_bound``): each side rounds every P value and its output to
bf16, each rounding off by at most 2^-8 relative, so the two differ by
at most ``2 * 2^-8 * (|out| + sum p|v| / l)``.
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
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import fused_superstep as kfs
from repro_torch.kernels import outbox_reduce as kob
from repro_torch.kernels import segment_reduce as ksr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

KINDS = ["bfs", "sssp", "cc", "pagerank", "bc_fwd", "bc_bwd", "bfs_relax"]


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
        "bfs_relax": lambda: alg("bfs").BFS_RELAX_PROGRAM,
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
    elif kind == "bfs_relax":
        cols = [levels, active]
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
              device="cpu", view=False):
    """The port's ``bottomup_scan_op`` on numpy inputs, as numpy; ``view``
    hands it ``x`` as a query-minor view (``ell_spmv.query_minor_view``),
    as the engines do."""
    def put(a, dtype):
        return (None if a is None else torch.as_tensor(
            np.ascontiguousarray(a), dtype=dtype, device=device))

    xs = put(x, torch.float32)
    if view:
        xs = kell.query_minor_view(xs, math.inf)
    y, scanned = tops.bottomup_scan_op(
        put(row_ptr, torch.int32), put(col, torch.int32),
        put(val, torch.float32), xs, semiring=semiring,
        early_exit=early_exit, skip=put(skip, torch.bool))
    return y.cpu().numpy(), scanned.cpu().numpy()


def long_row_inputs(semiring, early_exit, q, rng, x_len=700):
    """CSR rows longer than the kernel's chunk (``ell_spmv.BUDGET``
    slots) beside empty and short rows: a 5000-slot row whose sources are
    dead (+inf for every query) for its first 3000 slots, so the first hit
    lies in its second chunk; a 2049-slot row live only in its last slot;
    a 4100-slot row with no live slot; empty rows between them.  Messages
    and skip as in ``scan_inputs``."""
    dead = np.arange(x_len // 2, dtype=np.int32)            # +inf sources
    livec = np.arange(x_len // 2, x_len, dtype=np.int32)
    rows = [rng.choice(dead, 3000), rng.choice(livec, 2000), [], [],
            rng.choice(dead, 2048), rng.choice(livec, 1), [],
            rng.choice(dead, 4100), rng.integers(0, x_len, 7), []]
    rows = [np.concatenate(rows[:2]), rows[2], rows[3],
            np.concatenate(rows[4:6]), rows[6], rows[7], rows[8], rows[9]]
    lengths = [len(r) for r in rows]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    col = np.concatenate(rows).astype(np.int32)
    val = (rng.uniform(0.5, 2.0, size=col.shape).astype(np.float32)
           if semiring == "min_plus" else None)
    if early_exit:
        live = rng.random((q, x_len)) < rng.choice([0.05, 0.5, 1.0], (q, 1))
        x = np.where(live, 3.0, np.inf).astype(np.float32)
    else:
        x = rng.uniform(0, 100, (q, x_len)).astype(np.float32)
        x[rng.random((q, x_len)) < 0.2] = np.inf
    x[:, dead] = np.inf
    skip = rng.random((q, len(rows))) < 0.3
    return row_ptr, col, val, x, skip


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
@pytest.mark.parametrize("q", [1, 3, 8, 13])
@pytest.mark.parametrize("parts,strategy,block_e", [
    (1, "rand", 128), (2, "high", 256), (3, "low", 1024)])
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_matches_plain_on_card(cuda, kind, parts, strategy, block_e,
                                      q):
    """Q below, at and above one 8-query group, ragged (1, 3, 13) and
    whole (8); ``block_e`` 128, 256 and 1024 (1, 2 and 8 edges a
    thread)."""
    tg = TG.rmat(10, 8, seed=5).with_uniform_weights(seed=2)
    tp = TPT.partition(tg, parts, strategy, include_reverse=True)
    ea = tp.rev if kind == "bc_bwd" else tp.fwd
    blk = TPT.build_block_metadata(ea, block_e=block_e)
    tprog = port_program(kind, tp.num_vertices)
    vstate, scal = make_inputs(kind, q, parts, tp.v_max,
                               np.random.default_rng(q))
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
@pytest.mark.parametrize("q", [1, 3, 13])
@pytest.mark.parametrize("kind", ["bfs", "bc_bwd"])
def test_kernel_never_writes_the_padded_queries_on_card(cuda, kind, q):
    """The query-minor state's padded lanes are read and never written
    out: NaN there leaves the accumulator as it is with the padding ``PAD``
    (the op's own copy), bit for bit."""
    tg = TG.rmat(10, 8, seed=5)
    tp = TPT.partition(tg, 2, "high", include_reverse=True)
    ea = tp.rev if kind == "bc_bwd" else tp.fwd
    blk = TPT.build_block_metadata(ea, block_e=256)
    vstate, scal = make_inputs(kind, q, 2, tp.v_max,
                               np.random.default_rng(q))
    vs = torch.as_tensor(vstate, device=cuda)
    vt = kfs.query_minor_state(vs)
    assert vt.shape[-1] == kfs.padded_queries(q) > q
    nan = vt.clone()
    nan[..., q:] = float("nan")
    args = [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                            device=cuda)
            for a in (blk.src, blk.local, blk.mask)]
    base = torch.as_tensor(blk.base, dtype=torch.int32, device=cuda)
    sc = torch.as_tensor(scal, device=cuda)
    got = [kfs.fused_superstep(kind, x, sc, *args, None, base,
                               num_segments=tp.seg_count, block_e=256)
           for x in (vt, nan)]
    assert got[0].shape == (q, 2, tp.seg_count)
    assert torch.equal(got[0], got[1])


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
@pytest.mark.parametrize("q", [1, 3, 5, 8, 13])
def test_bottomup_kernel_matches_plain_on_card(cuda, semiring, early_exit,
                                               skip, q):
    """Bit for bit against the plain version, with ``x`` copied by the op
    and given as a query-minor view; two launches bit-equal."""
    rng = np.random.default_rng(q)
    row_ptr, col, val, x, skip_mask = scan_inputs(semiring, early_exit, q,
                                                  rng)
    skip_mask = skip_mask if skip else None
    args = (row_ptr, col, val, x, skip_mask, semiring, early_exit)
    before = kbu.bottomup_scan.launches
    got = port_scan(*args, cuda)
    again = port_scan(*args, cuda, view=True)
    torch.cuda.synchronize()
    assert kbu.bottomup_scan.launches == before + 2
    want = port_scan(*args)
    for a, b in zip(got + again, want + want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("semiring,early_exit", [
    ("min", False), ("min", True), ("min_plus", False)])
@pytest.mark.parametrize("q", [1, 3, 8, 13])
def test_bottomup_kernel_on_rows_longer_than_a_chunk_on_card(
        cuda, semiring, early_exit, q):
    """Rows cut into several chunks by the row plan, the first hit in a
    later chunk, rows with no live slot, empty rows: bit for bit with the
    plain version, two launches bit-equal, one launch each."""
    rng = np.random.default_rng(100 + q)
    row_ptr, col, val, x, skip = long_row_inputs(semiring, early_exit, q,
                                                 rng)
    plan = kell.row_plan(row_ptr)
    assert plan.long_rows.shape[0] == 3 and plan.num_partials == 3 + 2 + 3
    args = (row_ptr, col, val, x, skip if early_exit else None, semiring,
            early_exit)
    before = kbu.bottomup_scan.launches
    got, again = port_scan(*args, cuda), port_scan(*args, cuda, view=True)
    torch.cuda.synchronize()
    assert kbu.bottomup_scan.launches == before + 2
    want = port_scan(*args)
    for a, b in zip(got + again, want + want):
        np.testing.assert_array_equal(a, b)
    if early_exit:   # a hit in the second chunk counts the whole first
        first_live = np.argmax(np.isfinite(x[:, col[:5000]]), axis=1)
        hit = np.isfinite(x[:, col[:5000]]).any(axis=1)
        np.testing.assert_array_equal(
            want[1][:, 0], np.where(skip[:, 0], 0,
                                    np.where(hit, first_live + 1, 5000)))


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
    to ``kmax`` slots (``csrc/ell_spmv.cu``): in a run, ``LANE_RUN`` adds
    in a lane, 5 butterfly levels and the product; in chunks,
    ``BUDGET / THREADS`` adds in a thread, 5 warp and 3 block levels, the
    chunk partials in order and the product."""
    return max(kell.LANE_RUN + 6, kell.BUDGET // kell.THREADS + 8
               + math.ceil(kmax / kell.BUDGET))


def dense_sum_depth(k):
    """Roundings of ``dense_spmv``'s sum over ``k`` (``csrc/dense_spmv.cu``):
    32 products in a lane, the 8 warps of a block in order, the
    ``ceil(k / 256)`` slices in order, the product."""
    return 32 + 8 + math.ceil(k / 256) + 1


def within_f32_bound(got, exact, mag, depth):
    """|got - exact| <= depth * 2^-24 * sum|terms| everywhere."""
    slack = (got.double() - exact).abs() - 1.01 * depth * 2.0 ** -24 * mag
    return bool((slack <= 0).all())


def within_bf16_bound(got, want, q, k, v, causal, window):
    """bf16 attention vs its plain version: |got - want| <= 2 * 2^-8 *
    (|want| + sum p|v| / l) everywhere.  Both round each P value (weight
    p / l of its row of V) and the output to bf16, 2^-8 relative at most;
    ``sum p|v| / l`` is the plain version on |v| in f32."""
    mag = tref.flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                   causal=causal, window=window)
    want = want.float()
    slack = (got.float() - want).abs() - 1.01 * 2 * 2.0 ** -8 * (
        want.abs() + mag)
    return bool((slack <= 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("semiring", ["plus_times", "min_plus", "min"])
@pytest.mark.parametrize("q", [1, 3, 8, 9])
def test_ell_kernel_matches_plain_on_card(cuda, semiring, q):
    """Skewed rows around every edge of the row plan: empty, 1, 31, 32,
    33 slots, a run's budget and one either side, 4097 and a 70k-slot row
    of 35 chunks, among short random rows; Q below, at and above one
    8-query pass and not a multiple of 4."""
    rng = np.random.default_rng(q)
    b = kell.BUDGET
    lengths = rng.choice([0, 0, 1, 5, 32, 33, 200], size=3000)
    lengths[[3, 50, 51, 52, 53, 400, 401, 402, 403, 404, 2999]] = [
        0, 1, 31, 32, 33, b - 1, b, b + 1, 4097, 70000, 0]
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    x_len = 5000
    col = rng.integers(0, x_len, size=int(row_ptr[-1])).astype(np.int32)
    val = rng.uniform(0.5, 2.0, size=col.shape).astype(np.float32)
    x = rng.uniform(0, 1, (q, x_len)).astype(np.float32)
    if semiring != "plus_times":
        x[rng.random((q, x_len)) < 0.2] = np.inf
    args = [torch.as_tensor(a, device=cuda) for a in (row_ptr, col, val, x)]
    plan = kell.row_plan(row_ptr).to(cuda)
    before = kell.ell_spmv.launches
    got = tops.ell_spmv_op(*args, semiring=semiring, plan=plan)
    again = tops.ell_spmv_op(*args, semiring=semiring, plan=plan)
    built = tops.ell_spmv_op(*args, semiring=semiring)
    torch.cuda.synchronize()
    assert kell.ell_spmv.launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, built)
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
                                   (8, 2816, 2816), (11, 129, 513),
                                   (13, 301, 258), (8, 1027, 1030),
                                   (1, 3, 5), (13, 2816, 2816),
                                   (9, 257, 129), (13, 511, 2817),
                                   (9, 2816, 2817), (13, 257, 129)])
def test_dense_kernels_match_plain_on_card(cuda, m, k, n):
    """M of 1, 3, 8, 9, 11 and 13 (one 8-query pass, ragged, two passes); K
    and N multiples of 4 and not (N % 4 != 0 takes the scalar loads), K
    below one 256-row slice, just past one (257) and two (511), and over 11
    of them, N just past a 128-column tile (129) and past 22 (2817).  The
    min-plus inputs hold a row and a column of +inf in ``a`` and a query
    of +inf in ``x``."""
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
    a_inf[k // 2] = torch.inf
    a_inf[:, n // 2] = torch.inf
    x_inf = torch.where(x < 0.2, torch.inf, x)
    x_inf[m // 2] = torch.inf
    got = tops.dense_spmv_minplus_op(x_inf, a_inf)
    assert torch.equal(got, tref.dense_spmv_minplus_ref(x_inf, a_inf))
    assert torch.equal(got, tops.dense_spmv_minplus_op(x_inf, a_inf))
    torch.cuda.synchronize()
    assert (kds.dense_spmv.launches, kds.dense_spmv_minplus.launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.gpu
def test_dense_kernels_share_their_tickets_on_card(cuda):
    """Both semirings take one tickets array per device and stream, and
    every launch leaves it 0: launches of the two in turns on one stream
    give the results of each alone."""
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.uniform(0, 1, (8, 2816)).astype(np.float32),
                        device=cuda)
    a = rng.uniform(0, 2, (2816, 2817)).astype(np.float32)
    a[rng.random(a.shape) < 0.7] = 0.0
    a = torch.as_tensor(a, device=cuda)
    a_inf = torch.where(a == 0, torch.inf, a)
    plus, minplus = tops.dense_spmv_op(x, a), tops.dense_spmv_minplus_op(
        x, a_inf)
    torch.cuda.synchronize()
    key = (x.device, torch.cuda.current_stream(x.device).cuda_stream)
    tickets = kds._TICKETS[key]
    assert int(tickets.abs().sum()) == 0
    turns = [f(x, b) for _ in range(3) for f, b in (
        (tops.dense_spmv_op, a), (tops.dense_spmv_minplus_op, a_inf))]
    torch.cuda.synchronize()
    assert kds._TICKETS[key] is tickets
    assert int(tickets.abs().sum()) == 0
    for i, y in enumerate(turns):
        assert torch.equal(y, minplus if i % 2 else plus)


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


def _tiered_engines(pg, backend, cuda, **kw):
    """A resident engine and a tiered one with a partition streamed (the
    plan's table row 1, or row 0 where row 1's windows keep every partition
    hot, at the least power-of-two ``win_blocks`` that plans)."""
    from repro_torch.core.bsp import BSPEngine

    fused = backend == "fused"
    for row in (1, 0):      # row 0 (all cold) where row 1 keeps all hot
        wb = 1
        while True:
            try:
                probe = TPT.build_tier_plan(pg, 1 << 60, block_e=256,
                                            win_blocks=wb, fused=fused)
                plan = TPT.build_tier_plan(pg, probe.table[row]["hbm_bytes"],
                                           block_e=256, win_blocks=wb,
                                           fused=fused)
                break
            except ValueError:
                wb *= 2
        if len(plan.cold):
            break
    res = BSPEngine(pg, backend=backend, block_e=256, device=cuda, **kw)
    tie = BSPEngine(pg, backend=backend, block_e=256, device=cuda,
                    tiered=plan, win_blocks=wb, **kw)
    return res, tie


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_engine_tiered_matches_resident_on_card(cuda, backend):
    """Tiered (one of two partitions streamed from pinned host memory)
    against resident on the same backend: all five algorithms bit for
    bit, sums included, with equal steps; the path's kernels launch; the
    plan's device bytes are the engine's; no arena or buffer is made after
    the first run."""
    from repro_torch.algorithms import (betweenness_centrality_batched,
                                        bfs_batched, connected_components,
                                        pagerank, sssp_batched, symmetrize)

    g = TG.rmat(13, 8, seed=4).with_uniform_weights(seed=3)
    pg = TPT.partition(g, 2, TPT.HIGH, include_reverse=True)
    pgs = TPT.partition(symmetrize(g), 2, TPT.HIGH)
    kw = dict(hybrid_k_dense=256) if backend == "hybrid" else {}
    res, tie = _tiered_engines(pg, backend, cuda, **kw)
    res_cc, tie_cc = _tiered_engines(pgs, backend, cuda, **kw)
    assert len(tie.tier_plan.cold) == 1
    assert tie.tier_plan.fwd.num_windows >= 2 and len(tie_cc.tier_plan.cold)
    stats = tie.tiered_stats()
    assert stats["device_arena_bytes"] == tie.tier_plan.hbm_bytes
    assert all(td.arena.tensors[k].is_pinned() for td in tie._tier.values()
               for k in td.arena.names)
    runs = [lambda e, _: bfs_batched(e, [0, 9, 99]),
            lambda e, _: sssp_batched(e, [0, 9]),
            lambda _, c: connected_components(c),
            lambda e, _: (pagerank(e, 10), None),
            lambda e, _: betweenness_centrality_batched(e, [0, 9])]
    counters = ((kfs.fused_superstep,) if backend == "fused" else
                (kell.ell_spmv, kds.dense_spmv, kds.dense_spmv_minplus))
    for fn in counters:
        fn.launches = 0
    for run in runs:
        a, sa = run(res, res_cc)
        b, sb = run(tie, tie_cc)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        if sa is not None:
            np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
    made = tie.tiered_stats()["buffers_made"]
    bfs_batched(tie, [1, 2])
    pagerank(tie, 3)
    assert tie.tiered_stats()["buffers_made"] == made
    assert all(fn.launches > 0 for fn in counters)


@pytest.mark.gpu
def test_ell_window_plan_keeps_each_rows_lanes_on_card(cuda):
    """Rows cut out of a split and planned with the split plan's lane
    counts (``row_plan(lanes=)``, as the tiered hybrid's windows are) sum
    bit for bit as in the whole split; planned afresh, some row gets
    another lane count and another last bit."""
    rng = np.random.default_rng(11)
    short, wide = rng.integers(1, 6, 3000), rng.integers(70, 400, 900)
    lens = np.concatenate([short[:1500], wide[:500], [kell.BUDGET * 2 + 7],
                           short[1500:], wide[500:]])
    rp = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    x_len, q = 5000, 8
    col = rng.integers(0, x_len, rp[-1]).astype(np.int32)
    val = rng.random(rp[-1]).astype(np.float32)
    x = torch.as_tensor(rng.random((q, x_len)).astype(np.float32),
                        device=cuda)
    full = kell.row_plan(rp)
    lanes = kell.plan_lanes(full)

    def put(a, dt):
        return torch.as_tensor(a, dtype=dt, device=cuda)

    def spmv(ptr, c, v, plan):
        return tops.ell_spmv_op(put(ptr, torch.int32), put(c, torch.int32),
                                put(v, torch.float32), x,
                                semiring="plus_times", plan=plan.to(cuda))

    y_full = spmv(rp, col, val, full).cpu()
    # every third row: the runs around each kept row change
    sel = np.arange(0, len(lens), 3)
    ptr = np.concatenate([[0], np.cumsum(lens[sel])])
    idx = np.repeat(rp[sel] - ptr[:-1], lens[sel]) + np.arange(ptr[-1])
    kept = kell.row_plan(ptr, lanes=lanes[sel])
    fresh = kell.row_plan(ptr)
    assert np.array_equal(kell.plan_lanes(kept), lanes[sel])
    assert not np.array_equal(kell.plan_lanes(fresh), lanes[sel])
    y_kept = spmv(ptr, col[idx], val[idx], kept).cpu()
    y_fresh = spmv(ptr, col[idx], val[idx], fresh).cpu()
    assert torch.equal(y_kept, y_full[:, sel])
    assert not torch.equal(y_fresh, y_full[:, sel])


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
@pytest.mark.parametrize("q,e", [(1, 6001), (3, 20480), (8, 37777),
                                 (13, 30001)])
def test_outbox_kernel_matches_plain_on_card(cuda, combine, weight_op, q, e):
    """Bit for bit against the plain version (dyadic sums are exact), with
    ``x`` copied by the op and given as a query-minor view; two launches
    bit-equal."""
    rng = np.random.default_rng(e + q)
    num_slots, x_len = 4000, 3001
    src, flat, x, w, dead = outbox_inputs(e, num_slots, q, x_len, combine,
                                          rng)
    args = [torch.as_tensor(a, device=cuda) for a in (x, src, flat, w)]
    kw = dict(num_slots=num_slots, combine=combine, weight_op=weight_op)
    xq = kell.query_minor_view(args[0], tref.identity(combine))
    before = kob.outbox_reduce.launches
    got = tops.outbox_reduce_op(*args, **kw)
    again = tops.outbox_reduce_op(xq, *args[1:], **kw)
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
@pytest.mark.parametrize("combine", ["sum", "min"])
def test_outbox_kernel_one_slot_over_many_blocks_on_card(cuda, combine):
    """One slot's run covering three whole edge blocks and the ends of two
    more, a slot filling exactly one block, Q=13 (two query groups, the
    second ragged): bit for bit with the plain version (dyadic messages),
    two launches bit-equal."""
    be = kob.BLOCK_E
    flat = np.concatenate([np.full(be - 100, 3), np.full(3 * be + 200, 9),
                           np.full(be - 100, 11), np.full(be, 12),
                           np.arange(20, 20 + 333)]).astype(np.int32)
    rng = np.random.default_rng(5)
    x_len = 500
    src = rng.integers(0, x_len, len(flat)).astype(np.int32)
    x = (rng.integers(0, 64, (13, x_len)) * 2.0 ** -10).astype(np.float32)
    x, src_t, flat_t = (torch.as_tensor(a, device=cuda)
                        for a in (x, src, flat))
    kw = dict(num_slots=400, combine=combine)
    before = kob.outbox_reduce.launches
    got = tops.outbox_reduce_op(x, src_t, flat_t, None, **kw)
    again = tops.outbox_reduce_op(x, src_t, flat_t, None, **kw)
    torch.cuda.synchronize()
    assert kob.outbox_reduce.launches == before + 2
    want = tref.outbox_reduce_ref(x, src_t, flat_t, None, **kw)
    assert torch.equal(got, again) and torch.equal(got, want)


@pytest.mark.gpu
def test_outbox_kernel_refuses_what_it_does_not_take(cuda):
    xt = torch.zeros(10, 4, device=cuda)
    idx = torch.zeros(4, dtype=torch.int32, device=cuda)
    kw = dict(num_slots=3, num_queries=2)
    with pytest.raises(ValueError, match="int32"):
        kob.outbox_reduce(xt, idx.long(), idx, None, combine="sum", **kw)
    with pytest.raises(ValueError, match="needs weight"):
        kob.outbox_reduce(xt, idx, idx, None, combine="min",
                          weight_op="add", **kw)
    with pytest.raises(ValueError, match="CUDA"):
        kob.outbox_reduce(xt.cpu(), idx.cpu(), idx.cpu(), None,
                          combine="sum", **kw)
    with pytest.raises(ValueError, match="multiple of 4"):
        kob.outbox_reduce(torch.zeros(10, 6, device=cuda), idx, idx, None,
                          combine="sum", **kw)
    with pytest.raises(ValueError, match="aligned"):
        kob.outbox_reduce(torch.zeros(41, device=cuda)[1:].view(10, 4), idx,
                          idx, None, combine="sum", **kw)
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = kob.outbox_reduce.launches
    out = kob.outbox_reduce(xt, empty, empty, None, combine="min", **kw)
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


def segment_inputs(e, num_segments, q, combine, rng, dyadic=True):
    """Sorted ids with empty segment ranges (before the first id, inside,
    after the last) and a hub segment spanning many 1024-edge blocks;
    messages ``[Q, E]``, dyadic (every partial sum exact) or continuous."""
    hub = num_segments // 2
    lo, hi = num_segments // 10, num_segments - num_segments // 10
    others = rng.integers(lo, hi, e - 5000)
    others[(others > hub + 10) & (others < hub + 200)] = hub
    ids = np.sort(np.concatenate([others, np.full(5000, hub)])).astype(
        np.int32)
    if dyadic:
        msgs = rng.integers(-64, 64, (q, e)) * 2.0 ** -10
    else:
        msgs = rng.normal(size=(q, e))
    if combine == "min":
        msgs[rng.random((q, e)) < 0.2] = np.inf
    return ids, msgs.astype(np.float32)


def segment_sum_depth(ids, block_e=ksr.BLOCK_E):
    """Roundings on the longest path of the kernel's sum: a thread's run,
    the warp scan (5) and fold (4), a carry, and two per block a segment's
    run touches in the merge."""
    return outbox_sum_depth(ids, block_e) - 1


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["mixed", "one segment"])
@pytest.mark.parametrize("combine", ["sum", "min"])
@pytest.mark.parametrize("q,e", [(1, 7001), (3, 20480), (5, 50001),
                                 (8, 20480), (13, 7001), (8, 6003)])
def test_segment_kernel_matches_plain_on_card(cuda, combine, q, e, layout):
    """Q of 1 (the one-row instance), 3, 5, 8 and 13 (a group of 8 and a
    ragged one); E % 4 != 0 (7001, 50001, 6003: scalar loads) and == 0
    (16-byte loads); a hub run over more than two 1024-edge blocks, or
    every id one segment; the first and last segments empty."""
    rng = np.random.default_rng(e + q)
    num_segments = 3000
    ids, msgs = segment_inputs(e, num_segments, q, combine, rng)
    if layout == "one segment":
        ids = np.full(e, num_segments // 2, np.int32)
    m, i = torch.as_tensor(msgs, device=cuda), torch.as_tensor(ids,
                                                                device=cuda)
    before = ksr.segment_reduce.launches
    got = tops.segment_reduce_op(m, i, num_segments, combine=combine)
    again = ksr.segment_reduce(m, i, num_segments=num_segments,
                               combine=combine)
    want = tref.segment_reduce_ref(m, i.long(), num_segments, combine)
    torch.cuda.synchronize()
    assert ksr.segment_reduce.launches == before + 2
    assert got.shape == (q, num_segments)
    assert torch.equal(got, again)
    assert torch.equal(got, want)
    ident = 0.0 if combine == "sum" else math.inf
    empty = np.setdiff1d(np.arange(num_segments), ids)
    assert empty[0] == 0 and empty[-1] == num_segments - 1
    assert bool((got[:, torch.as_tensor(empty, device=cuda)] == ident).all())


@pytest.mark.gpu
def test_segment_kernel_sums_within_f32_bound_on_card(cuda):
    rng = np.random.default_rng(11)
    ids, msgs = segment_inputs(80000, 4000, 4, "sum", rng, dyadic=False)
    m = torch.as_tensor(msgs, device=cuda)
    i = torch.as_tensor(ids, device=cuda)
    got = tops.segment_reduce_op(m[None], i, 4000)[0]     # a leading axis
    assert torch.equal(got, tops.segment_reduce_op(m, i, 4000))
    exact = tref.segment_reduce_ref(m.double(), i.long(), 4000, "sum")
    mag = tref.segment_reduce_ref(m.double().abs(), i.long(), 4000, "sum")
    assert within_f32_bound(got, exact, mag, segment_sum_depth(ids))


@pytest.mark.gpu
def test_segment_kernel_refuses_what_it_does_not_take(cuda):
    m = torch.zeros(2, 10, device=cuda)
    i = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ksr.segment_reduce(m, i.long(), num_segments=3, combine="sum")
    with pytest.raises(ValueError, match="float32"):
        ksr.segment_reduce(m.double(), i, num_segments=3, combine="sum")
    with pytest.raises(ValueError, match="CUDA"):
        ksr.segment_reduce(m.cpu(), i.cpu(), num_segments=3, combine="sum")
    with pytest.raises(ValueError, match="sorted"):
        tops.segment_reduce_op(m, torch.arange(10, 0, -1, device=cuda), 11)
    before = ksr.segment_reduce.launches
    out = tops.segment_reduce_op(m[:, :0], i[:0], 3, combine="min")
    assert bool((out == math.inf).all()) and out.shape == (2, 3)
    assert ksr.segment_reduce.launches == before


def attention_inputs(b, s, g, r, d, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, s, g, r, d, generator=gen, device=device)
    k = torch.randn(b, s, g, d, generator=gen, device=device)
    v = torch.randn(b, s, g, d, generator=gen, device=device)
    return tuple(t.to(getattr(torch, dtype)) for t in (q, k, v))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,d", [(256, 64), (200, 128), (1000, 64), (77, 16),
                                 (130, 32)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0),
                                           (False, 100)])
def test_flash_kernel_matches_plain_on_card(cuda, causal, window, s, d,
                                            dtype):
    """GQA (2 KV groups x 3 query heads), ragged S, every head dim."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = attention_inputs(2, s, 2, 3, d, dtype, cuda, seed=s + d)
    before = kfa.flash_attention.launches
    got = kfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                    q_chunk=128, k_chunk=96)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert within_bf16_bound(got, want, q, k, v, causal, window)
    assert torch.equal(got, kfa.flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 8])
def test_flash_kernel_head_dim_256_on_card(cuda, window, dtype):
    """gemma3's head dim: four 64-column sub-tiles on the tensor cores, the
    f32 kernel at its largest shared-memory stage; GQA (2 KV groups x 2
    query heads, gemma3's R), a ragged S, the local window of the smoke
    config and full causal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = attention_inputs(2, 300, 2, 2, 256, dtype, cuda, seed=window)
    got = kfa.flash_attention(q, k, v, causal=True, window=window)
    want = tref.flash_attention_ref(q, k, v, causal=True, window=window)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert within_bf16_bound(got, want, q, k, v, True, window)
    assert torch.equal(got, kfa.flash_attention(q, k, v, causal=True,
                                                window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
@pytest.mark.parametrize("s,r", [(333, 1), (130, 2)])
def test_flash_kernel_head_dim_80_on_card(cuda, s, r, causal, window,
                                          dtype):
    """zamba2's head dim: the bf16 kernel on two 64-column sub-tiles whose
    second is zero-filled past column 80 by the TMA unit (the next head's
    columns must not leak in, nor columns 80-127 be stored), the f32
    kernel at 5 columns a thread; MHA (zamba2's R = 1) and a pair, ragged
    S, causal, windowed and full."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = attention_inputs(2, s, 3, r, 80, dtype, cuda, seed=s + r)
    before = kfa.flash_attention.launches
    got = kfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kfa.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert within_bf16_bound(got, want, q, k, v, causal, window)
    assert torch.equal(got, kfa.flash_attention(q, k, v, causal=causal,
                                                window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-125m"])
def test_ssm_smoke_on_card_matches_the_cpu(cuda, arch, monkeypatch):
    """The SSM and hybrid smoke configs (zamba2's at its head dim 80) at
    f32 compute with one set of weights on the card and on the CPU:
    prefill (logits and every cache leaf) and two decode steps within
    1e-4; zamba2's prefill launches the flash kernel once a shared-block
    call (the plain attention is never reached on the card)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import api
    from repro_torch.models import attention as tattn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              compute_dtype="float32")
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, head_dim=80)
    cpu = api.build(cfg, "cpu", torch.Generator().manual_seed(9))
    card = api.build(cfg, cuda)
    card.module.load_state_dict(cpu.module.state_dict())
    tokens = TokenStream(cfg, 2, 70).batch_at(0)["tokens"][:, :70]
    real_ref = tattn.flash_attention_ref

    def refuse(q, *a, **k):
        assert q.device.type == "cpu", "a CUDA tensor reached the plain one"
        return real_ref(q, *a, **k)

    monkeypatch.setattr(tattn, "flash_attention_ref", refuse)
    kfa.flash_attention.launches = 0
    lg_card, c_card = card.prefill({"tokens": tokens.to(cuda)}, max_len=72)
    want = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    assert kfa.flash_attention.launches == want
    lg_cpu, c_cpu = cpu.prefill({"tokens": tokens}, max_len=72)
    tol = dict(rtol=1e-4, atol=1e-4)
    for step in range(3):
        torch.testing.assert_close(lg_card.cpu(), lg_cpu, **tol)
        for key in (k for k in c_cpu if k != "len"):
            assert c_card[key].dtype == c_cpu[key].dtype
            torch.testing.assert_close(c_card[key].cpu(), c_cpu[key], **tol)
        if step < 2:
            tok = lg_cpu.argmax(-1)
            lg_card, c_card = card.decode_step(c_card, tok.to(cuda))
            lg_cpu, c_cpu = cpu.decode_step(c_cpu, tok)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [1, 2, 8])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_kernel_pairs_query_heads_on_card(cuda, r, window):
    """The bf16 kernel's two warpgroups share K/V between query heads of
    one KV group: one head (the second warpgroup idle), a pair, and
    tinyllama's eight heads per group, at a ragged S."""
    q, k, v = attention_inputs(2, 333, 3, r, 64, "bfloat16", cuda,
                               seed=r + window)
    got = kfa.flash_attention(q, k, v, causal=True, window=window)
    want = tref.flash_attention_ref(q, k, v, causal=True, window=window)
    assert within_bf16_bound(got, want, q, k, v, True, window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1024, 2048])
@pytest.mark.parametrize("r", [1, 2])
def test_flash_kernel_non_causal_long_on_card(cuda, r, s, dtype):
    """An encoder's attention (seamless: MHA, R = 1): every key tile live
    for every row, at long S; at R = 1 the second warpgroup of the pair
    computes a repeat of the head and must store nothing.  Counted apart
    as non-causal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = attention_inputs(2, s, 2, r, 64, dtype, cuda, seed=s + r)
    before = (kfa.flash_attention.launches,
              kfa.flash_attention.noncausal_launches)
    got = kfa.flash_attention(q, k, v, causal=False)
    assert (kfa.flash_attention.launches,
            kfa.flash_attention.noncausal_launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = tref.flash_attention_ref(q, k, v, causal=False)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert within_bf16_bound(got, want, q, k, v, False, 0)
    assert torch.equal(got, kfa.flash_attention(q, k, v, causal=False))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_vlm_prefix_shape_on_card(cuda, dtype):
    """internvl2's prefill shape at B = 2: 256 patches before 2048 tokens
    (S = 2304, not a power of two), 8 KV groups of 6 query heads, D =
    128, causal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = attention_inputs(2, 2304, 8, 6, 128, dtype, cuda, seed=6)
    before = kfa.flash_attention.noncausal_launches
    got = kfa.flash_attention(q, k, v, causal=True)
    assert kfa.flash_attention.noncausal_launches == before
    want = tref.flash_attention_ref(q, k, v, causal=True)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    else:
        assert within_bf16_bound(got, want, q, k, v, True, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_on_card_matches_the_cpu(cuda, dtype):
    """``attention.cross_attention`` (plain PyTorch, f32 scores) on the
    card against the CPU, a decoder's 33 queries against 70 frames."""
    from repro_torch.models import attention as tattn

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(12)
    q = torch.randn(2, 33, 4, 2, 64, generator=gen).to(getattr(torch, dtype))
    k = torch.randn(2, 70, 4, 64, generator=gen).to(q.dtype)
    v = torch.randn(2, 70, 4, 64, generator=gen).to(q.dtype)
    got = tattn.cross_attention(q.to(cuda), k.to(cuda), v.to(cuda))
    assert got.dtype == q.dtype and got.device.type == "cuda"
    tol = (dict(rtol=1e-4, atol=1e-5) if dtype == "float32"
           else dict(rtol=1e-2, atol=1e-2))
    torch.testing.assert_close(got.cpu(), tattn.cross_attention(q, k, v),
                               **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_seamless_smoke_prefill_on_card_matches_the_cpu(cuda, compute_dtype,
                                                        monkeypatch):
    """seamless-m4t-large-v2's smoke config with one set of weights on the
    card and on the CPU: prefill (logits and the ``k``, ``v``, ``xk``,
    ``xv`` caches) and two decode steps.  Each layer launches the flash
    kernel once in the encoder (non-causal) and once in the decoder; the
    plain attention is never reached on the card.  Tolerances as
    ``test_lm_on_card_matches_the_cpu``'s."""
    import dataclasses

    from repro_torch.configs import seamless_m4t_large_v2 as C
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import api
    from repro_torch.models import attention as tattn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.SMOKE_CONFIG, compute_dtype=compute_dtype)
    cpu = api.build(cfg, "cpu", torch.Generator().manual_seed(9))
    card = api.build(cfg, cuda)
    card.module.load_state_dict(cpu.module.state_dict())
    batch = TokenStream(cfg, 2, 70).batch_at(0)
    batch["tokens"] = batch["tokens"][:, :70]
    real_ref = tattn.flash_attention_ref

    def refuse(q, *a, **k):
        assert q.device.type == "cpu", "a CUDA tensor reached the plain one"
        return real_ref(q, *a, **k)

    monkeypatch.setattr(tattn, "flash_attention_ref", refuse)
    kfa.flash_attention.launches = kfa.flash_attention.noncausal_launches = 0
    lg_card, c_card = card.prefill({k: v.to(cuda) for k, v in batch.items()},
                                   max_len=72)
    assert (kfa.flash_attention.launches,
            kfa.flash_attention.noncausal_launches) == (2 * cfg.n_layers,
                                                        cfg.n_layers)
    lg_cpu, c_cpu = cpu.prefill(batch, max_len=72)
    tol = (dict(rtol=1e-4, atol=1e-4) if compute_dtype == "float32"
           else dict(rtol=0.05, atol=0.1))
    torch.testing.assert_close(lg_card.float().cpu(), lg_cpu.float(), **tol)
    for key in ("k", "v", "xk", "xv"):
        torch.testing.assert_close(c_card[key].float().cpu(),
                                   c_cpu[key].float(), **tol)
    for _ in range(2):
        tok = lg_cpu.argmax(-1)
        lg_card, c_card = card.decode_step(c_card, tok.to(cuda))
        lg_cpu, c_cpu = cpu.decode_step(c_cpu, tok)
        torch.testing.assert_close(lg_card.float().cpu(), lg_cpu.float(),
                                   **tol)


@pytest.mark.gpu
def test_flash_op_keeps_the_jax_contract_on_card(cuda):
    """``ops.flash_attention_op`` on ``[B, H, S, D]`` with GQA equals the
    kernel on the model's layout, and the plain version."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn(2, 6, 300, 64, generator=gen, device=cuda)
    k = torch.randn(2, 2, 300, 64, generator=gen, device=cuda)
    v = torch.randn(2, 2, 300, 64, generator=gen, device=cuda)
    got = tops.flash_attention_op(q, k, v, causal=True, window=50)
    want = tops.flash_attention_op(q.cpu(), k.cpu(), v.cpu(), causal=True,
                                   window=50)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = attention_inputs(1, 8, 2, 2, 64, "float32", cuda, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        kfa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                            v[..., :48].contiguous())
    with pytest.raises(ValueError, match="float32"):
        kfa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="bfloat16"):
        kfa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        kfa.flash_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v)


@pytest.mark.gpu
def test_cuda_tensors_never_reach_the_plain_versions(cuda, monkeypatch):
    """On the card the ops and the model's attention launch the kernels or
    raise; the plain versions are for CPU tensors only."""
    from repro_torch.models import attention as tattn

    def refuse(*_a, **_k):
        raise AssertionError("a CUDA tensor reached the plain version")

    for mod, name in ((tops, "flash_attention_ref"),
                      (tops, "segment_reduce_ref"),
                      (tops, "bottomup_scan_ref"),
                      (tops, "outbox_reduce_ref"),
                      (tattn, "flash_attention_ref")):
        monkeypatch.setattr(mod, name, refuse)
    q, k, v = attention_inputs(1, 70, 2, 2, 32, "bfloat16", cuda, seed=1)
    before = (kfa.flash_attention.launches, ksr.segment_reduce.launches)
    tattn.chunked_attention(q, k, v, window=16)
    tops.flash_attention_op(q.flatten(2, 3).transpose(1, 2),
                            k.transpose(1, 2), v.transpose(1, 2))
    tops.segment_reduce_op(torch.ones(3, 5, device=cuda),
                           torch.tensor([0, 0, 1, 3, 3], device=cuda), 4)
    assert kfa.flash_attention.launches == before[0] + 2
    assert ksr.segment_reduce.launches == before[1] + 1
    idx = torch.tensor([0, 1, 1, 2], dtype=torch.int32, device=cuda)
    xs = torch.ones(3, 3, device=cuda)
    before = (kbu.bottomup_scan.launches, kob.outbox_reduce.launches)
    tops.bottomup_scan_op(torch.tensor([0, 2, 4], dtype=torch.int32,
                                       device=cuda), idx, None, xs,
                          semiring="min")
    tops.outbox_reduce_op(xs, idx, idx, None, num_slots=3, combine="sum")
    assert (kbu.bottomup_scan.launches, kob.outbox_reduce.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_lm_on_card_matches_the_cpu(cuda, compute_dtype):
    """The reduced tinyllama (GQA, untied head) with one set of weights on
    the card and on the CPU: prefill and two decode steps; one flash launch
    per layer per prefill.  f32 compute within 1e-4; bf16 within the CPU
    parity tests' bf16 tolerance (0.1 + 0.05 |x|)."""
    import dataclasses

    from repro_torch.configs import tinyllama_1_1b as C
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.CONFIG.reduced(n_kv_heads=2,
                                               tie_embeddings=False),
                              compute_dtype=compute_dtype)
    cpu = api.build(cfg, "cpu", torch.Generator().manual_seed(9))
    card = api.build(cfg, cuda)
    card.module.load_state_dict(cpu.module.state_dict())
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (2, 70)))
    kfa.flash_attention.launches = 0
    lg_card, c_card = card.prefill({"tokens": toks.to(cuda)}, max_len=72)
    assert kfa.flash_attention.launches == cfg.n_layers
    lg_cpu, c_cpu = cpu.prefill({"tokens": toks}, max_len=72)
    tol = (dict(rtol=1e-4, atol=1e-4) if compute_dtype == "float32"
           else dict(rtol=0.05, atol=0.1))
    torch.testing.assert_close(lg_card.float().cpu(), lg_cpu.float(), **tol)
    for _ in range(2):
        tok = lg_cpu.argmax(-1)
        lg_card, c_card = card.decode_step(c_card, tok.to(cuda))
        lg_cpu, c_cpu = cpu.decode_step(c_cpu, tok)
        torch.testing.assert_close(lg_card.float().cpu(), lg_cpu.float(),
                                   **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_ffn_on_card_matches_the_cpu(cuda, factor):
    """olmoe's smoke MoE layer (8 experts, top 2) with one set of weights:
    two card runs bit-equal (dispatch by assignment, no atomics) at bf16
    and f32; the f32 card run against the CPU run, routing (experts, slots,
    keep) equal and outputs within 1e-4, with choices dropped at 0.5."""
    import dataclasses

    from repro_torch.configs import olmoe_1b_7b as C
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.SMOKE_CONFIG, moe_capacity_factor=factor)
    gen = torch.Generator().manual_seed(11)
    lp = {name: torch.randn(shape, generator=gen) / math.sqrt(shape[-2])
          for name, shape in moe.moe_layer_params(cfg).items()}
    x = torch.randn(2, 40, cfg.d_model, generator=gen)
    for dtype in (torch.bfloat16, torch.float32):
        lpc = {k: v.to(cuda, dtype) for k, v in lp.items()}
        xc = x.to(cuda, dtype)
        a, b = moe.moe_ffn(xc, lpc, cfg), moe.moe_ffn(xc, lpc, cfg)
        assert a.dtype == dtype and torch.equal(a, b)
    routes = [moe.route(moe.router_logits(t.reshape(80, -1), w), cfg)
              for t, w in ((x, lp["moe_wg"]),
                           (x.to(cuda), lp["moe_wg"].to(cuda)))]
    for name in ("expert", "slot", "keep"):
        assert torch.equal(getattr(routes[0], name),
                           getattr(routes[1], name).cpu()), name
    assert bool(routes[0].keep.all()) == (factor == 1.25)
    # a: the f32 card run, the loop's last
    torch.testing.assert_close(a.cpu(), moe.moe_ffn(x, lp, cfg), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["bfs", "sssp"])
@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_continuous_session_matches_drain_on_card(cuda, backend, alg):
    """A continuous session (4 slots, chunk 2, a stream of 24: hub, fringe
    and seeded vertices) on the card, bit for bit against the port's drain
    batch of the same engine with equal steps, every slot refilled, zero
    retraces; the backend's kernels launch in the session's windows."""
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.launch.graph_serve import query_batch
    from repro_torch.runtime import ServeSession

    # scale 10: the hybrid planner splits (|H| = 512 of 1,024), so both
    # of its kernels run
    g = TG.rmat(10, 8, seed=13).with_uniform_weights(seed=1)
    eng = BSPEngine(TPT.partition(g, 2, TPT.HIGH), backend=backend,
                    block_e=256)
    deg = g.out_degrees()
    stream = np.concatenate([[int(np.argmax(deg)), int(np.argmin(deg))],
                             np.random.default_rng(3).integers(
                                 0, g.num_vertices, size=22)])
    want = [query_batch(eng, alg, stream[i:i + 4])
            for i in range(0, len(stream), 4)]
    rows = np.concatenate([w[0] for w in want])
    steps = np.concatenate([w[1] for w in want])
    counters = ((kfs.fused_superstep,) if backend == "fused"
                else (kell.ell_spmv, kds.dense_spmv_minplus))
    session = ServeSession(eng, alg, slots=4, chunk=2)
    qids = session.submit(stream)
    for fn in counters:
        fn.launches = 0
    rep = session.drain()
    assert all(fn.launches > 0 for fn in counters)
    got = {r["query"]: r for r in session.poll()}
    for j, qid in enumerate(qids):
        np.testing.assert_array_equal(got[qid]["result"], rows[j])
        assert got[qid]["steps"] == int(steps[j])
    assert rep["refills"] == len(stream) - 4
    assert rep["min_slot_refills"] >= 1
    assert rep["retraces"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["fused", "hybrid"])
def test_dynamic_engine_matches_rebuilt_graph_on_card(cuda, backend):
    """A dynamic engine on the card after a mutation stream (inserts and
    deletes; scale 10, 2 partitions): BFS and SSSP bit for bit with equal
    steps against a fresh engine over the rebuilt graph, the backend's
    kernels launched on the mutated layout (tombstones in the fused
    kernel's mask; the hybrid's spare-slot rows through the scan and the
    dense min-plus product), nothing rebuilt across
    the batches; then an insert-only window's warm BFS bit for bit a cold
    run, through the ``bfs_relax`` kind on the fused backend."""
    import importlib

    from repro_torch.core.bsp import BSPEngine
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.data.graphs import edge_stream

    tbfs = importlib.import_module("repro_torch.algorithms.bfs")
    tsssp = importlib.import_module("repro_torch.algorithms.sssp")
    g = TG.rmat(10, 8, seed=13).with_uniform_weights(seed=1)
    stream = edge_stream(g, 3, 64, churn=0.7, seed=5)
    dg = DynamicGraph(g, 2, TPT.HIGH, mutation_capacity=64)
    # the hybrid forced to pull, so its scan and dense kernels run in
    # every superstep
    kw = dict(direction="pull") if backend == "hybrid" else {}
    eng = BSPEngine(dg, backend=backend, block_e=256, **kw)
    sources = [0, 3, 17, 91]
    tbfs.bfs_batched(eng, sources)
    tsssp.sssp_batched(eng, sources)
    entries = eng.cache_entries()
    for b in stream:
        dg.apply_mutations(b)
    counters = ((kfs.fused_superstep,) if backend == "fused"
                else (kds.dense_spmv_minplus, kbu.bottomup_scan))
    for fn in counters:
        fn.launches = 0
    got = [fn(eng, sources) for fn in (tbfs.bfs_batched, tsssp.sssp_batched)]
    # before the fresh engine loads its own kernels (its pull scan)
    assert eng.cache_entries() == entries
    fresh = BSPEngine(TPT.partition(TG.apply_mutation_batches(g, stream), 2,
                                    TPT.HIGH), backend=backend, block_e=256)
    for fn, (res, steps) in zip((tbfs.bfs_batched, tsssp.sssp_batched), got):
        want, want_steps = fn(fresh, sources)
        np.testing.assert_array_equal(res, want)
        np.testing.assert_array_equal(steps, want_steps)
    assert eng.dynamic_rebinds == eng.hybrid_dyn_rebuilds == 0
    prev, _ = tbfs.bfs_batched(eng, sources)
    mark = dg.mark()
    dg.apply_mutations(edge_stream(dg.mutated_csr(), 1, 64, churn=1.0,
                                   seed=6)[0])
    dirty, monotone = dg.dirty_since(mark)
    assert monotone
    kfs.fused_superstep.launches = 0
    warm, warm_steps = tbfs.bfs_incremental(eng, prev, dirty)
    relax_launches = kfs.fused_superstep.launches
    cold, cold_steps = tbfs.bfs_batched(eng, sources)
    np.testing.assert_array_equal(warm, cold)
    assert warm_steps.max() < cold_steps.max()
    assert all(fn.launches > 0 for fn in counters)
    if backend == "fused":
        assert relax_launches == int(warm_steps.max())


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_checked_exchange_flags_one_mismatch_on_card(cuda, backend):
    """The checked exchange on CUDA tensors: a one-superstep window counts
    no mismatch clean and exactly one under the ``exchange.payload``
    poison (one flipped element), and the poisoned window leaves the
    carry as it was; the fused kernel launches in the window."""
    import importlib

    from repro_torch.core.bsp import BSPEngine

    tbfs = importlib.import_module("repro_torch.algorithms.bfs")
    g = TG.rmat(10, 8, seed=13)
    pg = TPT.partition(g, 2, TPT.HIGH)
    eng = BSPEngine(pg, backend=backend, block_e=256)
    state = {"level": tbfs.multi_source_state(pg, [0, 3, 17, 91],
                                              device=cuda)}
    before = state["level"].clone()
    fin = torch.zeros(4, dtype=torch.bool, device=cuda)
    steps_q = torch.zeros(4, dtype=torch.int32, device=cuda)
    kfs.fused_superstep.launches = 0
    counts = []
    for poison in (False, True):
        *_, bad = eng._chunk_call(tbfs.BFS_PROGRAM, 1, state, 0, fin,
                                  steps_q, poison)
        assert bad.device.type == "cuda"
        counts.append(int(bad))
    assert counts == [0, 1]
    assert torch.equal(state["level"], before)
    assert (kfs.fused_superstep.launches > 0) == (backend == "fused")


@pytest.mark.gpu
def test_device_monitor_records_equal_the_cpu_monitor_on_card(cuda):
    """``InvariantMonitor`` on CUDA snapshots gives the CPU monitor's
    records for the same window sequence: a clean window, a regression, a
    NaN slot, a refill (rebase), a regressed vote and a step jump."""
    from repro_torch.runtime import InvariantMonitor

    rng = np.random.default_rng(0)
    level = rng.integers(0, 5, size=(4, 2, 64)).astype(np.float32)
    windows = []
    cur = level.copy()
    for w in range(5):
        cur = cur.copy()
        if w == 1:
            cur[2, 1, 7] += 1.0                          # monotonicity
        if w == 2:
            cur[1, 0, 3] = np.nan                        # finiteness
        fin = np.array([w >= 3, False, w == 2, False])   # slot 0, slot 2
        steps = np.array([2, 2, 2, 2 + 5 * (w == 4)]) * (w + 1)
        windows.append((cur, fin, steps.astype(np.int32), 2 * (w + 1)))
    monitors = {dev: InvariantMonitor(keys=("level",), combine="min",
                                      chunk=2) for dev in ("cpu", "cuda")}
    for w, (lv, fin, steps, step) in enumerate(windows):
        recs = []
        for dev, mon in monitors.items():
            if w == 3:
                mon.rebase(np.array([False, False, False, True]))
            recs.append(mon.observe(dict(
                state={"level": torch.as_tensor(lv, device=dev)},
                finished=fin, steps_q=steps, step=step)))
        assert recs[0] == recs[1]
    assert monitors["cpu"].fired == monitors["cuda"].fired
    assert {c["check"] for r in monitors["cuda"].fired
            for c in r["checks"]} >= {"monotonicity", "finiteness",
                                      "finished_regressed", "steps_delta"}


@pytest.mark.gpu
def test_checkpoint_of_cuda_tensors_restores_on_card(cuda, tmp_path):
    """A tree of CUDA tensors (f32, bool, int32, int64) saved and restored
    onto ``cuda`` bit for bit, with their dtypes; the save copies them to
    the host before its writer thread starts."""
    from repro_torch.checkpoint import CheckpointManager

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"state": {"level": torch.randn(8, 2, 1000, device=cuda,
                                           generator=gen),
                      "active": torch.rand(8, 2, 1000, device=cuda,
                                           generator=gen) < 0.5},
            "steps_q": torch.arange(8, dtype=torch.int32, device=cuda),
            "ids": torch.arange(5, dtype=torch.int64, device=cuda) << 40}
    mgr = CheckpointManager(tmp_path)
    mgr.save_tree(3, tree, blocking=False)
    like = {"state": {k: torch.zeros_like(v) for k, v in
                      tree["state"].items()},
            "steps_q": torch.zeros_like(tree["steps_q"]),
            "ids": torch.zeros_like(tree["ids"])}
    step, got = mgr.restore_tree(like)
    assert step == 3
    for a, b in ((got["state"]["level"], tree["state"]["level"]),
                 (got["state"]["active"], tree["state"]["active"]),
                 (got["steps_q"], tree["steps_q"]),
                 (got["ids"], tree["ids"])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("alg", ["bfs", "sssp"])
def test_certified_cuda_session_never_serves_a_host_row_on_card(cuda, alg):
    """A certified session on the card recomputes a rejected result through
    its engine: with a certifier that rejects every query's first answer
    and whose numpy recompute must never run, every query is recomputed,
    recovered and served bit for bit as the engine's drain batches give
    it; the fused kernel launches."""
    from repro_torch.core.bsp import BSPEngine
    from repro_torch.runtime import (ResultCertifier, ServeSession,
                                     drain_reference)
    from repro_torch.runtime.verify import CheckResult, Verdict

    class FirstRejected(ResultCertifier):
        def __init__(self, *args):
            super().__init__(*args)
            self.seen = set()

        def certify(self, result, source=None):
            v = super().certify(result, source=source)
            if source in self.seen:
                return v
            self.seen.add(source)
            return Verdict(v.algorithm, False,
                           v.checks + (CheckResult("drill", False, 1),))

        def recompute(self, source=None):
            raise AssertionError("a host oracle's row was served on the card")

    g = TG.rmat(10, 8, seed=13).with_uniform_weights(seed=1)
    eng = BSPEngine(TPT.partition(g, 2, TPT.HIGH), backend="fused",
                    block_e=256)
    sources = np.random.default_rng(0).integers(0, g.num_vertices, 8)
    want = drain_reference(eng, alg, sources, 4)
    kfs.fused_superstep.launches = 0
    s = ServeSession(eng, alg, slots=4, chunk=2,
                     certifier=FirstRejected(alg, g))
    s.submit(sources)
    s.drain()
    rep = s.report()
    got = {r["query"]: r["result"] for r in s.poll()}
    assert rep["recomputed"] == len(sources)
    assert all(r["recovered"] for r in rep["certify_failed"])
    assert not s.quarantined_qids
    for q in range(len(sources)):
        np.testing.assert_array_equal(got[q], want[q])
    assert kfs.fused_superstep.launches > 0


@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_tiered_dynamic_engine_matches_resident_on_card(cuda, backend):
    """A tiered engine over a dynamic graph whose payload is in pinned host
    memory (scale 10, 2 partitions, at least one streamed), after a
    mutation stream
    and after a compaction: BFS and SSSP bit for bit with equal steps
    against a resident dynamic engine over the same graph, the fused kernel
    launched on the hot partition and each window of each superstep, the
    arenas rebuilt only at the compaction, ``hbm_bytes`` the device arena
    bytes; the hybrid refuses."""
    import importlib

    from repro_torch.core.bsp import BSPEngine
    from repro_torch.core.dynamic import DynamicGraph
    from repro_torch.data.graphs import edge_stream

    tbfs = importlib.import_module("repro_torch.algorithms.bfs")
    tsssp = importlib.import_module("repro_torch.algorithms.sssp")
    g = TG.rmat(10, 8, seed=13).with_uniform_weights(seed=1)
    dg = DynamicGraph(g, 2, TPT.HIGH, mutation_capacity=64, device="cpu",
                      pin=True)
    fused = backend == "fused"
    wb = 1
    while True:          # the least win_blocks whose all-cold plan cuts
        try:
            probe = TPT.build_tier_plan(dg.pg, 1 << 62, block_e=256,
                                        win_blocks=wb, fused=fused,
                                        dynamic=dg)
            TPT.build_tier_plan(dg.pg, int(probe.table[0]["hbm_bytes"]),
                                block_e=256, win_blocks=wb, fused=fused,
                                dynamic=dg)
            break
        except ValueError:
            wb *= 2
    # table[1] (the denser partition hot), or table[0] (both cold) where
    # row 1's windows are so wide that its budget holds both partitions
    budget = int(probe.table[1]["hbm_bytes"])
    if not len(TPT.build_tier_plan(dg.pg, budget, block_e=256,
                                   win_blocks=wb, fused=fused,
                                   dynamic=dg).cold):
        budget = int(probe.table[0]["hbm_bytes"])
    tiered = BSPEngine(dg, backend=backend, block_e=256, tiered=budget,
                       win_blocks=wb)
    resident = BSPEngine(dg, backend=backend, block_e=256)
    plan = tiered.tier_plan
    assert len(plan.cold) >= 1 and plan.fwd.num_windows >= 1
    assert tiered.tiered_stats()["device_arena_bytes"] == plan.hbm_bytes
    sources = [0, 3, 17, 91]
    made = tiered.tiered_buffers_made
    for b in edge_stream(g, 3, 64, churn=0.7, seed=5):
        dg.apply_mutations(b)
        for fn in (tbfs.bfs_batched, tsssp.sssp_batched):
            before = kfs.fused_superstep.launches
            got, steps = fn(tiered, sources)
            n = kfs.fused_superstep.launches - before
            want, want_steps = fn(resident, sources)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(steps, want_steps)
            if fused:
                assert n == int(steps.max()) * (
                    int(len(plan.hot) > 0) + plan.fwd.num_windows)
    assert tiered.tiered_buffers_made == made
    dg.compact()
    got, steps = tbfs.bfs_batched(tiered, sources)
    want, want_steps = tbfs.bfs_batched(resident, sources)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(steps, want_steps)
    assert tiered.tiered_buffers_made > made
    assert tiered.tier_plan is not plan
    assert (tiered.tiered_stats()["device_arena_bytes"]
            == tiered.tier_plan.hbm_bytes)
    with pytest.raises(ValueError, match="does not support dynamic"):
        BSPEngine(dg, backend="hybrid", tiered=budget)


@pytest.mark.gpu
def test_train_step_on_card_matches_the_cpu(cuda):
    """One ``make_train_step`` step of the reduced tinyllama (GQA, untied
    head, f32 compute, two microbatches) from one set of parameters on the
    card and on the CPU: the metrics within 1e-5 relative and the
    parameters within 1e-5 relative (atol 1e-5 of each leaf's largest
    magnitude), with AdamW's ``eps`` at 1e-3 (at the default 1e-8 the
    first update of a near-zero gradient amplifies f32 differences by up
    to ``lr·δg/eps``); the parameters stay f32 on the card and the flash
    route refuses an input that requires grad.  Then bf16 compute: a
    finite loss that falls over three steps on one batch."""
    import dataclasses

    from repro_torch.configs import tinyllama_1_1b as C
    from repro_torch.models import api
    from repro_torch.models import attention as attn
    from repro_torch.optim import AdamW, tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.CONFIG.reduced(n_kv_heads=2,
                                               tie_embeddings=False),
                              compute_dtype="float32")
    cpu, card = api.build(cfg, "cpu", serve=False), api.build(
        cfg, cuda, serve=False)
    params = cpu.init_params(torch.Generator().manual_seed(5))
    batch = api.synth_batch(cfg, api.ShapeSpec("t", "train", 64, 4), seed=5,
                            device="cpu")
    opt = AdamW(learning_rate=1e-2, warmup_steps=1, eps=1e-3)
    out = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        p = tree_map(lambda x: x.to(dev), params)
        step = api.make_train_step(model, opt, microbatches=2)
        out[name] = step(p, opt.init(p), {k: v.to(dev)
                                          for k, v in batch.items()})
    for k in ("loss", "grad_norm_sq"):
        np.testing.assert_allclose(float(out["card"][2][k]),
                                   float(out["cpu"][2][k]), rtol=1e-5)
    for a, b in zip(tree_leaves(out["card"][0]), tree_leaves(out["cpu"][0])):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    q = torch.zeros(1, 64, 2, 2, 16, device=cuda, requires_grad=True)
    kv = torch.zeros(1, 64, 2, 16, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        attn.chunked_attention(q, kv, kv)
    bf = api.build(dataclasses.replace(cfg, compute_dtype="bfloat16"), cuda,
                   serve=False)
    p = tree_map(lambda x: x.to(cuda), params)
    state = opt.init(p)
    step = api.make_train_step(bf, AdamW(learning_rate=1e-2,
                                         warmup_steps=1), microbatches=2)
    cb = {k: v.to(cuda) for k, v in batch.items()}
    losses = []
    for _ in range(3):
        p, state, met = step(p, state, cb)
        losses.append(float(met["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
