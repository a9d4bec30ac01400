"""The port's ``fused_superstep_op`` against the JAX package's, per message
kind, on the same partition, block layout, state and step.

On the CPU the port takes its plain version; JAX runs its Pallas kernel in
interpret mode when the block span fits (rmat9, P=1, ``block_e=256``) and
its reference branch when it does not (``max_span=8``).  Tolerances: the min
kinds (bfs, sssp, cc) bit for bit, a min is order-free; the sum kinds
(pagerank, bc_fwd, bc_bwd) ``rtol=1e-6, atol=1e-9``, the f32 reassociation
bound ``tests/test_fused_superstep.py`` uses between fused and reference.

The CUDA kernel itself is held against the same plain version on the card
in ``test_torch_kernel_card.py``.
"""
import dataclasses
import importlib
import math

import numpy as np
import pytest
import torch

from test_torch_jaxref import JG, JPT, jbc, jbfs, jcc, jops, jpr, jsssp
from test_torch_kernel_card import (KINDS, assert_parity, make_inputs,
                                    port_op)

from repro_torch.core import graph as TG
from repro_torch.core import partition as TPT
from repro_torch.kernels import _build
from repro_torch.kernels import fused_superstep as kfs
from repro_torch.kernels import ops as tops

# The algorithm packages re-export functions named like their modules.
tbc = importlib.import_module("repro_torch.algorithms.bc")
tbfs = importlib.import_module("repro_torch.algorithms.bfs")
tcc = importlib.import_module("repro_torch.algorithms.cc")
tpr = importlib.import_module("repro_torch.algorithms.pagerank")
tsssp = importlib.import_module("repro_torch.algorithms.sssp")

GATHER_CHUNK = 256


def _programs(kind, n):
    """(JAX program, port program) of each message kind."""
    return {
        "bfs": (jbfs.BFS_PROGRAM, tbfs.BFS_PROGRAM),
        "sssp": (jsssp.SSSP_PROGRAM, tsssp.SSSP_PROGRAM),
        "cc": (jcc.CC_PROGRAM, tcc.CC_PROGRAM),
        "pagerank": (jpr.make_pagerank_program(n),
                     tpr.make_pagerank_program(n)),
        "bc_fwd": (jbc.FORWARD_PROGRAM, tbc.FORWARD_PROGRAM),
        "bc_bwd": (jbc.BACKWARD_PROGRAM, tbc.BACKWARD_PROGRAM),
        # BFS's incremental (relaxation) form
        "bfs_relax": (jbfs.BFS_RELAX_PROGRAM, tbfs.BFS_RELAX_PROGRAM),
    }[kind]


def _jax_fused(jprog, vstate, blk, dst_ext, seg, **kw):
    import jax.numpy as jnp

    spec = jprog.edge_msg

    def msg_fn(vals, weight, scals):
        return spec.fn(dict(zip(spec.gather, vals)), weight, scals[0],
                       dict(zip(spec.consts, scals[1:])))

    v_max = vstate.shape[3]
    v_pad = -(-v_max // GATHER_CHUNK) * GATHER_CHUNK
    vpad = np.pad(vstate, ((0, 0), (0, 0), (0, 0), (0, v_pad - v_max)))
    weight = jnp.asarray(blk.weight) if spec.use_weight else None
    return np.asarray(jops.fused_superstep_op(
        msg_fn, jnp.asarray(vpad), weight, jnp.asarray(kw.pop("scal")),
        jnp.asarray(blk.src), jnp.asarray(blk.local), jnp.asarray(blk.mask),
        jnp.asarray(blk.base), jnp.asarray(dst_ext), num_segments=seg,
        combine=jprog.combine, span=blk.span, block_e=blk.block_e,
        gather_chunk=GATHER_CHUNK, interpret=True, **kw))


# (scale, P, strategy, block_e, max_span): the first runs JAX's Pallas
# kernel (spans fit), the second forces its reference branch.
CASES = {
    "jax-kernel": (9, 1, "rand", 256, 4096),
    "jax-fallback": (9, 2, "high", 128, 8),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def layout(request):
    scale, parts, strategy, block_e, max_span = CASES[request.param]
    jg = JG.rmat(scale, 8, seed=5).with_uniform_weights(seed=2)
    jp = JPT.partition(jg, parts, strategy)
    blk = JPT.build_block_metadata(jp.fwd, block_e=block_e)
    span_fits = blk.span <= jops.fused_span_limit(block_e, "min", max_span)
    assert span_fits == (request.param == "jax-kernel")
    return jp, blk, max_span


@pytest.mark.parametrize("kind", KINDS)
def test_plain_op_matches_jax_op(layout, kind):
    jp, blk, max_span = layout
    jprog, tprog = _programs(kind, jp.num_vertices)
    assert tprog.edge_msg.kind == kind
    rng = np.random.default_rng(KINDS.index(kind))
    vstate, scal = make_inputs(kind, 2, jp.num_parts, jp.v_max, rng)
    seg = jp.seg_count
    want = _jax_fused(jprog, vstate, blk, jp.fwd.dst_ext, seg, scal=scal,
                      max_span=max_span)
    got = port_op(tprog, vstate, scal, blk, jp.fwd.dst_ext, seg).numpy()
    assert got.shape == (2, jp.num_parts, seg)
    assert_parity(jprog.combine, got, want)


def test_empty_segments_hold_the_identity():
    """The sink and unused outbox slots receive no message: 0 for sums,
    +inf for mins, as ``jax.ops.segment_*`` leaves them."""
    tg = TG.rmat(7, 4, seed=1)
    tp = TPT.partition(tg, 2, TPT.RAND)
    blk = TPT.build_block_metadata(tp.fwd, block_e=128)
    for kind in ("bfs", "pagerank"):
        _, tprog = _programs(kind, tp.num_vertices)
        vstate, scal = make_inputs(kind, 1, 2, tp.v_max,
                                   np.random.default_rng(0))
        acc = port_op(tprog, vstate, scal, blk, tp.fwd.dst_ext,
                       tp.seg_count).numpy()
        ident = math.inf if tprog.combine == "min" else 0.0
        assert (acc[:, :, tp.v_max] == ident).all()          # the sink
        unused = ~tp.fwd.outbox_mask.reshape(2, -1)
        assert (acc[0, :, tp.v_max + 1:][unused] == ident).all()


def test_device_tensor_needs_a_device_kind():
    """Only a CPU tensor takes the plain version.  Any other tensor goes to
    the kernel, so a message without a kind raises there instead of falling
    back (checked before any launch; meta tensors stand in for the card)."""
    msg = dataclasses.replace(tbfs.BFS_PROGRAM.edge_msg, kind=None)
    fake = torch.zeros(1, 1, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no device form"):
        tops.fused_superstep_op(msg, fake, None, fake, fake, fake, fake,
                                fake, fake, num_segments=9, combine="min",
                                block_e=128)
    sum_msg = tpr.make_pagerank_program(8).edge_msg
    with pytest.raises(ValueError, match="combines by sum"):
        tops.fused_superstep_op(sum_msg, fake, None, fake, fake, fake, fake,
                                fake, fake, num_segments=9, combine="min",
                                block_e=128)


@pytest.mark.parametrize("q", [1, 3, 8, 13])
def test_query_minor_state_pads_lanes_never_written_out(q):
    """The kernel's state layout ``[Pl, K, V, Qp]``: Qp = Q rounded up to
    a multiple of 4, the padded lanes ``PAD``.  ``stack_query_minor``'s
    ``[Q, Pl, K, V]`` view is taken as it is (no second copy), and the op
    gives the same accumulator on it as on the contiguous state, with the
    Q real queries only (the card test puts NaN in the padded lanes)."""
    tg = TG.rmat(7, 4, seed=q).with_uniform_weights(seed=2)
    tp = TPT.partition(tg, 2, TPT.HIGH)
    blk = TPT.build_block_metadata(tp.fwd, block_e=128)
    _, tprog = _programs("sssp", tp.num_vertices)
    vstate, scal = make_inputs("sssp", q, 2, tp.v_max,
                               np.random.default_rng(q))
    vs = torch.as_tensor(vstate)
    vt = kfs.query_minor_state(vs)
    qp = kfs.padded_queries(q)
    assert qp % kfs.QUERY_ALIGN == 0 and q <= qp < q + kfs.QUERY_ALIGN
    assert vt.shape == (2, 2, tp.v_max, qp) and vt.is_contiguous()
    assert torch.equal(vt[..., :q], vs.permute(1, 2, 3, 0))
    assert bool((vt[..., q:] == kfs.PAD).all())
    view = kfs.stack_query_minor([vs[:, :, 0], vs[:, :, 1].double()])
    assert view.shape == vs.shape and torch.equal(view, vs)
    base = kfs.query_minor_state(view)
    assert base.data_ptr() == view.data_ptr() and torch.equal(base, vt)
    want = port_op(tprog, vstate, scal, blk, tp.fwd.dst_ext, tp.seg_count)
    got = tops.fused_superstep_op(
        tprog.edge_msg, view, torch.as_tensor(blk.weight),
        torch.as_tensor(scal), torch.as_tensor(blk.src),
        torch.as_tensor(blk.local), torch.as_tensor(blk.mask),
        torch.as_tensor(blk.base), torch.as_tensor(tp.fwd.dst_ext),
        num_segments=tp.seg_count, combine="min", block_e=128)
    assert got.shape == (q, 2, tp.seg_count) and torch.equal(got, want)


def _wrapper_args(case):
    """Arguments of ``fused_superstep.fused_superstep`` on CPU tensors:
    valid ones (BFS, Q=3, Pl=1, V=16, one 128-edge block) with one thing
    the kernel does not take, by ``case``."""
    kind, q, k, qp, block_e = "bfs", 3, 1, 4, 128
    vt_dtype, src_dtype, weight = torch.float32, torch.int32, None
    if case == "kind":
        kind = "bellman_ford"
    elif case == "block_e":
        block_e = 100
    elif case == "gathered":
        k = 2
    elif case == "query axis":
        qp = 6
    elif case == "too few lanes":
        q = 5
    elif case == "state dtype":
        vt_dtype = torch.float64
    elif case == "index dtype":
        src_dtype = torch.int64
    elif case == "weight":
        kind, k = "sssp", 2
    vt = torch.zeros((1, k, 16, qp), dtype=vt_dtype)
    scal = torch.zeros((q, 1, 1))
    src = torch.zeros((1, 128), dtype=src_dtype)
    ints = torch.zeros((1, 128), dtype=torch.int32)
    base = torch.zeros((1, 1), dtype=torch.int32)
    return (kind, vt, scal, src, ints, ints, weight, base), dict(
        num_segments=18, block_e=block_e)


REFUSALS = {"kind": "unknown message kind", "block_e": "block_e",
            "gathered": "gathered arrays", "query axis": "query axis",
            "too few lanes": "query axis", "state dtype": "torch.float32",
            "index dtype": "torch.int32", "weight": "needs edge weights",
            "device": "must be a CUDA tensor"}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_before_it_launches(case):
    """Bad kinds, shapes, dtypes and devices raise before the library is
    loaded or the launch counted (a valid CPU call raises for its
    device: only a CUDA tensor reaches the kernel)."""
    args, kw = _wrapper_args(case)
    before = kfs.fused_superstep.launches
    with pytest.raises(ValueError, match=REFUSALS[case]):
        kfs.fused_superstep(*args, **kw)
    assert kfs.fused_superstep.launches == before
    assert kfs.SOURCE not in _build._loaded
