"""The port's ``bottomup_scan_op`` against the JAX package's, on the same
rows, messages and skip mask.

The port takes CSR rows; JAX takes the same rows as an ELL block padded with
a sentinel column that reads the +inf sink it appends to ``x``.  On the CPU
the port runs its plain version and JAX its Pallas kernel in interpret mode.
Tolerance: bit for bit for ``y`` (a min is order-free) and for the integer
``scanned`` counts.  The CUDA kernel is held against the same plain version
on the card in ``test_torch_kernel_card.py``.  The op also reads the
engines' query-minor view of ``x`` (Q in {1, 3, 8, 13}) as it reads ``x``,
takes the row plan the engines keep and refuses another's, and the kernel's
wrapper refuses what it does not take before it launches.
"""
import numpy as np
import pytest
import torch

from test_torch_jaxref import jops
from test_torch_kernel_card import SCAN_MODES, port_scan, scan_inputs

from repro_torch.kernels import bottomup as kbu
from repro_torch.kernels import ell_spmv as kell
from repro_torch.kernels import ops as tops


def jax_scan(row_ptr, col, val, x, skip, semiring, early_exit):
    """The same rows through ``repro.kernels.ops.bottomup_scan_op``."""
    import jax.numpy as jnp

    v, x_len = row_ptr.shape[0] - 1, x.shape[1]
    kreal = np.diff(row_ptr).astype(np.int32)
    k = max(int(kreal.max()), 1)
    rows = np.repeat(np.arange(v), kreal)
    slots = np.arange(len(col)) - np.repeat(row_ptr[:-1], kreal)
    ell = np.full((v, k), x_len, np.int32)        # sentinel: the sink
    ell[rows, slots] = col
    ell_val = None
    if val is not None:
        ell_val = np.zeros((v, k), np.float32)
        ell_val[rows, slots] = val
        ell_val = jnp.asarray(ell_val)
    xs = np.concatenate([x, np.full((x.shape[0], 1), np.inf, np.float32)],
                        axis=1)
    y, scanned = jops.bottomup_scan_op(
        jnp.asarray(ell), ell_val, jnp.asarray(xs), jnp.asarray(kreal),
        semiring=semiring, early_exit=early_exit,
        skip=None if skip is None else jnp.asarray(skip), block_v=128,
        interpret=True)
    return np.asarray(y), np.asarray(scanned)


@pytest.mark.parametrize("semiring,early_exit,skip", SCAN_MODES)
@pytest.mark.parametrize("q", [1, 3])
def test_plain_scan_matches_jax(semiring, early_exit, skip, q):
    rng = np.random.default_rng(10 * q + len(semiring))
    row_ptr, col, val, x, skip_mask = scan_inputs(semiring, early_exit, q,
                                                  rng)
    skip_mask = skip_mask if skip else None
    got = port_scan(row_ptr, col, val, x, skip_mask, semiring, early_exit)
    want = jax_scan(row_ptr, col, val, x, skip_mask, semiring, early_exit)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int32


def test_scan_refuses_what_it_cannot_compute_exactly():
    rng = np.random.default_rng(0)
    row_ptr, col, val, x, _ = scan_inputs("min_plus", False, 1, rng)
    with pytest.raises(ValueError, match="min semiring"):
        port_scan(row_ptr, col, val, x, None, "min_plus", True)
    with pytest.raises(ValueError, match="min combine"):
        port_scan(row_ptr, col, val, x, None, "plus_times", False)


@pytest.mark.parametrize("semiring,early_exit,skip", SCAN_MODES)
@pytest.mark.parametrize("q", [1, 3, 8, 13])
def test_scan_op_reads_a_query_minor_view_as_it_reads_x(semiring, early_exit,
                                                        skip, q):
    """The op gives the same ``y`` and ``scanned`` for ``x`` and for the
    engine's query-minor view of it (``ell_spmv.query_minor_view``), with
    the rows' plan given or built."""
    rng = np.random.default_rng(q)
    row_ptr, col, val, x, skip_mask = scan_inputs(semiring, early_exit, q,
                                                  rng)
    skip_mask = skip_mask if skip else None
    args = (row_ptr, col, val, x, skip_mask, semiring, early_exit)
    want = port_scan(*args)
    got = port_scan(*args, view=True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    xq = kell.query_minor_view(torch.as_tensor(x), np.inf)
    y, cnt = tops.bottomup_scan_op(
        torch.as_tensor(row_ptr), torch.as_tensor(col),
        None if val is None else torch.as_tensor(val), xq,
        semiring=semiring, early_exit=early_exit,
        skip=None if skip_mask is None else torch.as_tensor(skip_mask),
        plan=kell.row_plan(row_ptr))
    np.testing.assert_array_equal(y.numpy(), want[0])
    np.testing.assert_array_equal(cnt.numpy(), want[1])


def test_scan_op_refuses_a_plan_of_other_rows():
    rng = np.random.default_rng(2)
    row_ptr, col, _, x, _ = scan_inputs("min", False, 2, rng)
    args = [torch.as_tensor(a) for a in (row_ptr, col)]
    for rows in (row_ptr[:-1], np.minimum(row_ptr, row_ptr[-1] - 1)):
        with pytest.raises(ValueError, match="does not belong"):
            tops.bottomup_scan_op(*args, None, torch.as_tensor(x),
                                  semiring="min", plan=kell.row_plan(rows))


def test_scan_kernel_wrapper_refuses_before_it_launches():
    """``bottomup.bottomup_scan`` checks the plan, shapes and types, then
    the device, and raises before anything is built or launched."""
    rng = np.random.default_rng(3)
    row_ptr, col, val, x, _ = scan_inputs("min_plus", False, 3, rng)
    rp, c, v = (torch.as_tensor(a) for a in (row_ptr, col, val))
    xt = kell.query_minor(torch.as_tensor(x), np.inf)
    plan = kell.row_plan(row_ptr).to("cpu")
    before = kbu.bottomup_scan.launches
    cases = [
        (dict(xt=xt.double()), "float32"),
        (dict(xt=xt[:, :3]), "multiple of 4"),
        (dict(xt=xt.t().contiguous().t()), "contiguous"),
        (dict(col=c.long()), "int32"),
        (dict(val=None), "min_plus"),
        (dict(val=v[:-1]), "differ"),
        (dict(plan=kell.row_plan(row_ptr[:-1]).to("cpu")), "does not belong"),
        (dict(num_queries=0), "queries"),
        (dict(semiring="min_plus", early_exit=True), "no kernel mode"),
        ({}, "CUDA"),
    ]
    for change, match in cases:
        a = dict(row_ptr=rp, col=c, val=v, xt=xt, plan=plan,
                 semiring="min_plus", num_queries=3)
        a.update(change)
        with pytest.raises(ValueError, match=match):
            kbu.bottomup_scan(a.pop("row_ptr"), a.pop("col"), a.pop("val"),
                              a.pop("xt"), a.pop("plan"), **a)
    assert kbu.bottomup_scan.launches == before


def test_pull_layout_keeps_the_row_plan_of_its_rows():
    """The engine's pull layout carries ``row_plan`` of its own rows, which
    its scans pass to the op, and the op holds the plan to the rows."""
    from repro_torch.core import graph as TG
    from repro_torch.core import partition as TPT
    from repro_torch.core.bsp import BSPEngine

    pg = TPT.partition(TG.rmat(9, 8, seed=3), 3, TPT.HIGH)
    pull = BSPEngine(pg, device="cpu")._pull
    want = kell.row_plan(pull.row_ptr)
    np.testing.assert_array_equal(pull.plan.blocks.numpy(), want.blocks)
    np.testing.assert_array_equal(pull.plan.long_rows.numpy(),
                                  want.long_rows)
    assert (pull.plan.num_partials, pull.plan.num_rows,
            pull.plan.num_slots) == (want.num_partials, want.num_rows,
                                     want.num_slots)
    pull.plan.check(pull.row_ptr, pull.col)
