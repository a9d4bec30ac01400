"""The port's ``bottomup_scan_op`` against the JAX package's, on the same
rows, messages and skip mask.

The port takes CSR rows; JAX takes the same rows as an ELL block padded with
a sentinel column that reads the +inf sink it appends to ``x``.  On the CPU
the port runs its plain version and JAX its Pallas kernel in interpret mode.
Tolerance: bit for bit for ``y`` (a min is order-free) and for the integer
``scanned`` counts.  The CUDA kernel is held against the same plain version
on the card in ``test_torch_kernel_card.py``.
"""
import numpy as np
import pytest

from test_torch_jaxref import jops
from test_torch_kernel_card import SCAN_MODES, port_scan, scan_inputs


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
