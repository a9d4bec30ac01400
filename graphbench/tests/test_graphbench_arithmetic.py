"""The yardstick's arithmetic on synthetic input: traversed edges, bounds,
and the trace reader's busy, idle and gap charges."""
from __future__ import annotations

import math

import numpy as np
import pytest

from gblib import trace, yardstick


def test_traversed_edges_counts_reached_out_degrees():
    out_deg = np.array([3, 0, 2, 5], dtype=np.int64)
    res = np.array([[0, 1, np.inf, 2], [np.inf, np.inf, 0, np.inf]],
                   dtype=np.float32)
    # row 0 reaches 0, 1, 3: 3 + 0 + 5; row 1 reaches 2: 2
    assert yardstick.traversed_edges(res, out_deg) == 10


def test_bounds():
    v, nnz = 1 << 20, 1 << 24
    # the min-plus dense stage at Q=64 over a 2816 block is compute-bound
    k = 2816
    assert yardstick.dense_bound_s(64, k, k) == pytest.approx(
        2 * 64 * k * k / yardstick.F32_OPS_PER_S)
    scan = yardstick.scan_bound_s("min_plus", v, nnz, 64, v)
    assert scan == pytest.approx(max(
        (4 * (v + 1) + 8 * nnz + 4 * 64 * v + 8 * 64 * v)
        / yardstick.HBM_BYTES_PER_S, 2 * 64 * nnz / yardstick.F32_OPS_PER_S))


def test_trace_union_busy_idle_and_gap_charges():
    ms = 1_000_000
    device = [("ell_block_kernel(int const*)", 0, 2 * ms),
              ("ell_merge_kernel(int const*)", 1 * ms, 3 * ms),  # overlaps
              ("Memcpy DtoH (Device -> Pageable)", 5 * ms, 6 * ms),
              ("dense_spmv_kernel<1, 4>(float const*)", 8 * ms, 9 * ms)]
    host = [("aten::item", 2 * ms, 4 * ms),          # covers 3..4
            ("aten::_local_scalar_dense", 2 * ms, 4 * ms),   # nested
            ("cudaLaunchKernel", 7 * ms, 8 * ms)]
    s = trace.summarize(device, host, [(0, 10 * ms)])
    assert s["window_s"] == pytest.approx(0.010)
    assert s["busy_s"] == pytest.approx(0.005)         # 0-3, 5-6, 8-9
    assert s["dtoh_s"] == pytest.approx(0.001)
    gaps = dict(s["idle_gaps"])
    # idle: 3-5, 6-8, 9-10 = 5 ms; 3-4 aten::item, 7-8 cudaLaunchKernel
    assert gaps["aten::item"] == pytest.approx(0.001)
    assert gaps["cudaLaunchKernel"] == pytest.approx(0.001)
    assert gaps[trace.NO_HOST_OP] == pytest.approx(0.003)
    assert "aten::_local_scalar_dense" not in gaps
    assert sum(gaps.values()) == pytest.approx(0.010 - s["busy_s"])
    assert trace.device_seconds(s, "ell_block_kernel", "ell_merge_kernel") \
        == pytest.approx(0.004)
    assert s["device_ops"][0][0] in ("ell_block_kernel", "ell_merge_kernel")
    assert math.isclose(sum(t for _, t in s["device_ops"]), 0.006)


def test_trace_clips_to_the_window():
    ms = 1_000_000
    s = trace.summarize([("k", -5 * ms, 2 * ms), ("k", 9 * ms, 12 * ms)], [],
                        [(0, 10 * ms)])
    assert s["busy_s"] == pytest.approx(0.003)
    assert dict(s["idle_gaps"])[trace.NO_HOST_OP] == pytest.approx(0.007)


def test_trace_window_is_the_calls():
    """Two calls, 0-4 and 6-10 ms; the client's 4-6 ms is no one's idle
    time, and a kernel across the boundary counts inside the calls only."""
    ms = 1_000_000
    device = [("k", 1 * ms, 5 * ms), ("k", 7 * ms, 8 * ms)]
    host = [("client work", 4 * ms, 6 * ms), ("aten::item", 8 * ms, 10 * ms)]
    s = trace.summarize(device, host, [(6 * ms, 10 * ms), (0, 4 * ms)])
    assert s["window_s"] == pytest.approx(0.008)
    assert s["busy_s"] == pytest.approx(0.004)        # 1-4 and 7-8
    assert s["device_s"]["k"] == pytest.approx(0.004)
    gaps = dict(s["idle_gaps"])
    assert "client work" not in gaps
    assert gaps["aten::item"] == pytest.approx(0.002)
    assert gaps[trace.NO_HOST_OP] == pytest.approx(0.002)   # 0-1, 6-7
