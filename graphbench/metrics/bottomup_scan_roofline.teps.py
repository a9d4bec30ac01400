"""bottomup_scan_roofline.teps: the pull direction's sparse stage (the
bottom-up scan over the split's remainder rows) in a min-plus traversal,
where the scan reads every slot: each launch's ``row_ptr``, ``col``,
``val`` and ``x`` read once and ``y`` and the scanned counts written once
at the HBM rate, over the scan kernels' device time.  With an early exit
(BFS) the slots read depend on the frontier, which no counter gives, so
the metric reads nothing there."""
from gblib import trace, yardstick


def read(run):
    s = run["shapes"]
    launches = run["launches"].get("bottomup_scan", 0)
    if (s["semiring"] != "min_plus"
            or s["uniform"] or not launches or not run["trace"]):
        return None
    busy = trace.device_seconds(run["trace"], "scan_block_kernel",
                                "scan_merge_kernel")
    if busy <= 0:
        return None
    least = launches * yardstick.scan_bound_s(s["semiring"], s["rows"],
                                              s["nnz"], s["q"], s["n"])
    return 100.0 * least / busy
