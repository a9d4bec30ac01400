"""dense_spmv_roofline.teps: the dense stage (min-plus over the hub block
``[k_dense, k_dense]`` for the batch's queries) in a traversal: each
launch's ``x``, ``a`` and ``y`` once at the HBM rate, or its ``2 Q k k``
operations at the float32 rate, whichever is larger, over the dense
kernel's device time."""
from gblib import trace, yardstick


def read(run):
    s = run["shapes"]
    launches = run["launches"].get("dense_spmv_minplus", 0)
    if not launches or not run["trace"]:
        return None
    busy = trace.device_seconds(run["trace"], "dense_spmv_kernel")
    if busy <= 0:
        return None
    k = s["k_dense"]
    return 100.0 * launches * yardstick.dense_bound_s(s["q"], k, k) / busy
