"""result_copy_ms: device-to-host copy time per call in the SSSP cells."""
from gblib.readers import result_copy_ms as read  # noqa: F401
