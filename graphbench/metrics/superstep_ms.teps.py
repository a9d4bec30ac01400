"""superstep_ms.teps: milliseconds a superstep in the SSSP cells' calls."""
from gblib.readers import superstep_ms as read  # noqa: F401
