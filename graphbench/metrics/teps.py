"""teps: traversed edges per second of the SSSP cells (``gblib/readers.py``)."""
from gblib.readers import traversed_edges_per_s as read  # noqa: F401
