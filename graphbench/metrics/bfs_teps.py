"""bfs_teps: traversed edges per second of the BFS cells (``gblib/readers.py``)."""
from gblib.readers import traversed_edges_per_s as read  # noqa: F401
