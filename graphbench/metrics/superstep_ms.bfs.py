"""superstep_ms.bfs: milliseconds a superstep in the BFS cells' calls."""
from gblib.readers import superstep_ms as read  # noqa: F401
