"""result_copy_ms.bfs: device-to-host copy time per call in the BFS cells."""
from gblib.readers import result_copy_ms as read  # noqa: F401
