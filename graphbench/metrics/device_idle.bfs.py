"""device_idle.bfs: the device's idle share of the BFS cells' traced calls."""
from gblib.readers import device_idle as read  # noqa: F401
