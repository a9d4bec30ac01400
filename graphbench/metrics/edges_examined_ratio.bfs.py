"""edges_examined_ratio.bfs: the vote's examined edges over queries x |E|, BFS cells."""
from gblib.readers import edges_examined_ratio as read  # noqa: F401
