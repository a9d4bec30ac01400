"""edges_examined_ratio: the vote's examined edges over queries x |E|, SSSP cells."""
from gblib.readers import edges_examined_ratio as read  # noqa: F401
