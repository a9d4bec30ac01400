"""partition_s: the host graph layer's set-up (``core/graph.py::
from_edge_list`` and ``core/partition.py::partition``), host clock."""


def read(run):
    return run["setup"]["partition_s"]
