"""csr_build_s: host seconds of the ``graph.from_edge_list`` span in
set-up (``core/graph.py``: the edge list's sort into CSR)."""
from pathlib import Path

from gblib import spans

# loaded before set-up, in a traced run only: record the program's spans
spans.install(Path(__file__).resolve().parents[2])


def read(run):
    return spans.setup_span_s(run, "graph.from_edge_list")
