"""kernel_load_s: host seconds of the ``kernels.load`` spans in set-up
(``kernels/_build.py::load``: building a CUDA library with nvcc where it is
not built yet, and loading it)."""
from pathlib import Path

from gblib import spans

# loaded before set-up, in a traced run only: record the program's spans
spans.install(Path(__file__).resolve().parents[2])


def read(run):
    return spans.setup_span_s(run, "kernels.load")
