"""gather_ms.teps: device ms charged to the ``entry.result_copy`` span
(``gather_batch``: the index gather of the ``[Q, n]`` answers and their copy
to the host) per call, SSSP cells."""
from pathlib import Path

from gblib import spans

# loaded before set-up, in a traced run only: record the program's spans
spans.install(Path(__file__).resolve().parents[2])


def read(run):
    return spans.device_ms_per_call(run, "entry.result_copy")
