"""gather_ms.bfs: device ms charged to the ``entry.result_copy`` span per
call, BFS cells."""
from pathlib import Path

from gblib import spans

# loaded before set-up, in a traced run only: record the program's spans
spans.install(Path(__file__).resolve().parents[2])


def read(run):
    return spans.device_ms_per_call(run, "entry.result_copy")
