"""push_ms.teps: device ms charged to the ``bsp.push`` span (the push
direction's gather, segment min and examined-edge count) per superstep that
ran a push (``bsp.supersteps.push`` + ``bsp.supersteps.mixed``), SSSP
cells."""
from pathlib import Path

from gblib import spans

# loaded before set-up, in a traced run only: record the program's spans
spans.install(Path(__file__).resolve().parents[2])


def read(run):
    return spans.device_ms_per_superstep(run, "bsp.push", "push", "mixed")
