"""pull_ms.teps: device ms charged to the ``bsp.pull`` span (the bottom-up
scan and the dense stage) per superstep that ran a pull
(``bsp.supersteps.pull`` + ``bsp.supersteps.mixed``), SSSP cells."""
from pathlib import Path

from gblib import spans

# loaded before set-up, in a traced run only: record the program's spans
spans.install(Path(__file__).resolve().parents[2])


def read(run):
    return spans.device_ms_per_superstep(run, "bsp.pull", "pull", "mixed")
