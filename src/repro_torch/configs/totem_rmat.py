"""The paper's own workload configs (Table 2): RMAT scale-free graphs.

RMAT parameters (A,B,C) = (0.57, 0.19, 0.19), average degree 16 — exactly
the paper's Graph500-style generator.  The paper's RMAT27–30 are reduced to
RMAT16–22 for runnable benchmarks; the full-scale entries are for
partition-shape arithmetic only.  Copied from ``repro.configs.totem_rmat``.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class GraphWorkload:
    name: str
    scale: int               # |V| = 2^scale
    edge_factor: int = 16
    kind: str = "rmat"       # rmat | uniform


# Reduced-scale stand-ins for the paper's Table 2 workloads.
RMAT_SMALL = GraphWorkload("rmat18", 18)        # benchmark default
RMAT_MEDIUM = GraphWorkload("rmat20", 20)
RMAT_LARGE = GraphWorkload("rmat22", 22)
UNIFORM_SMALL = GraphWorkload("uniform18", 18, kind="uniform")

# Full-scale (partition-shape math only; never allocated).
RMAT28 = GraphWorkload("rmat28", 28)
RMAT30 = GraphWorkload("rmat30", 30)

CONFIG = RMAT_SMALL
SMOKE_CONFIG = GraphWorkload("rmat10", 10)
