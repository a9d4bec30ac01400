"""Data pipelines of the port (the JAX package's ``repro/data``)."""
from repro_torch.data.tokens import TokenStream
from repro_torch.data.graphs import load_workload

__all__ = ["TokenStream", "load_workload"]
