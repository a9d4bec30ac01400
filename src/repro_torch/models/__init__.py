"""Language models of the port (the JAX package's ``repro/models``)."""
