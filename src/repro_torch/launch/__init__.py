"""Multi-process drivers of the sharded engine (the counterparts of the JAX
package's ``repro.launch`` self-tests)."""
