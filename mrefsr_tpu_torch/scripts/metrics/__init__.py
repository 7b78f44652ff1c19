"""The metric CLIs (port of the JAX package's ``scripts/metrics/``)."""
