"""Checkpoint store of the port (format 2, shared with the JAX package)."""
