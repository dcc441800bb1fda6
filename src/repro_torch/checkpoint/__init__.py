"""Durable checkpoints of solves (the JAX package's on-disk format)."""
