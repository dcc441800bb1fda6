"""Durable checkpoints of solves and train states (the JAX package's
on-disk format)."""
