"""Sharding rules and the shard / unshard of tensors over a mesh (the
port of the JAX package's ``repro.parallel``)."""
