"""LM substrate of the port: configuration, layers, blocks, the
decoder-only and encoder-decoder models, serving steps and the weight
converter from the JAX package's parameter pytree (``convert``)."""
