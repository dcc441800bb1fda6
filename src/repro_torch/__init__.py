"""PyTorch/CUDA port of the even-odd Wilson CG solver for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Module paths mirror it: ``core`` (lattice, Wilson operator,
operator registry, solvers, even-odd plumbing, SolverPlan), ``kernels``
(the hand-written CUDA kernels and their plain PyTorch versions, built
from ``csrc/`` by ``kernels.build``), ``data`` and ``launch``; and the
LM scaffold's serving half: ``models`` (configuration, layers,
attention blocks with KV caches, MoE, RG-LRU and RWKV-6, the
decoder-only and encoder-decoder models, the prefill / decode steps and
``convert.params_from_jax``) and ``configs`` (the ten architectures'
hyperparameters), served by ``launch.serve``; and its training half:
``optim`` (AdamW, the schedule), the train steps of ``models.steps`` on
one device or data-parallel on a mesh, ``parallel`` (the JAX package's
sharding rules and the blocks they place), trained by ``launch.train``.
"""
