"""PyTorch/CUDA port of the even-odd Wilson CG solver for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package imports nothing
of it.  Module paths mirror it: ``core`` (lattice, Wilson operator,
operator registry, solvers, even-odd plumbing, SolverPlan), ``kernels``
(the hand-written CUDA kernels and their plain PyTorch versions, built
from ``csrc/`` by ``kernels.build``), ``data`` and ``launch``.
"""
