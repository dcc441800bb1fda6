"""Workload generation and committed fixtures."""

from repro_torch.data.synthetic import lattice_problem

__all__ = ["lattice_problem"]
