"""Workload generation and committed fixtures."""

from repro_torch.data.synthetic import SyntheticLM, lattice_problem

__all__ = ["SyntheticLM", "lattice_problem"]
