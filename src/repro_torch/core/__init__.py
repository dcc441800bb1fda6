"""Lattice geometry, the Wilson operator, the operator registry, the
solvers, the even-odd plumbing and the SolverPlan entry point."""

from repro_torch.core.lattice import (LatticeShape, field_dot,
                                      field_dot_batched, field_norm2,
                                      field_norm2_batched, fields_from_numpy,
                                      merge_eo, pack_gauge, pack_spinor,
                                      random_gauge, random_spinor,
                                      resolve_device, split_eo,
                                      split_eo_gauge, unpack_gauge,
                                      unpack_spinor)
from repro_torch.core.plan import SolverPlan
from repro_torch.core.plan import solve as solve_plan

__all__ = ["LatticeShape", "SolverPlan", "field_dot", "field_dot_batched",
           "field_norm2", "field_norm2_batched", "fields_from_numpy",
           "merge_eo", "pack_gauge", "pack_spinor", "random_gauge",
           "random_spinor", "resolve_device", "solve_plan", "split_eo",
           "split_eo_gauge", "unpack_gauge", "unpack_spinor"]
