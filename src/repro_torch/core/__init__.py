"""Lattice geometry, the Wilson operator, the operator registry, the
solvers, the even-odd plumbing and the SolverPlan entry point."""

from repro_torch.core.lattice import (LatticeShape, field_dot,
                                      field_dot_batched, field_norm2,
                                      field_norm2_batched, fields_from_numpy,
                                      merge_eo, merge_eo_gauge, pack_gauge,
                                      pack_spinor, parity_masks,
                                      random_gauge, random_spinor,
                                      resolve_device, split_eo,
                                      split_eo_gauge, unit_gauge,
                                      unpack_gauge, unpack_spinor)
from repro_torch.core.operators import dslash_dagger_g, normal_op_g
from repro_torch.core.plan import SolverPlan
from repro_torch.core.plan import solve as solve_plan
from repro_torch.core.solvers import cg_trace, cgnr, cgnr_eo

__all__ = ["LatticeShape", "SolverPlan", "cg_trace", "cgnr", "cgnr_eo",
           "dslash_dagger_g", "field_dot", "field_dot_batched",
           "field_norm2", "field_norm2_batched", "fields_from_numpy",
           "merge_eo", "merge_eo_gauge", "normal_op_g", "pack_gauge",
           "pack_spinor", "parity_masks", "random_gauge", "random_spinor",
           "resolve_device", "solve_plan", "split_eo", "split_eo_gauge",
           "unit_gauge", "unpack_gauge", "unpack_spinor"]
