"""Quickstart: one SolverPlan solves any registered lattice operator (the
PyTorch port's twin of examples/quickstart.py).

The whole stack is plan-driven: pick an operator FAMILY from the registry
(`wilson` or `twisted-mass`), and the same even-odd Schur CGNR — same
transport kernels, same batching, same precision machinery — solves it.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py \
        --operator twisted-mass --mu 0.25 --device cpu
"""

import argparse

import torch

from repro_torch.core import (LatticeShape, SolverPlan, random_gauge,
                              random_spinor, resolve_device, solve_plan)
from repro_torch.core.operators import dslash_g, operator_names

parser = argparse.ArgumentParser(description=__doc__)
parser.add_argument("--operator", default="wilson",
                    choices=sorted(operator_names()),
                    help="lattice operator family from the registry")
parser.add_argument("--mu", type=float, default=0.0,
                    help="twisted-mass site parameter (i*mu*gamma5 term)")
parser.add_argument("--device", default="cuda",
                    help="torch device (cuda: the card's kernels; cpu: "
                         "their plain versions)")
args = parser.parse_args()
dev = resolve_device(args.device)

# 1) a 4^3 x 8 lattice with a random SU(3) gauge field and source b
lat = LatticeShape(4, 4, 4, 8)
mass = 0.3
gen = torch.Generator(device=dev)
gen.manual_seed(0)
gauge, b = random_gauge(gen, lat), random_spinor(gen, lat)

# 2) name the solve as data: even-odd Schur CGNR on the chosen operator.
#    The family only swaps the site-local term; every transport layer
#    (hop kernels, halo exchange, batching, packing) is shared.
plan = SolverPlan(operator="eo-schur", operator_family=args.operator,
                  mu=args.mu)
x, stats = solve_plan(plan, gauge, b, mass, tol=1e-6, maxiter=1000,
                      device=dev)

residual = dslash_g(gauge, x, mass, twist=plan.twist) - b
rel = float(torch.linalg.norm(residual.ravel()) / torch.linalg.norm(b.ravel()))
print(f"{args.operator} eo-schur cgnr: {int(stats.iterations)} iterations, "
      f"true relative residual {rel:.2e}")

# 3) the paper's mixed-precision reliable-update CG composes with any
#    family: bulk iterations in bf16, true-residual corrections in f32
mp = SolverPlan(operator="eo-schur", operator_family=args.operator,
                mu=args.mu, precision="mixed")
x_mp, st_mp = solve_plan(mp, gauge, b, mass, tol=1e-6, device=dev)
res_mp = dslash_g(gauge, x_mp, mass, twist=plan.twist) - b
rel_mp = float(torch.linalg.norm(res_mp.ravel()) /
               torch.linalg.norm(b.ravel()))
print(f"{args.operator} eo-schur mpcg: {int(st_mp.iterations)} bf16 inner "
      f"iterations, {int(st_mp.outer_iterations)} f32 reliable updates, "
      f"true relative residual {rel_mp:.2e}")
assert rel < 1e-5 and rel_mp < 1e-5
