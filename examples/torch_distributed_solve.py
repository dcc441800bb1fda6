"""Distributed lattice solve: 4D domain decomposition + halo exchange over
a (pod, data, model) mesh, with the pipelined single-reduction CG (the
PyTorch port's twin of examples/distributed_solve.py).

    torchrun --nproc-per-node 8 examples/torch_distributed_solve.py
    torchrun --nproc-per-node 2 examples/torch_distributed_solve.py \
        --mesh 1x1x2 --device cpu

Each rank of the ``torchrun`` job is one device of the mesh: NCCL with a
card a rank, else gloo (CPU ranks, or ranks sharing card 0).
"""

import argparse
import sys

import torch

from repro_torch.core import LatticeShape
from repro_torch.core import distributed as dist
from repro_torch.core.wilson import dslash_packed
from repro_torch.data import lattice_problem
from repro_torch.launch.mesh import make_debug_mesh


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mesh", default="2x2x2",
                    help="(pod, data, model) sizes; their product is the "
                         "torchrun job's size")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cpu)")
    args = ap.parse_args(argv)
    shape = tuple(int(n) for n in args.mesh.split("x"))
    mesh = make_debug_mesh(shape, ("pod", "data", "model"),
                           device=args.device)
    lead = mesh.rank == 0
    if lead:
        print(f"[dist] ranks={mesh.world_size} mesh={mesh.shape} "
              f"transport={mesh.transport}")

    lat = LatticeShape(8, 8, 8, 8)
    gauge, b = lattice_problem(lat, mass=0.2, seed=0, device=mesh.device)
    if lead:
        print(f"[dist] lattice {lat} decomposed T->data Z->model Y->pod")

    for solver in ("pipecg", "mpcg"):
        x, st = dist.solve_wilson(mesh, gauge, b, 0.2, solver=solver,
                                  tol=1e-6, maxiter=1000)
        r = dslash_packed(gauge, x, 0.2) - b
        rel = float(torch.linalg.norm(r.ravel()) / torch.linalg.norm(
            b.ravel()))
        if lead:
            print(f"[dist] {solver}: iters={int(st.iterations)} "
                  f"outer={int(st.outer_iterations)} rel_res={rel:.2e}")
        assert rel < 1e-5
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
