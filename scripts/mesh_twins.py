#!/usr/bin/env python3
"""Write the JAX twins of the port's mesh solves to a fixture.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mesh_twins.py

Draws a 4x4x4x8 problem with numpy from seed 20 (SU(3) links by QR, one
RHS ``b`` and a 2-RHS batch ``bb``), runs the JAX package's sharded solves
on a 2x2 (``data``, ``model``) mesh of four fake CPU devices with
``verify=False`` (on jax 0.9.0 only their verification raises), mass
0.1, tol 1e-6, maxiter 500, and writes the inputs, each solve's x and
its counts to ``src/repro_torch/data/mesh_twins_4x4x4x8_seed20.npz``.
``tests/test_torch_distributed.py`` holds the port's mesh solves to
these twins; compiling the five sharded loops costs minutes of one core,
which the test suite's clock cannot pay on every run, so the twins are
computed here once and the halo operators are held to JAX live.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "data" / "mesh_twins_4x4x4x8_seed20.npz"
DIMS = (4, 4, 4, 8)                 # T, Z, Y, X
MASS, TOL, MAXITER = 0.1, 1e-6, 500
# (solve, plan fields, RHS name): the satellite list of the mesh slice
SOLVES = {"eo_cgnr_n2": (dict(nrhs=2), "bb"),
          "eo_pipecg_n2_tm": (dict(nrhs=2, solver="pipecg",
                                   operator_family="twisted-mass", mu=0.3),
                              "bb"),
          "full_cgnr": (dict(operator="full"), "b"),
          "full_pipecg": (dict(operator="full", solver="pipecg"), "b"),
          "full_mpcg": (dict(operator="full", precision="mixed"), "b")}


def su3(rng, shape):
    a = (rng.standard_normal(shape + (3, 3))
         + 1j * rng.standard_normal(shape + (3, 3)))
    q, r = np.linalg.qr(a)
    diag = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (diag / np.abs(diag))[..., None, :]
    return (q / np.linalg.det(q)[..., None, None] ** (1 / 3)).astype(
        np.complex64)


def inputs(seed: int = 20) -> dict:
    rng = np.random.default_rng(seed)
    t, z, y, x = DIMS

    def spinor(*lead):
        s = lead + (t, z, y, x, 4, 3)
        return (rng.standard_normal(s)
                + 1j * rng.standard_normal(s)).astype(np.complex64)

    return dict(u=su3(rng, (4, t, z, y, x)), b=spinor(), bb=spinor(2))


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    import jax
    from repro.compat import make_mesh
    from repro.core import plan as plan_mod

    fields = inputs()
    mesh = make_mesh((2, 2), ("data", "model"))
    arrays = dict(fields)
    meta = {"jax": jax.__version__, "mesh": "2x2", "mass": MASS, "tol": TOL,
            "maxiter": MAXITER, "plans": SOLVES, "solves": {}}
    for name, (kw, rhs) in SOLVES.items():
        t0 = time.time()
        x, st = plan_mod.solve(plan_mod.SolverPlan(mesh=mesh, **kw),
                               fields["u"], fields[rhs], MASS, tol=TOL,
                               maxiter=MAXITER, verify=False)
        arrays[f"x/{name}"] = np.asarray(x)
        meta["solves"][name] = dict(
            iterations=int(st.iterations), outer=int(st.outer_iterations),
            rhs_iterations=(None if st.rhs_iterations is None
                            else [int(v) for v in st.rhs_iterations]),
            converged=np.asarray(st.converged).tolist())
        print(f"{name}: {meta['solves'][name]} ({time.time() - t0:.1f} s)",
              flush=True)
    arrays["meta"] = np.asarray(json.dumps(meta))
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT.relative_to(ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
