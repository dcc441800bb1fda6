"""Pipelined CG of the port against the JAX package's (split from
``tests/test_torch_krylov.py``, whose module docstring states the inputs
and the count rules, and whose fixture and helpers these tests share):
the plan's pipecg on both paths and backends at N = 1 and 4, its
residual replacement and its injected fused reduction.
"""

import numpy as np
import pytest
import torch

from repro.core import SolverPlan as JaxPlan
from repro.core import plan as jplan
from repro_torch.core import plan as tplan
from repro_torch.core import solvers
from repro_torch.core.lattice import pack_gauge, pack_spinor
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.wilson_dslash import ops as wops
from test_torch_krylov import MASS, TOL, TWIN, _rhs, fx, rel_err  # noqa: F401

import torch_one_thread  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("backend", ["kernels", "reference"])
@pytest.mark.parametrize("operator,n", [("eo-schur", 1), ("eo-schur", 4),
                                        ("full", 1), ("full", 4)])
def test_pipecg_matches_jax(fx, backend, operator, n):
    bt, bj = _rhs(fx, n)
    nrhs = None if n == 1 else n
    plan = tplan.SolverPlan(operator=operator, backend=backend,
                            solver="pipecg", nrhs=nrhs)
    reset_counts()
    x, st = tplan.solve(plan, fx["ut"], bt, MASS, tol=TOL, device="cpu")
    c = counts()
    xj, sj = jplan.solve(JaxPlan(operator=operator, solver="pipecg",
                                 nrhs=nrhs, **TWIN[backend]),
                         fx["u"], bj, MASS, tol=TOL, maxiter=1000)
    assert bool(torch.atleast_1d(st.verified).all())
    assert bool((torch.atleast_1d(st.verdict) == solvers.CONVERGED).all())
    assert rel_err(x, xj) <= 1e-5
    its = (st.rhs_iterations.tolist() if nrhs else [st.iterations])
    want = (np.asarray(sj.rhs_iterations).tolist() if nrhs
            else [int(sj.iterations)])
    k = st.iterations
    assert torch.atleast_1d(st.matvecs).tolist() == [k + 1 + 2 * (k // 25)] * n
    # one fused reduction an iteration: no K2/K3; K1 four a matvec plus
    # the Schur RHS and the back-substitution, K4 two a matvec plus D^dag b
    if backend == "kernels":
        mv = k + 1 + 2 * (k // 25)
        want_c = ({"wilson_hop": 4 * mv + 4} if operator == "eo-schur"
                  else {"wilson_full": 2 * mv + 1})
        got = {name: v["plain_calls"] for name, v in c.items()
               if v["plain_calls"]}
        assert got == want_c
    assert its == want


def test_pipecg_residual_replacement_and_fused_dots(fx):
    """Every 25 iterations the true residual replaces the recursive one
    (two more matvecs); 0 disables it, and the recurrences drift (the
    recursive residual converges, x does not); an injected ``fused_dots``
    is the iteration's one reduction."""
    up = pack_gauge(fx["ut"])
    op = lambda v: wops.normal_op(up, v, MASS)  # noqa: E731
    rhs = wops.dslash_dagger(up, pack_spinor(fx["bt"]), MASS)
    calls = []

    def fused(r, w):
        calls.append(1)
        return torch.stack(((r * r).sum(), (w * r).sum()))

    x, st = solvers.pipecg(op, rhs, tol=TOL, fused_dots=fused)
    assert st.iterations == 30 and int(st.matvecs) == 33
    assert len(calls) == st.iterations + 1
    x0, st0 = solvers.pipecg(op, rhs, tol=TOL, residual_replacement_every=0)
    assert int(st0.matvecs) == st0.iterations + 1
    xc, _ = solvers.cg(op, rhs, tol=TOL)
    assert rel_err(x, xc) <= 1e-5 and rel_err(x0, xc) > 1e-3
