"""Block CG of the port against the JAX package's (split from
``tests/test_torch_krylov.py``, whose module docstring states the inputs
and the count rules, and whose fixture and helpers these tests share):
its Gram products, column mixes and pseudo-solve, the N = 4 solves on
both paths and backends, N = 16 at mass -1.7, and its full-f32 guard.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SolverPlan as JaxPlan
from repro.core import plan as jplan
from repro.core import solvers as jsol
from repro_torch.core import plan as tplan
from repro_torch.core import solvers
from repro_torch.core.lattice import pack_spinor
from repro_torch.kernels import counts, reset_counts
from test_torch_krylov import (LIGHT, MASS, TOL, TWIN, fx,  # noqa: F401
                               near_or_between, rel_err)

import torch_one_thread  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("layout", ["packed", "natural"])
def test_gram_mix_and_psolve_match_jax(fx, layout):
    rng = np.random.default_rng(3)
    if layout == "packed":
        a = np.asarray(pack_spinor(fx["b16t"][:4]))
        b = np.asarray(pack_spinor(fx["b16t"][4:8]))
        coef = rng.standard_normal((4, 4)).astype(np.float32)
    else:
        a, b = np.asarray(fx["b16"][:4]), np.asarray(fx["b16"][4:8])
        coef = (rng.standard_normal((4, 4))
                + 1j * rng.standard_normal((4, 4))).astype(np.complex64)
    ta, tb = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))
    g = solvers.gram(ta, tb)
    gj = jsol.gram(jnp.asarray(a), jnp.asarray(b))
    assert g.dtype == torch.float32 if layout == "packed" else g.is_complex()
    assert rel_err(g, gj) <= 1e-5
    assert rel_err(solvers._mix(ta, torch.from_numpy(coef)),
                   jsol._mix(jnp.asarray(a), jnp.asarray(coef))) <= 1e-5
    # a Hermitian PSD Gram with one direction repeated: rank 3 of 4, the
    # pseudo-solve drops the null direction as JAX's does
    p = np.concatenate([a[:3], a[:1]])
    gp = solvers.gram(torch.from_numpy(p), torch.from_numpy(p))
    gpj = jsol.gram(jnp.asarray(p), jnp.asarray(p))
    rhs = np.asarray(solvers.gram(torch.from_numpy(p), tb))
    out = solvers._gram_psolve(gp, torch.from_numpy(rhs))
    outj = jsol._gram_psolve(gpj, jnp.asarray(rhs))
    assert bool(torch.isfinite(out).all())
    assert rel_err(out, outj) <= 1e-5


@pytest.mark.parametrize("backend", ["kernels", "reference"])
@pytest.mark.parametrize("operator", ["eo-schur", "full"])
def test_blockcg_n4_matches_jax(fx, backend, operator):
    plan = tplan.SolverPlan(operator=operator, backend=backend,
                            solver="blockcg", nrhs=4)
    reset_counts()
    x, st = tplan.solve(plan, fx["ut"], fx["b16t"][:4], MASS, tol=TOL,
                        device="cpu")
    c = counts()
    xj, sj = jplan.solve(JaxPlan(operator=operator, solver="blockcg", nrhs=4,
                                 **TWIN[backend]),
                         fx["u"], fx["b16"][:4], MASS, tol=TOL, maxiter=1000)
    assert st.iterations == int(sj.iterations)
    assert st.rhs_iterations.tolist() == np.asarray(
        sj.rhs_iterations).tolist()
    assert st.iterations == (14 if operator == "eo-schur" else 27)
    assert bool(st.verified.all()) and st.matvecs.tolist() == [
        st.iterations] * 4
    assert rel_err(x, xj) <= 1e-5
    if backend == "kernels":
        k = st.iterations
        got = {name: v["plain_calls"] for name, v in c.items()
               if v["plain_calls"]}
        assert got == ({"wilson_hop": 4 * k + 4} if operator == "eo-schur"
                       else {"wilson_full": 2 * k + 1})


@pytest.fixture(scope="module")
def blockcg16_twins(fx):
    """JAX's block CG on the 16-RHS batch at mass -1.7, both backends."""
    out = {}
    for name, kw in TWIN.items():
        _, sj = jplan.solve(JaxPlan(solver="blockcg", nrhs=16, **kw),
                            fx["u"], fx["b16"], LIGHT, tol=TOL, maxiter=1000)
        out[name] = (int(sj.iterations),
                     np.asarray(sj.rhs_iterations).tolist())
    return out


@pytest.mark.parametrize("backend", ["kernels", "reference"])
def test_blockcg_n16_light_mass(fx, blockcg16_twins, backend):
    x, st = tplan.solve(tplan.SolverPlan(backend=backend, solver="blockcg",
                                         nrhs=16),
                        fx["ut"], fx["b16t"], LIGHT, tol=TOL, device="cpu")
    loops = [t[0] for t in blockcg16_twins.values()]
    assert near_or_between(st.iterations, loops), (st.iterations, loops)
    for i, n in enumerate(st.rhs_iterations.tolist()):
        assert near_or_between(n, [t[1][i] for t in
                                   blockcg16_twins.values()])
    assert bool(st.verified.all())
    assert bool((st.verdict == solvers.CONVERGED).all())


def test_blockcg_requires_full_f32_products(fx):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            solvers.blockcg(lambda v: v, torch.ones(2, 3))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    with pytest.raises(ValueError, match="RHS-batch"):
        solvers.blockcg(lambda v: v, torch.ones(3))
