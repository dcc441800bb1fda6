"""The whole slice: the port's ``plan.solve`` against the JAX package's.

The 4^4, seed-7, mass-0.1, tol-1e-6 problem of the JAX package's solver
goldens (fields from ``repro.core.random_gauge``/``random_spinor`` with
``PRNGKey(7)``, batch RHS ``n`` from ``fold_in(kb, n)``), solved by the
port's "kernels" backend on the CPU (so through the kernels' plain
versions) and by the JAX package.  Goldens: 14 iterations for Wilson, 13
for twisted mass at mu = 0.25, 14 for every RHS of batches of 1, 4, 8 and
16.  x agrees with the JAX solution to 1e-4 relative (max-abs error over
max-abs entry); every RHS of a batch equals its own single solve bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LatticeShape, random_gauge, random_spinor
from repro.core import SolverPlan as JaxPlan
from repro.core import solve_plan as jax_solve
from repro_torch.core import eo, solvers
from repro_torch.core import plan as tplan
from repro_torch.core.lattice import fields_from_numpy
from repro_torch.kernels import counts, reset_counts
from repro_torch.launch import solve as cli

import torch_one_thread  # noqa: F401  (one intra-op thread)

MASS, TOL = 0.1, 1e-6


@pytest.fixture(scope="module")
def problem():
    lat = LatticeShape(4, 4, 4, 4)
    ku, kb = jax.random.split(jax.random.PRNGKey(7))
    u, b = random_gauge(ku, lat), random_spinor(kb, lat)
    batch = jnp.stack([random_spinor(jax.random.fold_in(kb, i), lat)
                       for i in range(16)])
    ut, bt = fields_from_numpy(np.asarray(u), np.asarray(b), device="cpu")
    _, batch_t = fields_from_numpy(np.asarray(u), np.asarray(batch),
                                   device="cpu")
    return dict(u=u, b=b, batch=batch, ut=ut, bt=bt, batch_t=batch_t)


def close(x, ref, tol=1e-4):
    ref = np.asarray(ref)
    err = np.max(np.abs(x.numpy() - ref))
    assert err <= tol * np.max(np.abs(ref)), err


def _port(problem, b, **plan_kw):
    plan = tplan.SolverPlan(**plan_kw)
    return tplan.solve(plan, problem["ut"], b, MASS, tol=TOL, maxiter=1000,
                       device="cpu")


@pytest.mark.parametrize("family,mu,golden", [("wilson", 0.0, 14),
                                              ("twisted-mass", 0.25, 13)])
def test_single_rhs_matches_jax_and_goldens(problem, family, mu, golden):
    reset_counts()
    x, st = _port(problem, problem["bt"], operator_family=family, mu=mu)
    k = st.iterations
    assert k == golden
    assert int(st.verdict) == solvers.CONVERGED and bool(st.verified)
    assert int(st.matvecs) == k
    # the launch accounting the chip run asserts, on the plain versions
    c = counts()
    assert c["wilson_hop"]["plain_calls"] == 4 * k + 4
    assert c["cg_update"]["plain_calls"] == k
    assert c["cg_xpay"]["plain_calls"] == k
    assert all(v["launches"] == 0 for v in c.values())
    xj, sj = jax_solve(JaxPlan(operator="eo-schur", operator_family=family,
                               mu=mu, backend="reference"),
                       problem["u"], problem["b"], MASS, tol=TOL,
                       maxiter=1000)
    assert int(sj.iterations) == golden
    close(x, xj)
    xr, sr = _port(problem, problem["bt"], operator_family=family, mu=mu,
                   backend="reference")
    assert sr.iterations == golden
    close(xr, xj)


def test_batch_sweep_matches_jax_and_singles(problem):
    x16, st16 = _port(problem, problem["batch_t"], nrhs=16)
    assert st16.rhs_iterations.tolist() == [14] * 16
    assert st16.iterations == 14 and bool(st16.verified.all())
    xj, sj = jax_solve(JaxPlan(operator="eo-schur", backend="reference",
                               nrhs=16), problem["u"], problem["batch"],
                       MASS, tol=TOL, maxiter=1000)
    assert np.asarray(sj.rhs_iterations).tolist() == [14] * 16
    close(x16, xj)
    for n in (1, 4, 8):
        xn, stn = _port(problem, problem["batch_t"][:n], nrhs=n)
        assert stn.rhs_iterations.tolist() == [14] * n
        assert torch.equal(xn, x16[:n])
    for i in (0, 15):
        xi, sti = _port(problem, problem["batch_t"][i])
        assert sti.iterations == 14
        assert torch.equal(xi, x16[i])


def test_reference_backend_batch_equals_singles(problem):
    xb, stb = _port(problem, problem["batch_t"][:2], nrhs=2,
                    backend="reference")
    assert stb.rhs_iterations.tolist() == [14, 14]
    for i in range(2):
        xi, _ = _port(problem, problem["batch_t"][i], backend="reference")
        assert torch.equal(xi, xb[i])


def test_forwarders_and_per_rhs_tolerance(problem):
    x, st = eo.solve_wilson_eo(problem["ut"], problem["bt"], MASS, tol=TOL,
                               device="cpu")
    assert st.iterations == 14
    xb, stb = eo.solve_wilson_eo_batched(problem["ut"],
                                         problem["batch_t"][:2], MASS,
                                         tol=TOL, device="cpu")
    assert stb.rhs_iterations.tolist() == [14, 14]
    # per-RHS tolerances in one masked loop: the loose RHS freezes early
    plan = tplan.SolverPlan(nrhs=2)
    _, stv = tplan.solve(plan, problem["ut"], problem["batch_t"][:2], MASS,
                         tol=torch.tensor([1e-2, 1e-6]), device="cpu")
    it = stv.rhs_iterations.tolist()
    assert it[1] == 14 and it[0] < it[1]
    with pytest.raises(ValueError, match="scalar"):
        tplan.solve(tplan.SolverPlan(), problem["ut"], problem["bt"], MASS,
                    tol=torch.tensor([1e-2, 1e-6]), device="cpu")


def test_maxiter_verdict(problem):
    _, st3 = tplan.solve(tplan.SolverPlan(), problem["ut"], problem["bt"],
                         MASS, tol=TOL, maxiter=3, device="cpu")
    assert st3.iterations == 3
    assert solvers.verdict_name(st3.verdict) == "maxiter_exhausted"
    assert not bool(st3.verified)


@pytest.mark.parametrize("field,value,item", [
    ("solver", "pipecg", "item 9"), ("solver", "blockcg", "item 9"),
    ("mesh", object(), "item 12")])
def test_plan_fields_outside_the_slice_raise(problem, field, value, item):
    """The plan fields of the later slices are ported: the item-9 solvers
    build and solve (their counts are held against JAX in
    test_torch_krylov.py); the item-12 mesh takes a
    ``repro_torch.core.distributed.Mesh`` and refuses anything else (mesh
    solves are held against JAX in test_torch_distributed.py)."""
    if item == "item 9":
        nrhs = 2 if value == "blockcg" else None
        x, st = _port(problem, problem["batch_t"][:2] if nrhs
                      else problem["bt"], **{field: value}, nrhs=nrhs)
        assert bool(torch.atleast_1d(st.verified).all())
        assert st.iterations == 14
        return
    with pytest.raises(TypeError, match="Mesh"):
        tplan.SolverPlan(**{field: value})


@pytest.mark.parametrize("precision,operator,golden", [
    ("mixed", "eo-schur", 15), ("low", "full", 27)])
def test_mixed_and_low_plans_solve(problem, precision, operator, golden):
    """The plans that raised before mixed precision was ported now solve
    (the counts and contracts are held against JAX in test_torch_mixed.py):
    mixed converges and verifies, low (cg16) converges in bf16 and is
    unverified by design."""
    x, st = _port(problem, problem["bt"], precision=precision,
                  operator=operator)
    assert st.iterations == golden
    assert int(st.verdict) == solvers.CONVERGED
    assert bool(st.verified) == (precision == "mixed")
    assert x.dtype == torch.complex64 and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("kw,item", [(dict(checkpoint="policy"), "item 10"),
                                     (dict(deflation="harvested"), "item 9")])
def test_solve_options_outside_the_slice_raise(problem, kw, item, tmp_path):
    """The options of later slices, ported since: ``deflation`` takes a
    harvested basis (one more matvec, verified); ``checkpoint`` takes a
    CheckpointPolicy and solves in segments, bitwise the one-shot solve
    (held against JAX in test_torch_durability.py)."""
    if item == "item 9":
        _, _, basis = tplan.harvest_deflation(
            tplan.SolverPlan(), problem["ut"], problem["batch_t"][0], MASS,
            tol=1e-8, nev=4, verify_tol=TOL, device="cpu")
        _, st = tplan.solve(tplan.SolverPlan(), problem["ut"], problem["bt"],
                            MASS, tol=TOL, deflation=basis, device="cpu")
        assert bool(st.verified) and int(st.matvecs) == st.iterations + 1
        return
    policy = tplan.CheckpointPolicy(dir=str(tmp_path), every_iters=5)
    x, st = tplan.solve(tplan.SolverPlan(), problem["ut"], problem["bt"],
                        MASS, tol=TOL, device="cpu", checkpoint=policy)
    x1, st1 = tplan.solve(tplan.SolverPlan(), problem["ut"], problem["bt"],
                          MASS, tol=TOL, device="cpu")
    assert bool(st.verified) and st.iterations == st1.iterations
    assert torch.equal(x, x1)
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        f"step_{st.iterations - st.iterations % 5:08d}",
        f"step_{st.iterations:08d}"]


def test_plan_validation(problem):
    with pytest.raises(ValueError, match="did you mean 'kernels'"):
        tplan.SolverPlan(backend="kernel")
    with pytest.raises(ValueError, match="no site parameter 'mu'"):
        tplan.SolverPlan(mu=0.3)
    with pytest.raises(ValueError, match="nrhs"):
        tplan.SolverPlan(nrhs=0)
    with pytest.raises(ValueError, match="rank-7"):
        tplan.solve(tplan.SolverPlan(nrhs=2), problem["ut"], problem["bt"],
                    MASS, device="cpu")
    with pytest.raises(NotImplementedError, match="r=1"):
        tplan.solve(dataclasses.replace(tplan.SolverPlan(), r=0.5),
                    problem["ut"], problem["bt"], MASS, device="cpu")


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--lattice", "4x4x4x4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.solve(tplan.SolverPlan(), np.zeros((4, 2, 2, 2, 2, 3, 3)),
                    np.zeros((2, 2, 2, 2, 4, 3)), MASS)


def test_cli_on_cpu(capsys):
    eo_f32 = ["--parity", "eo", "--solver", "cgnr"]
    assert cli.main(["--lattice", "4x4x4x4", "--nrhs", "2", "--device",
                     "cpu", "--mass", "0.1", *eo_f32]) == 0
    out = capsys.readouterr().out
    assert "per-RHS iterations" in out and "verdict" in out
    assert "operator=eo-schur" in out and "precision=single" in out
    assert cli.main(["--lattice", "4x4x4x4", "--device", "cpu",
                     "--operator", "twisted-mass", "--mu", "0.25",
                     "--backend", "reference", *eo_f32]) == 0
    assert "verdict: converged verified=True" in capsys.readouterr().out
