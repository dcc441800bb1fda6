"""The remaining Krylov solvers of the port against the JAX package's.

Pipelined CG (``tests/test_torch_krylov_pipecg.py``), BiCGStab, block CG
with its Gram products and pseudo-solve
(``tests/test_torch_krylov_blockcg.py``) and EigCG deflation (harvest,
Ritz basis, Galerkin start), each held against its JAX twin on the
same numpy inputs: the 4^4 seed-7 fixture of the solver goldens
(``src/repro_torch/data/golden_4x4x4x4_seed7.npz``, bitwise the JAX
package's generation), tol 1e-6.  The port runs on the CPU, its ``"kernels"`` backend through the
kernels' plain versions; JAX's ``"pallas"`` backend runs with
``interpret=False`` (its CPU lowering, ``kernels/wilson_dslash/xla.py``).

Count rules: at mass 0.1 the port's iterations equal the JAX twins';
at mass -1.7, where block CG's f32 Gram pseudo-inverse
gives 71 iterations on one JAX backend and 90 on the other, each count
lies within 2 of one twin's or between the two.  Solutions agree to 1e-5
(max-abs error over the max-abs entry).  This file holds the fixture and
the helpers the other two import.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SolverPlan as JaxPlan
from repro.core import plan as jplan
from repro.core import solvers as jsol
from repro.core.eo import schur_rhs as jax_schur_rhs
from repro.core.operators import dslash_g as jax_dslash_g
from repro_torch.core import plan as tplan
from repro_torch.core import solvers
from repro_torch.core.eo import schur_rhs
from repro_torch.core.lattice import fields_from_numpy
from repro_torch.core.operators import dslash_g
from repro_torch.kernels import counts, reset_counts
from repro_torch.launch import solve as cli

import torch_one_thread  # noqa: F401  (one intra-op thread)

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "data" / "golden_4x4x4x4_seed7.npz")
TOL = 1e-6
MASS, LIGHT = 0.1, -1.7
# port backend -> its JAX twin's
TWIN = {"kernels": dict(backend="pallas", interpret=False),
        "reference": dict(backend="reference")}


@pytest.fixture(scope="module")
def fx():
    with np.load(GOLDEN) as f:
        d = {k: f[k] for k in f.files}
    ut, bt = fields_from_numpy(d["gauge"], d["b"], device="cpu")
    _, b16t = fields_from_numpy(d["gauge"], d["b_batch16"], device="cpu")
    return dict(u=jnp.asarray(d["gauge"]), b=jnp.asarray(d["b"]),
                b16=jnp.asarray(d["b_batch16"]), ut=ut, bt=bt, b16t=b16t)


def rel_err(x, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref)))


def near_or_between(n: int, twins) -> bool:
    """Within 2 of one twin's count, or between the two twins' counts."""
    return (min(twins) <= n <= max(twins)
            or any(abs(n - t) <= 2 for t in twins))


def _rhs(fx, n):
    return (fx["bt"], fx["b"]) if n == 1 else (fx["b16t"][:n], fx["b16"][:n])


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def test_bicgstab_matches_jax(fx):
    x, st = solvers.bicgstab(lambda v: dslash_g(fx["ut"], v, MASS), fx["bt"],
                             tol=TOL, maxiter=500)
    xj, sj = jsol.bicgstab(lambda v: jax_dslash_g(fx["u"], v, MASS), fx["b"],
                           tol=TOL, maxiter=500)
    assert int(st.verdict) == solvers.CONVERGED and bool(st.converged)
    assert st.iterations == int(sj.iterations)
    assert int(st.matvecs) == 2 * st.iterations
    assert rel_err(x, xj) <= 1e-5
    res = dslash_g(fx["ut"], x, MASS) - fx["bt"]
    assert float(res.norm() / fx["bt"].norm()) < 10 * TOL


# ---------------------------------------------------------------------------
# EigCG deflation
# ---------------------------------------------------------------------------


def test_cg_harvest_is_cg(fx):
    ctx = tplan.resolve(tplan.SolverPlan(), fx["ut"], LIGHT)
    a_hat = lambda v: ctx.ops.dhat_dag(ctx.ops.dhat(v))  # noqa: E731
    rhs = schur_rhs(ctx.ops, *ctx.prepare(fx["bt"]))
    x, st = solvers.cg(a_hat, rhs, tol=1e-8, maxiter=1000)
    xh, sh, (v, al, be) = solvers.cg_harvest(a_hat, rhs, tol=1e-8,
                                             maxiter=1000, m_max=40)
    assert torch.equal(x, xh) and sh.iterations == st.iterations > 40
    assert int(sh.matvecs) == st.iterations
    assert v.shape == (40,) + tuple(rhs.shape)
    norms = torch.stack([(w * w).sum() for w in v])
    assert torch.allclose(norms, torch.ones(40), atol=1e-5)
    assert bool((al > 0).all() and (be > 0).all())


@pytest.fixture(scope="module")
def jax_harvest(fx):
    """JAX's harvest records on the packed Schur operator (pallas twin) at
    mass -1.7: the same numpy inputs for the port's Ritz step."""
    plan = JaxPlan(backend="pallas", interpret=False)
    ctx = jplan.resolve(plan, fx["u"], LIGHT)
    a_hat = lambda v: ctx.ops.dhat_dag(ctx.ops.dhat(v))  # noqa: E731
    b_e, b_o = ctx.prepare(fx["b16"][0])
    rhs = jax_schur_rhs(ctx.ops, b_e, b_o)
    _, st, rec = jsol.cg_harvest(a_hat, rhs, tol=1e-8, maxiter=1000,
                                 m_max=160)
    k = int(st.iterations)
    basis = jsol.ritz_deflation_basis(a_hat, *rec, k, 16)
    return dict(a_hat=a_hat, k=k, rec=[np.array(r) for r in rec],
                basis=basis, ctx=ctx)


def test_ritz_basis_matches_jax(fx, jax_harvest):
    ctx = tplan.resolve(tplan.SolverPlan(), fx["ut"], LIGHT)
    a_hat = lambda v: ctx.ops.dhat_dag(ctx.ops.dhat(v))  # noqa: E731
    v, al, be = (torch.from_numpy(r) for r in jax_harvest["rec"])
    basis = solvers.ritz_deflation_basis(a_hat, v, al, be, jax_harvest["k"],
                                         16)
    jb = jax_harvest["basis"]
    assert basis.nev == 16 and basis.gram.shape == (16, 16)
    ritz = torch.linalg.eigvalsh(basis.gram.double())
    ritz_j = np.linalg.eigvalsh(np.asarray(jb.gram, np.float64))
    assert np.max(np.abs(ritz.numpy() - ritz_j) / np.abs(ritz_j)) <= 1e-4
    w, wj = basis.w.double().reshape(16, -1), torch.from_numpy(
        np.asarray(jb.w, np.float64)).reshape(16, -1)
    cos = (w * wj).sum(1).abs() / (w.norm(dim=1) * wj.norm(dim=1))
    assert float(cos.min()) >= 1 - 1e-4, cos
    # a harvest shorter than nev pads with inert slots
    small = solvers.ritz_deflation_basis(a_hat, v, al, be, 3, 5)
    assert small.nev == 5 and torch.equal(small.w[3:],
                                          torch.zeros_like(small.w[3:]))
    assert torch.equal(small.gram[3:, 3:], torch.eye(2))
    with pytest.raises(ValueError, match="empty"):
        solvers.ritz_deflation_basis(a_hat, v, al, be, 0, 4)


def test_deflate_x0_with_a_jax_basis(fx, jax_harvest):
    jb = jax_harvest["basis"]
    basis = solvers.deflation_basis_from_numpy(np.asarray(jb.w),
                                               np.asarray(jb.gram),
                                               device="cpu")
    ctx = jax_harvest["ctx"]
    rhs_j = jnp.stack([jax_schur_rhs(ctx.ops, *ctx.prepare(fx["b16"][i]))
                       for i in (1, 2)])
    x0j = jsol.deflate_x0(jb, rhs_j)
    rhs = torch.from_numpy(np.array(rhs_j))
    assert rel_err(solvers.deflate_x0(basis, rhs), x0j) <= 1e-5
    assert rel_err(solvers.deflate_x0(basis, rhs[0]), x0j[0]) <= 1e-5
    padded = torch.stack([rhs[0], torch.zeros_like(rhs[0])])
    x0 = solvers.deflate_x0(basis, padded)
    assert torch.equal(x0[1], torch.zeros_like(x0[1]))
    # the carried-across basis drives the port's deflated solve
    _, st = tplan.solve(tplan.SolverPlan(), fx["ut"], fx["b16t"][1], LIGHT,
                        tol=TOL, deflation=basis, device="cpu")
    assert bool(st.verified) and int(st.matvecs) == st.iterations + 1


@pytest.fixture(scope="module")
def light_twins(fx):
    """JAX's light-mass harvest (batch[0], tol 1e-8, nev 32, m_max 160),
    then batch[1] solved cold and deflated, on both backends."""
    out = {}
    for name, kw in TWIN.items():
        plan = JaxPlan(**kw)
        _, sh, basis = jplan.harvest_deflation(
            plan, fx["u"], fx["b16"][0], LIGHT, tol=1e-8, maxiter=1000,
            nev=32, m_max=160, verify_tol=TOL)
        _, s0 = jplan.solve(plan, fx["u"], fx["b16"][1], LIGHT, tol=TOL,
                            maxiter=1000)
        _, s1 = jplan.solve(plan, fx["u"], fx["b16"][1], LIGHT, tol=TOL,
                            maxiter=1000, deflation=basis)
        out[name] = dict(harvest=(int(sh.iterations), int(sh.matvecs)),
                         cold=int(s0.iterations),
                         deflated=(int(s1.iterations), int(s1.matvecs)))
    return out


@pytest.mark.parametrize("backend", ["kernels", "reference"])
def test_harvest_and_deflated_solve_light_mass(fx, light_twins, backend):
    plan = tplan.SolverPlan(backend=backend)
    reset_counts()
    _, sh, basis = tplan.harvest_deflation(
        plan, fx["ut"], fx["b16t"][0], LIGHT, tol=1e-8, nev=32, m_max=160,
        verify_tol=TOL, device="cpu")
    c = counts()
    tw = light_twins.values()
    assert bool(sh.verified) and int(sh.verdict) == solvers.CONVERGED
    assert near_or_between(sh.iterations, [t["harvest"][0] for t in tw])
    assert int(sh.matvecs) == sh.iterations + 32
    assert basis.nev == 32 and basis.gram.shape == (32, 32)
    if backend == "kernels":   # the harvest runs plain vector algebra
        assert {k: v["plain_calls"] for k, v in c.items()
                if v["plain_calls"]} == {"wilson_hop": 4 * int(sh.matvecs)
                                         + 4}
    _, s0 = tplan.solve(plan, fx["ut"], fx["b16t"][1], LIGHT, tol=TOL,
                        device="cpu")
    assert near_or_between(s0.iterations, [t["cold"] for t in tw])
    reset_counts()
    _, s1 = tplan.solve(plan, fx["ut"], fx["b16t"][1], LIGHT, tol=TOL,
                        deflation=basis, device="cpu")
    c = counts()
    assert bool(s1.verified) and int(s1.matvecs) == s1.iterations + 1
    assert near_or_between(s1.iterations, [t["deflated"][0] for t in tw])
    if backend == "kernels":   # one more matvec: r0 = b - A x0
        assert c["wilson_hop"]["plain_calls"] == 4 * s1.iterations + 8
        assert c["cg_update"]["plain_calls"] == s1.iterations


# ---------------------------------------------------------------------------
# the plan's guards and the CLI
# ---------------------------------------------------------------------------


def _message(fn):
    with pytest.raises((NotImplementedError, ValueError)) as e:
        fn()
    return str(e.value)


def test_plan_guards_raise_as_jax_does(fx):
    basis = solvers.DeflationBasis(w=torch.zeros(2, 8),
                                   gram=torch.eye(2))
    jbasis = jsol.DeflationBasis(w=jnp.zeros((2, 8)), gram=jnp.eye(2))
    for kw in (dict(solver="pipecg"), dict(precision="mixed")):
        port = _message(lambda: tplan.solve(
            tplan.SolverPlan(**kw), fx["ut"], fx["bt"], MASS,
            deflation=basis, device="cpu"))
        jax_ = _message(lambda: jplan.solve(JaxPlan(**kw), fx["u"], fx["b"],
                                            MASS, deflation=jbasis))
        assert port == jax_ and "deflation composes" in port
    assert "checkpoint=set" in _message(lambda: tplan.solve(
        tplan.SolverPlan(), fx["ut"], fx["bt"], MASS, deflation=basis,
        checkpoint=object(), device="cpu"))
    for kw, b_t, b_j in ((dict(nrhs=2), fx["b16t"][:2], fx["b16"][:2]),
                         (dict(operator="full"), fx["bt"], fx["b"])):
        port = _message(lambda: tplan.harvest_deflation(
            tplan.SolverPlan(**kw), fx["ut"], b_t, MASS, device="cpu"))
        jax_ = _message(lambda: jplan.harvest_deflation(
            JaxPlan(**kw), fx["u"], b_j, MASS))
        assert port == jax_ and "harvest_deflation needs" in port
    assert _message(lambda: tplan.SolverPlan(solver="blockcg")) == \
        _message(lambda: JaxPlan(solver="blockcg"))
    for kw in (dict(solver="pipecg", precision="mixed"),
               dict(solver="blockcg", nrhs=2, precision="low",
                    operator="full")):
        assert "precision='single' only" in _message(
            lambda: tplan.SolverPlan(**kw))


def test_cache_key_names_every_field():
    a = tplan.SolverPlan(solver="blockcg", nrhs=4)
    assert a.cache_key() == tplan.SolverPlan(solver="blockcg",
                                             nrhs=4).cache_key()
    hash(a.cache_key())
    for change in (dict(nrhs=2), dict(backend="reference"),
                   dict(operator_family="twisted-mass", mu=0.25),
                   dict(solver="cgnr")):
        assert dataclasses.replace(a, **change).cache_key() != a.cache_key()


@pytest.mark.parametrize("extra", [
    ["--parity", "eo", "--solver", "pipecg"],
    ["--solver", "pipecg", "--nrhs", "2"],
    ["--parity", "eo", "--solver", "blockcg", "--nrhs", "2"],
    ["--parity", "eo", "--solver", "cgnr", "--deflate", "4"],
    ["--parity", "eo", "--solver", "blockcg", "--nrhs", "2", "--deflate",
     "4"]])
def test_cli_runs_the_new_solvers(capsys, extra):
    assert cli.main(["--lattice", "4x4x4x4", "--device", "cpu", "--mass",
                     "0.1", *extra]) == 0
    out = capsys.readouterr().out
    assert "verdict" in out and "FAIL" not in out
    if "--deflate" in extra:
        assert "deflation harvest: nev=4" in out


def test_cli_refuses_deflation_outside_its_paths(capsys):
    args = ["--lattice", "4x4x4x4", "--device", "cpu", "--mass", "0.1"]
    assert cli.main(args + ["--deflate", "4"]) == 1   # full mixed: refused
    assert "harvest_deflation needs" in capsys.readouterr().out
    assert cli.main(args + ["--parity", "eo", "--solver", "pipecg",
                            "--deflate", "4"]) == 1
    assert "deflation composes" in capsys.readouterr().out
    assert cli.main(args + ["--solver", "blockcg"]) == 1
    assert "set nrhs" in capsys.readouterr().out
