"""The remaining Krylov solvers of the port against the JAX package's.

Pipelined CG, BiCGStab, block CG (with its Gram products and
pseudo-solve) and EigCG deflation (harvest, Ritz basis, Galerkin start),
each held against its JAX twin on the same numpy inputs: the 4^4 seed-7
fixture of the solver goldens (``src/repro_torch/data/
golden_4x4x4x4_seed7.npz``, bitwise the JAX package's generation), tol
1e-6.  The port runs on the CPU, its ``"kernels"`` backend through the
kernels' plain versions; JAX's ``"pallas"`` backend runs with
``interpret=False`` (its CPU lowering, ``kernels/wilson_dslash/xla.py``).

Count rules: at mass 0.1 the port's iterations equal the JAX twins';
at mass -1.7, where block CG's f32 Gram pseudo-inverse
gives 71 iterations on one JAX backend and 90 on the other, each count
lies within 2 of one twin's or between the two.  Solutions agree to 1e-5
(max-abs error over the max-abs entry).
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
from repro_torch.core.lattice import (fields_from_numpy, pack_gauge,
                                      pack_spinor)
from repro_torch.core.operators import dslash_g
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.wilson_dslash import ops as wops
from repro_torch.launch import solve as cli

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
# pipelined CG
# ---------------------------------------------------------------------------


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
# block CG's matrix algebra and solves
# ---------------------------------------------------------------------------


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
