"""The public functions the port exports beside the JAX package's
``repro.core``, against their JAX twins on the same numpy inputs.

* ``unit_gauge``, ``parity_masks`` and ``merge_eo_gauge`` bitwise equal
  to JAX's;
* ``dslash_dagger_g`` and ``normal_op_g`` within 1e-5 (max-abs error
  over max(1, max |JAX|)) of JAX's on fields JAX generated, Wilson and
  twisted mass;
* ``cg_trace``'s ||r||^2 history (one RHS, and a masked batch), ``cgnr``
  and ``cgnr_eo`` within 1e-5 relative of JAX's with equal iteration
  counts on the 4^4 seed-7 fixture of the solver goldens (27 full-lattice
  iterations, 14 even-odd); ``cgnr_eo`` also on packed half fields
  through K1 and the fused CG kernels K2/K3 (their plain versions here),
  with K1 launched 4I + 4 times and K2/K3 I times each.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro.core import eo as jeo
from repro.core import lattice as jl
from repro.core import operators as jops
from repro.core import solvers as jsol
from repro_torch.core import eo as teo
from repro_torch.core import lattice as tl
from repro_torch.core import operators as tops
from repro_torch.core import solvers as tsol
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.cg_fused import ops as cg_ops

import torch_one_thread  # noqa: F401  (one intra-op thread)

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "data" / "golden_4x4x4x4_seed7.npz")
MASS, TOL = 0.1, 1e-6
EIGHT = ("unit_gauge", "parity_masks", "merge_eo_gauge", "dslash_dagger_g",
         "normal_op_g", "cg_trace", "cgnr", "cgnr_eo")


def T(a):
    return torch.from_numpy(np.array(a))


def rel_err(x, ref) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    assert x.shape == ref.shape
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def fx():
    with np.load(GOLDEN) as f:
        d = {k: f[k] for k in f.files}
    return dict(u=d["gauge"], b=d["b"], batch=d["b_batch"],
                ut=T(d["gauge"]), bt=T(d["b"]), batch_t=T(d["b_batch"]))


def test_the_eight_are_exported_under_jax_names():
    import repro.core as jcore
    for name in EIGHT:
        assert name in tcore.__all__ and callable(getattr(tcore, name))
        assert callable(getattr(jcore, name))


@pytest.mark.parametrize("dims", [(4, 4, 4, 4), (2, 4, 6, 8)],
                         ids=lambda d: "x".join(map(str, d)))
def test_lattice_functions_bitwise(dims):
    lat_j, lat_t = jl.LatticeShape(*dims), tl.LatticeShape(*dims)
    assert np.array_equal(tcore.unit_gauge(lat_t).numpy(),
                          np.asarray(jl.unit_gauge(lat_j)))
    for ours, theirs in zip(tcore.parity_masks(lat_t),
                            jl.parity_masks(lat_j)):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    u = jl.random_gauge(jax.random.PRNGKey(3), lat_j)
    u_e, u_o = jl.split_eo_gauge(u)
    merged = tcore.merge_eo_gauge(T(u_e), T(u_o))
    assert np.array_equal(merged.numpy(),
                          np.asarray(jl.merge_eo_gauge(u_e, u_o)))
    assert np.array_equal(merged.numpy(), np.asarray(u))


@pytest.mark.parametrize("twist", [0.0, 0.25], ids=["wilson", "twisted"])
def test_dagger_and_normal_op_match_jax(twist):
    lat = jl.LatticeShape(4, 4, 4, 8)
    ku, kb = jax.random.split(jax.random.PRNGKey(17))
    u = jl.random_gauge(ku, lat)
    psi = jl.random_spinor(kb, lat)
    for ours, theirs in ((tcore.dslash_dagger_g, jops.dslash_dagger_g),
                         (tcore.normal_op_g, jops.normal_op_g)):
        got = ours(T(u), T(psi), MASS, twist=twist).numpy()
        want = np.asarray(theirs(u, psi, MASS, twist=twist))
        err = np.max(np.abs(got - want))
        assert err <= 1e-5 * max(1.0, np.max(np.abs(want))), err


def test_dagger_is_the_adjoint_of_dslash_g():
    """<phi, D psi> = <D^dag phi, psi> for the twisted family."""
    gen = torch.Generator().manual_seed(5)
    lat = tl.LatticeShape(4, 4, 4, 4)
    u = tl.random_gauge(gen, lat)
    phi, psi = tl.random_spinor(gen, lat), tl.random_spinor(gen, lat)
    lhs = tl.field_dot(phi, tops.dslash_g(u, psi, MASS, twist=0.3))
    rhs = tl.field_dot(tcore.dslash_dagger_g(u, phi, MASS, twist=0.3), psi)
    assert abs(complex(lhs - rhs)) <= 1e-4 * abs(complex(lhs))


def test_cg_trace_history_matches_jax(fx):
    op_t = lambda v: tcore.normal_op_g(fx["ut"], v, MASS)  # noqa: E731
    op_j = lambda v: jops.normal_op_g(jnp.asarray(fx["u"]), v, MASS)  # noqa
    rhs_t = tops.dslash_g(fx["ut"], fx["bt"], MASS)
    rhs_j = jops.dslash_g(jnp.asarray(fx["u"]), jnp.asarray(fx["b"]), MASS)
    x, hist = tcore.cg_trace(op_t, rhs_t, iters=12)
    xj, hj = jsol.cg_trace(op_j, rhs_j, iters=12)
    assert hist.shape == (12,) and rel_err(hist, hj) <= 1e-5
    assert rel_err(x, xj) <= 1e-5
    # the history decreases as CG's does, and a single-RHS trace refuses
    # the batched mode's mask
    assert float(hist[-1]) < float(hist[0])
    with pytest.raises(ValueError, match="requires batched=True"):
        tcore.cg_trace(op_t, rhs_t, iters=2, tol=1e-3)


def test_cg_trace_batched_mask_matches_jax(fx):
    """A per-RHS (iters, N) history with the convergence mask: a system
    that reaches tol stays flat, as JAX's does."""
    batch_t = fx["batch_t"][:2]
    batch_j = jnp.asarray(fx["batch"][:2])
    op_t = lambda v: torch.stack([tcore.normal_op_g(fx["ut"], w, MASS)  # noqa
                                  for w in v])
    op_j = jax.vmap(lambda v: jops.normal_op_g(jnp.asarray(fx["u"]), v,
                                               MASS))
    x, hist = tcore.cg_trace(op_t, batch_t, iters=40, batched=True, tol=1e-3)
    xj, hj = jsol.cg_trace(op_j, batch_j, iters=40, batched=True, tol=1e-3)
    assert hist.shape == (40, 2) and rel_err(hist, hj) <= 1e-5
    assert rel_err(x, xj) <= 1e-5
    assert bool((hist[-1] == hist[-2]).all())   # both frozen by now


def test_cgnr_matches_jax_and_golden(fx):
    d_t = lambda v: tops.dslash_g(fx["ut"], v, MASS)  # noqa: E731
    dd_t = lambda v: tcore.dslash_dagger_g(fx["ut"], v, MASS)  # noqa: E731
    u = jnp.asarray(fx["u"])
    x, st = tcore.cgnr(d_t, dd_t, fx["bt"], tol=TOL, maxiter=500)
    xj, sj = jsol.cgnr(lambda v: jops.dslash_g(u, v, MASS),
                       lambda v: jops.dslash_dagger_g(u, v, MASS),
                       jnp.asarray(fx["b"]), tol=TOL, maxiter=500)
    assert st.iterations == int(sj.iterations) == 27
    assert bool(st.converged)
    assert rel_err(x, xj) <= 1e-5


def _jax_cgnr_eo(fx):
    ops = jeo.eo_operators(jnp.asarray(fx["u"]), MASS)
    b_e, b_o = jl.split_eo(jnp.asarray(fx["b"]))
    (x_e, x_o), sj = jsol.cgnr_eo(ops.dhat, ops.dhat_dag, ops.d_eo,
                                  ops.d_oe, ops.m_inv, b_e, b_o, tol=TOL,
                                  maxiter=500)
    return np.asarray(jl.merge_eo(x_e, x_o)), sj


def test_cgnr_eo_matches_jax_and_golden(fx):
    ops = teo.eo_operators(fx["ut"], MASS)
    b_e, b_o = tl.split_eo(fx["bt"])
    (x_e, x_o), st = tcore.cgnr_eo(ops.dhat, ops.dhat_dag, ops.d_eo,
                                   ops.d_oe, ops.m_inv, b_e, b_o, tol=TOL,
                                   maxiter=500)
    xj, sj = _jax_cgnr_eo(fx)
    assert st.iterations == int(sj.iterations) == 14
    assert rel_err(tl.merge_eo(x_e, x_o), xj) <= 1e-5


def test_cgnr_eo_on_packed_halves_runs_the_kernels(fx):
    """``cgnr_eo`` on packed half fields: the Schur blocks through K1,
    the vector updates through K2/K3, the loop the plan's ``cg``."""
    ops = teo.eo_operators_packed(fx["ut"], MASS)
    b_e, b_o = (tl.pack_spinor(h) for h in tl.split_eo(fx["bt"]))
    update, xpay = cg_ops.fused_engine()
    reset_counts()
    (x_e, x_o), st = tcore.cgnr_eo(ops.dhat, ops.dhat_dag, ops.d_eo,
                                   ops.d_oe, ops.m_inv, b_e, b_o, tol=TOL,
                                   maxiter=500, update=update, xpay=xpay)
    c = {k: v["plain_calls"] for k, v in counts().items() if v["plain_calls"]}
    xj, sj = _jax_cgnr_eo(fx)
    k = st.iterations
    assert k == int(sj.iterations) == 14
    assert c == {"wilson_hop": 4 * k + 4, "cg_update": k, "cg_xpay": k}
    x = tl.merge_eo(tl.unpack_spinor(x_e), tl.unpack_spinor(x_o))
    assert rel_err(x, xj) <= 1e-5
    # the same solve as the plan's even-odd CGNR, bitwise
    xp, sp = tcore.solve_plan(tcore.SolverPlan(), fx["ut"], fx["bt"], MASS,
                              tol=TOL, maxiter=500, device="cpu")
    assert sp.iterations == k and torch.equal(xp, x)
