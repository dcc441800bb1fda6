"""Port vs JAX: the full-lattice slice (the full-lattice kernel K4 and the
``operator="full"`` solve).

* ``core.wilson``'s full-lattice functions (natural dagger and normal
  operator, the packed split/merge, ``hop_term_packed``,
  ``dslash_packed`` and its dagger and normal operator) against
  ``repro.core.wilson`` at 4^4 and 4x6x8x16.
* ``ops.dslash`` against the JAX package's jnp oracle
  (``ops.dslash(use_pallas=False)``) for every (gamma5_in, gamma5_out,
  twist) at N = 1 and N = 3, and against the JAX Pallas kernel
  interpreted in three launches that together set each flag on and off
  and cover N = 3 (an interpreted launch costs seconds here).
* K4's arithmetic, emulated here with its compile-time spin structure
  (``hop_spec``), its site coefficients and its neighbour index
  arithmetic (this machine cannot run it), against its plain version for
  every flag combination.
* ``normal_op`` is two kernel calls for any N.
* ``plan.solve(SolverPlan(operator="full"))`` on the 4^4, seed-7,
  mass-0.1, tol-1e-6 problem of the JAX solver goldens: 27 iterations
  for Wilson, twisted mass at mu = 0.25 and each RHS of a 4-RHS batch,
  as the JAX reference backend takes; x agrees with JAX to 1e-4
  relative; a batch equals its own single solves bitwise; the packed
  layout agrees with the natural one.

Tolerance on fields: max-abs error <= 1e-5 times max(1, max |reference|),
the slack of f32 sums taken in another order (entries of the normal
operator reach ~70, where one f32 ulp is ~8e-6).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SolverPlan as JaxPlan
from repro.core import lattice as jl
from repro.core import solve_plan as jax_solve
from repro.core import wilson as jw
from repro.kernels.wilson_dslash import ops as jops
from repro_torch.core import plan as tplan
from repro_torch.core import solvers
from repro_torch.core import wilson as tw
from repro_torch.core.lattice import fields_from_numpy, pack_gauge, pack_spinor
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.wilson_dslash import kernel as tk
from repro_torch.kernels.wilson_dslash import ops as tops
from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
from repro_torch.launch import solve as cli

MASS, TOL = 0.1, 1e-6
SHAPES = [jl.LatticeShape(4, 4, 4, 4), jl.LatticeShape(4, 6, 8, 16)]
# (gamma5_in, gamma5_out, twist): twist != 0 with both flags is the dagger
FLAGS = list(itertools.product((False, True), (False, True), (0.0, 0.25)))


def T(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, tol=1e-5):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.max(np.abs(ours - ref))
    assert err <= tol * max(1.0, np.max(np.abs(ref))), err


@pytest.fixture(scope="module", params=SHAPES, ids=str)
def fields(request):
    lat = request.param
    ku, kb = jax.random.split(jax.random.PRNGKey(51))
    u = jl.random_gauge(ku, lat)
    b = jnp.stack([jl.random_spinor(jax.random.fold_in(kb, i), lat)
                   for i in range(3)])
    return dict(u=np.asarray(u), b=np.asarray(b[0]),
                up=np.asarray(jl.pack_gauge(u)),
                pp=np.asarray(jl.pack_spinor(b)))


# ---------------------------------------------------------------------------
# core.wilson: the full-lattice oracles
# ---------------------------------------------------------------------------


def test_natural_dagger_and_normal_op_match_jax(fields):
    u, b = fields["u"], fields["b"]
    close(tw.dslash_dagger(T(u), T(b), MASS), jw.dslash_dagger(u, b, MASS))
    close(tw.normal_op(T(u), T(b), MASS), jw.normal_op(u, b, MASS))


def test_packed_split_and_merge_match_jax(fields):
    pp, up = fields["pp"][0], fields["up"]
    for ours, ref in zip(tw._split_packed_spinor(T(pp)),
                         jw._split_packed_spinor(pp)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for ours, ref in zip(tw._split_packed_gauge(T(up)),
                         jw._split_packed_gauge(up)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    re, im = tw._split_packed_spinor(T(pp))
    np.testing.assert_array_equal(tw._merge_packed_spinor(re, im).numpy(),
                                  pp)


@pytest.mark.parametrize("mu", range(4))
@pytest.mark.parametrize("forward", [True, False])
def test_hop_term_packed_matches_jax(fields, mu, forward):
    up, pp = fields["up"], fields["pp"][0]
    close(tw.hop_term_packed(T(up[mu]), T(pp), mu, forward),
          jw.hop_term_packed(up[mu], pp, mu, forward))


def test_dslash_packed_family_matches_jax(fields):
    up, pp, u, b = fields["up"], fields["pp"][0], fields["u"], fields["b"]
    close(tw.dslash_packed(T(up), T(pp), MASS),
          jw.dslash_packed(up, pp, MASS))
    close(tw.dslash_dagger_packed(T(up), T(pp), MASS),
          jw.dslash_dagger_packed(up, pp, MASS))
    close(tw.normal_op_packed(T(up), T(pp), MASS),
          jw.normal_op_packed(up, pp, MASS))
    # the packed operator is the natural one on the wire format
    close(tw.dslash_packed(T(jl.pack_gauge(u)), T(jl.pack_spinor(b)), MASS),
          jl.pack_spinor(jw.dslash(u, b, MASS)))
    assert tw.dslash_flops(100) == jw.dslash_flops(100) == 132000


# ---------------------------------------------------------------------------
# ops: the full-lattice entry points over K4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [None, 3])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_dslash_matches_jax_oracle(fields, flags, n):
    g5in, g5out, twist = flags
    up, pp = fields["up"], fields["pp"]
    pp = pp[0] if n is None else pp
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    close(tops.dslash(T(up), T(pp), MASS, **kw),
          jops.dslash(up, pp, MASS, use_pallas=False, **kw))


# (lattice index, N, gamma5_in, gamma5_out, twist): each flag on and off
PALLAS_CASES = [(0, 1, True, False, 0.0), (0, 3, False, True, 0.25),
                (0, 1, True, True, -0.25)]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_dslash_matches_pallas_interpret(case):
    i, n, g5in, g5out, twist = case
    lat = SHAPES[i]
    ku, kb = jax.random.split(jax.random.PRNGKey(52))
    up = np.asarray(jl.pack_gauge(jl.random_gauge(ku, lat)))
    pp = np.asarray(jnp.stack([jl.pack_spinor(jl.random_spinor(
        jax.random.fold_in(kb, j), lat)) for j in range(n)]))
    pp = pp[0] if n == 1 else pp
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    # bz given explicitly: the tuning cache's choice for small lattices
    # is a streaming mode this jax cannot interpret
    ref = jops.dslash(up, pp, MASS, interpret=True, bz=2, **kw)
    close(tops.dslash(T(up), T(pp), MASS, **kw), ref)


def emulate_wilson_full(up, pp, mass, *, twist, gamma5_in, gamma5_out):
    """csrc/wilson_full.cu step by step: the site term from
    ``site_coeffs``, the neighbour indices with periodic wrap (x +- 1 on
    the full X axis), the compile-time projection/reconstruction of
    ``hop_spec``, the SU(3) product (daggered for backward hops) and the
    hops' sum scaled by -1/2 in the epilogue."""
    unit = (1, 1j, -1, -1j)
    m_hi, m_lo, tw_hi, tw_lo = tk.site_coeffs(mass, twist, gamma5_in,
                                              gamma5_out)
    batched = pp.dim() == 6
    ps = pp if batched else pp[None]
    _, t_, z_, y_, _, x_ = ps.shape
    t, z, y, x = torch.meshgrid(torch.arange(t_), torch.arange(z_),
                                torch.arange(y_), torch.arange(x_),
                                indexing="ij")
    tp, tm = (t + 1) % t_, (t - 1) % t_
    zp, zm = (z + 1) % z_, (z - 1) % z_
    yp, ym = (y + 1) % y_, (y - 1) % y_
    xp, xm = (x + 1) % x_, (x - 1) % x_

    ps = ps.permute(0, 1, 2, 3, 5, 4)            # (N, T, Z, Y, X, 24)
    ps = torch.complex(ps[..., 0::2], ps[..., 1::2]).reshape(
        ps.shape[:5] + (4, 3))

    def links(mu, idx):
        g = up.permute(0, 1, 2, 3, 5, 4)[mu][idx]  # (T, Z, Y, X, 18)
        return torch.complex(g[..., 0::2], g[..., 1::2]).reshape(
            g.shape[:4] + (3, 3))

    m = torch.tensor([m_hi, m_hi, m_lo, m_lo])[:, None]
    tw_s = torch.tensor([tw_hi, tw_hi, tw_lo, tw_lo])[:, None]
    hops = [  # (mu, forward, spinor index, link index)
        (0, True, (tp, z, y, x), (t, z, y, x)),
        (0, False, (tm, z, y, x), (tm, z, y, x)),
        (1, True, (t, zp, y, x), (t, z, y, x)),
        (1, False, (t, zm, y, x), (t, zm, y, x)),
        (2, True, (t, z, yp, x), (t, z, y, x)),
        (2, False, (t, z, ym, x), (t, z, ym, x)),
        (3, True, (t, z, y, xp), (t, z, y, x)),
        (3, False, (t, z, y, xm), (t, z, y, xm)),
    ]
    acc = torch.zeros_like(ps)
    for mu, fwd, sidx, uidx in hops:
        p = ps[(slice(None),) + sidx]                   # (N, ..., 4, 3)
        proj, recon = tk.hop_spec(mu, fwd, gamma5_in, gamma5_out)
        half = torch.stack([p[..., a, :] + unit[q] * p[..., col, :]
                            for a, (col, q) in enumerate(proj)], dim=-2)
        link = links(mu, uidx)
        if not fwd:
            link = link.conj().transpose(-1, -2)
        g = torch.einsum("...rc,n...ac->n...ar", link, half)
        acc[..., :2, :] += g
        for i, (src, ph) in enumerate(recon):
            acc[..., 2 + i, :] += unit[ph] * g[..., src, :]
    out = (m + 1j * tw_s) * ps - 0.5 * acc
    packed = torch.view_as_real(out).reshape(out.shape[:5] + (24,))
    packed = packed.permute(0, 1, 2, 3, 5, 4).contiguous()
    return packed if batched else packed[0]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_kernel_algorithm_matches_plain_version(fields, flags, n):
    g5in, g5out, twist = flags
    up, pp = T(fields["up"]), T(fields["pp"])
    pp = pp[0] if n == 1 else pp
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    close(emulate_wilson_full(up, pp, MASS, **kw),
          wilson_full_ref(up, pp, MASS, **kw))


@pytest.mark.parametrize("twist", [0.0, 0.25])
def test_dslash_dagger_is_the_adjoint(fields, twist):
    # <phi, D psi> = <D^dag phi, psi>; the real dot of packed fields is the
    # real part of the complex one (f64, so only the algebra is tested)
    up, pp = T(fields["up"]).double(), T(fields["pp"]).double()
    phi, psi = pp[0], pp[1]
    kw = dict(twist=twist, use_kernels=False)
    lhs = (phi * tops.dslash(up, psi, MASS, **kw)).sum()
    rhs = (tops.dslash_dagger(up, phi, MASS, **kw) * psi).sum()
    assert abs(float(lhs - rhs)) <= 1e-12 * float(phi.norm() * psi.norm())


@pytest.mark.parametrize("n", [1, 4])
def test_normal_op_is_two_calls_for_any_n(fields, n):
    up, pp = fields["up"], fields["pp"]
    v = pp[0] if n == 1 else np.concatenate([pp, pp[:1]])
    reset_counts()
    out = tops.normal_op(T(up), T(v), MASS, twist=0.25)
    c = counts()
    assert c["wilson_full"] == {"launches": 0, "plain_calls": 2}
    assert all(c[k]["plain_calls"] == 0 for k in c if k != "wilson_full")
    close(out, jops.normal_op(up, v, MASS, twist=0.25, use_pallas=False))


def test_batched_dslash_equals_looped(fields):
    up, pp = T(fields["up"]), T(fields["pp"])
    out = tops.dslash(up, pp, MASS, twist=0.25, gamma5_in=True,
                      gamma5_out=True)
    for i in range(pp.shape[0]):
        assert torch.equal(out[i], tops.dslash(up, pp[i], MASS, twist=0.25,
                                               gamma5_in=True,
                                               gamma5_out=True))


def test_wrapper_rejects_bad_operands(fields):
    up, pp = T(fields["up"]), T(fields["pp"])
    with pytest.raises(ValueError, match="does not match"):
        tk.wilson_full(up, pp[..., :2], MASS)
    with pytest.raises(ValueError, match="rank"):
        tk.wilson_full(up, pp[0, 0], MASS)
    with pytest.raises(NotImplementedError, match="item 8"):
        tk.wilson_full(up.bfloat16(), pp.bfloat16(), MASS)


# ---------------------------------------------------------------------------
# plan.solve(operator="full") against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    lat = jl.LatticeShape(4, 4, 4, 4)
    ku, kb = jax.random.split(jax.random.PRNGKey(7))
    u, b = jl.random_gauge(ku, lat), jl.random_spinor(kb, lat)
    batch = jnp.stack([jl.random_spinor(jax.random.fold_in(kb, i), lat)
                       for i in range(4)])
    ut, bt = fields_from_numpy(np.asarray(u), np.asarray(b), device="cpu")
    _, batch_t = fields_from_numpy(np.asarray(u), np.asarray(batch),
                                   device="cpu")
    return dict(u=u, b=b, batch=batch, ut=ut, bt=bt, batch_t=batch_t)


def _port(problem, b, layout="natural", u=None, **plan_kw):
    plan = tplan.SolverPlan(operator="full", **plan_kw)
    return tplan.solve(plan, problem["ut"] if u is None else u, b, MASS,
                       tol=TOL, maxiter=1000, layout=layout, device="cpu")


def _close_rel(x, ref, tol=1e-4):
    ref = np.asarray(ref)
    err = np.max(np.abs(x.numpy() - ref))
    assert err <= tol * np.max(np.abs(ref)), err


@pytest.mark.parametrize("family,mu", [("wilson", 0.0),
                                       ("twisted-mass", 0.25)])
def test_full_solve_matches_jax_and_goldens(problem, family, mu):
    reset_counts()
    x, st = _port(problem, problem["bt"], operator_family=family, mu=mu)
    k = st.iterations
    assert k == 27
    assert int(st.verdict) == solvers.CONVERGED and bool(st.verified)
    assert int(st.matvecs) == k
    # the launch accounting the chip run asserts, on the plain versions
    c = counts()
    assert c["wilson_full"]["plain_calls"] == 2 * k + 1
    assert all(c[n]["plain_calls"] == 0 for n in ("wilson_hop", "cg_update",
                                                  "cg_xpay"))
    assert all(v["launches"] == 0 for v in c.values())
    xj, sj = jax_solve(JaxPlan(operator="full", operator_family=family,
                               mu=mu, backend="reference"),
                       problem["u"], problem["b"], MASS, tol=TOL,
                       maxiter=1000)
    assert int(sj.iterations) == 27 and bool(sj.verified)
    _close_rel(x, xj)
    xr, sr = _port(problem, problem["bt"], operator_family=family, mu=mu,
                   backend="reference")
    assert sr.iterations == 27 and bool(sr.verified)
    _close_rel(xr, xj)


def test_full_batch_matches_jax_and_singles(problem):
    x4, st4 = _port(problem, problem["batch_t"], nrhs=4)
    assert st4.rhs_iterations.tolist() == [27] * 4
    assert st4.iterations == 27 and bool(st4.verified.all())
    xj, sj = jax_solve(JaxPlan(operator="full", backend="reference",
                               nrhs=4), problem["u"], problem["batch"],
                       MASS, tol=TOL, maxiter=1000)
    assert np.asarray(sj.rhs_iterations).tolist() == [27] * 4
    _close_rel(x4, xj)
    for i in (0, 3):
        xi, sti = _port(problem, problem["batch_t"][i])
        assert sti.iterations == 27
        assert torch.equal(xi, x4[i])


def test_packed_layout_agrees_with_natural(problem):
    up = pack_gauge(problem["ut"])
    x, st = _port(problem, problem["bt"])
    reset_counts()
    xp, stp = _port(problem, pack_spinor(problem["bt"]), layout="packed",
                    u=up)
    # the packed solve verifies through the kernel: one more call
    assert counts()["wilson_full"]["plain_calls"] == 2 * stp.iterations + 2
    assert stp.iterations == st.iterations == 27 and bool(stp.verified)
    assert torch.equal(xp, pack_spinor(x))
    rel = float(stp.true_residual_norm2 / (pack_spinor(problem["bt"])
                                           ** 2).sum()) ** 0.5
    assert rel < 10 * TOL
    xb, stb = _port(problem, pack_spinor(problem["batch_t"][:2]),
                    layout="packed", u=up, nrhs=2)
    assert stb.rhs_iterations.tolist() == [27, 27]
    assert bool(stb.verified.all())


def test_packed_layout_errors(problem):
    up, bp = pack_gauge(problem["ut"]), pack_spinor(problem["bt"])
    with pytest.raises(ValueError, match="full-operator contract"):
        tplan.solve(tplan.SolverPlan(), up, bp, MASS, layout="packed",
                    device="cpu")
    with pytest.raises(ValueError, match="rank-5 packed"):
        _port(problem, bp[None], layout="packed", u=up)
    with pytest.raises(ValueError, match="rank-6 packed"):
        _port(problem, bp, layout="packed", u=up, nrhs=1)
    with pytest.raises(ValueError, match="layout must be"):
        _port(problem, problem["bt"], layout="wire")
    with pytest.raises(ValueError, match="even-odd context"):
        tplan.resolve(tplan.SolverPlan(operator="full"), problem["ut"], MASS)
    with pytest.raises(NotImplementedError, match="item 8"):
        tplan.SolverPlan(operator="full", precision="mixed")
    with pytest.raises(NotImplementedError, match="r=1"):
        _port(problem, problem["bt"], r=0.5)


def test_cli_parity_full(capsys):
    assert cli.main(["--lattice", "4x4x4x4", "--parity", "full",
                     "--device", "cpu", "--mass", "0.1", "--operator",
                     "twisted-mass", "--mu", "0.25"]) == 0
    out = capsys.readouterr().out
    assert "operator=full" in out
    assert "verdict: converged verified=True" in out
