"""Port vs JAX: float16 storage in K1-K4 and the plans that run it.

* Each kernel's plain version on float16 inputs against its JAX twin on
  the same float16 bits: the parity hop for every flag set and the
  full-lattice operator for every gamma5 flag pair with and without
  twist against ``wilson_dslash/xla.py`` (f32 compute, one rounding, the
  Pallas kernels' numerics), one hop launch against the Pallas kernel in
  interpret mode, and the fused CG update, xpay and gated xpay against
  ``cg_fused/ref.py``.  Tolerance: at most 1 float16 ulp per entry (the
  f32 sums are taken in another order, so one rounding may land on the
  neighbouring value); an entry that cancels below 2^-13 of the field's
  largest entry is held to the ulp at that floor (float16 keeps 11
  significant bits, so the floor is 2^-23 of the scale, where two f32
  orders of the same sums differ, as bf16's 2^-16 is); residual norms,
  f32 sums, 1e-5 relative.  The plain versions widen to f32, compute in
  f32 and round once: no arithmetic runs in torch's float16.
* Small values, down into float16's subnormals and below its smallest
  subnormal, round as JAX's casts round them, bitwise.
* ``plan.solve`` with ``low="float16"`` on the 4^4, seed-7, mass-0.1,
  tol-1e-6 goldens, on both port backends, at JAX's float16 counts (the
  reference and pallas backends alike): even-odd 15 / 4 for Wilson and
  twisted mass, full 33 / 5 at N = 1 and 33 x 4 / 5 at N = 4, cg16 27
  (verified False by design); converged and verified, x within 1e-3 of
  JAX's float16 solve (cg16 1e-2: float16 noise), the kernels backend's
  launch counts on the float16 instances.
* b scaled by 1e4, past float16's range: both port backends stop as
  JAX does, verdict 3 (stagnation) after 0 inner and 50 outer iterations
  with a finite x.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LatticeShape, random_gauge, random_spinor
from repro.core import SolverPlan as JaxPlan
from repro.core import lattice as jl
from repro.core import solve_plan as jax_solve
from repro.kernels.cg_fused import ref as jcg
from repro.kernels.wilson_dslash import ops as jops
from repro.kernels.wilson_dslash import xla as jxla
from repro_torch.core import plan as tplan
from repro_torch.core import solvers
from repro_torch.core.lattice import fields_from_numpy
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
from repro_torch.kernels.wilson_dslash import kernel as tk
from repro_torch.kernels.wilson_dslash.ref import (wilson_full_ref,
                                                   wilson_hop_ref)

import torch_one_thread  # noqa: F401  (one intra-op thread)

MASS, TOL = 0.1, 1e-6
F16 = torch.float16
# below this share of the field's largest entry an entry is held to the
# floor's ulp (see the module docstring)
ULP_FLOOR = 2.0 ** -13


def f16_ordinal(a) -> np.ndarray:
    """float16 values (numpy from JAX or torch) as ordered integers:
    adjacent representable values differ by 1, +0 and -0 coincide."""
    if isinstance(a, torch.Tensor):
        bits = a.contiguous().view(torch.int16).numpy().astype(np.int64)
    else:
        bits = np.asarray(a).view(np.int16).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def f16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of float16 values at magnitude ``v`` (11 significant
    bits; 2^-24 through the subnormals)."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, np.maximum(e - 11, -24))


def assert_within_one_ulp(ours: torch.Tensor, ref):
    """At most 1 float16 ulp per entry (the ulp at ULP_FLOOR of the
    field's largest entry for an entry that cancels below it)."""
    assert ours.dtype == F16
    ref_np = np.asarray(ref)
    assert ref_np.dtype == np.float16 and ours.shape == ref_np.shape
    ulps = np.abs(f16_ordinal(ours) - f16_ordinal(ref_np))
    a, b = ours.double().numpy(), ref_np.astype(np.float64)
    floor = f16_ulp(ULP_FLOOR * np.abs(b).max())
    ok = (ulps <= 1) | (np.abs(a - b) <= floor)
    assert ok.all(), (int(ulps.max()), a[~ok][:4], b[~ok][:4])


def to_f16(a):
    """The same float16 bits on both sides: (JAX array, torch tensor)."""
    j = jnp.asarray(a).astype(jnp.float16)
    bits = np.asarray(j).view(np.int16).copy()
    return j, torch.from_numpy(bits).view(F16)


# ---------------------------------------------------------------------------
# the kernels' plain versions at float16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fields():
    lat = jl.LatticeShape(4, 4, 4, 8)
    ku, kb = jax.random.split(jax.random.PRNGKey(43))
    u = jl.random_gauge(ku, lat)
    ue, uo = jl.split_eo_gauge(u)
    psi = jnp.stack([jl.random_spinor(jax.random.fold_in(kb, i), lat)
                     for i in range(3)])
    half = jnp.stack([jl.split_eo(psi[i])[0] for i in range(3)])
    return dict(upe=to_f16(jl.pack_gauge(ue)), upo=to_f16(jl.pack_gauge(uo)),
                up=to_f16(jl.pack_gauge(u)), pp=to_f16(jl.pack_spinor(psi)),
                ph=to_f16(jl.pack_spinor(half)),
                acc=to_f16(-0.5 * jl.pack_spinor(half)))


HOP_FLAGS = [(parity, g5in, g5out, acc, twist)
             for parity in (0, 1) for g5in in (False, True)
             for g5out in (False, True) for acc in (False, True)
             for twist in (False, True)]


def _hop_kw(g5in, g5out, acc, twist):
    return dict(gamma5_in=g5in, gamma5_out=g5out,
                hop_coeff=-0.3 if (acc or twist) else 1.0,
                hop_twist=0.2 if twist else 0.0,
                acc_coeff=1.7 if acc else 0.0,
                acc_twist=-0.4 if (acc and twist) else 0.0)


@pytest.mark.parametrize("flags", HOP_FLAGS,
                         ids=lambda f: "-".join(map(str, f)))
def test_f16_hop_matches_xla_twin(fields, flags):
    parity, g5in, g5out, acc, twist = flags
    u_out, u_nbr = ((fields["upe"], fields["upo"]) if parity == 0
                    else (fields["upo"], fields["upe"]))
    kw = _hop_kw(g5in, g5out, acc, twist)
    ja, ta = fields["acc"] if acc else (None, None)
    ours = wilson_hop_ref(u_out[1], u_nbr[1], fields["ph"][1], parity=parity,
                          psi_acc=ta, **kw)
    ref = jxla.dslash_parity_xla(u_out[0], u_nbr[0], fields["ph"][0],
                                 parity=parity, psi_acc=ja, **kw)
    assert_within_one_ulp(ours, ref)
    # the wrapper on CPU tensors is the plain version, float16 in and out
    reset_counts()
    assert torch.equal(tk.wilson_hop(u_out[1], u_nbr[1], fields["ph"][1],
                                     parity=parity, psi_acc=ta, **kw), ours)
    assert counts()["wilson_hop_f16"] == {"launches": 0, "plain_calls": 1}


def test_f16_hop_matches_pallas_interpret(fields):
    # one launch (interpreting a Pallas kernel costs seconds): N = 3, the
    # accumulator, twist and both gamma5 flags on
    (je, te), (jo, to), (jp, tp) = fields["upe"], fields["upo"], fields["ph"]
    ja, ta = fields["acc"]
    kw = _hop_kw(True, True, True, True)
    ours = tk.wilson_hop(te, to, tp, parity=0, psi_acc=ta, **kw)
    ref = jops.hop_block(je, jo, jp, psi_acc=ja, interpret=True, bz=2,
                         which="eo", **kw)
    assert_within_one_ulp(ours, ref)


@pytest.mark.parametrize("g5in", [False, True])
@pytest.mark.parametrize("g5out", [False, True])
@pytest.mark.parametrize("twist", [0.0, 0.25])
def test_f16_full_matches_xla_twin(fields, g5in, g5out, twist):
    (ju, tu), (jp, tp) = fields["up"], fields["pp"]
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    ours = wilson_full_ref(tu, tp, MASS, **kw)
    ref = jxla.dslash_xla(ju, jp, MASS, **kw)
    assert_within_one_ulp(ours, ref)
    reset_counts()
    assert torch.equal(tk.wilson_full(tu, tp, MASS, **kw), ours)
    assert counts()["wilson_full_f16"] == {"launches": 0, "plain_calls": 1}


def _cg_fields(n, seed):
    rng = np.random.default_rng(seed)
    return [to_f16(rng.standard_normal((n, 4, 2, 24, 7)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("n", [1, 4])
def test_f16_cg_update_matches_jax_ref(n):
    (jx, tx), (jr, trr), (jp, tp), (jap, tap) = _cg_fields(n, 13)
    alpha = np.linspace(-0.7, 1.3, n).astype(np.float32)
    if n > 1:
        alpha[1] = 0.0   # a frozen lane
    xo, ro, rs = cg_update_ref(torch.from_numpy(alpha), tx, trr, tp, tap)
    jxo, jro, jrs = jcg.cg_update_batched_ref(alpha, jx, jr, jp, jap)
    assert_within_one_ulp(xo, jxo)
    assert_within_one_ulp(ro, jro)
    assert rs.dtype == torch.float32
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), rtol=1e-5)
    if n > 1:
        assert torch.equal(xo[1], tx[1]) and torch.equal(ro[1], trr[1])


@pytest.mark.parametrize("gated", [False, True])
def test_f16_cg_xpay_matches_jax_ref(gated):
    n = 4
    _, (jr, trr), (jp, tp), _ = _cg_fields(n, 14)
    beta = np.linspace(0.1, 0.9, n).astype(np.float32)
    if gated:
        gate = np.arange(n) % 2 == 0
        po = cg_xpay_ref(torch.from_numpy(beta), trr, tp,
                         torch.from_numpy(gate))
        ref = jcg.cg_xpay_batched_ref(beta, jr, jp, gate)
        assert torch.equal(po[1], tp[1]) and torch.equal(po[3], tp[3])
    else:
        po = cg_xpay_ref(torch.from_numpy(beta), trr, tp)
        ref = jax.vmap(jcg.cg_xpay_ref)(jnp.asarray(beta), jr, jp)
    assert_within_one_ulp(po, ref)


def test_f16_narrowing_of_small_values_matches_jax():
    """K2's x + a p with x = 0 and K3's r + b p with r = 0, a and b from
    1.37 * 2^-14 down to 2^-26 and p in [0.5, 2): the f32 products, down
    through float16's subnormals and below 2^-24, narrow once, bitwise
    as JAX's reference kernels narrow them (round to nearest even,
    subnormals kept)."""
    rng = np.random.default_rng(15)
    a = np.array([1.37 * 2.0 ** -k for k in range(14, 27)], np.float32)
    n = len(a)
    jp, tp = to_f16(rng.uniform(0.5, 2.0, (n, 999)).astype(np.float32))
    jz, tz = to_f16(np.zeros((n, 999), np.float32))
    xo, _, _ = cg_update_ref(torch.from_numpy(a), tz, tz, tp, tp)
    jxo, _, _ = jcg.cg_update_batched_ref(a, jz, jz, jp, jp)
    po = cg_xpay_ref(torch.from_numpy(a), tz, tp)
    jpo = jax.vmap(jcg.cg_xpay_ref)(jnp.asarray(a), jz, jp)
    for ours, ref in ((xo, jxo), (po, jpo)):
        assert np.array_equal(ours.view(torch.int16).numpy(),
                              np.asarray(ref).view(np.int16))
    sub = (xo != 0) & (xo.float().abs() < 2.0 ** -14)
    assert int(sub.sum()) > 5000 and int((xo == 0).sum()) > 0


# ---------------------------------------------------------------------------
# plan.solve at the 4^4 goldens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    lat = LatticeShape(4, 4, 4, 4)
    ku, kb = jax.random.split(jax.random.PRNGKey(7))
    u, b = random_gauge(ku, lat), random_spinor(kb, lat)
    batch = jnp.stack([random_spinor(jax.random.fold_in(kb, i), lat)
                       for i in range(4)])
    ut, bt = fields_from_numpy(np.asarray(u), np.asarray(b), device="cpu")
    _, batch_t = fields_from_numpy(np.asarray(u), np.asarray(batch),
                                   device="cpu")
    return dict(u=u, b=b, batch=batch, ut=ut, bt=bt, batch_t=batch_t)


# (plan fields, RHS, JAX's float16 inner counts per RHS, outer), the same
# on JAX's reference and pallas backends
GOLDENS = {
    "eo_mixed": (dict(precision="mixed"), "b", [15], 4),
    "eo_mixed_tm": (dict(precision="mixed", operator_family="twisted-mass",
                         mu=0.25), "b", [15], 4),
    "full_mixed": (dict(operator="full", precision="mixed"), "b", [33], 5),
    "full_mixed_n4": (dict(operator="full", precision="mixed", nrhs=4),
                      "batch", [33] * 4, 5),
    "full_cg16": (dict(operator="full", precision="low"), "b", [27], 1)}


def _rel_res(st, b):
    rows = b if b.dim() == 7 else b[None]
    bs = torch.stack([(v.abs() ** 2).sum() for v in rows])
    return (torch.atleast_1d(st.true_residual_norm2) / bs).sqrt()


@pytest.fixture(scope="module")
def jax_twins(problem):
    """JAX's float16 solves of GOLDENS (reference backend)."""
    out = {}
    for name, (kw, rhs, _, _) in GOLDENS.items():
        out[name] = jax_solve(JaxPlan(backend="reference", low=jnp.float16,
                                      **kw),
                              problem["u"], problem[rhs], MASS, tol=TOL,
                              maxiter=1000)
    return out


def _want_plain_calls(kw, k, outer) -> dict:
    """The kernels backend's plain calls (the launches of a card run) of a
    float16 solve of k inner iterations and ``outer`` reliable updates."""
    if kw.get("operator") == "full":
        if kw["precision"] == "low":
            return {"wilson_full_f16": 2 * k, "wilson_full": 1}
        return {"wilson_full_f16": 2 * k, "wilson_full": 2 * outer + 1}
    return {"wilson_hop_f16": 4 * k, "wilson_hop": 4 * outer + 4,
            "cg_update_f16": k, "cg_xpay_f16": k}


@pytest.mark.parametrize("backend", ["kernels", "reference"])
@pytest.mark.parametrize("name", list(GOLDENS))
def test_f16_goldens_match_jax(problem, jax_twins, name, backend):
    kw, rhs, want, outer = GOLDENS[name]
    xj, sj = jax_twins[name]
    batched = "nrhs" in kw
    jits = (np.asarray(sj.rhs_iterations).tolist() if batched
            else [int(sj.iterations)])
    assert (jits, int(sj.outer_iterations)) == (want, outer)
    reset_counts()
    x, st = tplan.solve(tplan.SolverPlan(backend=backend, low="float16",
                                         **kw),
                        problem["ut"], problem["batch_t" if batched else "bt"],
                        MASS, tol=TOL, device="cpu")
    its = st.rhs_iterations.tolist() if batched else [st.iterations]
    assert (its, st.outer_iterations) == (want, outer)
    assert bool((torch.atleast_1d(st.verdict) == solvers.CONVERGED).all())
    low = kw["precision"] == "low"
    # cg16 cannot reach tol in float16: unverified by design
    assert bool(torch.atleast_1d(st.verified).all()) is not low
    if not low:
        assert float(_rel_res(st, problem["batch_t" if batched else "bt"]
                              ).max()) < 1e-5
    ref = np.asarray(xj)
    err = np.max(np.abs(x.numpy() - ref)) / np.max(np.abs(ref))
    assert err <= (1e-2 if low else 1e-3), err
    c = {n: v["plain_calls"] for n, v in counts().items() if v["plain_calls"]}
    if backend == "kernels":
        assert c == _want_plain_calls(kw, st.iterations, outer)
    else:
        assert c == {}
    assert all(v["launches"] == 0 for v in counts().values())


OVERFLOW_SCALE = 1e4


@pytest.fixture(scope="module")
def jax_overflow(problem):
    """JAX's float16 mixed solves of b x OVERFLOW_SCALE (reference
    backend): {operator: (verdict, inner, outer)}."""
    out = {}
    for operator in ("eo-schur", "full"):
        _, sj = jax_solve(JaxPlan(backend="reference", low=jnp.float16,
                                  operator=operator, precision="mixed"),
                          problem["u"], problem["b"] * OVERFLOW_SCALE, MASS,
                          tol=TOL, maxiter=1000)
        out[operator] = (int(sj.verdict), int(sj.iterations),
                         int(sj.outer_iterations))
    return out


@pytest.mark.parametrize("backend", ["kernels", "reference"])
@pytest.mark.parametrize("operator", ["eo-schur", "full"])
def test_f16_overflow_stops_as_jax_does(problem, jax_overflow, operator,
                                        backend):
    """b x 1e4 overflows float16 in the first inner matvec: JAX's solves
    (both backends) stop at verdict 3 after 0 inner and 50 outer
    iterations with a finite x; the port does the same, without
    rescaling."""
    kw = dict(operator=operator, precision="mixed")
    want = jax_overflow[operator]
    assert want == (solvers.STAGNATION, 0, 50)
    _, bt = fields_from_numpy(np.asarray(problem["u"]),
                              np.asarray(problem["b"] * OVERFLOW_SCALE),
                              device="cpu")
    x, st = tplan.solve(tplan.SolverPlan(backend=backend, low="float16",
                                         **kw),
                        problem["ut"], bt, MASS, tol=TOL, device="cpu")
    assert (int(st.verdict), st.iterations, st.outer_iterations) == want
    assert not bool(st.verified) and bool(torch.isfinite(x).all())


def test_f16_plan_and_wrappers_refuse_float64(problem):
    """float16 is a storage type of every kernel and of the kernels
    backend's plans; float64 is none (its plans run on the reference
    backend)."""
    assert tplan.SolverPlan(precision="mixed",
                            low="float16").low_dtype == F16
    with pytest.raises(NotImplementedError, match="float16"):
        tplan.SolverPlan(precision="mixed", low="float64")
    tplan.SolverPlan(precision="mixed", low="float64", backend="reference")
    z = torch.zeros(4, 4, 4, 4, 18, 2, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="float16"):
        tk.wilson_hop(z, z, torch.zeros(4, 4, 4, 24, 2, dtype=torch.float64),
                      parity=0)
