"""Port vs JAX: mixed precision (bf16 storage in K1-K4, mpcg, the plan).

* Each kernel's plain version on bf16 inputs against its JAX twin on the
  same bf16 inputs: the parity hop for every flag set and the
  full-lattice operator for every gamma5 flag pair with and without twist
  against ``wilson_dslash/xla.py`` (f32 compute, one rounding, the Pallas
  kernels' numerics), one hop launch against the Pallas kernel in
  interpret mode, and the fused CG update, xpay and gated xpay against
  ``cg_fused/ref.py``.  Tolerance: at most 1 bf16 ulp per entry (the f32
  sums are taken in another order, so one rounding to bf16 may land on
  the neighbouring value); the residual norms, f32 sums, 1e-5 relative.
* ``complex_to_real_pair``/``real_pair_to_complex`` bitwise.
* ``mpcg`` on injected dense operators against JAX's, and the even-odd
  composition the plan runs (``eo.schur_rhs``, ``mpcg``,
  ``eo.back_substitute_odd``) against JAX's ``mpcg_eo``.
* ``plan.solve`` mixed and low on the 4^4, seed-7, mass-0.1, tol-1e-6
  goldens, with the JAX tests' contracts: converged and verified, true
  relative residual < 1e-5, inner iterations >= 2x outer (even-odd) or
  >= 3x outer (full), at most 3x the f32 count, x within 1e-3 (relative
  max-abs) of JAX's mixed solve.  Counts, each against the twin named:
  even-odd 15 inner / 4 outer (JAX reference and pallas backends alike);
  full N = 1 35 / 5 and N = 4 33, 33, 35, 33 / 5, equal to JAX's pallas
  backend (its CPU lowering, xla.py) and within 2 of JAX's reference
  backend (33 / 5; 33 x 4), whose dslash_packed rounds the bf16 mass term
  before it widens; cg16 27, verified False by design.
* The plan's rules.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LatticeShape, random_gauge, random_spinor
from repro.core import SolverPlan as JaxPlan
from repro.core import lattice as jl
from repro.core import solve_plan as jax_solve
from repro.core import solvers as jsolvers
from repro.kernels.cg_fused import ref as jcg
from repro.kernels.wilson_dslash import ops as jops
from repro.kernels.wilson_dslash import xla as jxla
from repro_torch.core import eo, solvers
from repro_torch.core import lattice as tl
from repro_torch.core import plan as tplan
from repro_torch.core.lattice import fields_from_numpy
from repro_torch.core.precision import CPU_TEST, DEFAULT, parse_dtype
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
from repro_torch.kernels.wilson_dslash import kernel as tk
from repro_torch.kernels.wilson_dslash.ref import (wilson_full_ref,
                                                   wilson_hop_ref)
from repro_torch.launch import solve as cli

import torch_one_thread  # noqa: F401  (one intra-op thread)

MASS, TOL = 0.1, 1e-6


def bf16_ordinal(a) -> np.ndarray:
    """bf16 values (numpy from JAX or torch) as ordered integers: adjacent
    representable values differ by 1, +0 and -0 coincide."""
    if isinstance(a, torch.Tensor):
        bits = a.contiguous().view(torch.int16).numpy().astype(np.int64)
    else:
        bits = np.asarray(a).view(np.int16).astype(np.int64)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


# Entries that cancel far below the field's scale: two correct f32
# evaluations of the same sums in another order differ by about 1e-7 of
# the operands' O(1) scale, more than a bf16 ulp of an entry below 2^-16 of
# the field's largest entry.  Such an entry is held to 1 bf16 ulp of that
# floor instead of its own (2 of the 589,824 entries of the hop cases
# below are 2 ulps apart).
ULP_FLOOR = 2.0 ** -16


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at magnitude ``v`` (8 significant bits)."""
    _, e = np.frexp(np.abs(v))
    return np.ldexp(1.0, e - 8)


def assert_within_one_ulp(ours: torch.Tensor, ref):
    """At most 1 bf16 ulp per entry (the ulp at ULP_FLOOR of the field's
    largest entry for an entry that cancels below it)."""
    assert ours.dtype == torch.bfloat16
    ref_np = np.asarray(ref)
    assert ours.shape == tuple(ref_np.shape)
    ulps = np.abs(bf16_ordinal(ours) - bf16_ordinal(ref_np))
    a = ours.double().numpy()
    b = ref_np.astype(np.float64)
    floor = bf16_ulp(ULP_FLOOR * np.abs(b).max())
    ok = (ulps <= 1) | (np.abs(a - b) <= floor)
    assert ok.all(), (int(ulps.max()), a[~ok][:4], b[~ok][:4])


def to_bf16(a):
    """The same bf16 bits on both sides: (JAX array, torch tensor)."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    bits = np.asarray(j).view(np.int16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# the kernels' plain versions at bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fields():
    lat = jl.LatticeShape(4, 4, 4, 8)
    ku, kb = jax.random.split(jax.random.PRNGKey(41))
    u = jl.random_gauge(ku, lat)
    ue, uo = jl.split_eo_gauge(u)
    psi = jnp.stack([jl.random_spinor(jax.random.fold_in(kb, i), lat)
                     for i in range(3)])
    half = jnp.stack([jl.split_eo(psi[i])[0] for i in range(3)])
    return dict(upe=to_bf16(jl.pack_gauge(ue)), upo=to_bf16(jl.pack_gauge(uo)),
                up=to_bf16(jl.pack_gauge(u)), pp=to_bf16(jl.pack_spinor(psi)),
                ph=to_bf16(jl.pack_spinor(half)),
                acc=to_bf16(-0.5 * jl.pack_spinor(half)))


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
def test_bf16_hop_matches_xla_twin(fields, flags):
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


def test_bf16_hop_matches_pallas_interpret(fields):
    # one launch (interpreting a Pallas kernel costs seconds): N = 3, the
    # accumulator, twist and both gamma5 flags on
    (je, te), (jo, to), (jp, tp) = fields["upe"], fields["upo"], fields["ph"]
    ja, ta = fields["acc"]
    kw = dict(which="eo", **_hop_kw(True, True, True, True))
    ours = tk.wilson_hop(te, to, tp, parity=0, psi_acc=ta,
                         **{k: v for k, v in kw.items() if k != "which"})
    ref = jops.hop_block(je, jo, jp, psi_acc=ja, interpret=True, bz=2, **kw)
    assert_within_one_ulp(ours, ref)


@pytest.mark.parametrize("g5in", [False, True])
@pytest.mark.parametrize("g5out", [False, True])
@pytest.mark.parametrize("twist", [0.0, 0.25])
def test_bf16_full_matches_xla_twin(fields, g5in, g5out, twist):
    (ju, tu), (jp, tp) = fields["up"], fields["pp"]
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    ours = wilson_full_ref(tu, tp, MASS, **kw)
    ref = jxla.dslash_xla(ju, jp, MASS, **kw)
    assert_within_one_ulp(ours, ref)
    # the wrapper on CPU tensors is the plain version, bf16 in and out
    reset_counts()
    assert torch.equal(tk.wilson_full(tu, tp, MASS, **kw), ours)
    assert counts()["wilson_full_bf16"] == {"launches": 0, "plain_calls": 1}


def _cg_fields(n, seed):
    rng = np.random.default_rng(seed)
    return [to_bf16(rng.standard_normal((n, 4, 2, 24, 7)).astype(np.float32))
            for _ in range(4)]


@pytest.mark.parametrize("n", [1, 4])
def test_bf16_cg_update_matches_jax_ref(n):
    (jx, tx), (jr, trr), (jp, tp), (jap, tap) = _cg_fields(n, 3)
    alpha = np.linspace(-0.7, 1.3, n).astype(np.float32)
    if n > 1:
        alpha[1] = 0.0   # a frozen lane
    xo, ro, rs = cg_update_ref(torch.from_numpy(alpha), tx, trr, tp, tap)
    jxo, jro, jrs = jcg.cg_update_batched_ref(alpha, jx, jr, jp, jap)
    assert_within_one_ulp(xo, jxo)
    assert_within_one_ulp(ro, jro)
    assert rs.dtype == torch.float32
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), rtol=1e-5)
    # the norm is of the f32 r' before rounding, not of the stored bf16
    if n == 1:
        stored = float((ro.float() ** 2).sum())
        assert float(rs[0]) != stored
    else:
        assert torch.equal(xo[1], tx[1]) and torch.equal(ro[1], trr[1])
        for i in range(n):
            sx, sr, srs = cg_update_ref(torch.from_numpy(alpha[i:i + 1]),
                                        tx[i:i + 1], trr[i:i + 1],
                                        tp[i:i + 1], tap[i:i + 1])
            assert torch.equal(sx[0], xo[i]) and torch.equal(srs[0], rs[i])


@pytest.mark.parametrize("gated", [False, True])
def test_bf16_cg_xpay_matches_jax_ref(gated):
    n = 4
    _, (jr, trr), (jp, tp), _ = _cg_fields(n, 4)
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


@pytest.mark.parametrize("length", [1, 7, 8, 9, 12345, 8 ** 4 * 12])
@pytest.mark.parametrize("offset", [0, 1, 3, 7])
def test_bf16_vector_split_writes_every_element_once(offset, length):
    """csrc/cg_fused.cu's bf16 split of one RHS (the update and the xpay
    alike): a scalar head to the first 16-byte boundary, 8 bf16 a vector,
    a scalar tail; every element written once, every vector aligned, for
    a base ``offset`` elements (2 bytes each) past a 16-byte boundary."""
    mis = (2 * offset) % 16
    head = min(((16 - mis) & 15) // 2, length)
    nvec = (length - head) // 8
    writes = np.zeros(length, np.int64)
    writes[:head] += 1
    writes[head + 8 * nvec:] += 1
    for v in range(nvec):
        assert (2 * (offset + head + 8 * v)) % 16 == 0
        writes[head + 8 * v:head + 8 * v + 8] += 1
    assert (writes == 1).all()


def test_tile_plans_count_in_bytes():
    """bf16 tiles: strides in bf16 elements, padded to the 64 bf16 of the
    banks, 16-byte rows; TMA at 32^3 x 64, plain loads at the 4^4
    goldens' Xh = 2 (4-byte planes), as csrc/wilson_hop.cu decides.  At
    even widths the bf16 pair instances take twice the sites a tile (b =
    4 for K1, 8 for K4 at 32^3 x 64)."""
    b, ls, ss = tk.hop_tile_plan(32, 16, esize=2)
    assert (b, ls, ss) == (4, 336, 400)
    assert ls % 64 == 16 and ss % 64 == 16
    assert tk.hop_bulk(16, ls, ss, esize=2)
    assert tk.hop_smem_bytes(b, ls, ss, esize=2) == (
        (8 * b * ls + (6 * b + 2) * ss) * 2 + 16)
    assert not tk.hop_bulk(2, *tk.hop_tile_plan(4, 2, esize=2)[1:], esize=2)
    assert tk.hop_bulk(2, *tk.hop_tile_plan(4, 2)[1:])   # f32 unchanged
    assert tk.hop_tile_plan(32, 16) == (2, 304, 400)
    # K4 at X = 32: unpadded (a warp spans one row), so the X = 32
    # instances serve bf16 too; half the f32 tile's bytes at equal b
    b, ls = tk.full_tile_plan(32, 32, esize=2)
    assert (b, ls) == (8, 576) and tk.full_bulk(32, ls, esize=2)
    assert (tk.full_smem_bytes(b, ls, esize=2) - 16) * 2 == (
        tk.full_smem_bytes(b, ls) - 16)
    assert tk.full_bulk(4, tk.full_tile_plan(4, 4, esize=2)[1], esize=2)
    assert not tk.full_bulk(6, tk.full_tile_plan(4, 6, esize=2)[1], esize=2)


def test_real_pair_views_match_jax():
    rng = np.random.default_rng(9)
    v = (rng.standard_normal((3, 4, 5)) + 1j * rng.standard_normal(
        (3, 4, 5))).astype(np.complex64)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        ours = tl.complex_to_real_pair(torch.from_numpy(v), dtype)
        ref = np.asarray(jl.complex_to_real_pair(jnp.asarray(v), jdtype))
        assert np.array_equal(ours.float().numpy(), ref.astype(np.float32))
        back = tl.real_pair_to_complex(ours)
        jback = np.asarray(jl.real_pair_to_complex(jnp.asarray(ref)))
        assert back.dtype == torch.complex64
        assert np.array_equal(back.numpy(), jback)
    assert parse_dtype("bfloat16") == DEFAULT.low_dtype == torch.bfloat16
    assert CPU_TEST.low_dtype == CPU_TEST.high_dtype == torch.float32


# ---------------------------------------------------------------------------
# mpcg / mpcg_eo on injected operators
# ---------------------------------------------------------------------------


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((n, n)).astype(np.float32) / np.sqrt(n)
    return (m @ m.T + 0.3 * np.eye(n)).astype(np.float32)


def _dense_ops(a):
    """(op_low, op_high) for a dense f32 matrix, in torch and in JAX: the
    low operator widens its bf16 input, multiplies in f32 and rounds once."""
    at, aj = torch.from_numpy(a), jnp.asarray(a)

    def t_low(w):
        return (w.float() @ at.T).to(w.dtype)

    def j_low(w):
        return (w.astype(jnp.float32) @ aj.T).astype(w.dtype)

    return (t_low, lambda v: v @ at.T), (j_low, lambda v: v @ aj.T)


@pytest.mark.parametrize("batched", [False, True])
def test_mpcg_matches_jax(batched):
    """Both inner CGs on the fused engine's plain versions (f32 compute,
    one rounding to bf16, as the kernels), so the counts are comparable:
    plain bf16 tensor algebra rounds ``a * p`` before the add in torch and
    may not under XLA (then the counts drift by an iteration or two)."""
    from repro.kernels.cg_fused import ops as jcg_ops
    from repro_torch.kernels.cg_fused import ops as tcg_ops
    rng = np.random.default_rng(6)
    (tlow, thigh), (jlow, jhigh) = _dense_ops(_spd(48, 5))
    b = rng.standard_normal((2, 48) if batched else (48,)).astype(np.float32)
    kw = dict(tol=1e-6, inner_tol=5e-2, inner_maxiter=200, max_outer=50)
    tu, tx = (tcg_ops.fused_engine_batched() if batched
              else tcg_ops.fused_engine())
    ju, jx = (jcg_ops.fused_engine_batched(use_pallas=False) if batched
              else jcg_ops.fused_engine(use_pallas=False))
    x, st = solvers.mpcg(tlow, thigh, torch.from_numpy(b), batched=batched,
                         update=tu, xpay=tx, **kw)
    xj, sj = jsolvers.mpcg(jlow, jhigh, jnp.asarray(b), batched=batched,
                           low_dtype=jnp.bfloat16, update=ju, xpay=jx, **kw)
    assert st.outer_iterations == int(sj.outer_iterations) >= 2
    assert st.iterations == int(sj.iterations)
    if batched:
        assert st.rhs_iterations.tolist() == np.asarray(
            sj.rhs_iterations).tolist()
    assert int(torch.atleast_1d(st.matvecs)[0]) == (st.iterations
                                                    + st.outer_iterations)
    assert (torch.atleast_1d(st.verdict) == solvers.CONVERGED).all()
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(xj)).max())


def test_mpcg_batched_freezes_a_converged_system():
    a = _spd(48, 7)
    (tlow, thigh), _ = _dense_ops(a)
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 48)).astype(np.float32))
    # RHS 0 needs one reliable update at tol 1e-1: it must stop moving
    x, st = solvers.mpcg(tlow, thigh, b, tol=torch.tensor([1e-1, 1e-6]),
                         batched=True)
    x1, st1 = solvers.mpcg(tlow, thigh, b[:1], tol=1e-1, batched=True)
    assert st1.outer_iterations == 1
    assert torch.equal(x[0], x1[0])
    assert st.rhs_iterations[0] == st1.rhs_iterations[0]
    assert st.rhs_iterations[1] > st.rhs_iterations[0]


def test_mpcg_stagnation_and_breakdown_verdicts():
    a = _spd(16, 9)
    (tlow, thigh), _ = _dense_ops(a)
    b = torch.ones(16)
    # a low operator that is not the high one: the reliable updates stall
    _, st = solvers.mpcg(lambda w: (0.5 * w.float()).to(w.dtype), thigh, b,
                         tol=1e-6, max_outer=6)
    assert solvers.verdict_name(st.verdict) == "stagnation"
    # p.Ap = 0 in the inner CG: breakdown, and the loop stops
    _, st = solvers.mpcg(lambda w: torch.zeros_like(w), thigh, b, tol=1e-6)
    assert solvers.verdict_name(st.verdict) == "breakdown"
    assert st.outer_iterations == 1


def test_mpcg_eo_matches_jax():
    """Block operators of a 2x2 system with M_oo = s: D_hat = M_ee -
    D_eo D_oe / s, its normal operator in bf16 and f32.  The port's
    even-odd mixed solve (the Schur RHS, mpcg, the odd half
    back-substituted, as ``plan._parts_eo_mp`` composes them) against
    JAX's ``mpcg_eo``."""
    n, s = 24, 3.0
    rng = np.random.default_rng(10)
    mee = (4.0 * np.eye(n) + 0.3 * rng.standard_normal((n, n))).astype(
        np.float32)
    deo, doe = (0.3 * rng.standard_normal((2, n, n))).astype(np.float32)
    dhat = (mee - deo @ doe / s).astype(np.float32)
    be, bo = rng.standard_normal((2, n)).astype(np.float32)

    ah = (dhat.T @ dhat).astype(np.float32)

    def blocks(mat, low_op):
        a, d, e, o = (mat(v) for v in (ah, dhat, deo, doe))
        return (low_op(a), lambda v: v @ a.T, lambda v: v @ d,
                lambda v: v @ e.T, lambda v: v @ o.T, lambda v: v / s)

    def t_low(a):
        return lambda w: (w.float() @ a.T).to(w.dtype)

    def j_low(a):
        return lambda w: (w.astype(jnp.float32) @ a.T).astype(w.dtype)

    kw = dict(tol=1e-6, inner_tol=5e-2)
    a_low, a_high, *eo_ops = blocks(torch.from_numpy, t_low)
    ops = types.SimpleNamespace(**dict(zip(
        ("dhat_dag", "d_eo", "d_oe", "m_inv"), eo_ops)))
    tbe, tbo = torch.from_numpy(be), torch.from_numpy(bo)
    xe, st = solvers.mpcg(a_low, a_high, eo.schur_rhs(ops, tbe, tbo), **kw)
    xo = eo.back_substitute_odd(ops, tbo, xe)
    (jxe, jxo), sj = jsolvers.mpcg_eo(*blocks(jnp.asarray, j_low),
                                      jnp.asarray(be), jnp.asarray(bo),
                                      low_dtype=jnp.bfloat16, **kw)
    assert (st.iterations, st.outer_iterations) == (int(sj.iterations),
                                                    int(sj.outer_iterations))
    for ours, ref in ((xe, jxe), (xo, jxo)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-5 * np.abs(np.asarray(ref)).max())
    full = np.block([[mee, deo], [doe, s * np.eye(n)]])
    res = full @ np.concatenate([xe.numpy(), xo.numpy()]) - np.concatenate(
        [be, bo])
    assert np.linalg.norm(res) < 1e-5 * np.linalg.norm(np.concatenate(
        [be, bo]))


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


def _rel_res(st, b):
    rows = b if b.dim() == 7 else b[None]
    bs = torch.stack([(v.abs() ** 2).sum() for v in rows])
    return (torch.atleast_1d(st.true_residual_norm2) / bs).sqrt()


def _close_rel(x, ref, tol=1e-3):
    ref = np.asarray(ref)
    err = np.max(np.abs(x.numpy() - ref))
    assert err <= tol * np.max(np.abs(ref)), err


def _jax_mixed(problem, rhs, **kw):
    return jax_solve(JaxPlan(backend="reference", **kw), problem["u"],
                     problem[rhs], MASS, tol=TOL, maxiter=1000)


@pytest.mark.parametrize("family,mu", [("wilson", 0.0),
                                       ("twisted-mass", 0.25)])
def test_eo_mixed_goldens_and_contracts(problem, family, mu):
    kw = dict(operator="eo-schur", precision="mixed", operator_family=family,
              mu=mu)
    xj, sj = _jax_mixed(problem, "b", **kw)
    assert (int(sj.iterations), int(sj.outer_iterations)) == (15, 4)
    for backend in ("kernels", "reference"):
        reset_counts()
        x, st = tplan.solve(tplan.SolverPlan(backend=backend, **kw),
                            problem["ut"], problem["bt"], MASS, tol=TOL,
                            device="cpu")
        k, outer = st.iterations, st.outer_iterations
        assert (k, outer) == (15, 4)
        assert int(st.verdict) == solvers.CONVERGED and bool(st.verified)
        assert float(_rel_res(st, problem["bt"]).max()) < 1e-5
        assert k >= 2 * outer and k <= 3 * (14 if family == "wilson" else 13)
        assert int(st.matvecs) == k + outer
        _close_rel(x, xj)
        c = counts()
        if backend == "kernels":   # the launch accounting of the chip run
            assert c["wilson_hop_bf16"]["plain_calls"] == 4 * k
            assert c["wilson_hop"]["plain_calls"] == 4 * outer + 4
            assert c["cg_update_bf16"]["plain_calls"] == k
            assert c["cg_xpay_bf16"]["plain_calls"] == k
            assert c["cg_update"]["plain_calls"] == c["cg_xpay"][
                "plain_calls"] == 0
        else:
            assert all(v["plain_calls"] == 0 for v in c.values())
        assert all(v["launches"] == 0 for v in c.values())


def test_eo_mixed_forwarder(problem):
    x, st = eo.solve_wilson_eo_mp(problem["ut"], problem["bt"], MASS,
                                  device="cpu")
    assert (st.iterations, st.outer_iterations) == (15, 4)
    xr, sr = eo.solve_wilson_eo_mp(problem["ut"], problem["bt"], MASS,
                                   backend="reference", device="cpu")
    assert (sr.iterations, sr.outer_iterations) == (15, 4)
    _close_rel(x, xr)


@pytest.mark.parametrize("backend", ["kernels", "reference"])
def test_full_mixed_goldens_and_contracts(problem, backend):
    kw = dict(operator="full", precision="mixed")
    xj, sj = _jax_mixed(problem, "b", **kw)
    assert (int(sj.iterations), int(sj.outer_iterations)) == (33, 5)
    reset_counts()
    x, st = tplan.solve(tplan.SolverPlan(backend=backend, **kw),
                        problem["ut"], problem["bt"], MASS, tol=TOL,
                        device="cpu")
    k, outer = st.iterations, st.outer_iterations
    # equal to JAX's pallas backend (xla.py on the CPU), within 2 of its
    # reference backend
    assert (k, outer) == (35, 5)
    assert int(st.verdict) == solvers.CONVERGED and bool(st.verified)
    assert float(_rel_res(st, problem["bt"]).max()) < 1e-5
    assert 3 * outer <= k <= 3 * 27
    _close_rel(x, xj)
    c = counts()
    if backend == "kernels":
        assert c["wilson_full_bf16"]["plain_calls"] == 2 * k
        assert c["wilson_full"]["plain_calls"] == 2 * outer + 1
    assert sum(v["plain_calls"] for n, v in c.items()
               if not n.startswith("wilson_full")) == 0


def test_full_mixed_pallas_twin_counts(problem):
    _, sj = jax_solve(JaxPlan(operator="full", precision="mixed",
                              backend="pallas", interpret=False),
                      problem["u"], problem["b"], MASS, tol=TOL,
                      maxiter=1000)
    assert (int(sj.iterations), int(sj.outer_iterations)) == (35, 5)


def test_full_mixed_batch(problem):
    kw = dict(operator="full", precision="mixed", nrhs=4)
    xj, sj = _jax_mixed(problem, "batch", **kw)
    assert np.asarray(sj.rhs_iterations).tolist() == [33] * 4
    x, st = tplan.solve(tplan.SolverPlan(**kw), problem["ut"],
                        problem["batch_t"], MASS, tol=TOL, device="cpu")
    its = st.rhs_iterations.tolist()
    assert its == [33, 33, 35, 33]   # JAX's pallas backend's counts
    assert st.outer_iterations == 5 and bool(st.verified.all())
    assert (st.verdict == solvers.CONVERGED).all()
    assert float(_rel_res(st, problem["batch_t"]).max()) < 1e-5
    assert min(its) >= 3 * st.outer_iterations and max(its) <= 3 * 27
    _close_rel(x, xj)


def test_full_low_cg16(problem):
    kw = dict(operator="full", precision="low")
    xj, sj = _jax_mixed(problem, "b", **kw)
    assert int(sj.iterations) == 27 and not bool(sj.verified)
    reset_counts()
    x, st = tplan.solve(tplan.SolverPlan(**kw), problem["ut"], problem["bt"],
                        MASS, tol=TOL, device="cpu")
    assert st.iterations == 27
    assert not bool(st.verified)     # bf16 cannot reach tol: by design
    assert x.dtype == torch.complex64
    c = counts()
    assert c["wilson_full_bf16"]["plain_calls"] == 2 * 27
    assert c["wilson_full"]["plain_calls"] == 1
    # bf16 accuracy: about 2^-8 relative
    _close_rel(x, xj, tol=5e-2)


def test_packed_layout_mixed(problem):
    up, bp = tl.pack_gauge(problem["ut"]), tl.pack_spinor(problem["bt"])
    x, st = tplan.solve(tplan.SolverPlan(operator="full", precision="mixed"),
                        up, bp, MASS, tol=TOL, layout="packed", device="cpu")
    assert (st.iterations, st.outer_iterations) == (35, 5)
    assert x.dtype == torch.float32 and bool(st.verified)


# ---------------------------------------------------------------------------
# the plan's rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,err,match", [
    (dict(precision="mixed", solver="pipecg"), ValueError, "reliable-update"),
    (dict(precision="low", solver="blockcg", operator="full"), ValueError,
     "reliable-update"),
    (dict(precision="low"), ValueError, "full operator only"),
    (dict(precision="mixed", low="float64"), NotImplementedError,
     "float16"),
    (dict(precision="low", operator="full", low="float64"),
     NotImplementedError, "float16"),
    (dict(precision="mixed", low="bf8"), ValueError, "unknown dtype"),
])
def test_plan_rules(kw, err, match):
    with pytest.raises(err, match=match):
        tplan.SolverPlan(**kw)


def test_plan_rules_that_pass(problem):
    assert tplan.SolverPlan(precision="mixed").low_dtype == torch.bfloat16
    assert tplan.SolverPlan(precision="mixed",
                            low=torch.float32).low_dtype == torch.float32
    # the kernels store float16 too (Queue B item 9); the reference
    # backend has no storage limit; single ignores ``low``
    assert tplan.SolverPlan(precision="mixed",
                            low="float16").low_dtype == torch.float16
    assert tplan.SolverPlan(precision="low", operator="full",
                            low="float16").low_dtype == torch.float16
    tplan.SolverPlan(precision="mixed", low="float64", backend="reference")
    tplan.SolverPlan(low="float64")
    with pytest.raises(NotImplementedError, match="batched mixed"):
        tplan.solve(tplan.SolverPlan(precision="mixed", nrhs=2),
                    problem["ut"], problem["batch_t"][:2], MASS,
                    device="cpu")
    with pytest.raises(NotImplementedError, match="float16"):
        tk.wilson_hop(*(torch.zeros(4, 4, 4, 4, 18, 2, dtype=torch.float64)
                        for _ in range(2)),
                      torch.zeros(4, 4, 4, 24, 2, dtype=torch.float64),
                      parity=0)
    assert tk.wilson_hop(*(torch.zeros(4, 4, 4, 4, 18, 2, dtype=torch.float16)
                           for _ in range(2)),
                         torch.zeros(4, 4, 4, 24, 2, dtype=torch.float16),
                         parity=0).dtype == torch.float16
    with pytest.raises(ValueError, match="one dtype"):
        tk.wilson_full(torch.zeros(4, 4, 4, 4, 18, 4),
                       torch.zeros(4, 4, 4, 24, 4, dtype=torch.bfloat16), MASS)


def test_cli_defaults_are_jax_defaults(capsys):
    """The CLI's defaults are the JAX CLI's: --parity full --solver mpcg."""
    args = ["--lattice", "4x4x4x4", "--device", "cpu", "--mass", "0.1"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert "operator=full" in out and "precision=mixed" in out
    assert "verdict: converged verified=True" in out and "outer=" in out
    # cg16 runs and reports FAIL (not accurate to tol by design)
    assert cli.main(args + ["--solver", "cg16"]) == 1
    assert "precision=low" in capsys.readouterr().out
    # pipecg, refused before the solvers of ROADMAP item 9 were ported
    assert cli.main(args + ["--solver", "pipecg"]) == 0
    assert "solver=pipecg" in capsys.readouterr().out
