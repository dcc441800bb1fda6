"""SolverPlan — the one declarative entry point of the port's solve stack.

A :class:`SolverPlan` names a solve as data (operator, operator family,
backend, Krylov loop, batch shape, precision, mesh) and :func:`solve`
runs it.  The port carries two operators, single device, one RHS or a
batch, for every registered operator family:

* ``"eo-schur"`` (default) — the paper's solve on the even-odd Schur
  complement (:func:`_solve_eo`): CGNR, pipelined CG (``"pipecg"``) or
  block CG (``"blockcg"``, a batch sharing one Krylov space), or with
  ``precision="mixed"`` the reliable-update mpcg with a bf16 inner CG
  (:func:`_solve_eo_mp`, one RHS);
* ``"full"`` — the same loops on the full-lattice normal operator D^dag D
  (:func:`_solve_full`), in the natural layout or, with
  ``layout="packed"``, on packed real fields in and out; with
  ``precision="mixed"`` mpcg, with ``"low"`` an all-bf16 CG (cg16, not
  accurate to ``tol``: a measurement rig, verified False by design).

Precisions: ``"single"`` (f32), ``"mixed"`` (bulk iterations in ``low``
storage, true residuals and the solution in f32) and ``"low"``.

Backends:

* ``"kernels"`` (default) — packed fields through the port's CUDA
  kernels: the parity hop kernel (four launches per Schur normal matvec)
  and, for CGNR, the fused CG vector kernels; or the full-lattice kernel
  (two launches per normal matvec, plain vector algebra as in the JAX
  package).  ``low`` storage goes through the kernels' bf16 instances.
  On CPU tensors each kernel's plain PyTorch version runs instead.
* ``"reference"`` — the plain operators: natural-layout complex einsums
  for ``"eo-schur"``, the packed einsum operator for ``"full"``.

:func:`harvest_deflation` solves one system and returns an EigCG
deflation basis that later single-precision CGNR or block CG solves on
the same gauge field take as ``deflation=``.  Plan fields outside the
port raise ``NotImplementedError`` naming their ROADMAP item.  Every
solve ends with one verification matvec (:func:`_attach_verification`):
the natural-layout operator, or for ``layout="packed"`` the full-lattice
kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import solvers
from repro_torch.core.eo import (EOContext, back_substitute_odd,
                                 eo_context, schur_rhs)
from repro_torch.core.lattice import (complex_to_real_pair, field_norm2,
                                      field_norm2_batched, pack_gauge,
                                      pack_spinor, real_pair_to_complex,
                                      resolve_device, unpack_spinor)
from repro_torch.core.operators import (SiteTerm, dslash_g, get_operator,
                                        schur_normal_op_g, unknown_name)
from repro_torch.core.precision import parse_dtype

Tensor = torch.Tensor

_OPERATORS = ("full", "eo-schur")
_BACKENDS = ("reference", "kernels")
_SOLVERS = ("cgnr", "pipecg", "blockcg")
_PRECISIONS = ("single", "mixed", "low")

# where each plan field outside this slice is scheduled (ROADMAP.md)
_NOT_PORTED = {
    "mesh": "mesh plans are multi-device; ROADMAP Queue A item 12",
    "checkpoint": "checkpointed (segmented, durable) solves are ROADMAP "
                  "Queue A item 10",
}

# the low storage the kernels have instances for
_KERNEL_LOW = (torch.bfloat16, torch.float32)


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """A solve, described declaratively.

    Fields:
      operator:  "eo-schur" (CGNR on the half-size Schur complement) or
        "full" (CGNR on the full-lattice normal operator).
      operator_family: a registered lattice operator ("wilson",
        "twisted-mass"); ``mu`` is the twisted-mass parameter.
      backend:   "kernels" (packed fields, CUDA kernels) or "reference".
      solver:    "cgnr", "pipecg" (pipelined CG: one fused reduction an
        iteration) or "blockcg" (block CGNR: the N right-hand sides share
        one Krylov search space through N x N Gram solves; needs
        ``nrhs`` and single precision).
      precision: "single", "mixed" (reliable-update mpcg: bulk iterations
        in ``low``, true residuals wide) or "low" (all-low cg16, the full
        operator only).
      low:       the narrow dtype (name or torch dtype) for mixed/low;
        the kernels backend stores bfloat16 or float32.
      nrhs:      None for one RHS, or N for a masked batch of N.
      mesh:      None (multi-device plans are not ported yet).
      r:         Wilson parameter (the kernels need r = 1).
    """

    operator: str = "eo-schur"
    operator_family: str = "wilson"
    mu: float = 0.0
    backend: str = "kernels"
    solver: str = "cgnr"
    precision: str = "single"
    low: object = "bfloat16"
    nrhs: int | None = None
    mesh: object | None = None
    r: float = 1.0

    def __post_init__(self):
        for name, value, allowed in (("operator", self.operator, _OPERATORS),
                                     ("backend", self.backend, _BACKENDS),
                                     ("solver", self.solver, _SOLVERS),
                                     ("precision", self.precision,
                                      _PRECISIONS)):
            if value not in allowed:
                raise ValueError("SolverPlan: " + unknown_name(
                    f"SolverPlan.{name}", value, allowed))
        spec = get_operator(self.operator_family)
        if self.mu != 0.0 and "mu" not in spec.params:
            raise ValueError(
                f"SolverPlan: operator family {spec.name!r} has no site "
                f"parameter 'mu' (got mu={self.mu}); pick a family that "
                "declares it, e.g. operator_family='twisted-mass'")
        if self.precision in ("mixed", "low") and self.solver in ("pipecg",
                                                                  "blockcg"):
            raise ValueError(
                "SolverPlan: the mixed/low precision paths use the "
                f"reliable-update CG loop; solver={self.solver!r} composes "
                "with precision='single' only")
        if self.solver == "blockcg" and self.nrhs is None:
            raise ValueError(
                "SolverPlan: solver='blockcg' shares one Krylov space "
                "across a batch of right-hand sides; set nrhs (a single "
                "RHS has nothing to share — use solver='cgnr')")
        if self.precision == "low" and self.operator != "full":
            raise ValueError(
                "SolverPlan: precision='low' (all-low cg16) exists for the "
                "full operator only")
        if self.nrhs is not None and self.nrhs < 1:
            raise ValueError(f"SolverPlan.nrhs must be >= 1, got {self.nrhs}")
        if self.precision != "single":
            try:
                low = self.low_dtype
            except KeyError:
                raise ValueError(f"SolverPlan.low: unknown dtype "
                                 f"{self.low!r}") from None
            if self.backend == "kernels" and low not in _KERNEL_LOW:
                raise NotImplementedError(
                    f"SolverPlan.low={self.low!r}: the kernels store "
                    "bfloat16 or float32; other narrow storage (float16) "
                    "is ROADMAP Queue B item 9")
        if self.mesh is not None:
            raise NotImplementedError("SolverPlan.mesh: "
                                      + _NOT_PORTED["mesh"])

    @property
    def batched(self) -> bool:
        return self.nrhs is not None

    def cache_key(self) -> tuple:
        """The plan's hashable identity: every field that shapes a solve.
        A deflation basis belongs to the key of the plan that harvested
        it, with the same gauge field and mass."""
        return (self.operator, self.operator_family, self.mu, self.backend,
                self.solver, self.precision, str(self.low), self.nrhs,
                self.mesh, self.r)

    @property
    def low_dtype(self):
        return parse_dtype(self.low)

    @property
    def twist(self) -> float:
        """The family's site-term twist (0.0 for Wilson)."""
        return float(self.site_term(0.0).twist)

    def site_term(self, mass) -> SiteTerm:
        spec = get_operator(self.operator_family)
        kw = {name: getattr(self, name) for name in spec.params}
        return spec.make_site_term(mass, self.r, **kw)


def _family_site(plan: SolverPlan, mass) -> SiteTerm:
    """The family's site term, checked against the transport contract: the
    kernels fold the scale as ``mass + 4r``, so a family may vary only
    the twist."""
    site = plan.site_term(float(mass))
    expected = float(mass) + 4.0 * plan.r
    if float(site.scale) != expected:
        raise NotImplementedError(
            f"operator family {plan.operator_family!r} declared site "
            f"scale {float(site.scale)!r} but the transport kernels fold "
            f"mass + 4r = {expected!r}")
    return site


def resolve(plan: SolverPlan, u: Tensor, mass, *,
            out_dtype=torch.complex64) -> EOContext:
    """Resolve an even-odd plan to its bound blocks, converters and engine."""
    if plan.operator != "eo-schur":
        raise ValueError("resolve() returns the even-odd context; "
                         f"plan.operator={plan.operator!r} resolves inside "
                         "solve()")
    return eo_context(u, mass, r=plan.r,
                      twist=_family_site(plan, mass).twist,
                      use_kernels=plan.backend == "kernels",
                      batched=plan.batched, out_dtype=out_dtype)


# Post-solve verification gate: ||b - D x|| <= VERIFY_FACTOR * tol * ||b||.
# The slack absorbs the gap between the CGNR stopping rule (residual of the
# normal equations) and the original system's residual.
VERIFY_FACTOR = 10.0


def _attach_verification(plan: SolverPlan, u: Tensor, b: Tensor, mass,
                         x: Tensor, stats: solvers.SolveStats, tol,
                         layout: str = "natural") -> solvers.SolveStats:
    """One extra matvec: the true residual of ``D x = b``.

    The oracle is the family's natural-layout ``dslash_g``, independent
    of the Schur and normal-equation transforms the solver iterated on
    and of the kernels, so a broken transport cannot vouch for itself.
    Packed solves verify through the full-lattice kernel, the same
    operator on the wire format.  Fills ``true_residual_norm2`` and
    ``verified`` and turns the verdict NONFINITE when the true residual
    is not finite."""
    site = _family_site(plan, mass)
    if layout == "packed":
        from repro_torch.kernels.wilson_dslash import ops as wops
        ax = wops.dslash(u, x, float(mass), twist=site.twist,
                         use_kernels=plan.backend == "kernels")
    else:
        apply_d = lambda v: dslash_g(u, v, mass, r=plan.r, twist=site.twist)
        if plan.batched:
            ax = torch.stack([apply_d(x[n]) for n in range(x.shape[0])])
        else:
            ax = apply_d(x)
    r_true = b - ax.to(b.dtype)
    norm2_fn = field_norm2_batched if plan.batched else field_norm2
    rs_true = norm2_fn(r_true).real
    bs = norm2_fn(b).real
    tol_a = torch.as_tensor(tol, device=rs_true.device).to(rs_true.dtype)
    gate = (VERIFY_FACTOR * tol_a) ** 2 * bs
    finite = torch.isfinite(rs_true)
    verified = (rs_true <= gate) & finite
    verdict = stats.verdict
    if verdict is not None:
        verdict = torch.where(finite, verdict,
                              torch.full_like(verdict, solvers.NONFINITE))
    return stats._replace(true_residual_norm2=rs_true, verified=verified,
                          verdict=verdict)


def _check_batch_shape(plan: SolverPlan, b: Tensor, layout: str):
    base = 6 if layout == "natural" else 5
    want = base + 1 if plan.batched else base
    if b.dim() != want:
        raise ValueError(
            f"plan.nrhs={plan.nrhs} expects a rank-{want} {layout} RHS, "
            f"got shape {tuple(b.shape)}")
    if plan.batched and b.shape[0] != plan.nrhs:
        raise ValueError(f"plan.nrhs={plan.nrhs} but RHS batch axis has "
                         f"extent {b.shape[0]}")


def solve(plan: SolverPlan, u, b, mass, *, tol: float = 1e-8,
          maxiter: int = 1000, inner_tol: float = 5e-2,
          inner_maxiter: int = 200, max_outer: int = 50,
          residual_replacement_every: int = 25, layout: str = "natural",
          checkpoint=None, deflation: solvers.DeflationBasis | None = None,
          device="cuda") -> tuple[Tensor, solvers.SolveStats]:
    """Execute a :class:`SolverPlan`.

    Args:
      u, b: gauge field and right-hand side, tensors or arrays, moved to
        ``device``.  ``layout="natural"``: complex (4,T,Z,Y,X,3,3) and
        (T,Z,Y,X,4,3); ``layout="packed"`` (the full operator only):
        float32 (4,T,Z,Y,18,X) and (T,Z,Y,24,X).  The RHS has a leading
        N axis when ``plan.nrhs`` is set.
      tol/maxiter: CG stopping rule (relative, per RHS when batched).
      inner_tol/inner_maxiter/max_outer: the mixed precision's inner CG
        stopping rule and its number of reliable updates.
      residual_replacement_every: pipecg's drift control (0: never).
      checkpoint: not ported yet; anything but None raises.
      deflation: a :class:`solvers.DeflationBasis` from
        :func:`harvest_deflation` on the same gauge field, family, mass
        and backend: the solve starts from the Galerkin projection of the
        RHS on the basis (single-precision ``"cgnr"``/``"blockcg"``); the
        verification still gates against the original system, so a stale
        basis fails loudly.
      device: where the solve runs, ``"cuda"`` unless the caller asks for
        ``"cpu"`` (then each kernel's plain version runs).
    Returns:
      (x, SolveStats): x in the layout of ``b``; per-RHS stats fields
      when batched.
    """
    if layout not in ("natural", "packed"):
        raise ValueError(f"layout must be 'natural' or 'packed', "
                         f"got {layout!r}")
    if layout == "packed" and plan.operator != "full":
        raise ValueError("layout='packed' is the full-operator contract; "
                         "the even-odd path takes natural-layout fields")
    if deflation is not None and (
            plan.mesh is not None or checkpoint is not None
            or plan.solver == "pipecg" or plan.precision != "single"):
        raise NotImplementedError(
            "deflation composes with the single-device single-precision "
            "cg paths (solver='cgnr'/'blockcg', no checkpoint); got "
            f"solver={plan.solver!r} precision={plan.precision!r} "
            f"mesh={'set' if plan.mesh is not None else None} "
            f"checkpoint={'set' if checkpoint is not None else None}")
    if checkpoint is not None:
        raise NotImplementedError("solve(checkpoint=...): "
                                  + _NOT_PORTED["checkpoint"])
    dev = resolve_device(device)
    u = torch.as_tensor(u, device=dev)
    b = torch.as_tensor(b, device=dev)
    _check_batch_shape(plan, b, layout)
    kw = dict(tol=tol, maxiter=maxiter, inner_tol=inner_tol,
              inner_maxiter=inner_maxiter, max_outer=max_outer,
              residual_replacement_every=residual_replacement_every,
              deflation=deflation)
    if plan.operator == "full":
        x, stats = _solve_full(plan, u, b, mass, layout=layout, **kw)
    elif plan.precision == "mixed":
        if plan.batched:
            raise NotImplementedError(
                "batched mixed-precision eo-schur is not wired yet (as in "
                "the JAX package); drop nrhs or precision")
        x, stats = _solve_eo_mp(plan, u, b, mass, **kw)
    else:
        x, stats = _solve_eo(plan, u, b, mass, **kw)
    return x, _attach_verification(plan, u, b, mass, x, stats, tol,
                                   layout=layout)


def harvest_deflation(plan: SolverPlan, u, b, mass, *, tol: float = 1e-8,
                      maxiter: int = 1000, nev: int = 8, m_max: int = 48,
                      verify_tol: float | None = None, device="cuda",
                      ) -> tuple[Tensor, solvers.SolveStats,
                                 solvers.DeflationBasis]:
    """Solve one system and harvest a :class:`solvers.DeflationBasis`.

    Runs :func:`solvers.cg_harvest` (the plain CG trajectory, one Lanczos
    vector recorded an iteration in an ``m_max``-deep buffer on the
    device) on the plan's Schur normal operator, then condenses the
    records into the ``nev`` smallest Ritz pairs (the tridiagonal on the
    host, the vectors on the device).  The basis lives in the plan's
    working layout: reuse it through ``solve(..., deflation=basis)`` on
    the same gauge field, mass, family and backend.

    Returns ``(x, stats, basis)``; ``stats.matvecs`` includes the
    ``min(nev, iterations)`` matvecs of the projection ``W^H A W``.
    Verification gates at ``verify_tol`` (default ``tol``): a harvest
    iterates past the served tolerance to mine spectrum, and f32 cannot
    push the true residual below ~1e-7 relative.  Single-device,
    single-precision, single-RHS eo-schur only.
    """
    if (plan.operator != "eo-schur" or plan.precision != "single"
            or plan.batched or plan.mesh is not None):
        raise NotImplementedError(
            "harvest_deflation needs the single-device single-precision "
            "unbatched eo-schur path; got "
            f"operator={plan.operator!r} precision={plan.precision!r} "
            f"nrhs={plan.nrhs} mesh="
            f"{'set' if plan.mesh is not None else None}")
    dev = resolve_device(device)
    u = torch.as_tensor(u, device=dev)
    b = torch.as_tensor(b, device=dev)
    _check_batch_shape(plan, b, "natural")
    ctx = resolve(plan, u, mass, out_dtype=b.dtype)
    b_e, b_o = ctx.prepare(b)
    ops = ctx.ops
    a_hat = lambda v: ops.dhat_dag(ops.dhat(v))  # noqa: E731
    x_e, stats, (vbuf, albuf, bebuf) = solvers.cg_harvest(
        a_hat, schur_rhs(ops, b_e, b_o), tol=tol, maxiter=maxiter,
        m_max=m_max)
    k = stats.iterations
    basis = solvers.ritz_deflation_basis(a_hat, vbuf, albuf, bebuf, k, nev)
    del vbuf
    n_eff = max(1, min(nev, k, int(m_max)))
    stats = stats._replace(matvecs=stats.matvecs + n_eff)
    x = ctx.finish(x_e, back_substitute_odd(ops, b_o, x_e))
    stats = _attach_verification(
        plan, u, b, mass, x, stats,
        tol if verify_tol is None else float(verify_tol))
    return x, stats, basis


def _solve_eo(plan, u, b, mass, *, tol, maxiter, residual_replacement_every,
              deflation, **_):
    """CGNR (through the fused CG kernels on the kernels backend),
    pipelined CG or block CG on the Schur normal equations, then the odd
    half back-substituted.  Pipecg and block CG run plain vector algebra,
    as in the JAX package (their recurrences have another shape)."""
    ctx = resolve(plan, u, mass, out_dtype=b.dtype)
    b_e, b_o = ctx.prepare(b)
    ops = ctx.ops
    a_hat = lambda v: ops.dhat_dag(ops.dhat(v))  # noqa: E731
    rhs = schur_rhs(ops, b_e, b_o)
    x0 = None if deflation is None else solvers.deflate_x0(deflation, rhs)
    if plan.solver == "pipecg":
        x_e, stats = solvers.pipecg(
            a_hat, rhs, tol=tol, maxiter=maxiter,
            residual_replacement_every=residual_replacement_every,
            batched=ctx.batched)
    elif plan.solver == "blockcg":
        x_e, stats = solvers.blockcg(a_hat, rhs, x0, tol=tol,
                                     maxiter=maxiter)
    else:
        engine = {}
        if ctx.engine is not None:
            engine = dict(update=ctx.engine[0], xpay=ctx.engine[1])
        x_e, stats = solvers.cg(a_hat, rhs, x0, tol=tol, maxiter=maxiter,
                                batched=ctx.batched, **engine)
    return ctx.finish(x_e, back_substitute_odd(ops, b_o, x_e)), stats


def _solve_eo_mp(plan, u, b, mass, *, tol, inner_tol, inner_maxiter,
                 max_outer, **_):
    """Even-odd + mixed precision: a low-storage inner CG, wide reliable
    updates and back-substitution.

    Kernels backend: the low representation is the packed half field in
    ``low`` storage (the kernels read it narrow and compute in f32), the
    links rounded once; casts only at the reliable-update boundary; the
    inner CG runs on the bf16 hop kernel and the fused CG kernels.
    Reference backend: the bf16 real-pair view of the complex half field,
    the links rounded once up front.
    """
    low_dtype = plan.low_dtype
    twist = _family_site(plan, mass).twist
    ctx = resolve(plan, u, mass, out_dtype=b.dtype)
    b_e, b_o = ctx.prepare(b)
    ops = ctx.ops
    if plan.backend == "kernels":
        from repro_torch.kernels.wilson_dslash import ops as wops

        u_e_lo, u_o_lo = ops.u_e.to(low_dtype), ops.u_o.to(low_dtype)

        def a_low(w):  # low storage in and out, f32 inside the kernels
            return wops.schur_normal_op(u_e_lo, u_o_lo, w, mass, twist=twist)

        def a_high(v):
            return wops.schur_normal_op(ops.u_e, ops.u_o, v, mass,
                                        twist=twist)

        to_low = to_high = None   # mpcg's storage casts
    else:
        high = b.dtype

        def round_links(w):
            return real_pair_to_complex(complex_to_real_pair(w, low_dtype),
                                        w.dtype)

        u_e_lo, u_o_lo = round_links(ops.u_e), round_links(ops.u_o)

        def a_low(w):  # bf16 real pairs in and out, wide inside
            v = real_pair_to_complex(w, high)
            av = schur_normal_op_g(u_e_lo, u_o_lo, v, mass, r=plan.r,
                                   twist=twist)
            return complex_to_real_pair(av, low_dtype)

        def a_high(v):
            return schur_normal_op_g(ops.u_e, ops.u_o, v, mass, r=plan.r,
                                     twist=twist)

        def to_low(v):
            return complex_to_real_pair(v, low_dtype)

        def to_high(w):
            return real_pair_to_complex(w, high)

    engine = {}
    if ctx.engine is not None:
        engine = dict(update=ctx.engine[0], xpay=ctx.engine[1])
    (x_e, x_o), stats = solvers.mpcg_eo(
        a_low, a_high, ops.dhat_dag, ops.d_eo, ops.d_oe, ops.m_inv, b_e, b_o,
        tol=tol, inner_tol=inner_tol, inner_maxiter=inner_maxiter,
        max_outer=max_outer, low_dtype=low_dtype, to_low=to_low,
        to_high=to_high, **engine)
    return ctx.finish(x_e, x_o), stats


def _solve_full(plan, u, b, mass, *, tol, maxiter, layout, inner_tol,
                inner_maxiter, max_outer, residual_replacement_every,
                deflation):
    """CGNR, pipelined CG or block CG on D^dag D over packed full-lattice
    fields: the right-hand side D^dag b is one launch of the full-lattice
    kernel, every matvec two, and the vector algebra is plain tensor code,
    as in the JAX package.  ``precision="mixed"``: mpcg, its inner CG on
    ``low`` fields and links (rounded once), each reliable update two f32
    launches; ``"low"``: cg16, the whole CG on ``low`` storage."""
    from repro_torch.kernels.wilson_dslash import ops as wops

    if plan.r != 1.0:
        raise NotImplementedError(
            "the full-lattice operator hard-codes r=1 (its spin-projection "
            f"tables need the rank-2 projectors (1 -+ gamma_mu)); got "
            f"r={plan.r}")
    packed_in = layout == "packed"
    up = u if packed_in else pack_gauge(u)
    pp = b if packed_in else pack_spinor(b)
    m = float(mass)
    kw = dict(twist=_family_site(plan, mass).twist,
              use_kernels=plan.backend == "kernels")
    op_hi = lambda v: wops.normal_op(up, v, m, **kw)  # noqa: E731
    rhs = wops.dslash_dagger(up, pp, m, **kw)
    x0 = None if deflation is None else solvers.deflate_x0(deflation, rhs)
    if plan.precision == "single":
        if plan.solver == "pipecg":
            x, stats = solvers.pipecg(
                op_hi, rhs, tol=tol, maxiter=maxiter,
                residual_replacement_every=residual_replacement_every,
                batched=plan.batched)
        elif plan.solver == "blockcg":
            x, stats = solvers.blockcg(op_hi, rhs, x0, tol=tol,
                                       maxiter=maxiter)
        else:
            x, stats = solvers.cg(op_hi, rhs, x0, tol=tol, maxiter=maxiter,
                                  batched=plan.batched)
    else:
        low_dtype = plan.low_dtype
        up_lo = up.to(low_dtype)
        op_lo = lambda v: wops.normal_op(up_lo, v, m, **kw)  # noqa: E731
        if plan.precision == "mixed":
            x, stats = solvers.mpcg(
                op_lo, op_hi, rhs, tol=tol, inner_tol=inner_tol,
                inner_maxiter=inner_maxiter, max_outer=max_outer,
                low_dtype=low_dtype, batched=plan.batched)
        else:  # "low": all-low cg16, NOT accurate to tol (a measurement rig)
            x, stats = solvers.cg(op_lo, rhs.to(low_dtype), tol=tol,
                                  maxiter=maxiter, batched=plan.batched)
            x = x.to(pp.dtype)
    if packed_in:
        return x, stats
    return unpack_spinor(x, dtype=b.dtype), stats
