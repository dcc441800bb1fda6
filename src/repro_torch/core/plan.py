"""SolverPlan — the one declarative entry point of the port's solve stack.

A :class:`SolverPlan` names a solve as data (operator, operator family,
backend, batch shape, precision, mesh) and :func:`solve` runs it.  The
port carries two operators, single device, single precision, one RHS or
a masked batch, for every registered operator family:

* ``"eo-schur"`` (default) — the paper's solve: CGNR on the even-odd
  Schur complement (:func:`_solve_eo`);
* ``"full"`` — CGNR on the full-lattice normal operator D^dag D
  (:func:`_solve_full`), in the natural layout or, with
  ``layout="packed"``, on packed real fields in and out.

Backends:

* ``"kernels"`` (default) — packed fields through the port's CUDA
  kernels: the parity hop kernel (four launches per Schur normal matvec)
  and the fused CG vector kernels, or the full-lattice kernel (two
  launches per normal matvec, plain vector algebra as in the JAX
  package).  On CPU tensors each kernel's plain PyTorch version runs
  instead.
* ``"reference"`` — the plain operators: natural-layout complex einsums
  for ``"eo-schur"``, the packed einsum operator for ``"full"``.

Plan fields outside the port raise ``NotImplementedError`` naming their
ROADMAP item.  Every solve ends with one verification matvec
(:func:`_attach_verification`): the natural-layout operator, or for
``layout="packed"`` the full-lattice kernel.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import solvers
from repro_torch.core.eo import EOContext, eo_context
from repro_torch.core.lattice import (field_norm2, field_norm2_batched,
                                      pack_gauge, pack_spinor,
                                      resolve_device, unpack_spinor)
from repro_torch.core.operators import (SiteTerm, dslash_g, get_operator,
                                        unknown_name)

Tensor = torch.Tensor

_OPERATORS = ("full", "eo-schur")
_BACKENDS = ("reference", "kernels")
_SOLVERS = ("cgnr", "pipecg", "blockcg")
_PRECISIONS = ("single", "mixed", "low")

# where each plan field outside this slice is scheduled (ROADMAP.md)
_NOT_PORTED = {
    "mesh": "mesh plans are multi-device; ROADMAP Queue A item 12",
    "mixed": "precision='mixed' (reliable-update mpcg) is ROADMAP Queue A "
             "item 8",
    "low": "precision='low' (all-low cg16) is ROADMAP Queue A item 8",
    "pipecg": "solver='pipecg' is ROADMAP Queue A item 9",
    "blockcg": "solver='blockcg' is ROADMAP Queue A item 9",
    "checkpoint": "checkpointed (segmented, durable) solves are ROADMAP "
                  "Queue A item 10",
    "deflation": "deflated solves (EigCG basis, deflate_x0) are ROADMAP "
                 "Queue A item 9",
}


@dataclasses.dataclass(frozen=True)
class SolverPlan:
    """A solve, described declaratively.

    Fields:
      operator:  "eo-schur" (CGNR on the half-size Schur complement) or
        "full" (CGNR on the full-lattice normal operator).
      operator_family: a registered lattice operator ("wilson",
        "twisted-mass"); ``mu`` is the twisted-mass parameter.
      backend:   "kernels" (packed fields, CUDA kernels) or "reference".
      solver:    "cgnr" ("pipecg"/"blockcg" are not ported yet).
      precision: "single" ("mixed"/"low" are not ported yet).
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
        if self.nrhs is not None and self.nrhs < 1:
            raise ValueError(f"SolverPlan.nrhs must be >= 1, got {self.nrhs}")
        for field, value in (("operator", self.operator),
                             ("precision", self.precision),
                             ("solver", self.solver)):
            if value in _NOT_PORTED:
                raise NotImplementedError(f"SolverPlan.{field}: "
                                          + _NOT_PORTED[value])
        if self.mesh is not None:
            raise NotImplementedError("SolverPlan.mesh: "
                                      + _NOT_PORTED["mesh"])

    @property
    def batched(self) -> bool:
        return self.nrhs is not None

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
          maxiter: int = 1000, layout: str = "natural", checkpoint=None,
          deflation=None, device="cuda") -> tuple[Tensor, solvers.SolveStats]:
    """Execute a :class:`SolverPlan`.

    Args:
      u, b: gauge field and right-hand side, tensors or arrays, moved to
        ``device``.  ``layout="natural"``: complex (4,T,Z,Y,X,3,3) and
        (T,Z,Y,X,4,3); ``layout="packed"`` (the full operator only):
        float32 (4,T,Z,Y,18,X) and (T,Z,Y,24,X).  The RHS has a leading
        N axis when ``plan.nrhs`` is set.
      tol/maxiter: CG stopping rule (relative, per RHS when batched).
      checkpoint/deflation: not ported yet; anything but None raises.
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
    for name, value in (("checkpoint", checkpoint),
                        ("deflation", deflation)):
        if value is not None:
            raise NotImplementedError(f"solve({name}=...): "
                                      + _NOT_PORTED[name])
    dev = resolve_device(device)
    u = torch.as_tensor(u, device=dev)
    b = torch.as_tensor(b, device=dev)
    _check_batch_shape(plan, b, layout)
    if plan.operator == "full":
        x, stats = _solve_full(plan, u, b, mass, tol=tol, maxiter=maxiter,
                               layout=layout)
    else:
        x, stats = _solve_eo(plan, u, b, mass, tol=tol, maxiter=maxiter)
    return x, _attach_verification(plan, u, b, mass, x, stats, tol,
                                   layout=layout)


def _solve_eo(plan, u, b, mass, *, tol, maxiter):
    ctx = resolve(plan, u, mass, out_dtype=b.dtype)
    b_e, b_o = ctx.prepare(b)
    ops = ctx.ops
    engine = {}
    if ctx.engine is not None:
        engine = dict(update=ctx.engine[0], xpay=ctx.engine[1])
    (x_e, x_o), stats = solvers.cgnr_eo(
        ops.dhat, ops.dhat_dag, ops.d_eo, ops.d_oe, ops.m_inv, b_e, b_o,
        tol=tol, maxiter=maxiter, batched=ctx.batched, **engine)
    return ctx.finish(x_e, x_o), stats


def _solve_full(plan, u, b, mass, *, tol, maxiter, layout):
    """CGNR on D^dag D over packed full-lattice fields: the right-hand side
    D^dag b is one launch of the full-lattice kernel, every iteration two,
    and the vector algebra is plain tensor code, as in the JAX package."""
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
    x, stats = solvers.cgnr(lambda v: wops.dslash(up, v, m, **kw),
                            lambda v: wops.dslash_dagger(up, v, m, **kw),
                            pp, tol=tol, maxiter=maxiter,
                            batched=plan.batched)
    if packed_in:
        return x, stats
    return unpack_spinor(x, dtype=b.dtype), stats
