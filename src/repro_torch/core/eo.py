"""Even-odd (red-black) Schur-preconditioned Wilson solves.

* :func:`eo_operators` / :func:`eo_operators_packed` — the parity blocks
  of D bound to a gauge field: natural-layout reference, or packed half
  fields through the port's kernels;
* :func:`eo_context` — blocks + RHS/solution layout converters + the
  fused vector engine, derived once per (backend, batch shape);
* :func:`solve_wilson_eo` / :func:`solve_wilson_eo_batched` /
  :func:`solve_wilson_eo_mp` — forwarders to
  :func:`repro_torch.core.plan.solve`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import solvers
from repro_torch.core.lattice import (merge_eo, pack_gauge, pack_spinor,
                                      split_eo, split_eo_gauge,
                                      unpack_spinor)
from repro_torch.core.operators import SiteTerm, schur_dagger_g, schur_op_g
from repro_torch.core.wilson import dslash_eo, dslash_oe

Tensor = torch.Tensor


class EOOperators(NamedTuple):
    """The parity blocks of D, bound to a gauge field, as callables."""

    dhat: solvers.Op       # Schur operator on even half fields
    dhat_dag: solvers.Op   # its gamma5-adjoint
    d_eo: solvers.Op       # odd -> even hopping block
    d_oe: solvers.Op       # even -> odd hopping block
    m_inv: solvers.Op      # M_oo^{-1} (site-term inverse)
    u_e: Tensor            # per-parity link fields
    u_o: Tensor


def eo_operators(u: Tensor, mass, r: float = 1.0,
                 twist: float = 0.0) -> EOOperators:
    """Natural-layout Schur-system blocks (single RHS)."""
    u_e, u_o = split_eo_gauge(u)
    site = SiteTerm(mass + 4.0 * r, twist)
    return EOOperators(
        dhat=lambda v: schur_op_g(u_e, u_o, v, mass, r=r, twist=twist),
        dhat_dag=lambda v: schur_dagger_g(u_e, u_o, v, mass, r=r,
                                          twist=twist),
        d_eo=lambda v: dslash_eo(u_e, u_o, v, r=r),
        d_oe=lambda v: dslash_oe(u_e, u_o, v, r=r),
        m_inv=site.solve,
        u_e=u_e, u_o=u_o)


def eo_operators_packed(u: Tensor, mass, r: float = 1.0, *,
                        twist: float = 0.0) -> EOOperators:
    """The Schur-system blocks on PACKED half fields through the hop kernel.

    The callables take (T, Z, Y, 24, Xh) half fields or (N, ...) batches.
    The kernel's projector tables need r = 1; other r raise
    ``NotImplementedError`` (use :func:`eo_operators`).
    """
    if r != 1.0:
        raise NotImplementedError(
            "the packed parity hop kernel hard-codes r=1 (its spin-projection "
            f"tables need the rank-2 projectors (1 -+ gamma_mu)); got r={r}. "
            "Use the natural-layout blocks (backend='reference').")
    from repro_torch.kernels.wilson_dslash import ops as wops

    u_e, u_o = split_eo_gauge(u)
    upe, upo = pack_gauge(u_e), pack_gauge(u_o)
    site = SiteTerm(mass + 4.0 * r, twist)
    return EOOperators(
        dhat=lambda v: wops.schur_op(upe, upo, v, mass, twist=twist),
        dhat_dag=lambda v: wops.schur_op(upe, upo, v, mass, twist=twist,
                                         dagger=True),
        d_eo=lambda v: wops.dslash_eo(upe, upo, v),
        d_oe=lambda v: wops.dslash_oe(upe, upo, v),
        m_inv=site.solve,
        u_e=upe, u_o=upo)


def schur_rhs(ops: EOOperators, b_e: Tensor, b_o: Tensor) -> Tensor:
    """The Schur normal-equation RHS ``D_hat^dag (b_e - D_eo M_oo^-1 b_o)``."""
    return ops.dhat_dag(b_e - ops.d_eo(ops.m_inv(b_o)))


def back_substitute_odd(ops: EOOperators, b_o: Tensor, x_e: Tensor) -> Tensor:
    """Recover the odd half field: ``x_o = M_oo^-1 (b_o - D_oe x_e)``."""
    return ops.m_inv(b_o - ops.d_oe(x_e))


class EOContext(NamedTuple):
    """A resolved even-odd solve: blocks + layout converters + engine.

    ``prepare`` maps the natural-layout RHS to the two working-layout half
    fields, ``finish`` maps the half solutions back; ``engine`` is the
    fused (update, xpay) pair on the packed path, else None.
    """

    ops: EOOperators
    prepare: Callable[[Tensor], tuple[Tensor, Tensor]]
    finish: Callable[[Tensor, Tensor], Tensor]
    engine: tuple[Callable, Callable] | None
    batched: bool


def _per_rhs(fn):
    """Apply a single-RHS op to every slice of a leading batch axis."""
    return lambda v: torch.stack([fn(v[n]) for n in range(v.shape[0])])


def _split_batch(b: Tensor) -> tuple[Tensor, Tensor]:
    halves = [split_eo(b[n]) for n in range(b.shape[0])]
    return (torch.stack([h[0] for h in halves]),
            torch.stack([h[1] for h in halves]))


def eo_context(u: Tensor, mass, *, r: float = 1.0, twist: float = 0.0,
               use_kernels: bool = True, batched: bool = False,
               out_dtype=torch.complex64) -> EOContext:
    """Resolve the even-odd solve pieces for one (backend, batch) shape."""
    if use_kernels:
        ops = eo_operators_packed(u, mass, r=r, twist=twist)

        def prepare(b: Tensor) -> tuple[Tensor, Tensor]:
            b_e, b_o = _split_batch(b) if batched else split_eo(b)
            return pack_spinor(b_e), pack_spinor(b_o)

        def finish(x_e: Tensor, x_o: Tensor) -> Tensor:
            xe = unpack_spinor(x_e, dtype=out_dtype)
            xo = unpack_spinor(x_o, dtype=out_dtype)
            if batched:
                return torch.stack([merge_eo(xe[n], xo[n])
                                    for n in range(xe.shape[0])])
            return merge_eo(xe, xo)

        from repro_torch.kernels.cg_fused import ops as cg_ops
        engine = (cg_ops.fused_engine_batched() if batched
                  else cg_ops.fused_engine())
        return EOContext(ops=ops, prepare=prepare, finish=finish,
                         engine=engine, batched=batched)

    ops = eo_operators(u, mass, r=r, twist=twist)
    if batched:
        ops = ops._replace(dhat=_per_rhs(ops.dhat),
                           dhat_dag=_per_rhs(ops.dhat_dag),
                           d_eo=_per_rhs(ops.d_eo), d_oe=_per_rhs(ops.d_oe))
        return EOContext(
            ops=ops, prepare=_split_batch,
            finish=lambda xe, xo: torch.stack(
                [merge_eo(xe[n], xo[n]) for n in range(xe.shape[0])]),
            engine=None, batched=True)
    return EOContext(ops=ops, prepare=split_eo, finish=merge_eo,
                     engine=None, batched=False)


# ---------------------------------------------------------------------------
# Entry points — forwarders to the SolverPlan machinery
# ---------------------------------------------------------------------------


def solve_wilson_eo(u: Tensor, b: Tensor, mass, *, r: float = 1.0,
                    tol: float = 1e-8, maxiter: int = 1000,
                    backend: str = "kernels", device="cuda",
                    ) -> tuple[Tensor, solvers.SolveStats]:
    """Solve D x = b by CGNR on the even-sublattice Schur complement
    (natural-layout u, b in; merged natural x out)."""
    from repro_torch.core import plan as plan_mod
    p = plan_mod.SolverPlan(operator="eo-schur", backend=backend, r=r)
    return plan_mod.solve(p, u, b, mass, tol=tol, maxiter=maxiter,
                          device=device)


def solve_wilson_eo_batched(u: Tensor, b: Tensor, mass, *, r: float = 1.0,
                            tol: float = 1e-8, maxiter: int = 1000,
                            backend: str = "kernels", device="cuda",
                            ) -> tuple[Tensor, solvers.SolveStats]:
    """Solve D x_n = b_n for a batch (N, T, Z, Y, X, 4, 3) in one masked CG
    loop; every x_n equals the single-RHS solve of b_n."""
    if b.dim() != 7:
        raise ValueError(
            f"batched RHS must be (N, T, Z, Y, X, 4, 3); got "
            f"{tuple(b.shape)}. For a single RHS use solve_wilson_eo.")
    from repro_torch.core import plan as plan_mod
    p = plan_mod.SolverPlan(operator="eo-schur", backend=backend,
                            nrhs=b.shape[0], r=r)
    return plan_mod.solve(p, u, b, mass, tol=tol, maxiter=maxiter,
                          device=device)


def solve_wilson_eo_mp(u: Tensor, b: Tensor, mass, *, r: float = 1.0,
                       tol: float = 1e-6, inner_tol: float = 5e-2,
                       inner_maxiter: int = 200, max_outer: int = 50,
                       low_dtype=torch.bfloat16, backend: str = "kernels",
                       device="cuda") -> tuple[Tensor, solvers.SolveStats]:
    """Even-odd + mixed precision: a low-storage inner CG (``low_dtype``:
    bf16, or float16) on the half-size Schur normal system, f32 reliable
    updates and back-substitution.

    ``backend="kernels"``: the low representation is the packed half
    field in ``low_dtype`` storage, through the instances of that storage
    of the hop kernel and the fused CG kernels; links rounded to
    ``low_dtype`` once.  ``backend="reference"``: the low real-pair view
    of the complex half field.  Forwards to :func:`repro_torch.core.plan.solve` with
    ``SolverPlan(operator="eo-schur", precision="mixed", low=low_dtype)``.
    """
    from repro_torch.core import plan as plan_mod
    p = plan_mod.SolverPlan(operator="eo-schur", backend=backend,
                            precision="mixed", low=low_dtype, r=r)
    return plan_mod.solve(p, u, b, mass, tol=tol, inner_tol=inner_tol,
                          inner_maxiter=inner_maxiter, max_outer=max_outer,
                          device=device)
