"""Krylov solvers of the main path: CG with an injectable vector engine,
CGNR on the full lattice, even-odd Schur-preconditioned CGNR, and the
mixed-precision reliable-update CG (``mpcg``, ``mpcg_eo``).

The JAX package runs its loop in ``lax.while_loop`` with no host syncs.
Here the loop is Python: ``cond`` reads the stop test (one small
device-to-host copy) once per iteration, which keeps the iteration count
exact, and ``body`` issues the matvec and the vector work without
waiting on the device.  Everything else follows the JAX solver:

* ``update(alpha, x, r, p, ap) -> (x', r', ||r'||^2)`` and
  ``xpay(beta, r, p[, gate]) -> p'`` inject the vector algebra (the fused
  kernels of :mod:`repro_torch.kernels.cg_fused`); the defaults are plain
  tensor expressions.
* ``batched=True``: operands carry a leading RHS axis, reductions are
  per RHS, and a converged (or broken-down) system's alpha is forced to 0
  and its direction update gated off, so it stays frozen bit for bit
  while the others iterate.  ``tol`` may then be a per-RHS (N,) vector.
* Every exit is classified into ``VERDICTS``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.lattice import (field_dot, field_dot_batched,
                                      field_norm2, field_norm2_batched)

Tensor = torch.Tensor
Op = Callable[[Tensor], Tensor]


class SolveStats(NamedTuple):
    iterations: int                  # loop trip count (slowest RHS)
    outer_iterations: int            # 1 for plain CG
    residual_norm2: Tensor           # final recursive ||r||^2 (per RHS)
    converged: Tensor                # bool; per-RHS (N,) when batched
    rhs_iterations: Tensor | None = None   # per-RHS counts when batched
    verdict: Tensor | None = None          # int codes into VERDICTS
    true_residual_norm2: Tensor | None = None  # filled by plan.solve
    verified: Tensor | None = None
    matvecs: Tensor | None = None          # Krylov-operator applications


# ---------------------------------------------------------------------------
# Failure taxonomy
# ---------------------------------------------------------------------------

CONVERGED, MAXITER_EXHAUSTED, BREAKDOWN, STAGNATION, NONFINITE = range(5)
VERDICTS = ("converged", "maxiter_exhausted", "breakdown", "stagnation",
            "nonfinite")

# a solve is "stagnant" when ||r||^2 fails to shrink by STAGNATION_FACTOR
# over the last STAGNATION_WINDOW iterations
STAGNATION_WINDOW = 25
STAGNATION_FACTOR = 0.5


def verdict_name(code) -> str:
    """Map a verdict code (int or 0-d tensor) to its name."""
    return VERDICTS[int(code)]


def classify(rs: Tensor, limit: Tensor, broken=False,
             stalled=False) -> Tensor:
    """Classify a solver exit from its final ``||r||^2`` and failure flags.

    Precedence: converged, breakdown, nonfinite, stagnation,
    maxiter_exhausted.  A NaN residual never classifies as converged.
    """
    rs = torch.as_tensor(rs)
    dev = rs.device
    stalled = torch.as_tensor(stalled, device=dev)
    broken = torch.as_tensor(broken, device=dev)
    v = torch.where(stalled, STAGNATION, MAXITER_EXHAUSTED)
    v = torch.where(~torch.isfinite(rs), NONFINITE, v)
    v = torch.where(broken, BREAKDOWN, v)
    v = torch.where(rs <= limit, CONVERGED, v)
    return torch.broadcast_to(v, rs.shape).to(torch.int32)


def _real(x: Tensor) -> Tensor:
    return x.real if x.is_complex() else x


def _bcast(s: Tensor, field: Tensor) -> Tensor:
    """Broadcast per-RHS (N,) scalars over a batched field's site axes."""
    return s.reshape(s.shape + (1,) * (field.dim() - 1))


def _stop_limit(tol, bs: Tensor, batched: bool) -> Tensor:
    """The stopping limit ``tol^2 * ||b||^2`` (per RHS when batched).

    ``tol`` may be a scalar or, for a batched solve, a per-RHS (N,)
    vector: each system then stops against its own tolerance.
    """
    tol = torch.as_tensor(tol, device=bs.device)
    if tol.dim() > (1 if batched else 0):
        raise ValueError(
            "tol must be a scalar"
            + (" or a per-RHS (N,) vector" if batched else "")
            + f" ({'' if batched else 'batched=False; '}got shape "
            f"{tuple(tol.shape)})")
    return (tol.to(bs.dtype) ** 2) * bs


# ---------------------------------------------------------------------------
# Conjugate Gradient (HPD operator)
# ---------------------------------------------------------------------------


class LoopParts(NamedTuple):
    """A solver loop decomposed: ``cg`` is ``finish`` of iterating ``body``
    from ``init`` while ``cond`` holds.  ``cond`` is the one place the
    host reads the device."""

    init: dict
    cond: Callable[[dict], bool]
    body: Callable[[dict], dict]
    finish: Callable[[dict], tuple]


def cg_parts(op: Op, b: Tensor, x0: Tensor | None = None, *,
             tol: float = 1e-8, maxiter: int = 1000,
             update=None, xpay=None, batched: bool = False) -> LoopParts:
    """:func:`cg` decomposed into :class:`LoopParts` (same arguments)."""
    dot, norm2 = ((field_dot_batched, field_norm2_batched) if batched
                  else (field_dot, field_norm2))
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - op(x) if x0 is not None else b
    rs = _real(norm2(r))
    bs = _real(norm2(b))
    limit = _stop_limit(tol, bs, batched)

    def cond(c: dict) -> bool:
        if c["k"] >= maxiter:
            return False
        # a broken-down system cannot progress; NaN rs compares False
        alive = (c["rs"] > limit) & ~c["broken"]
        return bool(alive.any())

    def body(c: dict) -> dict:
        k, x, r, p, rs, broken = (c["k"], c["x"], c["r"], c["p"], c["rs"],
                                  c["broken"])
        rs_mark = rs if k % STAGNATION_WINDOW == 0 else c["rs_mark"]
        ap = op(p)
        pap = _real(dot(p, ap))
        zero = torch.zeros_like(pap)
        if batched:
            active = (rs > limit) & ~broken
            safe = active & (pap != 0)
            broken = broken | (active & (pap == 0))
            alpha = torch.where(
                safe, rs / torch.where(pap == 0, torch.ones_like(pap), pap),
                zero)
        else:
            safe = pap != 0
            broken = broken | (pap == 0)
            alpha = torch.where(
                safe, rs / torch.where(safe, pap, torch.ones_like(pap)), zero)
        if update is None:
            a = (_bcast(alpha, b) if batched else alpha).to(b.dtype)
            x = x + a * p
            r = r - a * ap
            rs_new = _real(norm2(r))
        else:
            x, r, rs_new = update(alpha, x, r, p, ap)
        beta = rs_new / (torch.where(rs == 0, torch.ones_like(rs), rs)
                         if batched else rs)
        if xpay is None:
            bb = (_bcast(beta, b) if batched else beta).to(b.dtype)
            p_new = r + bb * p
            p = torch.where(_bcast(safe, b), p_new, p) if batched else p_new
        else:
            p = xpay(beta, r, p, safe) if batched else xpay(beta, r, p)
        out = dict(k=k + 1, x=x, r=r, p=p, rs=rs_new, broken=broken,
                   rs_mark=rs_mark)
        if batched:
            out["it"] = torch.where(active, k + 1, c["it"])
        return out

    init = dict(k=0, x=x, r=r, p=r, rs=rs,
                broken=torch.zeros(rs.shape, dtype=torch.bool,
                                   device=rs.device),
                rs_mark=rs)
    if batched:
        init["it"] = torch.zeros(rs.shape, dtype=torch.int32,
                                 device=rs.device)
    init_mv = 0 if x0 is None else 1

    def finish(c: dict):
        k, rs = c["k"], c["rs"]
        stalled = (k >= STAGNATION_WINDOW) & (
            rs > STAGNATION_FACTOR * c["rs_mark"])
        stats = SolveStats(
            iterations=k, outer_iterations=1, residual_norm2=rs,
            converged=rs <= limit,
            rhs_iterations=c["it"] if batched else None,
            verdict=classify(rs, limit, c["broken"], stalled),
            matvecs=torch.full(rs.shape, k + init_mv, dtype=torch.int32,
                               device=rs.device))
        return c["x"], stats

    return LoopParts(init=init, cond=cond, body=body, finish=finish)


def cg(op: Op, b: Tensor, x0: Tensor | None = None, *,
       tol: float = 1e-8, maxiter: int = 1000,
       update=None, xpay=None, batched: bool = False,
       ) -> tuple[Tensor, SolveStats]:
    """Conjugate gradient for a Hermitian positive-definite ``op``.

    Stops when ``||r||^2 <= tol^2 ||b||^2`` (per RHS when batched) or at
    ``maxiter``.  ``update`` must return the residual norm it computed
    with the new x/r.
    """
    parts = cg_parts(op, b, x0, tol=tol, maxiter=maxiter, update=update,
                     xpay=xpay, batched=batched)
    carry = parts.init
    while parts.cond(carry):
        carry = parts.body(carry)
    return parts.finish(carry)


# ---------------------------------------------------------------------------
# CGNR: CG on the normal equations (the paper's solver for Dirac-Wilson)
# ---------------------------------------------------------------------------


def cgnr(d_op: Op, d_dag_op: Op, b: Tensor, **kw
         ) -> tuple[Tensor, SolveStats]:
    """Solve D x = b for non-Hermitian D via D^dag D x = D^dag b.

    Keyword arguments forward to :func:`cg`; for a batched solve the
    operators take the leading RHS axis.  Operator work: one ``d_dag_op``
    for the right-hand side, one ``d_op`` and one ``d_dag_op`` per
    iteration.
    """
    return cg(lambda v: d_dag_op(d_op(v)), d_dag_op(b), **kw)


# ---------------------------------------------------------------------------
# Even-odd (Schur) preconditioned CGNR
# ---------------------------------------------------------------------------
#
# For D = [[M_ee, D_eo], [D_oe, M_oo]], eliminating the odd block of D x = b
# leaves D_hat x_e = b_hat with D_hat = M_ee - D_eo M_oo^-1 D_oe and
# b_hat = b_e - D_eo M_oo^-1 b_o; then x_o = M_oo^-1 (b_o - D_oe x_e).
# CGNR solves D_hat^dag D_hat x_e = D_hat^dag b_hat.


def cgnr_eo(dhat: Op, dhat_dag: Op, d_eo: Op, d_oe: Op, m_inv: Op,
            b_e: Tensor, b_o: Tensor, x0: Tensor | None = None, *,
            tol: float = 1e-8, maxiter: int = 1000, update=None,
            xpay=None, batched: bool = False,
            ) -> tuple[tuple[Tensor, Tensor], SolveStats]:
    """Even-odd Schur-preconditioned CGNR; returns ((x_e, x_o), stats).

    Operator work: one ``d_eo`` and one ``dhat_dag`` for the right-hand
    side, one ``dhat`` and one ``dhat_dag`` per iteration, one ``d_oe`` for
    the back-substitution.
    """
    b_hat = b_e - d_eo(m_inv(b_o))
    x_e, stats = cg(lambda v: dhat_dag(dhat(v)), dhat_dag(b_hat), x0,
                    tol=tol, maxiter=maxiter, update=update, xpay=xpay,
                    batched=batched)
    x_o = m_inv(b_o - d_oe(x_e))
    return (x_e, x_o), stats


def mpcg_eo(a_low: Op, a_high: Op, dhat_dag: Op, d_eo: Op, d_oe: Op,
            m_inv: Op, b_e: Tensor, b_o: Tensor, *, tol: float = 1e-6,
            inner_tol: float = 5e-2, inner_maxiter: int = 200,
            max_outer: int = 50, low_dtype=torch.bfloat16, to_low=None,
            to_high=None, update=None, xpay=None, batched: bool = False,
            ) -> tuple[tuple[Tensor, Tensor], SolveStats]:
    """Even-odd reduction composed with mixed-precision reliable-update CG:
    the Schur normal system by :func:`mpcg` (bulk iterations through
    ``a_low``, true residuals through ``a_high``), then the odd sites
    back-substituted in high precision."""
    b_hat = b_e - d_eo(m_inv(b_o))
    x_e, stats = mpcg(a_low, a_high, dhat_dag(b_hat), tol=tol,
                      inner_tol=inner_tol, inner_maxiter=inner_maxiter,
                      max_outer=max_outer, low_dtype=low_dtype,
                      to_low=to_low, to_high=to_high, update=update,
                      xpay=xpay, batched=batched)
    x_o = m_inv(b_o - d_oe(x_e))
    return (x_e, x_o), stats


# ---------------------------------------------------------------------------
# Mixed-precision reliable-update CG (the paper's Ref. [10] variant)
# ---------------------------------------------------------------------------


def mpcg_parts(op_low: Op, op_high: Op, b: Tensor, *, tol: float = 1e-6,
               inner_tol: float = 5e-2, inner_maxiter: int = 200,
               max_outer: int = 50, low_dtype=torch.bfloat16, to_low=None,
               to_high=None, update=None, xpay=None,
               batched: bool = False) -> LoopParts:
    """:func:`mpcg` decomposed into :class:`LoopParts` (same arguments).

    Each outer cycle solves ``A d = r`` approximately in low precision
    (relative tolerance ``inner_tol``, at most ``inner_maxiter``
    iterations), then updates ``x += d`` and recomputes the TRUE residual
    ``r = b - A x`` in high precision (the reliable update).

    ``to_low``/``to_high`` convert a vector between the high- and
    low-precision representations and default to dtype casts; inject them
    when the representations differ (complex fields stored as bf16 real
    pairs), and ``op_low`` then works on the low representation.

    ``batched=True``: per-RHS outer residuals.  A converged system enters
    the next inner solve with a zeroed residual, so the inner mask
    freezes it at iteration 0 and its solution stops moving.
    """
    norm2 = field_norm2_batched if batched else field_norm2
    high = b.dtype
    if to_low is None:
        to_low = lambda v: v.to(low_dtype)  # noqa: E731
    if to_high is None:
        to_high = lambda v: v.to(high)  # noqa: E731
    bs = _real(norm2(b))
    limit = _stop_limit(tol, bs, batched)

    def cond(c: dict) -> bool:
        if c["outer"] >= max_outer:
            return False
        # a non-finite true residual compares False and goes inactive
        alive = (c["rs"] > limit) & ~c["broken"]
        return bool(alive.any())

    def body(c: dict) -> dict:
        r, rs = c["r"], c["rs"]
        rhs = r
        if batched:  # freeze converged systems: zero RHS, inactive inner CG
            rhs = torch.where(_bcast(rs > limit, r), r, torch.zeros_like(r))
        d, st = cg(op_low, to_low(rhs), tol=inner_tol,
                   maxiter=inner_maxiter, update=update, xpay=xpay,
                   batched=batched)
        x = c["x"] + to_high(d)
        r = b - op_high(x)                     # the reliable update
        out = dict(outer=c["outer"] + 1, inner=c["inner"] + st.iterations,
                   x=x, r=r, rs=_real(norm2(r)),
                   broken=c["broken"] | (st.verdict == BREAKDOWN),
                   rs_mark=rs)
        if batched:  # per-RHS inner-iteration totals across outer cycles
            out["it"] = c["it"] + st.rhs_iterations
        return out

    init = dict(outer=0, inner=0, x=torch.zeros_like(b), r=b, rs=bs,
                broken=torch.zeros(bs.shape, dtype=torch.bool,
                                   device=bs.device),
                rs_mark=bs)
    if batched:
        init["it"] = torch.zeros(bs.shape, dtype=torch.int32,
                                 device=bs.device)

    def finish(c: dict):
        outer, inner, rs = c["outer"], c["inner"], c["rs"]
        # outer-cycle stagnation: a reliable update that failed to contract
        # the true residual by STAGNATION_FACTOR over the last cycle
        stalled = (outer >= 2) & (rs > STAGNATION_FACTOR * c["rs_mark"])
        # each cycle: the inner CG's op_low applications plus one op_high
        stats = SolveStats(
            iterations=inner, outer_iterations=outer, residual_norm2=rs,
            converged=rs <= limit,
            rhs_iterations=c["it"] if batched else None,
            verdict=classify(rs, limit, c["broken"], stalled),
            matvecs=torch.full(rs.shape, inner + outer, dtype=torch.int32,
                               device=rs.device))
        return c["x"], stats

    return LoopParts(init=init, cond=cond, body=body, finish=finish)


def mpcg(op_low: Op, op_high: Op, b: Tensor, *, tol: float = 1e-6,
         inner_tol: float = 5e-2, inner_maxiter: int = 200,
         max_outer: int = 50, low_dtype=torch.bfloat16, to_low=None,
         to_high=None, update=None, xpay=None,
         batched: bool = False) -> tuple[Tensor, SolveStats]:
    """Two-precision CG: bulk iterations in ``low_dtype``, corrected by
    high-precision true-residual reliable updates (see
    :func:`mpcg_parts`).  ``iterations`` counts the inner iterations,
    ``outer_iterations`` the reliable updates, ``matvecs`` both."""
    parts = mpcg_parts(op_low, op_high, b, tol=tol, inner_tol=inner_tol,
                       inner_maxiter=inner_maxiter, max_outer=max_outer,
                       low_dtype=low_dtype, to_low=to_low, to_high=to_high,
                       update=update, xpay=xpay, batched=batched)
    carry = parts.init
    while parts.cond(carry):
        carry = parts.body(carry)
    return parts.finish(carry)
