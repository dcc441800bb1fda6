"""Krylov solvers: CG with an injectable vector engine, the
mixed-precision reliable-update CG (``mpcg``), pipelined CG (``pipecg``),
BiCGStab, block CG (``blockcg``) and EigCG-style deflation
(``cg_harvest``, ``ritz_deflation_basis``, ``deflate_x0``).  CGNR is
:func:`cg` on a normal operator (``plan._parts_eo``/``_parts_full``); the
even-odd mixed solve is :func:`mpcg` on the Schur normal equations
(``plan._parts_eo_mp``).

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

import numpy as np
import torch

from repro_torch.core.lattice import (field_dot, field_dot_batched,
                                      field_norm2, field_norm2_batched,
                                      resolve_device)

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
    host reads the device.  ``counter`` is the loop's iteration count, a
    host int kept in the carry (``mpcg``: the accumulated inner
    iterations), so a segmented runner (:func:`segment_cond`) bounds the
    loop without another read; it iterates the same ``body``, so a
    segmented solve is bitwise the one-shot solve."""

    init: dict
    cond: Callable[[dict], bool]
    body: Callable[[dict], dict]
    finish: Callable[[dict], tuple]
    counter: Callable[[dict], int]


def run(parts: LoopParts) -> tuple:
    """Iterate ``body`` from ``init`` while ``cond`` holds; ``finish``."""
    carry = parts.init
    while parts.cond(carry):
        carry = parts.body(carry)
    return parts.finish(carry)


def segment_cond(parts: LoopParts) -> Callable[[dict, int], bool]:
    """The segmented stopping rule: the solver's own ``cond`` and an
    iteration bound ``counter(carry) < stop``.  The bound is tested first,
    on the host int, so a segment's last test reads nothing from the
    device."""

    def cond(carry: dict, stop: int) -> bool:
        return parts.counter(carry) < stop and parts.cond(carry)

    return cond


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
                   rs_mark=rs_mark, alpha=alpha, beta=beta)
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

    return LoopParts(init=init, cond=cond, body=body, finish=finish,
                     counter=lambda c: c["k"])


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
    return run(parts)


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

    # the outer loop ends at reliable-update boundaries: a segment's
    # bound reads the accumulated inner count, and a segment may overrun
    # its stop by one inner solve
    return LoopParts(init=init, cond=cond, body=body, finish=finish,
                     counter=lambda c: c["inner"])


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
    return run(parts)


# ---------------------------------------------------------------------------
# Pipelined CG: one fused reduction per iteration (Ghysels-Vanroose)
# ---------------------------------------------------------------------------


def pipecg_parts(op: Op, b: Tensor, *, tol: float = 1e-8,
                 maxiter: int = 1000, residual_replacement_every: int = 25,
                 fused_dots=None, batched: bool = False) -> LoopParts:
    """:func:`pipecg` decomposed into :class:`LoopParts` (same arguments).

    Pipelined CG fuses the two inner products of an iteration,
    ``gamma = (r, r)`` and ``delta = (w, r)``, into one reduction, so the
    host reads one stacked tensor per iteration (in ``cond``), as plain
    CG does.  ``fused_dots(r, w)`` returns that stack (or the pair);
    a distributed version stacks both local partials and all-reduces
    them once.

    The three-term recurrences drift in floating point, so every
    ``residual_replacement_every`` iterations (0: never) the true
    residual ``r = b - A x`` and ``w = A r`` are recomputed: a host-side
    ``if`` costing two matvecs.

    ``batched=True`` follows :func:`cg`'s masked contract: per-RHS
    scalars, a converged system's alpha forced to 0 (x, r, w freeze) and
    its z, q, p recurrences gated off (beta tends to 1 for a frozen
    system, which would grow them).  The residual replacement stays
    global.
    """
    dot, norm2 = ((field_dot_batched, field_norm2_batched) if batched
                  else (field_dot, field_norm2))
    dt = b.dtype
    rr = int(residual_replacement_every)
    if fused_dots is None:
        def fused_dots(r, w):
            return torch.stack((_real(norm2(r)), _real(dot(w, r))))

    w = op(b)
    gamma, delta = fused_dots(b, w)
    bs = _real(norm2(b))
    limit = _stop_limit(tol, bs, batched)
    zero = torch.zeros_like(b)
    init = dict(k=0, x=torch.zeros_like(b), r=b, w=w, z=zero, q=zero,
                p=zero, gamma=gamma, delta=delta,
                alpha_prev=torch.ones_like(gamma),
                gamma_prev=torch.zeros_like(gamma), restarted=True,
                broken=torch.zeros(gamma.shape, dtype=torch.bool,
                                   device=gamma.device))
    if batched:
        init["it"] = torch.zeros(gamma.shape, dtype=torch.int32,
                                 device=gamma.device)

    def cond(c: dict) -> bool:
        if c["k"] >= maxiter:
            return False
        return bool(((c["gamma"] > limit) & ~c["broken"]).any())

    def body(c: dict) -> dict:
        k, x, r, w, z, q, p = (c[n] for n in "k x r w z q p".split())
        gamma, delta, broken = c["gamma"], c["delta"], c["broken"]
        m = op(w)
        gp, ap = c["gamma_prev"], c["alpha_prev"]
        beta = (torch.zeros_like(gamma) if c["restarted"] else
                gamma / torch.where(gp == 0, torch.ones_like(gp), gp))
        denom = delta - beta * gamma / torch.where(
            ap == 0, torch.ones_like(ap), ap)
        alpha = gamma / torch.where(denom == 0, torch.ones_like(denom),
                                    denom)
        if batched:
            active = (gamma > limit) & ~broken
            broken = broken | (active & (denom == 0))
            alpha = torch.where(active, alpha, torch.zeros_like(alpha))
            bb, aa = _bcast(beta, b).to(dt), _bcast(alpha, b).to(dt)
            gate = _bcast(active, b)
            z = torch.where(gate, m + bb * z, z)
            q = torch.where(gate, w + bb * q, q)
            p = torch.where(gate, r + bb * p, p)
        else:
            broken = broken | (denom == 0)
            bb, aa = beta.to(dt), alpha.to(dt)
            z = m + bb * z
            q = w + bb * q
            p = r + bb * p
        x = x + aa * p
        r = r - aa * q
        w = w - aa * z
        replace = rr > 0 and (k + 1) % rr == 0
        if replace:
            r = b - op(x)
            w = op(r)
        gamma_new, delta_new = fused_dots(r, w)
        out = dict(k=k + 1, x=x, r=r, w=w, z=z, q=q, p=p, gamma=gamma_new,
                   delta=delta_new, alpha_prev=alpha, gamma_prev=gamma,
                   restarted=replace, broken=broken)
        if batched:
            out["it"] = torch.where(active, k + 1, c["it"])
        return out

    def finish(c: dict):
        k, gamma = c["k"], c["gamma"]
        # the prologue's w = A r, one matvec an iteration, two more at
        # each residual replacement
        mv = k + 1 + (2 * (k // rr) if rr > 0 else 0)
        stats = SolveStats(
            iterations=k, outer_iterations=1, residual_norm2=gamma,
            converged=gamma <= limit,
            rhs_iterations=c["it"] if batched else None,
            verdict=classify(gamma, limit, c["broken"]),
            matvecs=torch.full(gamma.shape, mv, dtype=torch.int32,
                               device=gamma.device))
        return c["x"], stats

    return LoopParts(init=init, cond=cond, body=body, finish=finish,
                     counter=lambda c: c["k"])


def pipecg(op: Op, b: Tensor, *, tol: float = 1e-8, maxiter: int = 1000,
           residual_replacement_every: int = 25, fused_dots=None,
           batched: bool = False) -> tuple[Tensor, SolveStats]:
    """Pipelined CG for a Hermitian positive-definite ``op``: one fused
    reduction an iteration (see :func:`pipecg_parts`)."""
    parts = pipecg_parts(
        op, b, tol=tol, maxiter=maxiter,
        residual_replacement_every=residual_replacement_every,
        fused_dots=fused_dots, batched=batched)
    return run(parts)


# ---------------------------------------------------------------------------
# BiCGStab: a direct non-Hermitian solve (D x = b without normal equations)
# ---------------------------------------------------------------------------


def bicgstab(op: Op, b: Tensor, *, tol: float = 1e-8,
             maxiter: int = 1000) -> tuple[Tensor, SolveStats]:
    """BiCGStab for a general operator such as D itself, one RHS.

    Its inner products are complex, so it runs on natural complex fields
    (on packed real fields ``field_dot`` has no imaginary part).  The
    classic breakdowns, ``(rhat, r) = 0``, ``(rhat, v) = 0`` and
    ``||t||^2 = 0``, end the solve with the BREAKDOWN verdict.
    """
    dt = b.dtype
    x, r, rhat = torch.zeros_like(b), b, b
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    one = field_dot(b, b) * 0 + 1   # scalars in the dot's dtype
    rho = alpha = omega = one
    rs = _real(field_norm2(r))
    limit = _stop_limit(tol, _real(field_norm2(b)), False)
    broken = torch.zeros((), dtype=torch.bool, device=rs.device)

    def nz(s):
        return torch.where(s == 0, torch.ones_like(s), s)

    k = 0
    while k < maxiter and bool((rs > limit) & ~broken):
        rho_new = field_dot(rhat, r)
        beta = (rho_new / nz(rho)) * (alpha / nz(omega))
        p = r + beta.to(dt) * (p - omega.to(dt) * v)
        v = op(p)
        denom = field_dot(rhat, v)
        alpha = rho_new / nz(denom)
        s = r - alpha.to(dt) * v
        t = op(s)
        tn = _real(field_norm2(t))
        omega = field_dot(t, s) / nz(tn)
        broken = broken | (rho_new == 0) | (denom == 0) | (tn == 0)
        x = x + alpha.to(dt) * p + omega.to(dt) * s
        r = s - omega.to(dt) * t
        rho, rs, k = rho_new, _real(field_norm2(r)), k + 1
    stats = SolveStats(iterations=k, outer_iterations=1, residual_norm2=rs,
                       converged=rs <= limit,
                       verdict=classify(rs, limit, broken),
                       matvecs=torch.full((), 2 * k, dtype=torch.int32,
                                          device=rs.device))
    return x, stats


# ---------------------------------------------------------------------------
# Block CG: one shared Krylov search space for N right-hand sides
# ---------------------------------------------------------------------------
#
# Batched CG shares the matvec across N systems but keeps N Krylov spaces.
# Block CG (O'Leary 1980) shares the search space too: the N scalar
# alpha/beta pairs become N x N Gram solves, and the iteration count falls
# toward the one set by the spectrum divided by the block width.  The Gram
# products and the column mix are plain matrix products, which must run
# in full f32: under TF32 they lose about 10 bits and the solve breaks.


def gram(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise inner products ``G[i, j] = <a_i, b_j>`` over the leading
    axis: real for packed real fields, Hermitian for complex ones."""
    a2 = a.reshape(a.shape[0], -1)
    b2 = b.reshape(b.shape[0], -1)
    return a2.conj() @ b2.T


def _mix(fields: Tensor, coef: Tensor) -> Tensor:
    """Column mixing ``out_j = sum_i fields_i coef[i, j]`` over the leading
    RHS axis: block CG's ``alpha * p``."""
    f2 = fields.reshape(fields.shape[0], -1)
    return (coef.to(f2.dtype).T @ f2).reshape(fields.shape)


def _gram_pinv(g: Tensor, rcond: float = 1e-7) -> tuple[Tensor, Tensor]:
    """The eigenvectors of the Hermitian part of ``g`` (symmetrised as
    ``jnp.linalg.eigh`` does) and the inverse eigenvalues, zero at and
    below ``rcond * max |lambda|``: block CG's rank-deflation point."""
    evals, evecs = torch.linalg.eigh((g + g.mH) / 2)
    cut = rcond * torch.clamp(evals.abs().max(), min=1e-30)
    keep = evals > cut
    inv = torch.where(keep, 1.0 / torch.where(keep, evals,
                                              torch.ones_like(evals)),
                      torch.zeros_like(evals))
    return evecs, inv


def _pinv_apply(evecs: Tensor, inv: Tensor, rhs: Tensor) -> Tensor:
    return evecs @ (inv[:, None].to(rhs.dtype) * (evecs.mH @ rhs))


def _gram_psolve(g: Tensor, rhs: Tensor, rcond: float = 1e-7) -> Tensor:
    """Hermitian pseudo-solve of the N x N Gram system: eigenvalues below
    ``rcond * max |lambda|`` get zero inverse weight, so converged columns
    and linearly dependent directions drop out of the update instead of
    poisoning every column through a singular solve."""
    return _pinv_apply(*_gram_pinv(g, rcond), rhs)


def _check_full_f32():
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "blockcg needs full-f32 matrix products for its Gram systems; "
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.set_float32_matmul_precision)")


def blockcg(op: Op, b: Tensor, x0: Tensor | None = None, *,
            tol: float = 1e-8, maxiter: int = 1000
            ) -> tuple[Tensor, SolveStats]:
    """Block CG for a Hermitian positive-definite ``op`` over a leading RHS
    axis: N systems share one Krylov search space.

    Per iteration one block matvec ``Q = A P`` (the batched operator: one
    gauge read serves all N), then two Gram solves through one
    eigendecomposition, ``alpha = (P^H A P)^+ P^H R`` and
    ``beta = -(P^H A P)^+ Q^H R'``, with :func:`_gram_psolve`'s
    pseudo-inverse.  Converged columns are zeroed out of ``P``, so they
    drop out of the shared space; columns do not freeze bitwise as in the
    masked batched CG, but convergence, ``rhs_iterations`` and verdicts
    stay per RHS.  ``tol`` may be a per-RHS (N,) vector.
    """
    if b.dim() < 2:
        raise ValueError("blockcg requires a leading RHS-batch axis")
    _check_full_f32()
    norm2 = field_norm2_batched
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - op(x) if x0 is not None else b
    rs = _real(norm2(r))
    limit = _stop_limit(tol, _real(norm2(b)), True)
    # invariant: inactive columns of P are zero, so they add nothing to
    # the Gram matrices or the shared updates
    p = torch.where(_bcast(rs > limit, b), r, 0.0)
    k, rs_mark = 0, rs
    it = torch.zeros(rs.shape, dtype=torch.int32, device=rs.device)
    broken = torch.zeros(rs.shape, dtype=torch.bool, device=rs.device)

    def finite(t):
        return torch.where(torch.isfinite(t), t, torch.zeros_like(t))

    while k < maxiter and bool(((rs > limit) & ~broken).any()):
        if k % STAGNATION_WINDOW == 0:
            rs_mark = rs
        m = (rs > limit) & ~broken
        q = op(p)
        evecs, inv = _gram_pinv(gram(p, q))
        alpha = _pinv_apply(evecs, inv, gram(p, r))
        alpha = alpha * m[None, :].to(alpha.dtype)
        broken = broken | (m & ~torch.isfinite(alpha).all(dim=0))
        alpha = finite(alpha)
        x = x + _mix(p, alpha)
        r = r - _mix(q, alpha)
        rs_new = _real(norm2(r))
        m_next = (rs_new > limit) & ~broken
        beta = -_pinv_apply(evecs, inv, gram(q, r))
        beta = finite(beta * m_next[None, :].to(beta.dtype))
        p = torch.where(_bcast(m_next, b), r, 0.0) + _mix(p, beta)
        it = torch.where(m, k + 1, it)
        k, rs = k + 1, rs_new
    stalled = (k >= STAGNATION_WINDOW) & (rs > STAGNATION_FACTOR * rs_mark)
    stats = SolveStats(
        iterations=k, outer_iterations=1, residual_norm2=rs,
        converged=rs <= limit, rhs_iterations=it,
        verdict=classify(rs, limit, broken, stalled),
        matvecs=torch.full(rs.shape, k + (0 if x0 is None else 1),
                           dtype=torch.int32, device=rs.device))
    return x, stats


# ---------------------------------------------------------------------------
# EigCG-style deflation: harvest low eigenpairs from one solve, project them
# out of later solves on the same gauge field
# ---------------------------------------------------------------------------
#
# CG's alpha/beta coefficients are a Lanczos factorisation of the operator in
# the normalised-residual basis: T[k,k] = 1/a_k + b_{k-1}/a_{k-1},
# T[k,k+1] = sqrt(b_k)/a_k.  Recording the normalised residuals beside a
# solve (``cg_harvest``) yields Ritz pairs for free; a later solve projects
# its RHS on the basis (x0 = W (W^H A W)^-1 W^H b) and starts CG there.


class DeflationBasis(NamedTuple):
    """A harvested low-mode basis for one (gauge, operator) pair.

    ``w``: (nev, *field) Ritz vectors in the solver's working layout,
    kept on the device.  ``gram``: (nev, nev) ``W^H A W``, identity-padded
    on slots beyond the harvested rank (zero vectors there), so the
    Galerkin solve is nonsingular and a padded slot adds nothing.
    """

    w: Tensor
    gram: Tensor

    @property
    def nev(self) -> int:
        return self.w.shape[0]


def deflation_basis_from_numpy(w, gram, device="cuda") -> DeflationBasis:
    """A basis harvested elsewhere (the JAX package's ``w`` and ``gram`` as
    numpy arrays) as a :class:`DeflationBasis` on ``device``; the packed
    half-field layout is the same in both packages."""
    dev = resolve_device(device)
    return DeflationBasis(w=torch.tensor(np.asarray(w), device=dev),
                          gram=torch.tensor(np.asarray(gram), device=dev))


def cg_harvest(op: Op, b: Tensor, *, tol: float = 1e-8, maxiter: int = 1000,
               m_max: int = 48
               ) -> tuple[Tensor, SolveStats, tuple[Tensor, Tensor, Tensor]]:
    """:func:`cg` (one RHS, plain vector algebra) that also records its
    Lanczos data: returns ``(x, stats, (v, alphas, betas))``, the first
    ``min(iterations, m_max)`` normalised residuals ``v_k = r_k/||r_k||``
    (an (m_max, *field) buffer on the device) and their CG coefficients.
    The iterates and the count are :func:`cg`'s, bitwise."""
    m_max = int(min(m_max, maxiter))
    parts = cg_parts(op, b, tol=tol, maxiter=maxiter)
    c = parts.init
    vbuf = torch.zeros((m_max,) + tuple(b.shape), dtype=b.dtype,
                       device=b.device)
    albuf = torch.zeros(m_max, dtype=c["rs"].dtype, device=b.device)
    bebuf = torch.zeros_like(albuf)
    while parts.cond(c):
        k, rs = c["k"], c["rs"]
        if k < m_max:
            scale = torch.where(rs > 0, torch.rsqrt(rs), torch.zeros_like(rs))
            vbuf[k] = c["r"] * scale.to(b.dtype)
        c = parts.body(c)
        if k < m_max:
            albuf[k], bebuf[k] = c["alpha"], c["beta"]
    x, stats = parts.finish(c)
    return x, stats, (vbuf, albuf, bebuf)


def ritz_deflation_basis(op: Op, v: Tensor, alphas: Tensor, betas: Tensor,
                         k, nev: int) -> DeflationBasis:
    """:func:`cg_harvest`'s records as a :class:`DeflationBasis` of exactly
    ``nev`` slots.

    Only alpha and beta go to the host, where the k x k Lanczos
    tridiagonal's ``min(nev, k)`` smallest Ritz pairs are found in float64;
    the Ritz vectors ``W = V Y`` and ``gram = W^H A W`` (``min(nev, k)``
    more matvecs) are formed on the device.
    """
    m = int(min(int(k), v.shape[0]))
    if m < 1:
        raise ValueError("ritz_deflation_basis: empty harvest (k < 1)")
    al = alphas[:m].detach().cpu().numpy().astype(np.float64)
    be = betas[:m].detach().cpu().numpy().astype(np.float64)
    al = np.where(al == 0, 1.0, al)
    diag = 1.0 / al
    diag[1:] += be[:m - 1] / al[:m - 1]
    off = np.sqrt(np.maximum(be[:m - 1], 0.0)) / al[:m - 1]
    t = np.diag(diag) + np.diag(off, 1) + np.diag(off, -1)
    _, y = np.linalg.eigh(t)          # ascending: low modes first
    n_eff = max(1, min(nev, m))
    # the Lanczos vectors are q_k = (-1)^k r_k/||r_k||; the recorded v_k
    # drop the sign, so fold it into the eigenvector rows (unsigned v's
    # with unsigned y's would target the wrong end of the spectrum)
    signs = (-1.0) ** np.arange(m)
    yk = torch.from_numpy((y[:, :n_eff] * signs[:, None]).astype(np.float32))
    w = torch.tensordot(yk.to(device=v.device, dtype=v.dtype), v[:m],
                        dims=([0], [0]))
    aw = torch.stack([op(w[i]) for i in range(n_eff)])
    g = gram(w, aw)
    if n_eff < nev:
        pad = torch.zeros((nev - n_eff,) + tuple(w.shape[1:]), dtype=w.dtype,
                          device=w.device)
        w = torch.cat([w, pad])
        g_full = torch.eye(nev, dtype=g.dtype, device=g.device)
        g_full[:n_eff, :n_eff] = g
        g = g_full
    return DeflationBasis(w=w, gram=g)


def deflate_x0(basis: DeflationBasis, rhs: Tensor) -> Tensor:
    """Galerkin deflation ``x0 = W (W^H A W)^-1 W^H rhs``, per RHS when
    ``rhs`` has a leading batch axis (no mixing across RHS, so a NaN stays
    in its own x0); a zero RHS gives exactly zero."""
    nev = basis.w.shape[0]
    w2 = basis.w.reshape(nev, -1)
    batched = rhs.dim() == basis.w.dim()
    r2 = rhs.reshape(rhs.shape[0] if batched else 1, -1)
    proj = w2.conj() @ r2.T
    c = torch.linalg.solve(basis.gram.to(proj.dtype), proj)
    x0 = c.T @ w2.to(c.dtype)
    return x0.reshape(rhs.shape).to(rhs.dtype)
