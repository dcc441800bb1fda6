"""Retry and escalation for defended solves, and resuming a checkpoint.

A verdict from :mod:`repro_torch.core.solvers` classifies why a solve
exited; this module decides what to do about it.  :func:`defended_solve`
walks a :class:`RetryPolicy` ladder:

1. **Restart**: re-enter the same plan as a defect-correction step: the
   true residual ``r = b - D x`` of the current (finite) iterate is
   recomputed through the natural ``operators.dslash_g`` and the solver
   is asked for the correction ``D d = r``, to the remaining relative
   tolerance.  Krylov information is discarded, accumulated progress
   kept.  A non-finite iterate cannot seed a restart; such attempts start
   over from zero.
2. **Escalate precision**: a ``precision="mixed"``/``"low"`` plan that
   failed re-runs with ``precision="single"``.
3. **Fall back to the reference backend**: a ``backend="kernels"`` plan
   that still fails re-runs on the plain operators, taking the CUDA
   kernels out of the trust chain.  That rung really runs the plain
   versions, and its :class:`AttemptRecord` names it.  On a CUDA device
   it runs only under a policy the caller passes: the default policy
   there (:func:`default_policy`) stops at the kernels rungs, so a
   kernel that fails verification fails the solve instead of being
   replaced by its plain version.

Attempts are capped; exhaustion raises a structured :class:`SolveFailure`
carrying the per-attempt history.  Success at any rung returns stats
whose ``verified`` gate passed: ``defended_solve`` never returns an
unverified solution.  :func:`resume_solve` continues an interrupted
checkpointed solve from its latest valid snapshot.

Both take a mesh plan, with the global fields on every rank or, with
``blocks=True``, each rank's blocks (``plan.solve``'s block entry).  The
ladder then runs on each rank's blocks, the true residual is the mesh
verification (:func:`repro_torch.core.plan.mesh_true_residual`: the
plain natural operator on each block padded with its neighbours' faces,
the norms all-reduced), and every decision reads all-reduced values, so
every rank walks the same rungs and returns the same records.  The
backend rung runs the mesh's plain path (the kernels' plain versions on
the blocks).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import plan as plan_mod
from repro_torch.core.lattice import (field_norm2, field_norm2_batched,
                                      resolve_device)
from repro_torch.core.operators import dslash_g
from repro_torch.core.solvers import verdict_name

__all__ = ["AttemptRecord", "ResumeRecord", "RetryPolicy", "SolveFailure",
           "default_policy", "defended_solve", "resume_solve"]


@dataclasses.dataclass(frozen=True)
class AttemptRecord:
    """One rung of the ladder, as it actually ran."""

    attempt: int               # 0-based
    plan_desc: str             # "eo-schur/wilson/kernels/mixed" style
    restarted: bool            # seeded from the previous finite iterate
    iterations: int
    verdict: str               # VERDICTS name
    verified: bool
    residual_norm2: float      # the solver's own final ||r||^2
    true_residual_norm2: float  # the verification's ||b - D x||^2


class SolveFailure(RuntimeError):
    """Raised when the retry ladder is exhausted without a verified
    solve; carries the last attempt's verdict and every attempt."""

    def __init__(self, message: str, *, verdict: str,
                 attempts: tuple[AttemptRecord, ...]):
        super().__init__(message)
        self.verdict = verdict
        self.attempts = attempts


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """The escalation ladder for :func:`defended_solve`.

    ``max_attempts`` counts every solve attempt, the first included.
    Escalations apply in order (precision first, keeping the kernels;
    backend second) and each stays in effect for the remaining attempts.
    """

    max_attempts: int = 3
    escalate_precision: bool = True
    fallback_backend: bool = True
    restart_from_iterate: bool = True

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"RetryPolicy.max_attempts must be >= 1, got "
                f"{self.max_attempts}")

    def ladder(self, plan: plan_mod.SolverPlan
               ) -> tuple[plan_mod.SolverPlan, ...]:
        """The distinct plans the policy is willing to run, in order."""
        rungs = [plan]
        if self.escalate_precision and plan.precision != "single":
            rungs.append(dataclasses.replace(plan, precision="single"))
        if self.fallback_backend:
            for rung in list(rungs):
                if rung.backend == "kernels":
                    fallback = dataclasses.replace(rung, backend="reference")
                    if fallback not in rungs:
                        rungs.append(fallback)
        return tuple(rungs)


def default_policy(device) -> RetryPolicy:
    """The policy of a call that passes none: the JAX package's default,
    without the backend rung on a CUDA device (the plain versions run
    there only when the caller's policy asks for them)."""
    return RetryPolicy(
        fallback_backend=torch.device(device).type != "cuda")


def _plan_desc(plan: plan_mod.SolverPlan) -> str:
    return (f"{plan.operator}/{plan.operator_family}/{plan.backend}/"
            f"{plan.precision}")


def defended_solve(plan: plan_mod.SolverPlan, u, b, mass, *,
                   tol: float = 1e-8, maxiter: int = 1000,
                   policy: RetryPolicy | None = None, x0=None,
                   checkpoint=None, device="cuda", blocks: bool = False,
                   **solve_kw):
    """Run ``plan.solve`` under a retry and escalation ladder.

    ``policy=None`` is :func:`default_policy` of ``device``.

    Returns ``(x, stats, attempts)`` where every returned solve has
    ``stats.verified`` True for all right-hand sides.  Raises
    :class:`SolveFailure` when ``policy.max_attempts`` attempts across
    the ladder all fail verification.

    Restart: when the previous attempt left a finite iterate, the next
    solves the defect system ``D d = r`` with ``r = b - D x`` recomputed
    (one natural ``dslash_g`` a RHS) and a tolerance rescaled by
    ``||b|| / ||r||`` (capped at 0.1), then accumulates ``x + d``.
    Breakdown or NaN iterates restart from zero instead.

    ``x0`` seeds the first attempt with an existing iterate through the
    same defect correction: this is how :func:`resume_solve` continues
    from a checkpoint.  A non-finite ``x0`` is discarded.

    ``checkpoint`` (a :class:`plan.CheckpointPolicy`) makes the
    from-scratch attempts durable.  Restarted attempts run without it:
    their iterate is a correction ``d``, not the accumulated solution.
    ``deflation`` (through ``solve_kw``) warm-starts the first attempt
    only, and not under a checkpoint policy.

    A mesh plan runs on its mesh's device.  ``blocks=True``: ``u``, ``b``
    and ``x0`` are this rank's natural blocks and x comes back as this
    rank's block; otherwise they are global, sliced here, and x is
    gathered.  Either way every rank returns the same stats and records.
    """
    mesh = plan.mesh
    if mesh is not None and not blocks:
        return _defended_global_on_mesh(
            plan, u, b, mass, tol=tol, maxiter=maxiter, policy=policy,
            x0=x0, checkpoint=checkpoint, **solve_kw)
    if blocks and mesh is None:
        raise ValueError("defended_solve(..., blocks=True) takes a mesh "
                         "plan")
    dev = resolve_device(device if mesh is None else mesh.device)
    policy = default_policy(dev) if policy is None else policy
    ladder = policy.ladder(plan)
    deflation = solve_kw.pop("deflation", None)
    if mesh is not None:
        solve_kw["blocks"] = True
    site = plan.site_term(float(mass))
    u = torch.as_tensor(u, device=dev)
    b = torch.as_tensor(b, device=dev)
    norm2 = field_norm2_batched if plan.batched else field_norm2

    def residual(x):
        """``(b - D x, ||b - D x||^2)``, on a mesh this rank's block and
        the all-reduced norm."""
        if mesh is not None:
            r, rs, _ = plan_mod.mesh_true_residual(plan, u, b, mass, x)
            return r, rs

        def apply_d(v):
            return dslash_g(u, v, mass, r=plan.r, twist=site.twist)
        if plan.batched:
            r = b - torch.stack([apply_d(x[n])
                                 for n in range(x.shape[0])]).to(b.dtype)
        else:
            r = b - apply_d(x).to(b.dtype)
        return r, norm2(r).real

    bs = norm2(b).real
    if mesh is not None:
        bs = mesh.psum(bs, kind="verify_all_reduce")
    attempts: list[AttemptRecord] = []
    x_acc = None          # accumulated finite iterate (None: start from 0)
    if x0 is not None:
        x0 = torch.as_tensor(x0, device=dev).to(b.dtype)
        if x0.shape != b.shape:
            raise ValueError(
                f"defended_solve: x0 shape {tuple(x0.shape)} does not match "
                f"the RHS shape {tuple(b.shape)}")
        x_acc = x0  # finiteness is checked by the restart below
    last_verdict = "nonfinite"
    for attempt in range(policy.max_attempts):
        rung = ladder[min(attempt, len(ladder) - 1)]
        restarted = False
        rhs, rhs_tol = b, tol
        if x_acc is not None and policy.restart_from_iterate:
            r, rs = residual(x_acc)
            if bool(torch.isfinite(rs).all()):
                # defect correction: solve D d = r to the remaining
                # relative tolerance tol ||b|| / ||r|| (capped: the
                # restart must still tighten the iterate)
                scale = torch.sqrt(bs / torch.where(rs == 0,
                                                    torch.ones_like(rs), rs))
                rhs_tol = torch.minimum(
                    torch.tensor(tol, dtype=torch.float32, device=dev)
                    * scale.to(torch.float32),
                    torch.tensor(0.1, dtype=torch.float32, device=dev))
                rhs = r
                restarted = True
            else:
                x_acc = None  # poisoned iterate: restart from scratch
        ckw = dict(solve_kw)
        if checkpoint is not None and not restarted:
            ckw["checkpoint"] = checkpoint
        elif (deflation is not None and attempt == 0 and not restarted
                and checkpoint is None):
            ckw["deflation"] = deflation
        x, stats = plan_mod.solve(rung, u, rhs, mass, tol=rhs_tol,
                                  maxiter=maxiter, device=dev, **ckw)
        x_try = x if not restarted else x_acc + x
        # verify the accumulated iterate against the original system
        # (the attempt's own stats verified the defect system only)
        rs_fin = residual(x_try)[1]
        gate = (plan_mod.VERIFY_FACTOR
                * torch.tensor(tol, dtype=rs_fin.dtype, device=dev)) ** 2 * bs
        ok = (rs_fin <= gate) & torch.isfinite(rs_fin)
        all_ok = bool(ok.all())
        worst = int(stats.verdict.max())
        last_verdict = verdict_name(worst) if not all_ok else "converged"
        attempts.append(AttemptRecord(
            attempt=attempt, plan_desc=_plan_desc(rung),
            restarted=restarted, iterations=int(stats.iterations),
            verdict=verdict_name(worst), verified=all_ok,
            residual_norm2=float(stats.residual_norm2.max()),
            true_residual_norm2=float(rs_fin.max())))
        if all_ok:
            stats = stats._replace(
                true_residual_norm2=rs_fin, verified=torch.ones_like(ok),
                verdict=torch.zeros_like(stats.verdict),
                converged=torch.ones_like(ok))
            return x_try, stats, tuple(attempts)
        # keep a finite iterate as the next restart seed
        x_acc = x_try if bool(torch.isfinite(rs_fin).all()) else None
    raise SolveFailure(
        f"defended_solve: {policy.max_attempts} attempt(s) exhausted "
        f"without a verified solution (last verdict: {last_verdict}; "
        f"ladder: {[_plan_desc(p) for p in ladder]})",
        verdict=last_verdict, attempts=tuple(attempts))


def _defended_global_on_mesh(plan, u, b, mass, *, x0, **kw):
    """:func:`defended_solve`'s global entry on a mesh: this rank's blocks
    of u, b and ``x0`` sliced from the global fields, the ladder run on
    them, x gathered."""
    mesh = plan.mesh
    b = torch.as_tensor(b, device=mesh.device)
    u_l, b_l = plan_mod._shard_global(plan, torch.as_tensor(u), b, "natural")
    x0_l = None
    if x0 is not None:
        psi_spec = dist.layout_specs(mesh, "natural", plan.axis_map)[0]
        x0_l = dist.local_block(mesh, torch.as_tensor(x0, device=mesh.device)
                                .to(b.dtype), psi_spec)
    x_l, stats, attempts = defended_solve(plan, u_l, b_l, mass, x0=x0_l,
                                          blocks=True, **kw)
    return plan_mod._gather_x(plan, x_l, "natural"), stats, attempts


@dataclasses.dataclass(frozen=True)
class ResumeRecord:
    """How a :func:`resume_solve` picked a run back up."""

    resumed_from_step: int | None   # None: no checkpoint found, fresh solve
    checkpoint_iterations: int      # iterations banked before the crash
    checkpoint_verdict: str | None  # verdict saved with the checkpoint
    attempts: tuple[AttemptRecord, ...]


def resume_solve(plan: plan_mod.SolverPlan, u, b, mass, *,
                 checkpoint_dir: str, tol: float = 1e-8,
                 maxiter: int = 1000, policy: RetryPolicy | None = None,
                 missing_ok: bool = False, device="cuda",
                 blocks: bool = False, **solve_kw):
    """Continue an interrupted checkpointed solve.

    Restores the latest valid checkpoint from ``checkpoint_dir`` (a
    corrupt newest step falls back to the one before it; the JAX
    package's checkpoints read the same), seeds :func:`defended_solve`
    with the saved iterate, which defect-corrects against the original
    system and re-verifies the accumulated solution, and finally banks
    the verified result as a new checkpoint (pruning to 2), so repeated
    crash and resume cycles keep converging.

    ``missing_ok=True`` turns "no checkpoint yet" (a crash before the
    first segment boundary) into a fresh checkpointed defended solve;
    "every checkpoint is corrupt" stays an error.  Returns ``(x, stats,
    ResumeRecord)``.

    A mesh plan (global fields, or ``blocks=True`` and each rank's
    blocks): every rank reads the checkpoint, whose x is the unsharded
    global iterate (a one-device run's, a mesh run's or the JAX
    package's), and keeps its block of it when given blocks; the ladder
    runs as :func:`defended_solve` does on a mesh; rank 0 alone banks the
    gathered result and prunes, and a barrier holds every rank until the
    step is on disk.
    """
    from repro_torch.checkpoint import ckpt

    mesh = plan.mesh
    dev = resolve_device(device if mesh is None else mesh.device)
    b = torch.as_tensor(b, device=dev)
    vshape = (plan.nrhs,) if plan.batched else ()
    x_shape, read = tuple(b.shape), None
    if mesh is not None and blocks:
        psi_spec = dist.layout_specs(mesh, "natural", plan.axis_map)[0]
        x_shape = dist.global_shape(mesh, b.shape, psi_spec)
        read = {"x": dist.block_slices(mesh, x_shape, psi_spec)}
    target = {"iteration": ((), np.int32), "rhs_mask": (vshape, np.bool_),
              "verdict": (vshape, np.int32), "x": (x_shape, b.dtype)}
    try:
        step, tree = ckpt.restore_latest(checkpoint_dir, target, device=dev,
                                         blocks=read)
    except FileNotFoundError:
        if not missing_ok:
            raise
        step, ckpt_iters, ckpt_verdict, x0 = None, 0, None, None
    else:
        ckpt_iters = int(tree["iteration"])
        ckpt_verdict = verdict_name(int(tree["verdict"].max()))
        x0 = tree["x"]
    x, stats, attempts = defended_solve(
        plan, u, b, mass, tol=tol, maxiter=maxiter, policy=policy,
        x0=x0, checkpoint=(None if x0 is not None else
                           plan_mod.CheckpointPolicy(dir=checkpoint_dir)),
        device=dev, blocks=blocks, **solve_kw)
    # bank the verified accumulated iterate: a crash now resumes from the
    # answer, not from a pre-crash snapshot
    new_iters = ckpt_iters + sum(a.iterations for a in attempts)
    x_all = (plan_mod._gather_x(plan, x, "natural")
             if mesh is not None and blocks else x)
    if mesh is None or mesh.rank == 0:
        ckpt.save_checkpoint(checkpoint_dir, new_iters, {
            "x": x_all,
            "iteration": np.asarray(new_iters, np.int32),
            "verdict": np.zeros(vshape, np.int32),
            "rhs_mask": np.ones(vshape, np.bool_),
        })
        ckpt.prune_checkpoints(checkpoint_dir, 2)
    del x_all
    if mesh is not None:
        mesh.barrier()
    return x, stats, ResumeRecord(
        resumed_from_step=step, checkpoint_iterations=ckpt_iters,
        checkpoint_verdict=ckpt_verdict, attempts=attempts)
