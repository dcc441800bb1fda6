"""SolverPlan — the one declarative entry point of the port's solve stack.

A :class:`SolverPlan` names a solve as data (operator, operator family,
backend, Krylov loop, batch shape, precision, mesh) and :func:`solve`
runs it.  The port carries two operators, on one device or a
:class:`repro_torch.core.distributed.Mesh` of ranks, one RHS or a batch,
for every registered operator family:

* ``"eo-schur"`` (default) — the paper's solve on the even-odd Schur
  complement (:func:`_parts_eo`): CGNR, pipelined CG (``"pipecg"``) or
  block CG (``"blockcg"``, a batch sharing one Krylov space), or with
  ``precision="mixed"`` the reliable-update mpcg with a low inner CG
  (:func:`_parts_eo_mp`, one RHS);
* ``"full"`` — the same loops on the full-lattice normal operator D^dag D
  (:func:`_parts_full`), in the natural layout or, with
  ``layout="packed"``, on packed real fields in and out; with
  ``precision="mixed"`` mpcg, with ``"low"`` an all-low CG (cg16, not
  accurate to ``tol``: a measurement rig, verified False by design).

Precisions: ``"single"`` (f32), ``"mixed"`` (bulk iterations in ``low``
storage, true residuals and the solution in f32) and ``"low"``.

Backends:

* ``"kernels"`` (default) — packed fields through the port's CUDA
  kernels: the parity hop kernel (four launches per Schur normal matvec)
  and, for CGNR, the fused CG vector kernels; or the full-lattice kernel
  (two launches per normal matvec, plain vector algebra as in the JAX
  package).  ``low`` storage (bf16 by default, or float16) goes through
  the kernels' instances of that dtype.
  On CPU tensors each kernel's plain PyTorch version runs instead.
* ``"reference"`` — the plain operators: natural-layout complex einsums
  for ``"eo-schur"``, the packed einsum operator for ``"full"``.

:func:`harvest_deflation` solves one system and returns an EigCG
deflation basis that later single-precision CGNR or block CG solves on
the same gauge field take as ``deflation=``.  ``solve(checkpoint=
CheckpointPolicy(...))`` runs any loop but block CG in segments and
snapshots it between them (:func:`loop_program`, :func:`_solve_checkpointed`;
:mod:`repro_torch.core.resilience` resumes such a run).

A mesh plan (``mesh=``, ``axis_map=``) decomposes the lattice over the
mesh's ranks.  Its block entry, ``solve(..., blocks=True)``, takes each
rank's blocks of u and b (no rank holds a global field), packs them, and
iterates the same loops with halo-corrected local operators (K1 or K4 on
the block) and all-reduced reductions
(:mod:`repro_torch.core.distributed`); the result is this rank's block
of x and the same stats on every rank.  The global entry (``blocks``
False) takes the same GLOBAL fields on every rank, slices them, runs the
block entry and gathers x.  The mesh rules are the JAX package's: no
block CG, even-odd single precision only, the full operator single-RHS
only (:func:`_parts_full_sharded`, :func:`_parts_eo_sharded`).

Every solve ends with one verification matvec (:func:`_attach_verification`,
``verify=False`` skips it): the natural-layout operator, or for
``layout="packed"`` the full-lattice kernel.  A global-entry mesh solve
verifies the gathered x on rank 0 against the global fields and
broadcasts the verdict; a block-entry solve evaluates the natural
operator on each rank's blocks padded with its neighbours' faces and
all-reduces the norms (:func:`mesh_true_residual`).  Neither goes
through halo code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import solvers
from repro_torch.core.eo import (EOContext, back_substitute_odd,
                                 eo_context, schur_rhs)
from repro_torch.core.lattice import (complex_to_real_pair, field_dot,
                                      field_norm2, field_norm2_batched,
                                      pack_gauge, pack_spinor,
                                      real_pair_to_complex, resolve_device,
                                      unpack_gauge, unpack_spinor)
from repro_torch.core.operators import (SiteTerm, dslash_g, get_operator,
                                        schur_normal_op_g, unknown_name)
from repro_torch.core.precision import parse_dtype

Tensor = torch.Tensor

_OPERATORS = ("full", "eo-schur")
_BACKENDS = ("reference", "kernels")
_SOLVERS = ("cgnr", "pipecg", "blockcg")
_PRECISIONS = ("single", "mixed", "low")

# the low storage the kernels have instances for
_KERNEL_LOW = (torch.bfloat16, torch.float16, torch.float32)


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
        the kernels backend stores bfloat16, float16 or float32.
      nrhs:      None for one RHS, or N for a masked batch of N.
      mesh/axis_map: None for one device, or a
        :class:`repro_torch.core.distributed.Mesh` (and an optional
        {lattice axis: mesh axis name} override): the solve runs on every
        rank of the mesh with halo-corrected local operators and
        all-reduced reductions.
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
    mesh: dist.Mesh | None = None
    axis_map: Mapping[int, str] | None = None
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
                    "bfloat16, float16 or float32")
        if self.mesh is not None and not isinstance(self.mesh, dist.Mesh):
            raise TypeError(f"SolverPlan.mesh must be a repro_torch.core."
                            f"distributed.Mesh, got {type(self.mesh)!r}")

    @property
    def batched(self) -> bool:
        return self.nrhs is not None

    def cache_key(self) -> tuple:
        """The plan's hashable identity: every field that shapes a solve.
        A deflation basis belongs to the key of the plan that harvested
        it, with the same gauge field and mass.  ``axis_map`` may be a
        plain dict, hence the sorted tuple; a mesh hashes by identity."""
        axis_map = (None if self.axis_map is None
                    else tuple(sorted(self.axis_map.items())))
        return (self.operator, self.operator_family, self.mu, self.backend,
                self.solver, self.precision, str(self.low), self.nrhs,
                self.mesh, axis_map, self.r)

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
# slabs of a block-entry mesh verification (mesh_true_residual)
VERIFY_SLABS = 8


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
    return _gated(stats, norm2_fn(r_true).real, norm2_fn(b).real, tol)


def _gated(stats: solvers.SolveStats, rs_true, bs, tol) -> solvers.SolveStats:
    """``stats`` with the verification's true residual ``rs_true`` and its
    gate against ``||b||^2 = bs``; a non-finite residual turns the verdict
    NONFINITE."""
    tol_a = torch.as_tensor(tol, device=rs_true.device).to(rs_true.dtype)
    gate = (VERIFY_FACTOR * tol_a) ** 2 * bs
    finite = torch.isfinite(rs_true)
    verdict = stats.verdict
    if verdict is not None:
        verdict = torch.where(finite, verdict,
                              torch.full_like(verdict, solvers.NONFINITE))
    return stats._replace(true_residual_norm2=rs_true,
                          verified=(rs_true <= gate) & finite,
                          verdict=verdict)


def _check_layout(plan: SolverPlan, layout: str):
    if layout not in ("natural", "packed"):
        raise ValueError(f"layout must be 'natural' or 'packed', "
                         f"got {layout!r}")
    if layout == "packed" and plan.operator != "full":
        raise ValueError("layout='packed' is the full-operator contract; "
                         "the even-odd path takes natural-layout fields")


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
          residual_replacement_every: int = 25, dot=field_dot,
          norm2=field_norm2, layout: str = "natural", verify: bool = True,
          checkpoint=None, deflation: solvers.DeflationBasis | None = None,
          device="cuda", blocks: bool = False
          ) -> tuple[Tensor, solvers.SolveStats]:
    """Execute a :class:`SolverPlan`.

    Args:
      u, b: gauge field and right-hand side, tensors or arrays, moved to
        ``device``.  ``layout="natural"``: complex (4,T,Z,Y,X,3,3) and
        (T,Z,Y,X,4,3); ``layout="packed"`` (the full operator only):
        float32 (4,T,Z,Y,18,X) and (T,Z,Y,24,X).  The RHS has a leading
        N axis when ``plan.nrhs`` is set.  A mesh plan takes the GLOBAL
        fields on every rank, or with ``blocks=True`` this rank's blocks.
      blocks: the mesh's block entry.  ``u`` and ``b`` are this rank's
        blocks of the global fields (:func:`dist.shard_lattice_fields`'s
        output, or :func:`dist.block_slices` of a field no rank holds
        whole) and x comes back as this rank's block, with the same
        stats on every rank; verification evaluates the plain natural
        operator on each rank's blocks padded with its neighbours' faces
        (:func:`mesh_true_residual`).  A snapshot still holds the
        gathered global x, written by rank 0.  Without ``blocks`` a mesh
        solve slices the global fields, runs this entry and gathers x
        (:func:`_solve_global_on_mesh`).
      tol/maxiter: CG stopping rule (relative, per RHS when batched).
      inner_tol/inner_maxiter/max_outer: the mixed precision's inner CG
        stopping rule and its number of reliable updates.
      residual_replacement_every: pipecg's drift control (0: never).
      dot/norm2: injectable reductions of the single-device loops (the
        defaults swap to their per-RHS forms for a batch); mesh plans
        build their own all-reduced ones.
      verify: attach the post-solve verification matvec (the default).
        ``False`` is for callers that verify the solution themselves;
        they must not treat x as trusted.
      checkpoint: a :class:`CheckpointPolicy` makes the solve durable: the
        same loop runs in segments of at most ``every_iters`` iterations
        and ``(x, iteration, verdict, rhs_mask)`` is written to
        ``checkpoint.dir`` between them (:func:`_solve_checkpointed`);
        the result is bitwise the one-shot solve's.  Not for block CG;
        on a mesh, the even-odd path only, rank 0 writing.
      deflation: a :class:`solvers.DeflationBasis` from
        :func:`harvest_deflation` on the same gauge field, family, mass
        and backend: the solve starts from the Galerkin projection of the
        RHS on the basis (single-precision ``"cgnr"``/``"blockcg"``); the
        verification still gates against the original system, so a stale
        basis fails loudly.
      device: where the solve runs, ``"cuda"`` unless the caller asks for
        ``"cpu"`` (then each kernel's plain version runs).  A mesh plan
        runs on its mesh's device.
    Returns:
      (x, SolveStats): x in the layout of ``b``; per-RHS stats fields
      when batched.
    """
    _check_layout(plan, layout)
    if deflation is not None and (
            plan.mesh is not None or checkpoint is not None
            or plan.solver == "pipecg" or plan.precision != "single"):
        raise NotImplementedError(
            "deflation composes with the single-device single-precision "
            "cg paths (solver='cgnr'/'blockcg', no checkpoint); got "
            f"solver={plan.solver!r} precision={plan.precision!r} "
            f"mesh={'set' if plan.mesh is not None else None} "
            f"checkpoint={'set' if checkpoint is not None else None}")
    _check_mesh_plan(plan)
    if blocks and plan.mesh is None:
        raise ValueError("solve(..., blocks=True) is the mesh's block "
                         "entry; the plan has no mesh")
    dev = resolve_device(device if plan.mesh is None else plan.mesh.device)
    u = torch.as_tensor(u, device=dev)
    b = torch.as_tensor(b, device=dev)
    kw = dict(tol=tol, maxiter=maxiter, inner_tol=inner_tol,
              inner_maxiter=inner_maxiter, max_outer=max_outer,
              residual_replacement_every=residual_replacement_every,
              dot=dot, norm2=norm2, layout=layout)
    if plan.mesh is not None and not blocks:
        return _solve_global_on_mesh(plan, u, b, mass, verify=verify,
                                     checkpoint=checkpoint, device=dev, **kw)
    if checkpoint is not None:
        x, stats = _solve_checkpointed(plan, u, b, mass,
                                       checkpoint=checkpoint, **kw)
    elif plan.solver == "blockcg":
        _check_batch_shape(plan, b, layout)
        x, stats = _solve_blockcg(plan, u, b, mass, deflation=deflation,
                                  **kw)
    else:
        x, stats = _run(_loop_parts(plan, u, b, mass, deflation=deflation,
                                    **kw))
    if not verify:
        return x, stats
    if plan.mesh is not None:
        return x, _attach_verification_blocks(plan, u, b, mass, x, stats,
                                              tol, layout)
    return x, _attach_verification(plan, u, b, mass, x, stats, tol,
                                   layout=layout)


def _check_mesh_plan(plan: SolverPlan):
    """The JAX package's dispatch rules for mesh plans, in its words."""
    if plan.mesh is None:
        return
    if plan.solver == "blockcg":
        raise NotImplementedError(
            "blockcg is single-device (its N×N Gram einsums contract "
            "unsharded site axes); drop the mesh or use solver='cgnr'")
    if plan.operator == "eo-schur":
        if plan.precision != "single":
            raise NotImplementedError(
                "sharded eo-schur supports precision='single' (the "
                "mixed-precision Schur solve is single-device for now)")
    elif plan.batched:
        raise NotImplementedError(
            "sharded full-operator solves are single-RHS; use "
            "operator='eo-schur' for the sharded batched fast path")


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
    ctx, b_o, a_hat, rhs = _eo_setup(plan, u, b, mass)
    x_e, stats, (vbuf, albuf, bebuf) = solvers.cg_harvest(
        a_hat, rhs, tol=tol, maxiter=maxiter, m_max=m_max)
    k = stats.iterations
    basis = solvers.ritz_deflation_basis(a_hat, vbuf, albuf, bebuf, k, nev)
    del vbuf
    n_eff = max(1, min(nev, k, int(m_max)))
    stats = stats._replace(matvecs=stats.matvecs + n_eff)
    x = ctx.finish(x_e, back_substitute_odd(ctx.ops, b_o, x_e))
    stats = _attach_verification(
        plan, u, b, mass, x, stats,
        tol if verify_tol is None else float(verify_tol))
    return x, stats, basis


def _run(parts_post) -> tuple[Tensor, solvers.SolveStats]:
    """The one-shot solve: the loop run to its end, mapped to the plan's
    output layout."""
    parts, post = parts_post
    return post(*solvers.run(parts))


def _loop_parts(plan, u, b, mass, *, layout, deflation=None, **kw):
    """Resolve a plan (any loop but block CG) to its solver loop and the
    map of the loop's iterate to the plan's output layout: ``(parts,
    post)``.  :func:`solve` runs the loop to its end, a checkpointed solve
    in segments (:func:`loop_program`); both iterate the same body.  On a
    mesh ``u`` and ``b`` are this rank's blocks, the loop runs on them and
    ``post`` returns this rank's block of x."""
    _check_layout(plan, layout)
    _check_batch_shape(plan, b, layout)
    if plan.mesh is not None:
        if plan.operator == "full":
            return _parts_full_sharded(plan, u, b, mass, layout=layout, **kw)
        return _parts_eo_sharded(plan, u, b, mass, **kw)
    if plan.operator == "full":
        return _parts_full(plan, u, b, mass, layout=layout,
                           deflation=deflation, **kw)
    if plan.precision == "mixed":
        if plan.batched:
            raise NotImplementedError(
                "batched mixed-precision eo-schur is not wired yet (as in "
                "the JAX package); drop nrhs or precision")
        return _parts_eo_mp(plan, u, b, mass, **kw)
    return _parts_eo(plan, u, b, mass, deflation=deflation, **kw)


def _eo_setup(plan, u, b, mass):
    """The even-odd pieces every loop shares: the resolved context, the
    odd half of the RHS, the Schur normal operator and its RHS."""
    ctx = resolve(plan, u, mass, out_dtype=b.dtype)
    b_e, b_o = ctx.prepare(b)
    ops = ctx.ops
    a_hat = lambda v: ops.dhat_dag(ops.dhat(v))  # noqa: E731
    return ctx, b_o, a_hat, schur_rhs(ops, b_e, b_o)


def _eo_post(ctx: EOContext, b_o: Tensor):
    """The even-odd loops' output map: the odd half back-substituted."""
    def post(x_e, stats):
        return ctx.finish(x_e, back_substitute_odd(ctx.ops, b_o, x_e)), stats
    return post


def _parts_eo(plan, u, b, mass, *, tol, maxiter, residual_replacement_every,
              deflation, dot, norm2, **_):
    """CGNR (through the fused CG kernels on the kernels backend) or
    pipelined CG on the Schur normal equations, then the odd half
    back-substituted.  Pipecg runs plain vector algebra, as in the JAX
    package (its recurrences have another shape)."""
    ctx, b_o, a_hat, rhs = _eo_setup(plan, u, b, mass)
    if plan.solver == "pipecg":
        parts = solvers.pipecg_parts(
            a_hat, rhs, tol=tol, maxiter=maxiter,
            residual_replacement_every=residual_replacement_every,
            dot=dot, norm2=norm2, batched=ctx.batched)
    else:
        x0 = None if deflation is None else solvers.deflate_x0(deflation,
                                                               rhs)
        engine = {}
        if ctx.engine is not None:
            engine = dict(update=ctx.engine[0], xpay=ctx.engine[1])
        parts = solvers.cg_parts(a_hat, rhs, x0, tol=tol, maxiter=maxiter,
                                 dot=dot, norm2=norm2, batched=ctx.batched,
                                 **engine)
    return parts, _eo_post(ctx, b_o)


def _solve_blockcg(plan, u, b, mass, *, tol, maxiter, layout, deflation,
                   norm2, **_):
    """Block CG on the Schur normal equations (then the odd half
    back-substituted) or on D^dag D over packed full-lattice fields."""
    if plan.operator == "full":
        up, rhs, op_hi, unpack = _full_setup(plan, u, b, mass, layout)
        x0 = None if deflation is None else solvers.deflate_x0(deflation,
                                                               rhs)
        x, stats = solvers.blockcg(op_hi, rhs, x0, tol=tol, maxiter=maxiter,
                                   norm2=norm2)
        return unpack(x), stats
    ctx, b_o, a_hat, rhs = _eo_setup(plan, u, b, mass)
    x0 = None if deflation is None else solvers.deflate_x0(deflation, rhs)
    x_e, stats = solvers.blockcg(a_hat, rhs, x0, tol=tol, maxiter=maxiter,
                                 norm2=norm2)
    return _eo_post(ctx, b_o)(x_e, stats)


def _parts_eo_mp(plan, u, b, mass, *, tol, inner_tol, inner_maxiter,
                 max_outer, dot, norm2, **_):
    """Even-odd + mixed precision: a low-storage inner CG, wide reliable
    updates and back-substitution.  The loop is the outer reliable-update
    cycle, so a checkpointed solve's segments end at reliable updates.

    Kernels backend: the low representation is the packed half field in
    ``low`` storage (the kernels read it narrow and compute in f32), the
    links rounded once; casts only at the reliable-update boundary; the
    inner CG runs on the hop kernel's and the fused CG kernels' instances
    of that storage.  Reference backend: the low real-pair view of the
    complex half field,
    the links rounded once up front.
    """
    low_dtype = plan.low_dtype
    twist = _family_site(plan, mass).twist
    ctx, b_o, _, rhs = _eo_setup(plan, u, b, mass)
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

        def a_low(w):  # low real pairs in and out, wide inside
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
    parts = solvers.mpcg_parts(
        a_low, a_high, rhs, tol=tol,
        inner_tol=inner_tol, inner_maxiter=inner_maxiter,
        max_outer=max_outer, low_dtype=low_dtype, to_low=to_low,
        to_high=to_high, dot=dot, norm2=norm2, **engine)
    return parts, _eo_post(ctx, b_o)


def _check_full_r(plan):
    if plan.r != 1.0:
        raise NotImplementedError(
            "the full-lattice operator hard-codes r=1 (its spin-projection "
            f"tables need the rank-2 projectors (1 -+ gamma_mu)); got "
            f"r={plan.r}")


def _full_setup(plan, u, b, mass, layout):
    """The full-lattice pieces: packed links, the normal equations' RHS
    D^dag b (one K4 launch), the f32 normal operator and the map back to
    the RHS's layout."""
    from repro_torch.kernels.wilson_dslash import ops as wops

    _check_full_r(plan)
    packed_in = layout == "packed"
    up = u if packed_in else pack_gauge(u)
    pp = b if packed_in else pack_spinor(b)
    m = float(mass)
    kw = dict(twist=_family_site(plan, mass).twist,
              use_kernels=plan.backend == "kernels")
    op_hi = lambda v: wops.normal_op(up, v, m, **kw)  # noqa: E731
    rhs = wops.dslash_dagger(up, pp, m, **kw)

    def unpack(x):
        x = x.to(pp.dtype)
        return x if packed_in else unpack_spinor(x, dtype=b.dtype)

    return up, rhs, op_hi, unpack


def _parts_full(plan, u, b, mass, *, tol, maxiter, layout, inner_tol,
                inner_maxiter, max_outer, residual_replacement_every,
                deflation, dot, norm2):
    """CGNR or pipelined CG on D^dag D over packed full-lattice fields:
    the right-hand side D^dag b is one launch of the full-lattice kernel,
    every matvec two, and the vector algebra is plain tensor code, as in
    the JAX package.  ``precision="mixed"``: mpcg, its inner CG on
    ``low`` fields and links (rounded once), each reliable update two f32
    launches; ``"low"``: cg16, the whole CG on ``low`` storage."""
    from repro_torch.kernels.wilson_dslash import ops as wops

    up, rhs, op_hi, unpack = _full_setup(plan, u, b, mass, layout)
    if plan.precision == "single":
        if plan.solver == "pipecg":
            parts = solvers.pipecg_parts(
                op_hi, rhs, tol=tol, maxiter=maxiter,
                residual_replacement_every=residual_replacement_every,
                dot=dot, norm2=norm2, batched=plan.batched)
        else:
            x0 = (None if deflation is None
                  else solvers.deflate_x0(deflation, rhs))
            parts = solvers.cg_parts(op_hi, rhs, x0, tol=tol,
                                     maxiter=maxiter, dot=dot, norm2=norm2,
                                     batched=plan.batched)
    else:
        low_dtype = plan.low_dtype
        up_lo = up.to(low_dtype)
        m = float(mass)
        kw = dict(twist=_family_site(plan, mass).twist,
                  use_kernels=plan.backend == "kernels")
        op_lo = lambda v: wops.normal_op(up_lo, v, m, **kw)  # noqa: E731
        if plan.precision == "mixed":
            parts = solvers.mpcg_parts(
                op_lo, op_hi, rhs, tol=tol, inner_tol=inner_tol,
                inner_maxiter=inner_maxiter, max_outer=max_outer,
                low_dtype=low_dtype, dot=dot, norm2=norm2,
                batched=plan.batched)
        else:  # "low": all-low cg16, NOT accurate to tol (a measurement rig)
            parts = solvers.cg_parts(op_lo, rhs.to(low_dtype), tol=tol,
                                     maxiter=maxiter, dot=dot, norm2=norm2,
                                     batched=plan.batched)
    return parts, lambda x, stats: (unpack(x), stats)


# ---------------------------------------------------------------------------
# Mesh paths: halo-corrected local operators, all-reduced reductions
# ---------------------------------------------------------------------------
#
# The block entry (``solve(..., blocks=True)``): every rank passes its own
# blocks of u and b, packs them, and runs the single-device loops (cg,
# pipecg, mpcg) on its blocks with the reductions of
# :func:`dist.make_psum_dots`: every value a loop's host test reads is
# all-reduced, so the ranks stop together.  The JAX package's sharded
# loops use plain vector algebra, without the fused CG kernels; so do
# these.  ``post`` maps the loop's iterate to this rank's block of x.
# The global entry (:func:`_solve_global_on_mesh`) slices the global
# fields, runs the block entry and gathers x.


def _mesh_specs(plan: SolverPlan, layout: str):
    """(psi_spec, gauge_spec, sharded) of a mesh plan's fields."""
    return dist.layout_specs(plan.mesh, layout, plan.axis_map)


def _gather_x(plan: SolverPlan, x_blk: Tensor, layout: str) -> Tensor:
    """Every rank's block of x assembled into the global x (one
    all-gather), the same on every rank."""
    psi_spec = _mesh_specs(plan, layout)[0]
    return dist.gather_blocks(plan.mesh, x_blk, psi_spec, dist.global_shape(
        plan.mesh, x_blk.shape, psi_spec))


def _parts_full_sharded(plan, u, b, mass, *, tol, maxiter, layout,
                        inner_tol, inner_maxiter, max_outer,
                        residual_replacement_every, **_):
    """The full-lattice loops on this rank's blocks: K4 on the block (two
    launches a matvec, one for the RHS D^dag b) reading the exchanged
    ghost planes; CGNR, pipecg (one all-reduce an iteration), mpcg (the
    inner CG on K4's instance of the low storage, the links and their
    halo planes rounded once) or cg16.  One RHS."""
    _check_full_r(plan)
    mesh = plan.mesh
    packed_in = layout == "packed"
    up_l = u if packed_in else pack_gauge(u)
    b_l = b if packed_in else pack_spinor(b)
    _, _, sharded = dist.lattice_specs(mesh, plan.axis_map)
    m = float(mass)
    hkw = dict(use_kernels=plan.backend == "kernels",
               twist=_family_site(plan, mass).twist)
    u_prev = dist.link_halos(mesh, sharded, up_l)
    pdot, pnorm2 = dist.make_psum_dots(mesh)

    def normal_op(links, prev):
        return lambda v: dist.normal_op_halo(links, v, m, mesh, sharded,
                                             u_prev=prev, **hkw)

    op_hi = normal_op(up_l, u_prev)
    rhs = dist.dslash_dagger_halo(up_l, b_l, m, mesh, sharded, u_prev=u_prev,
                                  **hkw)
    kw = dict(tol=tol, dot=pdot, norm2=pnorm2)
    if plan.precision == "single":
        if plan.solver == "pipecg":
            parts = solvers.pipecg_parts(
                op_hi, rhs, maxiter=maxiter,
                residual_replacement_every=residual_replacement_every,
                fused_dots=dist.make_fused_psum_dots(mesh), **kw)
        else:
            parts = solvers.cg_parts(op_hi, rhs, maxiter=maxiter, **kw)
    else:
        low = plan.low_dtype
        # the halo planes rounded as the links are: the planes an exchange
        # of the low links would bring
        op_lo = normal_op(up_l.to(low),
                          {mu: p.to(low) for mu, p in u_prev.items()})
        if plan.precision == "mixed":
            parts = solvers.mpcg_parts(
                op_lo, op_hi, rhs, inner_tol=inner_tol,
                inner_maxiter=inner_maxiter, max_outer=max_outer,
                low_dtype=low, **kw)
        else:  # "low": all-low cg16, NOT accurate to tol (a measurement rig)
            parts = solvers.cg_parts(op_lo, rhs.to(low), maxiter=maxiter,
                                     **kw)

    def post(x_l, stats):
        x_l = x_l.to(b_l.dtype)
        return (x_l if packed_in else unpack_spinor(x_l, dtype=b.dtype)), stats

    return parts, post


def _check_eo_sharded(plan: SolverPlan, dims) -> None:
    """The sharded even-odd rules, before any collective: r = 1, and even
    local extents over the GLOBAL lattice ``dims`` (T, Z, Y)."""
    if plan.r != 1.0:
        # both backends: the halo corrections, the plain hop blocks and the
        # kernel all assume r=1 here; fail, never answer wrongly
        raise NotImplementedError(
            "the sharded parity stack hard-codes r=1 (bulk blocks AND "
            f"boundary corrections); got r={plan.r}. Use the single-device "
            "natural-layout path for r != 1.")
    _, _, sharded = dist.lattice_specs(plan.mesh, plan.axis_map)
    for mu, (ax, n) in sorted(sharded.items()):
        ext = dims[mu]
        if ext % n or (ext // n) % 2:
            raise ValueError(
                "sharded even-odd needs EVEN local extents (shard origins "
                "then have even global parity, so each device's local row "
                f"offsets equal the global ones); lattice axis {mu} has "
                f"extent {ext} over {n} '{ax}' shards")


def _eo_sharded_prep(plan: SolverPlan, u: Tensor, b: Tensor, mass):
    """Validate a sharded even-odd plan and split this rank's blocks.

    Even local extents make every block's parity origin even
    (:func:`dist.block_origin`), so the block's local even-odd split is
    its block of the global split.  The natural blocks are split and
    packed as on one device (the packed context of :func:`eo_context`,
    whatever the backend: the sharded stack runs on packed half fields).
    Returns ``(ctx, (upe, upo, pb_e, pb_o), sharded)``.
    """
    psi_spec = _mesh_specs(plan, "natural")[0]
    _check_eo_sharded(plan, dist.global_shape(plan.mesh, b.shape, psi_spec)
                      [-6:-3])
    assert sum(dist.block_origin(plan.mesh, b.shape, psi_spec)[:3]) % 2 == 0
    _, _, sharded = dist.lattice_specs(plan.mesh, plan.axis_map)
    ctx = eo_context(u, mass, twist=_family_site(plan, mass).twist,
                     use_kernels=True, batched=plan.batched,
                     out_dtype=b.dtype)
    b_e, b_o = ctx.prepare(b)
    return ctx, (ctx.ops.u_e, ctx.ops.u_o, b_e, b_o), sharded


def _parts_eo_sharded(plan, u, b, mass, *, tol, maxiter,
                      residual_replacement_every, **_):
    """Even-odd Schur CGNR or pipecg on this rank's blocks: the matvec is
    :func:`dist.schur_normal_op_halo` (four K1 launches on the block and
    their halo corrections); the RHS costs three launches and the odd
    half's back-substitution one, so a solve launches K1 4I + 4 times, as
    on one device.  The link halo planes are exchanged once, here."""
    mesh = plan.mesh
    batched = plan.batched
    ctx, (upe, upo, pb_e, pb_o), sharded = _eo_sharded_prep(plan, u, b, mass)
    site = _family_site(plan, mass)
    hkw = dict(use_kernels=plan.backend == "kernels",
               u_prev=(dist.link_halos(mesh, sharded, upe),
                       dist.link_halos(mesh, sharded, upo)))

    def d_eo(v):
        return dist.parity_hop_halo("eo", upe, upo, v, mesh, sharded, **hkw)

    def d_oe(v):
        return dist.parity_hop_halo("oe", upe, upo, v, mesh, sharded, **hkw)

    def a_hat(v):
        return dist.schur_normal_op_halo(upe, upo, v, mass, mesh, sharded,
                                         twist=site.twist, **hkw)

    b_hat = pb_e - d_eo(site.solve(pb_o))
    rhs = dist.schur_op_halo(upe, upo, b_hat, mass, mesh, sharded,
                             twist=site.twist, dagger=True, **hkw)
    pdot, pnorm2 = dist.make_psum_dots(mesh, batched=batched)
    kw = dict(tol=tol, maxiter=maxiter, dot=pdot, norm2=pnorm2,
              batched=batched)
    if plan.solver == "pipecg":
        parts = solvers.pipecg_parts(
            a_hat, rhs, residual_replacement_every=residual_replacement_every,
            fused_dots=dist.make_fused_psum_dots(mesh, batched=batched), **kw)
    else:
        parts = solvers.cg_parts(a_hat, rhs, **kw)

    def post(x_e, stats):
        return ctx.finish(x_e, site.solve(pb_o - d_oe(x_e))), stats

    return parts, post


def _shard_global(plan: SolverPlan, u: Tensor, b: Tensor, layout: str):
    """The global entry's slicing: the mesh rules checked on the global
    shapes (in the JAX package's words), then this rank's blocks
    (:func:`dist.shard_lattice_fields`)."""
    _check_batch_shape(plan, b, layout)
    if plan.operator == "eo-schur":
        _check_eo_sharded(plan, b.shape[-6:-3])
    return dist.shard_lattice_fields(plan.mesh, u, b, plan.axis_map,
                                     layout=layout)


def _solve_global_on_mesh(plan: SolverPlan, u: Tensor, b: Tensor, mass, *,
                          tol, layout, verify, **kw):
    """The global entry of a mesh plan, a thin wrapper of the block entry:
    this rank's blocks sliced from the global fields, the block entry run
    on them, x gathered (one all-gather) and verified on rank 0 against
    the global fields (:func:`_attach_verification_mesh`)."""
    u_l, b_l = _shard_global(plan, u, b, layout)
    x_l, stats = solve(plan, u_l, b_l, mass, tol=tol, layout=layout,
                       verify=False, blocks=True, **kw)
    x = _gather_x(plan, x_l, layout)
    del x_l
    if not verify:
        return x, stats
    return x, _attach_verification_mesh(plan, u, b, mass, x, stats, tol,
                                        layout)


def _attach_verification_mesh(plan: SolverPlan, u, b, mass, x, stats, tol,
                              layout: str) -> solvers.SolveStats:
    """:func:`_attach_verification` of a global-entry mesh solve: rank 0
    checks the gathered x against the global fields with the
    single-device oracle (no halo code, so a broken transport cannot
    vouch for itself) and broadcasts the true residual, the gate's result
    and the verdict in one collective; every rank returns the same
    stats."""
    mesh = plan.mesh
    rs, ok, verdict = (stats.residual_norm2.to(torch.float32),
                       torch.zeros_like(stats.converged), stats.verdict)
    if mesh.rank == 0:
        v = _attach_verification(plan, u, b, mass, x, stats, tol,
                                 layout=layout)
        rs, ok, verdict = v.true_residual_norm2, v.verified, v.verdict
    got = mesh.broadcast(torch.stack([rs.double(), ok.double(),
                                      verdict.double()]))
    return stats._replace(true_residual_norm2=got[0].to(torch.float32),
                          verified=got[1] != 0,
                          verdict=got[2].to(torch.int32))


def mesh_true_residual(plan: SolverPlan, u: Tensor, b: Tensor, mass,
                       x: Tensor, layout: str = "natural"):
    """The true residual of a block-entry mesh solve: ``(r, rs, bs)``,
    this rank's block of ``b - D x`` and the all-reduced ``||b - D x||^2``
    and ``||b||^2`` (per RHS when batched), the same bits on every rank.

    Each rank evaluates the family's plain natural ``dslash_g`` on its
    blocks padded with one neighbour plane per sharded direction
    (:func:`dist.pad_with_faces`: one all-gather of boundary planes,
    none of the solver's halo code, K1 or K4), so a broken halo exchange
    cannot vouch for itself.  It does so in VERIFY_SLABS slabs along a
    padded axis (each slab with its two neighbour rows, whose wrap no
    output row reads), so its temporaries are a slab's, not the block's.
    The two norms travel in one all-reduce, counted as
    ``verify_all_reduce``."""
    mesh = plan.mesh
    site = _family_site(plan, mass)
    if layout == "packed":
        u, b, x = unpack_gauge(u), unpack_spinor(b), unpack_spinor(x)
    _, _, sharded = dist.lattice_specs(mesh, plan.axis_map)
    u_pad, x_pad, inner = dist.pad_with_faces(mesh, sharded, u, x)
    padded = [mu for mu, sl in enumerate(inner) if sl != slice(None)]

    def apply_d(v):
        if not padded:
            return dslash_g(u_pad, v, mass, r=plan.r, twist=site.twist)
        a = padded[0]
        n = v.shape[a] - 2
        step = -(-n // VERIFY_SLABS)
        out = []
        for lo in range(0, n, step):
            rows = (slice(None),) * a + (slice(lo, min(n, lo + step) + 2),)
            keep = list(inner)
            keep[a] = slice(1, -1)
            out.append(dslash_g(u_pad[(slice(None),) + rows], v[rows], mass,
                                r=plan.r, twist=site.twist)[tuple(keep)])
        return torch.cat(out, dim=a)

    if plan.batched:
        ax = torch.stack([apply_d(x_pad[n]) for n in range(x.shape[0])])
    else:
        ax = apply_d(x_pad)
    del u_pad, x_pad
    r = b - ax.to(b.dtype)
    del ax
    norm2_fn = field_norm2_batched if plan.batched else field_norm2
    both = mesh.psum(torch.stack([norm2_fn(r).real, norm2_fn(b).real]),
                     kind="verify_all_reduce")
    return r, both[0], both[1]


def _attach_verification_blocks(plan: SolverPlan, u, b, mass, x, stats, tol,
                                layout: str) -> solvers.SolveStats:
    """:func:`_attach_verification` of a block-entry mesh solve, on no
    rank's global field: the true residual of :func:`mesh_true_residual`
    gated as on one device; every rank returns the same stats."""
    _, rs_true, bs = mesh_true_residual(plan, u, b, mass, x, layout)
    return _gated(stats, rs_true, bs, tol)


# ---------------------------------------------------------------------------
# Segmented solving: durability without touching the loop body
# ---------------------------------------------------------------------------
#
# A CheckpointPolicy runs the same loop body in segments of at most
# ``every_iters`` iterations and snapshots ``(x, iteration, verdict,
# rhs_mask)`` between them.  The segment's stopping rule is the solver's
# own ``cond`` and an iteration bound on the carry's host-int counter
# (``solvers.segment_cond``), so the iterates are bitwise the one-shot
# solve's and a segment adds no device read an iteration; the snapshot's
# I/O happens at segment boundaries only.


@dataclasses.dataclass(frozen=True)
class CheckpointPolicy:
    """How a durable solve checkpoints.

    Fields:
      dir:         checkpoint directory (``step_<N>`` subdirs; see
        :mod:`repro_torch.checkpoint.ckpt`).
      every_iters: segment length: snapshot after at most this many
        iterations (inner iterations for precision="mixed", whose
        segments end at reliable-update boundaries and may overrun by one
        inner solve).
      keep:        how many newest checkpoints to retain; older steps are
        pruned after each snapshot.  Keep >= 2 so a crash mid-write plus
        a corrupted latest step still leaves a restorable previous step.
    """

    dir: str
    every_iters: int = 50
    keep: int = 2

    def __post_init__(self):
        if not self.dir:
            raise ValueError("CheckpointPolicy.dir must be a directory path")
        if self.every_iters < 1:
            raise ValueError("CheckpointPolicy.every_iters must be >= 1, "
                             f"got {self.every_iters}")
        if self.keep < 1:
            raise ValueError(f"CheckpointPolicy.keep must be >= 1, "
                             f"got {self.keep}")


class LoopProgram(NamedTuple):
    """A plan's solve as a host-steppable program.

    ``start()`` returns the initial ``(carry, continue?)``; ``step(carry,
    stop)`` iterates the solver's own loop while it continues and
    ``counter(carry) < stop``, and returns the advanced ``(carry,
    continue?)``; ``finalize(carry)`` produces ``(x, SolveStats)`` in the
    plan's output layout from any carry, which is what a snapshot stores.
    ``counter(carry)`` is the iteration count, a host int.
    """

    start: Callable      # () -> (carry, cont)
    step: Callable       # (carry, stop: int) -> (carry, cont)
    counter: Callable    # carry -> int
    finalize: Callable   # carry -> (x, SolveStats)


def _segmented_program(parts: solvers.LoopParts, post) -> LoopProgram:
    """Wrap :class:`solvers.LoopParts` as a LoopProgram.  ``post(x_solver,
    stats)`` maps the solver's iterate to the plan's output layout; it
    runs at segment boundaries and at the end, never inside the loop."""
    seg_cond = solvers.segment_cond(parts)

    def step(carry, stop):
        while seg_cond(carry, int(stop)):
            carry = parts.body(carry)
        return carry, parts.cond(carry)

    def start():
        return parts.init, parts.cond(parts.init)

    def finalize(carry):
        return post(*parts.finish(carry))

    return LoopProgram(start=start, step=step, counter=parts.counter,
                       finalize=finalize)


def loop_program(plan: SolverPlan, u, b, mass, *, tol: float = 1e-8,
                 maxiter: int = 1000, inner_tol: float = 5e-2,
                 inner_maxiter: int = 200, max_outer: int = 50,
                 residual_replacement_every: int = 25, dot=field_dot,
                 norm2=field_norm2, layout: str = "natural",
                 device="cuda", blocks: bool = False) -> LoopProgram:
    """Resolve a plan to its host-steppable :class:`LoopProgram`.

    Mirrors :func:`solve`'s dispatch; ``finalize(carry)`` after stepping
    to the end is bitwise the one-shot ``solve``'s result before its
    verification (the same loop body, only the stopping rule differs).
    On a mesh (the even-odd path only) the carry stays on each rank's
    blocks between segments.  With ``blocks=True`` (:func:`solve`'s block
    entry) u and b are this rank's blocks and ``finalize`` returns this
    rank's block of x; otherwise they are the global fields, sliced here,
    and ``finalize`` gathers the global x.
    """
    if plan.solver == "blockcg":
        raise NotImplementedError(
            "blockcg has no segmented LoopProgram (checkpointing shares "
            "the cg/pipecg carry contracts); use solver='cgnr' for "
            "checkpointed solves")
    if plan.mesh is not None:
        if plan.operator != "eo-schur":
            raise NotImplementedError(
                "segmented solving on a mesh is wired for the eo-schur "
                "fast path; use operator='eo-schur' (or drop the mesh)")
        _check_mesh_plan(plan)
        device = plan.mesh.device
    elif blocks:
        raise ValueError("loop_program(..., blocks=True) takes a mesh plan")
    dev = resolve_device(device)
    u = torch.as_tensor(u, device=dev)
    b = torch.as_tensor(b, device=dev)
    gather = plan.mesh is not None and not blocks
    if gather:
        u, b = _shard_global(plan, u, b, layout)
    prog = _segmented_program(*_loop_parts(
        plan, u, b, mass, tol=tol, maxiter=maxiter, inner_tol=inner_tol,
        inner_maxiter=inner_maxiter, max_outer=max_outer,
        residual_replacement_every=residual_replacement_every, dot=dot,
        norm2=norm2, layout=layout))
    if not gather:
        return prog

    def finalize(carry):
        x, stats = prog.finalize(carry)
        return _gather_x(plan, x, layout), stats

    return prog._replace(finalize=finalize)


def _snapshot(checkpoint: CheckpointPolicy, prog: LoopProgram, carry,
              mesh: dist.Mesh | None = None, gather=None) -> int:
    """Write one durable snapshot from a segment-boundary carry.

    Stores the plan-layout iterate and the resume contract ``(x,
    iteration, verdict, rhs_mask)`` as host arrays, in the JAX package's
    dtypes (the iteration an int32 scalar), keyed by the iteration count
    as the step number.  On a mesh every rank finalizes to its block of x
    and ``gather`` assembles the global x (a collective), rank 0 writes
    the unsharded x, and a barrier holds every rank until the step is on
    disk.  Returns the step written.
    """
    from repro_torch.checkpoint import ckpt

    x, stats = prog.finalize(carry)
    if gather is not None:
        x = gather(x)
    step = int(stats.iterations)
    if mesh is None or mesh.rank == 0:
        ckpt.save_checkpoint(checkpoint.dir, step, {
            "x": x,
            "iteration": np.asarray(step, np.int32),
            "verdict": stats.verdict,
            "rhs_mask": stats.converged,
        })
        ckpt.prune_checkpoints(checkpoint.dir, checkpoint.keep)
    if mesh is not None:
        mesh.barrier()
    return step


def _solve_checkpointed(plan, u, b, mass, *, checkpoint, **kw):
    """Run a plan's LoopProgram in segments, snapshotting between them (on
    a mesh, on this rank's blocks: the block entry's program).

    The host loop below is the only durability addition: between two
    snapshots runs the one-shot solve's own loop.  A process killed
    mid-segment loses at most ``every_iters`` iterations;
    :func:`repro_torch.core.resilience.resume_solve` picks the run back up
    from the latest valid snapshot.
    """
    mesh = plan.mesh
    prog = loop_program(plan, u, b, mass, device=b.device,
                        blocks=mesh is not None, **kw)
    gather = None
    if mesh is not None:
        gather = lambda x: _gather_x(plan, x, kw["layout"])  # noqa: E731
    every = int(checkpoint.every_iters)
    carry, cont = prog.start()
    while cont:
        carry, cont = prog.step(carry, prog.counter(carry) + every)
        _snapshot(checkpoint, prog, carry, mesh, gather)
    return prog.finalize(carry)
