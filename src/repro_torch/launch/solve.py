"""Lattice solver launcher — the paper's workload end to end, plan-driven.

    python -m repro_torch.launch.solve --lattice 8x8x8x16
    python -m repro_torch.launch.solve --nrhs 4
    python -m repro_torch.launch.solve --parity eo --solver cgnr
    python -m repro_torch.launch.solve --parity eo --solver blockcg --nrhs 4
    python -m repro_torch.launch.solve --parity eo --solver cgnr --deflate 8
    python -m repro_torch.launch.solve --operator twisted-mass --mu 0.25
    python -m repro_torch.launch.solve --backend reference --device cpu
    python -m repro_torch.launch.solve --parity eo --solver cgnr \
        --checkpoint-dir ckpt --checkpoint-every 5
    python -m repro_torch.launch.solve --parity eo --solver cgnr \
        --checkpoint-dir ckpt --resume
    torchrun --nproc-per-node 4 -m repro_torch.launch.solve --device cpu \
        --mesh debug --parity eo --nrhs 4 --solver pipecg
    torchrun --nproc-per-node 4 -m repro_torch.launch.solve --device cpu \
        --mesh debug --parity eo --solver cgnr --checkpoint-dir ckpt --resume

Builds a random SU(3) gauge configuration and source(s) from ``--seed``,
solves D x = b on the full lattice (``--parity full``, the default) or on
the even-odd Schur complement (``--parity eo``) through one
:class:`repro_torch.core.plan.SolverPlan`: ``--solver mpcg`` (the
default) is the mixed-precision reliable-update CG with a bf16 inner CG,
``cgnr`` CGNR in f32, ``pipecg`` pipelined CG (one fused reduction an
iteration), ``blockcg`` block CG over an ``--nrhs`` batch (one shared
Krylov space), ``cg16`` an all-bf16 CG on the full lattice (not accurate
to ``--tol``, so it reports FAIL by design).  ``--deflate NEV`` first
harvests an NEV-vector EigCG basis from a solve of another RHS on the
same gauge field (even-odd, cgnr or blockcg) and starts this solve from
its projection.  ``--checkpoint-dir`` segments the
solve and snapshots it every ``--checkpoint-every`` iterations;
``--resume`` continues from the directory's latest valid snapshot (the
JAX package's checkpoints included) in a fresh process.  ``--mesh debug``
runs under ``torchrun --nproc-per-node 4`` on a 2x2 ``data`` x ``model``
mesh (T and Z sharded; :func:`repro_torch.launch.mesh.make_debug_mesh`:
NCCL with a card a rank, else gloo); every rank solves the same system
and rank 0 reports.  ``--resume`` works there too: every rank restores
the snapshot (one-device and mesh snapshots hold the same unsharded x),
and rank 0 banks the result.  The sha256 of
the u and b built from ``--seed`` is printed, so a resumed process shows
it solves the killed process's system.  Reports iterations,
matvecs, the true relative residual and the verdict — per right-hand side
for a batch.  Runs on the card (``--device cuda``, the default) and
refuses to fall back to the CPU when there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import sys
import time

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core import solvers
from repro_torch.core.lattice import (LatticeShape, random_spinor,
                                      resolve_device)
from repro_torch.core.operators import dslash_g, get_operator, operator_names
from repro_torch.data import lattice_problem


# solver name -> (Krylov loop, precision), as the JAX package's CLI maps
# them
_SOLVERS = {
    "cgnr": ("cgnr", "single"),
    "pipecg": ("pipecg", "single"),
    "blockcg": ("blockcg", "single"),
    "mpcg": ("cgnr", "mixed"),
    "cg16": ("cgnr", "low"),
}


def _sha256(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes on the host."""
    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def build_plan(args, mesh=None) -> plan_mod.SolverPlan:
    """Resolve the CLI axes to a SolverPlan."""
    loop, precision = _SOLVERS[args.solver]
    return plan_mod.SolverPlan(operator="eo-schur" if args.parity == "eo"
                               else "full",
                               operator_family=args.operator, mu=args.mu,
                               backend=args.backend, solver=loop,
                               precision=precision, nrhs=args.nrhs,
                               mesh=mesh)


def debug_mesh(device):
    """The 2x2 ``data`` x ``model`` mesh of ``--mesh debug``; outside
    ``torchrun`` a clear exit."""
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        return make_debug_mesh((2, 2), ("data", "model"), device=device)
    except RuntimeError as e:
        raise SystemExit(f"[solve] --mesh debug: {e}") from None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lattice", default="4x4x4x8", help="TxZxYxX extents")
    p.add_argument("--mass", type=float, default=0.2)
    p.add_argument("--solver", default="mpcg", choices=sorted(_SOLVERS),
                   help="Krylov loop / precision policy (blockcg shares "
                        "one search space across an --nrhs batch)")
    p.add_argument("--parity", choices=["full", "eo"], default="full",
                   help="operator shape: the full lattice or the even-odd "
                        "Schur complement")
    p.add_argument("--operator", default="wilson",
                   choices=sorted(operator_names()),
                   help="operator family from the registry: "
                        + "; ".join(f"{n}: {get_operator(n).description}"
                                    for n in operator_names()))
    p.add_argument("--mu", type=float, default=0.0,
                   help="twisted-mass site parameter (i*mu*gamma5 term)")
    p.add_argument("--backend", choices=["reference", "kernels"],
                   default="kernels")
    p.add_argument("--nrhs", type=int, default=None,
                   help="solve N right-hand sides in one masked CG loop")
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--deflate", type=int, default=0, metavar="NEV",
                   help="harvest an NEV-vector EigCG deflation basis from "
                        "a solve of a separate RHS (same gauge and mass), "
                        "then start this solve from its projection (eo "
                        "parity, cgnr/blockcg, single precision only)")
    p.add_argument("--deflate-harvest-tol", type=float, default=1e-8,
                   help="recursive-residual tolerance the harvest solve "
                        "iterates to (deeper than --tol mines more "
                        "spectrum)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="segment the solve and snapshot (x, iteration, "
                        "verdict, rhs_mask) here every --checkpoint-every "
                        "iterations")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="segment length in iterations between snapshots")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest valid checkpoint from "
                        "--checkpoint-dir and defect-correct from the "
                        "saved iterate (fresh checkpointed solve when the "
                        "directory has no checkpoint yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    p.add_argument("--mesh", default="none", choices=["none", "debug"],
                   help="debug: a 2x2 data x model mesh over the ranks of "
                        "`torchrun --nproc-per-node 4`")
    args = p.parse_args(argv)
    if args.resume and args.checkpoint_dir is None:
        p.error("--resume requires --checkpoint-dir")
    if args.deflate > 0 and (args.resume or args.checkpoint_dir):
        p.error("--deflate does not compose with checkpointed solves")
    if args.mesh != "none" and args.deflate > 0:
        p.error("--deflate runs on one device (the harvest is "
                "single-device, as in the JAX package)")

    mesh = debug_mesh(args.device) if args.mesh == "debug" else None
    try:
        return _run(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as tdist
            tdist.destroy_process_group()


def _run(args, mesh) -> int:
    # on a mesh every rank solves and rank 0 reports
    def say(*a, **k):
        if mesh is None or mesh.rank == 0:
            print(*a, **k)

    dev = resolve_device(args.device if mesh is None else mesh.device)
    shape = LatticeShape(*(int(v) for v in args.lattice.split("x")))
    u, b = lattice_problem(shape, mass=args.mass, seed=args.seed,
                           packed=False, device=dev)
    if args.nrhs is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1)
        b = torch.stack([random_spinor(gen, shape)
                         for _ in range(args.nrhs)])
    try:
        plan = build_plan(args, mesh)
    except (ValueError, NotImplementedError) as e:
        say(f"[solve] invalid plan: {e}")
        return 1
    where = (None if mesh is None else f"{mesh.shape} transport="
             f"{mesh.transport} world={mesh.world_size}")
    say(f"[solve] plan: operator={plan.operator} "
        f"family={plan.operator_family} mu={plan.mu} "
        f"backend={plan.backend} solver={plan.solver} "
        f"precision={plan.precision} nrhs={plan.nrhs} mesh={where} "
        f"device={dev}")
    say(f"[solve] system: u sha256={_sha256(u)} b sha256={_sha256(b)}",
        flush=True)

    deflation = None
    if args.deflate > 0:
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 2)
        b_h = random_spinor(gen, shape)
        th = time.perf_counter()
        try:
            _, hst, deflation = plan_mod.harvest_deflation(
                dataclasses.replace(plan, solver="cgnr", nrhs=None), u, b_h,
                args.mass, tol=args.deflate_harvest_tol,
                maxiter=args.maxiter, nev=args.deflate,
                m_max=max(4 * args.deflate, 48), verify_tol=args.tol,
                device=dev)
        except (ValueError, NotImplementedError) as e:
            say(f"[solve] invalid plan: {e}")
            return 1
        say(f"[solve] deflation harvest: nev={deflation.nev} "
            f"iters={hst.iterations} matvecs={int(hst.matvecs)} "
            f"verified={bool(hst.verified)} "
            f"time={time.perf_counter() - th:.2f}s")

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    try:
        if args.resume:
            from repro_torch.core import resilience
            xsol, st, record = resilience.resume_solve(
                plan, u, b, args.mass, checkpoint_dir=args.checkpoint_dir,
                tol=args.tol, maxiter=args.maxiter, missing_ok=True,
                device=dev)
            if record.resumed_from_step is None:
                say("[solve] no checkpoint found; fresh checkpointed "
                    "solve", flush=True)
            else:
                say(f"[solve] resumed from step "
                    f"{record.resumed_from_step} "
                    f"({record.checkpoint_iterations} iterations banked, "
                    f"checkpoint verdict "
                    f"{record.checkpoint_verdict})", flush=True)
            for a in record.attempts:
                say(f"[solve] attempt {a.attempt}: {a.plan_desc} "
                    f"restarted={a.restarted} iterations={a.iterations} "
                    f"verdict={a.verdict} verified={a.verified}",
                    flush=True)
        else:
            policy = None
            if args.checkpoint_dir is not None:
                policy = plan_mod.CheckpointPolicy(
                    dir=args.checkpoint_dir,
                    every_iters=args.checkpoint_every)
                say(f"[solve] checkpointing to {policy.dir} every "
                    f"{policy.every_iters} iterations", flush=True)
            xsol, st = plan_mod.solve(plan, u, b, args.mass, tol=args.tol,
                                      maxiter=args.maxiter,
                                      deflation=deflation,
                                      checkpoint=policy, device=dev)
    except (ValueError, NotImplementedError) as e:
        # a composition the plan refuses
        say(f"[solve] invalid plan: {e}")
        return 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    twist = plan.twist
    op = lambda v: dslash_g(u, v, args.mass, twist=twist)
    xs = xsol if plan.batched else xsol[None]
    bs = b if plan.batched else b[None]
    rels = [float(torch.linalg.vector_norm(op(xs[n]) - bs[n])
                  / torch.linalg.vector_norm(bs[n]))
            for n in range(xs.shape[0])]
    verdicts = torch.atleast_1d(st.verdict).tolist()
    verified = torch.atleast_1d(st.verified).tolist()
    matvecs = torch.atleast_1d(st.matvecs).tolist()
    if plan.batched:
        per_rhs = st.rhs_iterations.tolist()
        say("[solve] per-RHS iterations: " + " ".join(
            f"rhs{i}={n}" for i, n in enumerate(per_rhs)))
        say("[solve] per-RHS matvecs:    " + " ".join(
            f"rhs{i}={v}" for i, v in enumerate(matvecs)))
        say("[solve] per-RHS rel_res:   " + " ".join(
            f"rhs{i}={r:.2e}" for i, r in enumerate(rels)))
        say("[solve] per-RHS verdict:   " + " ".join(
            f"rhs{i}={solvers.verdict_name(v)}"
            + ("" if verified[i] else "(UNVERIFIED)")
            for i, v in enumerate(verdicts)))
    else:
        say(f"[solve] verdict: {solvers.verdict_name(verdicts[0])} "
            f"verified={verified[0]}")

    # a solve succeeds only when every RHS converged by the taxonomy and
    # passed the true-residual verification matvec
    rel = max(rels)
    ok = rel < 10 * args.tol and all(
        v == solvers.CONVERGED and verified[i]
        for i, v in enumerate(verdicts))
    if not ok:
        say("[solve] FAIL: " + " ".join(
            f"rhs{i}:{solvers.verdict_name(v)}"
            for i, v in enumerate(verdicts)
            if v != solvers.CONVERGED or not verified[i]))
    say(f"[solve] lattice={shape} iters={st.iterations} "
        f"outer={st.outer_iterations} "
        f"matvecs={max(matvecs)} (total {sum(matvecs)} across "
        f"{len(matvecs)} RHS) max_rel_res={rel:.2e} time={dt:.3f}s "
        f"device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
