"""The port's multi-device solves against the JAX package's sharded ones.

Four gloo ranks (CPU processes, one thread each, a ``file://`` rendezvous
under the test's temporary directory) build two meshes from the same
ranks: 2x2 (``data``, ``model``: T and Z sharded) and 2x1x2 (``pod``,
``data``, ``model``: Y and Z sharded).  The inputs (a 4x4x4x8 lattice,
SU(3) links and RHS drawn with numpy from seed 20) and the JAX twins of
the 2x2 mesh's solves come from ``src/repro_torch/data/
mesh_twins_4x4x4x8_seed20.npz``, written by ``scripts/mesh_twins.py``
(JAX's sharded solves on four fake CPU devices with ``verify=False``: on
jax 0.9.0 only their verification raises; compiling the five sharded
loops costs minutes of one core, more than the suite's clock can pay on
every run).  Two JAX subprocesses (four fake devices, one core each)
run JAX's halo operators on either mesh live, trace the psums of its
sharded loops and raise its mesh rules.  Held here:

* every halo operator within 1e-5 (max-abs error over max-abs entry) of
  its JAX twin on the same mesh shape, and the Schur normal operator also
  of the port's global single-device operator;
* every sharded solve of the 2x2 mesh at JAX's iteration counts per RHS
  (inner and outer for mpcg), x within 1e-5 of JAX's x, verified by the
  port, with the same stats on every rank; the even-odd solves and full
  mpcg of the 2x1x2 mesh likewise against the port's single-device
  solve; cg16 and the legacy ``solve_wilson`` on the mesh;
* the halo'd K4 operators (f32, bf16 and float16), gathered, bitwise one
  global evaluation; the halo'd K1 operators in bf16 bitwise one away
  from the blocks' boundary planes;
* the all-reduces of one iteration equal to the psums in the body of
  JAX's while loop (cg 2, pipecg 1 for the whole batch), and the link
  halo planes exchanged once a solve;
* the mesh rules raising with JAX's own messages;
* a checkpointed mesh solve bitwise its one-shot mesh solve, with the
  single-device segmented solve's steps, and a starved mesh run resumed
  on one device to a verified x;
* the block entry (``solve(..., blocks=True)`` on each rank's blocks):
  every mesh solve's gathered x bitwise the global entry's on both
  meshes, the same counts, its blockwise verification within 1e-6 of
  rank 0's, packed blocks too, and a solve whose halo planes arrive
  corrupted reported unverified;
* ``resume_solve`` of the starved checkpoint on both meshes through both
  entries, and ``defended_solve`` starved on the mesh, with the same
  records on every rank;
* ``torchrun --nproc-per-node 4 -m repro_torch.launch.solve --mesh
  debug``, its ``--resume`` of a mesh run's snapshots, and that CLI's
  error outside ``torchrun``.

Every process group has a 60 s timeout and every spawn a deadline.  The
file runs as a script for one rank of the spawn:
``python tests/test_torch_distributed.py <rank> <dir>``.
"""

import dataclasses
import datetime
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_one_thread  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
TWINS = ROOT / "src" / "repro_torch" / "data" / "mesh_twins_4x4x4x8_seed20.npz"
MASS, TOL, MAXITER = 0.1, 1e-6, 500
DIMS = (4, 4, 4, 8)                 # T, Z, Y, X
WORLD = 4
PG_TIMEOUT = datetime.timedelta(seconds=60)
DEADLINE_S = 600                    # every spawn's join deadline
CORRUPT_MAXITER = 40                # the corrupted-halo solve's maxiter
DEFENDED_STARVE = 8                 # the defended solves' maxiter
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# the CLI's resume of a mesh run's snapshots under torchrun: the ranks of
# the spawn run the CLI's system (its defaults: 4x4x4x8, seed 0, mass 0.2)
# on the 2x2 mesh, checkpointed and starved at 6 iterations, into
# <dir>/ck_cli; then this resumes it
CLI_RESUME_ARGV = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc-per-node", "4", "-m",
                   "repro_torch.launch.solve", "--device", "cpu", "--mesh",
                   "debug", "--parity", "eo", "--solver", "cgnr", "--resume"]
CLI_MASS, CLI_STARVE = 0.2, 6
# (solve, plan fields, RHS name) of the satellite list, as
# scripts/mesh_twins.py runs them
SOLVES = {"eo_cgnr_n2": (dict(nrhs=2), "bb"),
          "eo_pipecg_n2_tm": (dict(nrhs=2, solver="pipecg",
                                   operator_family="twisted-mass", mu=0.3),
                              "bb"),
          "full_cgnr": (dict(operator="full"), "b"),
          "full_pipecg": (dict(operator="full", solver="pipecg"), "b"),
          "full_mpcg": (dict(operator="full", precision="mixed"), "b")}
# parity hop flag sets: (which, keywords, batched)
HOPS = {"oe_g5in_twist": ("oe", dict(gamma5_in=True, hop_coeff=0.2,
                                     hop_twist=0.05), False),
        "eo_g5out_acc_twist_n2": ("eo", dict(gamma5_out=True, acc_coeff=4.1,
                                             acc_twist=0.3, hop_coeff=-0.3),
                                  True)}
HALOS = (["dslash", "dslash_tm"] + [f"hop_{h}" for h in HOPS]
         + ["schur_normal_0.0", "schur_normal_0.3"])
# the mesh rules: (name, plan fields, field shapes), raised before any
# collective, by the port and by JAX
RULES = {"blockcg": (dict(solver="blockcg", nrhs=2), DIMS, 2),
         "mixed_eo": (dict(precision="mixed"), DIMS, None),
         "batched_full": (dict(operator="full", nrhs=2), DIMS, 2),
         "odd_local_extent": ({}, (6, 4, 4, 8), None),
         "r_not_1": (dict(r=0.5), DIMS, None)}

_JAX_COMMON = r"""
import json, os, sys, time
# one core each (the last argument picks it): the reference's compiles
# then cost their one-core time, not that plus several spinning threads
cpus = sorted(os.sched_getaffinity(0))
os.sched_setaffinity(0, {cpus[int(sys.argv[-1]) % len(cpus)]})
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.core import distributed as dist
from repro.core import plan as plan_mod
from repro.core import solvers
from repro.core.lattice import (pack_gauge, pack_spinor, split_eo,
                                split_eo_gauge)

d = sys.argv[1]
f = np.load(os.path.join(d, "inputs.npz"))
u, b, bb = (jnp.asarray(f[k]) for k in ("u", "b", "bb"))
M = 0.1
meshes = {"2x2": make_mesh((2, 2), ("data", "model")),
          "2x1x2": make_mesh((2, 1, 2), ("pod", "data", "model"))}
out, arrays = {}, {}
"""

_JAX_HALOS = _JAX_COMMON + r"""
HOPS = json.loads(sys.argv[2])
RULES = json.loads(sys.argv[3])
halo_mesh = sys.argv[4]
up, pp = pack_gauge(u), pack_spinor(b)
u_e, u_o = split_eo_gauge(u)
upe, upo = pack_gauge(u_e), pack_gauge(u_o)
pe = pack_spinor(split_eo(b)[0])
pbe = pack_spinor(jax.vmap(split_eo)(bb)[0])
for mname, mesh in [(halo_mesh, meshes[halo_mesh])]:
    psi_spec, gauge_spec, sharded = dist.lattice_specs(mesh)
    bspec = P(None, *psi_spec)

    def halos(up_, pp_, ue, uo, pe_, pbe_):
        outs = [dist.dslash_halo(up_, pp_, M, sharded),
                dist.dslash_halo(up_, pp_, M, sharded, twist=0.3)]
        for which, kw, batched in HOPS.values():
            p = pbe_ if batched else pe_
            acc = (0.5 * p + 0.1) if "acc_coeff" in kw else None
            outs.append(dist.parity_hop_halo(which, ue, uo, p, sharded,
                                             psi_acc=acc, **kw))
        for tw in (0.0, 0.3):
            outs.append(dist.schur_normal_op_halo(ue, uo, pe_, M, sharded,
                                                  twist=tw))
        return tuple(outs)

    ospecs = ((psi_spec,) * 2
              + tuple(bspec if h[2] else psi_spec for h in HOPS.values())
              + (psi_spec,) * 2)
    res = jax.jit(shard_map(
        halos, mesh=mesh,
        in_specs=(gauge_spec, psi_spec, gauge_spec, gauge_spec, psi_spec,
                  bspec),
        out_specs=ospecs, check_vma=False))(up, pp, upe, upo, pe, pbe)
    names = (["dslash", "dslash_tm"] + [f"hop_{h}" for h in HOPS]
             + ["schur_normal_0.0", "schur_normal_0.3"])
    for n, r in zip(names, res):
        arrays[f"{mname}/{n}"] = np.asarray(r)
# the mesh rules: JAX's messages (each raises before compiling anything)
mesh = meshes["2x2"]
for name, (kw, dims, n) in RULES.items() if halo_mesh == "2x2" else ():
    t_, z_, y_, x_ = dims
    uu = jnp.zeros((4, t_, z_, y_, x_, 3, 3), jnp.complex64)
    rhs = jnp.zeros(((n,) if n else ()) + (t_, z_, y_, x_, 4, 3),
                    jnp.complex64)
    try:
        plan_mod.solve(plan_mod.SolverPlan(mesh=mesh, **kw), uu, rhs, M,
                       tol=1e-6, verify=False)
        out[f"rule/{name}"] = None
    except (ValueError, NotImplementedError) as e:
        out[f"rule/{name}"] = [type(e).__name__, str(e)]
# psums in the body of each while loop of the sharded even-odd loops
# (repro.testing.while_body_psum_counts walks jax.core.ClosedJaxpr, which
# jax 0.9 no longer exports; this walks the jaxpr the same way)
def subjaxprs(v):
    if hasattr(v, "eqns"):
        yield v
    elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
        yield v.jaxpr
    elif isinstance(v, (tuple, list)):
        for w in v:
            yield from subjaxprs(w)


def eqns(jaxpr):
    for e in jaxpr.eqns:
        yield e
        for v in e.params.values():
            for sub in subjaxprs(v):
                yield from eqns(sub)


psi_spec, gauge_spec, sharded = dist.lattice_specs(mesh)
bspec = P(None, *psi_spec)
pbo = pack_spinor(jax.vmap(split_eo)(bb)[1])
kkw = dict(sharded=sharded, use_pallas=False)
pdot, pnorm2 = dist.make_psum_dots(mesh, batched=True)
for sv in ("cg", "pipecg") if halo_mesh == "2x2" else ():
    def local(ue, uo, be, bo, sv=sv):
        a_hat = lambda v: dist.schur_normal_op_halo(ue, uo, v, M, **kkw)
        d_eo = lambda v: dist.parity_hop_halo("eo", ue, uo, v, **kkw)
        ddag = lambda v: dist.schur_op_halo(ue, uo, v, M, dagger=True, **kkw)
        rhs = ddag(be - d_eo(bo / (M + 4.0)))
        if sv == "pipecg":
            return solvers.pipecg(
                a_hat, rhs, tol=1e-6, maxiter=500, dot=pdot, norm2=pnorm2,
                batched=True,
                fused_dots=dist.make_fused_psum_dots(mesh, batched=True))[0]
        return solvers.cg(a_hat, rhs, tol=1e-6, maxiter=500, dot=pdot,
                          norm2=pnorm2, batched=True)[0]
    jx = jax.make_jaxpr(shard_map(
        local, mesh=mesh, in_specs=(gauge_spec, gauge_spec, bspec, bspec),
        out_specs=bspec, check_vma=False))(upe, upo, pbe, pbo)
    bodies = [next(subjaxprs(w.params["body_jaxpr"]))
              for w in eqns(jx.jaxpr) if w.primitive.name == "while"]
    out[f"psums_per_iteration/{sv}"] = [
        sum(1 for e in eqns(body) if e.primitive.name.startswith("psum"))
        for body in bodies]
    # collective-permutes of one iteration: spinor planes (24 components a
    # site) and link planes (18), told apart by the operand's S/G axis
    perms = [[e.invars[0].aval.shape[-2] for e in eqns(body)
              if e.primitive.name == "ppermute"] for body in bodies]
    out[f"ppermutes_per_iteration/{sv}"] = [
        {"spinor": p.count(24), "link": p.count(18)} for p in perms]
np.savez(os.path.join(d, f"jax_halos_{halo_mesh}.npz"), **arrays)
print("RESULT" + json.dumps(out))
"""

# ---------------------------------------------------------------------------
# One rank of the port's spawn (this file run as a script)
# ---------------------------------------------------------------------------


def _stats_json(st) -> dict:
    def lst(v):
        return None if v is None else torch.atleast_1d(v).tolist()
    return dict(iterations=st.iterations, outer=st.outer_iterations,
                rhs_iterations=lst(st.rhs_iterations),
                converged=lst(st.converged), verdict=lst(st.verdict),
                verified=lst(st.verified),
                true_residual_norm2=lst(st.true_residual_norm2),
                residual_norm2=lst(st.residual_norm2))


def _mesh_solves(mesh: str) -> dict:
    """The solves run on ``mesh``: every one on 2x2 (held to the JAX
    twins), the even-odd ones and full mpcg on 2x1x2 (held to the
    single-device solve)."""
    return {k: v for k, v in SOLVES.items()
            if mesh == "2x2" or k.startswith("eo") or k == "full_mpcg"}


# the bf16 halo operators, each gathered and held against one global
# plain evaluation
BF16_HALOS = ("dslash", "dslash_dagger_tm", "hop_oe_g5in_twist",
              "hop_eo_g5out_acc_twist_n2")
# the halo'd K4 operators (ghost reads), held bitwise to one global plain
# evaluation in each storage dtype
K4_HALOS = ("dslash", "dslash_dagger_tm", "dslash_g5in_n2")
K4_DTYPES = ("float32", "bfloat16", "float16")


def _worker(rank: int, d: pathlib.Path):
    import torch.distributed as tdist

    from repro_torch import kernels
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import distributed as dist
    from repro_torch.core import plan as tplan
    from repro_torch.core.lattice import (field_dot, field_norm2, pack_gauge,
                                          pack_spinor, split_eo,
                                          split_eo_gauge)
    from repro_torch.kernels.wilson_dslash import ops as wops

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                             rank=rank, world_size=WORLD, timeout=PG_TIMEOUT)
    meshes = {name: dist.Mesh(shape, axes, device="cpu", transport="gloo",
                              timeout=PG_TIMEOUT)
              for name, (shape, axes) in MESHES.items()}
    with np.load(d / "inputs.npz") as f:
        u, b, bb = (torch.tensor(f[k]) for k in ("u", "b", "bb"))
    arrays, out, mine = {}, {}, {}

    # halo operators on local blocks, gathered
    up, pp = pack_gauge(u), pack_spinor(b)
    bpp = torch.stack([pack_spinor(v) for v in bb])
    u_e, u_o = split_eo_gauge(u)
    upe, upo = pack_gauge(u_e), pack_gauge(u_o)
    pe = pack_spinor(split_eo(b)[0])
    pbe = torch.stack([pack_spinor(split_eo(v)[0]) for v in bb])
    for mname, mesh in meshes.items():
        psi_spec, gauge_spec, sharded = dist.lattice_specs(mesh)
        upl, ppl = dist.shard_lattice_fields(mesh, up, pp)
        ue, uo = (dist.local_block(mesh, v, gauge_spec) for v in (upe, upo))
        pel, pbel = (dist.local_block(mesh, v, psi_spec) for v in (pe, pbe))
        res = [dist.dslash_halo(upl, ppl, MASS, mesh, sharded),
               dist.dslash_halo(upl, ppl, MASS, mesh, sharded, twist=0.3)]
        for which, kw, batched in HOPS.values():
            p = pbel if batched else pel
            acc = (0.5 * p + 0.1) if "acc_coeff" in kw else None
            res.append(dist.parity_hop_halo(which, ue, uo, p, mesh, sharded,
                                            psi_acc=acc, **kw))
        for tw in (0.0, 0.3):
            res.append(dist.schur_normal_op_halo(ue, uo, pel, MASS, mesh,
                                                 sharded, twist=tw))
            arrays[f"{mname}/global_schur_normal_{tw}"] = (
                wops.schur_normal_op(upe, upo, pe, MASS, twist=tw).numpy())
        for name, r in zip(HALOS, res):
            glob = (pp if name.startswith("dslash")
                    else pbe if r.dim() == 6 else pe)
            arrays[f"{mname}/{name}"] = dist.gather_blocks(
                mesh, r, psi_spec, glob.shape).numpy()
        # bf16 storage: the halo'd operators against one global plain
        # evaluation, the interior bitwise and the boundary planes (the
        # bulk's rounded plane plus a correction) apart
        lo = torch.bfloat16
        up16, upe16, upo16 = (v.to(lo) for v in (up, upe, upo))
        pp16, pe16, pbe16 = (v.to(lo) for v in (pp, pe, pbe))
        acc16 = (0.5 * pbe + 0.1).to(lo)
        ul, uel, uol = (dist.local_block(mesh, v, gauge_spec)
                        for v in (up16, upe16, upo16))
        ppl, pel, pbel, accl = (dist.local_block(mesh, v, psi_spec)
                                for v in (pp16, pe16, pbe16, acc16))
        hop1, hop2 = (HOPS[h][1] for h in ("oe_g5in_twist",
                                           "eo_g5out_acc_twist_n2"))
        plain = dict(use_kernels=False)
        bf16 = {
            "dslash": (dist.dslash_halo(ul, ppl, MASS, mesh, sharded),
                       wops.dslash(up16, pp16, MASS, **plain)),
            "dslash_dagger_tm": (
                dist.dslash_dagger_halo(ul, ppl, MASS, mesh, sharded,
                                        twist=0.3),
                wops.dslash_dagger(up16, pp16, MASS, twist=0.3, **plain)),
            "hop_oe_g5in_twist": (
                dist.parity_hop_halo("oe", uel, uol, pel, mesh, sharded,
                                     **hop1),
                wops.hop_block(upe16, upo16, pe16, which="oe", **hop1,
                               **plain)),
            "hop_eo_g5out_acc_twist_n2": (
                dist.parity_hop_halo("eo", uel, uol, pbel, mesh, sharded,
                                     psi_acc=accl, **hop2),
                wops.hop_block(upe16, upo16, pbe16, which="eo",
                               psi_acc=acc16, **hop2, **plain))}
        for name in BF16_HALOS:
            got, want = bf16[name]
            got = dist.gather_blocks(mesh, got, psi_spec, want.shape)
            batch, edge = want.dim() - 5, torch.zeros_like(want, dtype=bool)
            for mu, (_, n) in sharded.items():
                if n > 1:
                    at = torch.arange(want.shape[mu + batch])
                    at = at % (want.shape[mu + batch] // n)
                    view = [1] * want.dim()
                    view[mu + batch] = -1
                    edge |= ((at == 0) | (at == at.max())).view(view)
            mine[f"{mname}/bf16/{name}"] = dict(
                bitwise=bool(torch.equal(got, want)),
                interior_bitwise=bool(torch.equal(got[~edge], want[~edge])),
                max_abs=float((got.float() - want.float()).abs().max()),
                scale=float(want.float().abs().max()))
        # K4 with ghost reads, in every storage dtype, the whole block
        for dt in K4_DTYPES:
            lo = getattr(torch, dt)
            uk, pk, bk = up.to(lo), pp.to(lo), bpp.to(lo)
            ul, ppl, bl = (dist.local_block(mesh, v, spec) for v, spec in
                           ((uk, gauge_spec), (pk, psi_spec),
                            (bk, (None,) + psi_spec)))
            k4 = {"dslash": (dist.dslash_halo(ul, ppl, MASS, mesh, sharded),
                             wops.dslash(uk, pk, MASS, **plain)),
                  "dslash_dagger_tm": (
                      dist.dslash_dagger_halo(ul, ppl, MASS, mesh, sharded,
                                              twist=0.3),
                      wops.dslash_dagger(uk, pk, MASS, twist=0.3, **plain)),
                  "dslash_g5in_n2": (
                      dist.dslash_halo(ul, bl, MASS, mesh, sharded,
                                       gamma5_in=True),
                      wops.dslash(uk, bk, MASS, gamma5_in=True, **plain))}
            for name in K4_HALOS:
                got, want = k4[name]
                got = dist.gather_blocks(mesh, got, (None,) * (got.dim()
                                                               - 5)
                                         + psi_spec, want.shape)
                mine[f"{mname}/k4/{dt}/{name}"] = bool(torch.equal(got,
                                                                   want))

    # the sharded solves; on the 2x1x2 mesh the even-odd ones, and their
    # single-device twins
    rhs_of = {"b": b, "bb": bb}
    for mname, mesh in meshes.items():
        for name, (kw, rhs) in _mesh_solves(mname).items():
            before = dict(mesh.counts)
            kernels.reset_counts()
            x, st = tplan.solve(tplan.SolverPlan(mesh=mesh, **kw), u,
                                rhs_of[rhs], MASS, tol=TOL, maxiter=MAXITER,
                                device="cpu")
            key = f"{mname}/{name}"
            arrays[key] = x.numpy()
            mine[key] = _stats_json(st)
            out[f"counts/{key}"] = {k: v - before.get(k, 0)
                                    for k, v in mesh.counts.items()}
            # K1/K4 on CPU blocks: their plain versions, counted alike
            out[f"kernels/{key}"] = {k: v["plain_calls"]
                                     for k, v in kernels.counts().items()}

    # the all-bf16 cg16 (unverified by design) and the legacy packed-layout
    # forwarder, on the 2x2 mesh
    mesh = meshes["2x2"]
    x, st = tplan.solve(tplan.SolverPlan(mesh=mesh, operator="full",
                                         precision="low"), u, b, MASS,
                        tol=TOL, maxiter=MAXITER, device="cpu")
    mine["2x2/full_cg16"] = _stats_json(st)
    arrays["2x2/full_cg16"] = x.numpy()
    xw, stw = dist.solve_wilson(mesh, up, pp, MASS, solver="cg", tol=TOL,
                                maxiter=MAXITER)
    mine["2x2/solve_wilson_cg"] = _stats_json(stw)
    arrays["2x2/solve_wilson_cg"] = xw.numpy()
    # the block entry on packed blocks (the full operator's wire format)
    psi_spec = dist.lattice_specs(mesh)[0]
    xl, st = tplan.solve(tplan.SolverPlan(mesh=mesh, operator="full"),
                         *dist.shard_lattice_fields(mesh, up, pp), MASS,
                         tol=TOL, maxiter=MAXITER, layout="packed",
                         device="cpu", blocks=True)
    mine["blocks/2x2/packed_full_cgnr"] = dict(
        stats=_stats_json(st),
        bitwise=bool(torch.equal(dist.gather_blocks(mesh, xl, psi_spec,
                                                     pp.shape), xw)))
    arrays["packed/full_cgnr"] = pack_spinor(
        torch.tensor(arrays["2x2/full_cgnr"])).numpy()
    if rank == 0:
        x, st = tplan.solve(tplan.SolverPlan(operator="full",
                                             precision="low"), u, b, MASS,
                            tol=TOL, maxiter=MAXITER, device="cpu")
        arrays["single/full_cg16"] = x.numpy()
        out["single/full_cg16"] = _stats_json(st)
        for name, (kw, rhs) in _mesh_solves("2x1x2").items():
            x, st = tplan.solve(tplan.SolverPlan(**kw), u, rhs_of[rhs], MASS,
                                tol=TOL, maxiter=MAXITER, device="cpu")
            arrays[f"single/{name}"] = x.numpy()
            out[f"single/{name}"] = _stats_json(st)

    # all-reduces of one iteration of the sharded even-odd loops
    mesh = meshes["2x2"]
    for sv, solver in (("cg", "cgnr"), ("pipecg", "pipecg")):
        parts, _ = tplan._loop_parts(
            tplan.SolverPlan(mesh=mesh, nrhs=2, solver=solver), u, bb, MASS,
            layout="natural", tol=TOL, maxiter=MAXITER, inner_tol=5e-2,
            inner_maxiter=200, max_outer=50, residual_replacement_every=25,
            dot=field_dot, norm2=field_norm2)
        n0 = mesh.counts["all_reduce"]
        parts.body(parts.init)
        out[f"all_reduce_per_iteration/{sv}"] = (mesh.counts["all_reduce"]
                                                 - n0)

    # the mesh rules
    for name, (kw, dims, n) in RULES.items():
        t_, z_, y_, x_ = dims
        uu = torch.zeros((4, t_, z_, y_, x_, 3, 3), dtype=torch.complex64)
        rhs = torch.zeros(((n,) if n else ()) + (t_, z_, y_, x_, 4, 3),
                          dtype=torch.complex64)
        try:
            tplan.solve(tplan.SolverPlan(mesh=mesh, **kw), uu, rhs, MASS,
                        tol=TOL, device="cpu")
            out[f"rule/{name}"] = None
        except (ValueError, NotImplementedError) as e:
            out[f"rule/{name}"] = [type(e).__name__, str(e)]

    # durability: segmented == one-shot on the mesh; a starved run
    plan = tplan.SolverPlan(mesh=mesh)
    x1, s1 = tplan.solve(plan, u, b, MASS, tol=TOL, maxiter=MAXITER,
                         device="cpu")
    x2, s2 = tplan.solve(plan, u, b, MASS, tol=TOL, maxiter=MAXITER,
                         device="cpu", checkpoint=tplan.CheckpointPolicy(
                             str(d / "ck_mesh"), 5, keep=100))
    tplan.solve(plan, u, b, MASS, tol=TOL, maxiter=6, device="cpu",
                checkpoint=tplan.CheckpointPolicy(str(d / "ck_starved"), 3,
                                                  keep=100))
    mine["durable"] = dict(bitwise=bool(torch.equal(x1, x2)),
                           one_shot=_stats_json(s1),
                           segmented=_stats_json(s2))
    _block_entry_cases(rank, d, meshes, u, rhs_of, arrays, x1, mine)
    # the CLI's system, checkpointed on the 2x2 mesh and starved, for the
    # fixture's torchrun --resume
    from repro_torch.core.lattice import LatticeShape
    from repro_torch.data import lattice_problem
    uc, bc = lattice_problem(LatticeShape(*DIMS), seed=0, packed=False,
                             device="cpu")
    tplan.solve(plan, uc, bc, CLI_MASS, tol=TOL, maxiter=CLI_STARVE,
                device="cpu", checkpoint=tplan.CheckpointPolicy(
                    str(d / "ck_cli"), 5))
    mine["cli_system_sha"] = [hashlib.sha256(v.numpy().tobytes()).hexdigest()
                              for v in (uc, bc)]
    if rank == 0:
        tplan.solve(tplan.SolverPlan(), u, b, MASS, tol=TOL,
                    maxiter=MAXITER, device="cpu",
                    checkpoint=tplan.CheckpointPolicy(str(d / "ck_single"),
                                                      5, keep=100))
        out["durable"] = {k: ckpt.valid_steps(str(d / k)) for k in
                          ("ck_mesh", "ck_single", "ck_starved")}
        np.savez(d / "port.npz", **arrays)
        (d / "port.json").write_text(json.dumps(out))
    (d / f"rank{rank}.json").write_text(json.dumps(mine))
    tdist.destroy_process_group()


def _blocks(mesh, u, b):
    """This rank's natural-layout blocks of the global u and b."""
    from repro_torch.core import distributed as dist
    return dist.shard_lattice_fields(mesh, u, b, layout="natural")


def _gather(mesh, x_blk, like):
    from repro_torch.core import distributed as dist
    return dist.gather_blocks(mesh, x_blk, dist.layout_specs(mesh,
                                                             "natural")[0],
                              like.shape)


def _records(attempts) -> list:
    return [dataclasses.asdict(a) for a in attempts]


def _block_entry_cases(rank, d, meshes, u, rhs_of, arrays, x1, mine):
    """The mesh's block entry, its blockwise verification, and resumed and
    defended solves on a mesh plan through either entry."""
    import shutil

    from repro_torch.core import plan as tplan
    from repro_torch.core import resilience

    b = rhs_of["b"]
    # every solve through the block entry, against the global entry's x
    for mname, mesh in meshes.items():
        for name, (kw, rhs) in _mesh_solves(mname).items():
            ul, bl = _blocks(mesh, u, rhs_of[rhs])
            before = dict(mesh.counts)
            xl, st = tplan.solve(tplan.SolverPlan(mesh=mesh, **kw), ul, bl,
                                 MASS, tol=TOL, maxiter=MAXITER,
                                 device="cpu", blocks=True)
            x = _gather(mesh, xl, rhs_of[rhs])
            mine[f"blocks/{mname}/{name}"] = dict(
                bitwise=bool(np.array_equal(x.numpy(),
                                            arrays[f"{mname}/{name}"])),
                shapes=[list(v.shape) for v in (ul, bl, xl)],
                stats=_stats_json(st),
                counts={k: v - before.get(k, 0)
                        for k, v in mesh.counts.items()
                        if v != before.get(k, 0)})
    # a solve whose halo planes arrive corrupted: the solver's transport
    # (Mesh.ppermute) scales every spinor plane it receives; the
    # verification's faces travel by all-gather and are left alone
    mesh = meshes["2x2"]
    orig = mesh.ppermute

    def corrupt(axis, sends, *, kind="spinor"):
        got = orig(axis, sends, kind=kind)
        return [p * 1.01 for p in got] if kind == "spinor" else got

    ul, bl = _blocks(mesh, u, b)
    mesh.ppermute = corrupt
    try:
        _, st = tplan.solve(tplan.SolverPlan(mesh=mesh), ul, bl, MASS,
                            tol=TOL, maxiter=CORRUPT_MAXITER, device="cpu",
                            blocks=True)
        mine["corrupt"] = _stats_json(st)
    finally:
        del mesh.ppermute
    # the starved 2x2 checkpoint (steps 3 and 6) resumed on either mesh
    # through either entry, each from its own copy of the directory
    for mname, mesh in meshes.items():
        ul, bl = _blocks(mesh, u, b)
        for entry, args in (("global", (u, b)), ("blocks", (ul, bl))):
            ck = d / f"ck_resume_{mname}_{entry}"
            if rank == 0:
                shutil.copytree(d / "ck_starved", ck)
            mesh.barrier()
            x, st, rec = resilience.resume_solve(
                tplan.SolverPlan(mesh=mesh), *args, MASS,
                checkpoint_dir=str(ck), tol=TOL, maxiter=MAXITER,
                device="cpu", blocks=entry == "blocks")
            if entry == "blocks":
                x = _gather(mesh, x, b)
            mine[f"resume/{mname}/{entry}"] = dict(
                step=rec.resumed_from_step, banked=rec.checkpoint_iterations,
                attempts=_records(rec.attempts), stats=_stats_json(st),
                x_rel_err=rel_err(x.numpy(), x1.numpy()),
                listing=sorted(os.listdir(ck)))
    # defended through the block entry (the global entry's resumes above
    # ran it too): the first rung starved, the second restarted
    mesh = meshes["2x2"]
    x, st, att = resilience.defended_solve(
        tplan.SolverPlan(mesh=mesh), *_blocks(mesh, u, b), MASS, tol=TOL,
        maxiter=DEFENDED_STARVE, device="cpu", blocks=True)
    mine["defended"] = dict(attempts=_records(att), stats=_stats_json(st),
                            x_rel_err=rel_err(_gather(mesh, x, b).numpy(),
                                              x1.numpy()))


# ---------------------------------------------------------------------------
# The spawn and the tests
# ---------------------------------------------------------------------------


def _twins() -> tuple[dict, dict]:
    """The fixture's inputs and arrays, and its counts (meta)."""
    with np.load(TWINS) as f:
        arrays = {k: f[k] for k in f.files}
    return arrays, json.loads(str(arrays.pop("meta")))


def _start(argv, env, log: pathlib.Path):
    fh = open(log, "w")
    return subprocess.Popen(argv, env=env, stdout=fh,
                            stderr=subprocess.STDOUT, text=True), fh


def _finish(procs, deadline: float) -> dict:
    """Wait for every process until ``deadline``; kill what is left."""
    rcs = {}
    for name, (proc, fh) in procs.items():
        try:
            rcs[name] = proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            rcs[name] = "timeout"
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            fh.close()
    return rcs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    twins, meta = _twins()
    np.savez(d / "inputs.npz", **{k: twins[k] for k in ("u", "b", "bb")})
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ck = d / "ck_cli"
    t0 = time.time()
    procs = {
        **{f"jax_halos_{m}": _start([sys.executable, "-c", _JAX_HALOS,
                                     str(d), json.dumps(HOPS),
                                     json.dumps(RULES), m, str(i)], env,
                                    d / f"jax_halos_{m}.log")
           for i, m in enumerate(MESHES)},
        "torchrun": _start([sys.executable, "-m", "torch.distributed.run",
                            "--standalone", "--nproc-per-node", "4", "-m",
                            "repro_torch.launch.solve", "--device", "cpu",
                            "--mesh", "debug", "--parity", "eo", "--nrhs",
                            "4", "--solver", "pipecg"], env,
                           d / "torchrun.log")}
    ranks = {f"rank{r}": _start([sys.executable, __file__, str(r), str(d)],
                                env, d / f"rank{r}.log")
             for r in range(WORLD)}
    rcs = _finish(ranks, t0 + DEADLINE_S)
    # the ranks wrote the starved CLI run's snapshots: resume them under
    # torchrun while the JAX subprocesses still run
    procs.update(ranks, torchrun_resume=_start(
        CLI_RESUME_ARGV + ["--checkpoint-dir", str(ck)], env,
        d / "torchrun_resume.log"))
    rcs.update(_finish({k: v for k, v in procs.items() if k not in ranks},
                       t0 + DEADLINE_S))
    logs = {n: (d / f"{n}.log").read_text() for n in procs}
    jax_runs = [f"jax_halos_{m}" for m in MESHES]
    for name in jax_runs + [f"rank{r}" for r in range(WORLD)]:
        assert rcs[name] == 0, f"{name}: rc {rcs[name]}\n{logs[name][-4000:]}"

    def result(name):
        line = [ln for ln in logs[name].splitlines()
                if ln.startswith("RESULT")][-1]
        return json.loads(line[len("RESULT"):])

    with np.load(d / "port.npz") as f:
        port = {k: f[k] for k in f.files}
    assert meta["plans"] == json.loads(json.dumps(SOLVES)), meta["plans"]
    assert (meta["mass"], meta["tol"], meta["maxiter"]) == (MASS, TOL,
                                                            MAXITER)
    jx = {f"2x2/{k[2:]}": v for k, v in twins.items() if k.startswith("x/")}
    jx_json = {f"2x2/{k}": v for k, v in meta["solves"].items()}
    for name in jax_runs:
        with np.load(d / f"{name}.npz") as f:
            jx.update({k: f[k] for k in f.files})
        jx_json.update(result(name))
    return dict(d=d, port=port, jax=jx,
                port_json=json.loads((d / "port.json").read_text()),
                ranks=[json.loads((d / f"rank{r}.json").read_text())
                       for r in range(WORLD)],
                jax_json=jx_json,
                torchrun=(rcs["torchrun"], logs["torchrun"]),
                torchrun_resume=(rcs["torchrun_resume"],
                                 logs["torchrun_resume"],
                                 sorted(os.listdir(ck)) if ck.exists()
                                 else None),
                seconds=time.time() - t0)


def rel_err(x, ref) -> float:
    return float(np.max(np.abs(x - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("op", HALOS)
def test_halo_operator_matches_jax(runs, mesh, op):
    """Each ported halo operator, gathered from the local blocks, within
    1e-5 of its JAX twin on the same mesh shape."""
    got, want = runs["port"][f"{mesh}/{op}"], runs["jax"][f"{mesh}/{op}"]
    assert got.shape == want.shape
    assert rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("twist", [0.0, 0.3])
def test_schur_normal_halo_matches_global_operator(runs, mesh, twist):
    got = runs["port"][f"{mesh}/schur_normal_{twist}"]
    assert rel_err(got, runs["port"][f"{mesh}/global_schur_normal_{twist}"]
                   ) <= 1e-5


# cg16's count sits on bf16 rounding (its x is bf16 noise): held within 2
# of the single-device cg16's.  Full mpcg is held exactly: with K4 reading
# ghost planes, every mesh operator is bitwise one global evaluation, and
# its 33 / 5 equals JAX's reference twin on both meshes.
MIXED_INNER_SLACK = 2


def _check_stats_ranks(runs, key, st):
    assert all(r[key] == st for r in runs["ranks"][1:])


def _check_stats(runs, key, st):
    assert all(st["converged"]) and all(st["verified"])
    assert st["verdict"] == [0] * len(st["verdict"])
    _check_stats_ranks(runs, key, st)


@pytest.mark.parametrize("solve", list(SOLVES))
def test_sharded_solve_matches_jax_twin(runs, solve):
    """On the 2x2 mesh: JAX's counts per RHS, x within 1e-5 of JAX's x,
    converged and verified by the port's single-device oracle, the same
    stats on every rank."""
    key = f"2x2/{solve}"
    st = runs["ranks"][0][key]
    twin = runs["jax_json"][key]
    assert st["outer"] == twin["outer"]
    assert st["iterations"] == twin["iterations"]
    assert st["rhs_iterations"] == twin["rhs_iterations"]
    assert rel_err(runs["port"][key], runs["jax"][key]) <= 1e-5
    _check_stats(runs, key, st)


@pytest.mark.parametrize("solve", list(_mesh_solves("2x1x2")))
def test_y_sharded_solve_matches_single_device(runs, solve):
    """On the 2x1x2 mesh (Y and Z sharded, the local row parity from
    local coordinates): the even-odd solves and full mpcg at the
    single-device solve's counts per RHS (mpcg: inner and outer); x
    within 1e-5."""
    key = f"2x1x2/{solve}"
    st, one = runs["ranks"][0][key], runs["port_json"][f"single/{solve}"]
    assert st["outer"] == one["outer"]
    assert st["rhs_iterations"] == one["rhs_iterations"]
    assert st["iterations"] == one["iterations"]
    assert rel_err(runs["port"][key], runs["port"][f"single/{solve}"]) <= 1e-5
    _check_stats(runs, key, st)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("op", BF16_HALOS)
def test_bf16_halo_operator_matches_global_evaluation(runs, mesh, op):
    """bf16 storage, on every rank: a halo'd K4 operator's gathered output
    (ghost reads) is bitwise one global plain evaluation; a halo'd K1
    operator's is bitwise away from the blocks' boundary planes, and
    within 2 bf16 ulps of the scale on them, where the bulk's rounded
    plane plus an f32 correction rounds an entry twice."""
    for r in runs["ranks"]:
        res = r[f"{mesh}/bf16/{op}"]
        assert res["interior_bitwise"], res
        assert res["max_abs"] <= 2.0 ** -6 * res["scale"], res
        if op.startswith("dslash"):
            assert res["bitwise"], res


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("dtype", K4_DTYPES)
@pytest.mark.parametrize("op", K4_HALOS)
def test_k4_halo_operator_is_one_global_evaluation(runs, mesh, dtype, op):
    """K4 on a mesh block reads the neighbours' ghost planes where a row
    wraps across a sharded face: the gathered output is bitwise one plain
    evaluation of the global field, in every storage dtype, on every
    rank (one RHS, a gamma5-folded twisted dagger, and an N = 2 batch)."""
    assert all(r[f"{mesh}/k4/{dtype}/{op}"] for r in runs["ranks"])


def _mesh_shape(mesh: str):
    from repro_torch.launch.mesh import MeshShape
    shape, axes = MESHES[mesh]
    return MeshShape(dict(zip(axes, shape)), axes)


def _reckoned(solve: str, mesh: str, st: dict) -> dict:
    """The dry-run twin's closed forms for one of SOLVES."""
    from repro_torch.launch import dryrun_wilson as dw
    kw = SOLVES[solve][0]
    path = "full" if kw.get("operator") == "full" else "eo"
    solver = ("mpcg" if kw.get("precision") == "mixed"
              else {"cgnr": "cg", "pipecg": "pipecg"}[kw.get("solver",
                                                           "cgnr")])
    return dw.solve_counts(path, solver, DIMS, _mesh_shape(mesh),
                           nrhs=kw.get("nrhs", 1),
                           iterations=st["iterations"], outer=st["outer"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_counts_equal_mesh_counts(runs, mesh):
    """The production dry-run's closed forms
    (``launch/dryrun_wilson.solve_counts``) at this lattice and mesh, for
    each sharded solve's iteration counts, equal rank 0's ``Mesh.counts``
    (all-reduces, ppermute calls, spinor and link planes and bytes, the
    gather and the broadcast) and its K1/K4 launches (plain calls on CPU
    blocks)."""
    for solve in _mesh_solves(mesh):
        st = runs["ranks"][0][f"{mesh}/{solve}"]
        want = _reckoned(solve, mesh, st)
        got = runs["port_json"][f"counts/{mesh}/{solve}"]
        k = runs["port_json"][f"kernels/{mesh}/{solve}"]
        got = {**{key: got.get(key, 0) for key in want
                  if not key.startswith("k")},
               "k1": k["wilson_hop"] + k["wilson_hop_bf16"],
               "k4": k["wilson_full"], "k4_bf16": k["wilson_full_bf16"]}
        assert got == want, (solve, got, want)


@pytest.mark.parametrize("loop", ["cg", "pipecg"])
def test_dryrun_collectives_per_iteration_equal_jax_while_body(runs, loop):
    """One even-odd iteration on the 2x2 mesh (N = 2) as the dry-run
    reckons it: its all-reduces and spinor collective-permutes (planes:
    two a sharded direction for each hop block, four blocks a Schur
    matvec) equal the psums and spinor ppermutes in JAX's while body.
    The body holds pipecg's residual replacement (two more matvecs) as a
    branch, counted once, so pipecg's iteration is held with the
    replacement's planes added.  JAX also permutes a link plane in every
    block; the port exchanges the links once a solve (none an
    iteration): reported beside, not equated."""
    from repro_torch.launch import dryrun_wilson as dw
    m = _mesh_shape("2x2")

    def counts(k):
        return dw.solve_counts("eo", loop, DIMS, m, nrhs=2, iterations=k)

    def minus(a, b):
        return {key: a[key] - b[key] for key in a}

    per = minus(counts(2), counts(1))
    body = dict(per)
    if loop == "pipecg":  # the replacement at iteration 25 (rr = 25)
        body = minus(counts(25), counts(24))
    jax_perms = runs["jax_json"][f"ppermutes_per_iteration/{loop}"]
    print(f"{loop}: reckoned an iteration {per}, the body {body}; JAX's "
          f"while body {jax_perms}")
    assert [per["all_reduce"]] == runs["jax_json"][
        f"psums_per_iteration/{loop}"]
    assert [body["spinor_planes"]] == [p["spinor"] for p in jax_perms]
    assert per["link_planes"] == 0
    assert [p["link"] for p in jax_perms] == [body["spinor_planes"] // 2]


def test_sharded_cg16_matches_single_device(runs):
    """The all-bf16 CG on the mesh: converged in bf16 and unverified by
    design, as on one device (bf16 cannot reach tol, and the two x are
    bf16 noise apart: 2.3e-2, max-abs over max-abs, on these inputs), its
    count within 2 of the single-device cg16's (bf16 rounding,
    MIXED_INNER_SLACK)."""
    st = runs["ranks"][0]["2x2/full_cg16"]
    one = runs["port_json"]["single/full_cg16"]
    assert st["verdict"] == [0] and st["verified"] == [False]
    assert one["verdict"] == [0] and one["verified"] == [False]
    assert abs(st["iterations"] - one["iterations"]) <= MIXED_INNER_SLACK
    _check_stats_ranks(runs, "2x2/full_cg16", st)


def test_legacy_solve_wilson_forwards_to_the_packed_mesh_plan(runs):
    """``solve_wilson(mesh, up, b, ...)``: the full-operator mesh plan on
    packed global fields, the same iterations and x as the natural
    layout's full CGNR."""
    st = runs["ranks"][0]["2x2/solve_wilson_cg"]
    assert st["iterations"] == runs["ranks"][0]["2x2/full_cgnr"]["iterations"]
    assert st["verified"] == [True]
    assert rel_err(runs["port"]["2x2/solve_wilson_cg"],
                   runs["port"]["packed/full_cgnr"]) <= 1e-6
    _check_stats_ranks(runs, "2x2/solve_wilson_cg", st)


@pytest.mark.parametrize("loop", ["cg", "pipecg"])
def test_all_reduces_per_iteration_equal_jax_psums(runs, loop):
    """One iteration of the sharded even-odd loop (N = 2) issues as many
    all-reduces as JAX's while body holds psums: cg 2, pipecg 1 for the
    whole batch; a whole solve adds the set-up's two."""
    per = runs["port_json"][f"all_reduce_per_iteration/{loop}"]
    assert [per] == runs["jax_json"][f"psums_per_iteration/{loop}"]
    assert per == (1 if loop == "pipecg" else 2)
    name = "eo_pipecg_n2_tm" if loop == "pipecg" else "eo_cgnr_n2"
    c = runs["port_json"][f"counts/2x2/{name}"]
    assert c["all_reduce"] == 2 + per * runs["ranks"][0][f"2x2/{name}"][
        "iterations"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_link_planes_exchanged_once_per_solve(runs, mesh):
    """The link halo planes travel once a solve (one per sharded
    direction, per parity field on the even-odd path); the spinor planes
    travel per block; x is gathered once and the verdict broadcast
    once."""
    for solve in _mesh_solves(mesh):
        c = runs["port_json"][f"counts/{mesh}/{solve}"]
        fields = 1 if solve.startswith("full") else 2
        assert c["link_planes"] == 2 * fields, (solve, c)
        assert c["all_gather"] == 1 and c["broadcast"] == 1, (solve, c)
        assert c["spinor_planes"] > 10 * c["link_planes"], (solve, c)


@pytest.mark.parametrize("rule", list(RULES))
def test_mesh_rules_raise_in_jax_words(runs, rule):
    got = runs["port_json"][f"rule/{rule}"]
    assert got is not None
    assert got == runs["jax_json"][f"rule/{rule}"]


def test_checkpointed_mesh_solve_is_bitwise_its_one_shot(runs):
    """Segments of the mesh solve are the one-shot loop's body: x bitwise,
    the same stats, and the single-device segmented solve's steps."""
    dur = runs["ranks"][0]["durable"]
    assert dur["bitwise"]
    assert dur["segmented"] == dur["one_shot"]
    assert all(r["durable"] == dur for r in runs["ranks"][1:])
    steps = runs["port_json"]["durable"]
    k = dur["one_shot"]["iterations"]
    assert steps["ck_mesh"] == steps["ck_single"] == list(range(5, k, 5)) + [k]


def test_mesh_checkpoint_resumes_on_single_device(runs):
    """A snapshot holds the gathered x: a run starved on the 2x2 mesh
    resumes on one device, meshless, to a verified solution."""
    from repro_torch.core import plan as tplan
    from repro_torch.core.resilience import resume_solve

    steps = runs["port_json"]["durable"]["ck_starved"]
    assert steps == [3, 6]
    with np.load(runs["d"] / "inputs.npz") as f:
        u, b = torch.tensor(f["u"]), torch.tensor(f["b"])
    x, st, rec = resume_solve(tplan.SolverPlan(), u, b, MASS,
                              checkpoint_dir=str(runs["d"] / "ck_starved"),
                              tol=TOL, maxiter=MAXITER, device="cpu")
    assert rec.resumed_from_step == 6
    assert rec.attempts[0].restarted
    assert bool(st.verified)


def test_torchrun_cli_solves_on_the_debug_mesh(runs):
    rc, log = runs["torchrun"]
    assert rc == 0, log[-4000:]
    assert "mesh={'data': 2, 'model': 2} transport=gloo world=4" in log, log
    assert log.count("[solve] per-RHS verdict:   ") == 1, log
    assert "UNVERIFIED" not in log and "FAIL" not in log, log


def test_torchrun_cli_resumes_a_mesh_run(runs):
    """``--resume --mesh debug`` under torchrun: the CLI's system (the
    same sha256 as it prints), checkpointed on the 2x2 mesh and starved at
    6 iterations (snapshots 5 and 6), is resumed by every rank and rank 0
    reports in the single-device resume's format; the directory ends with
    the newest snapshot and the banked step."""
    rc, resumed, listing = runs["torchrun_resume"]
    assert rc == 0, resumed[-4000:]
    assert "mesh={'data': 2, 'model': 2} transport=gloo world=4" in resumed
    u_sha, b_sha = runs["ranks"][0]["cli_system_sha"]
    assert f"[solve] system: u sha256={u_sha} b sha256={b_sha}" in resumed
    lines = [ln for ln in resumed.splitlines() if ln.startswith("[solve]")]
    said = [ln for ln in lines if ln.startswith("[solve] resumed from")]
    assert said == [f"[solve] resumed from step {CLI_STARVE} ({CLI_STARVE} "
                    "iterations banked, checkpoint verdict "
                    "maxiter_exhausted)"], lines
    attempts = [ln for ln in lines if ln.startswith("[solve] attempt")]
    assert len(attempts) == 1, lines
    assert ("restarted=True" in attempts[0]
            and "verdict=converged verified=True" in attempts[0]), lines
    assert "[solve] verdict: converged verified=True" in lines, lines
    assert "FAIL" not in resumed, resumed[-4000:]
    banked = CLI_STARVE + int(attempts[0].split("iterations=")[1].split()[0])
    assert listing == [f"step_{CLI_STARVE:08d}", f"step_{banked:08d}"], listing


def test_block_plumbing_inverts_the_slicer():
    """``block_slices`` cut a global field into blocks that
    ``global_shape`` and ``block_origin`` map back: the blocks tile the
    field, each from its origin, and an even local extent gives every
    block an even parity origin (both meshes' specs, both layouts)."""
    import types

    from repro_torch.core import distributed as dist
    for shape, axes in MESHES.values():
        for layout, site in (("natural", (8, 4, 3)), ("packed", (24, 8))):
            fake = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                         axis_names=axes)
            mesh = types.SimpleNamespace(**vars(fake), coords={})
            psi_spec, gauge_spec, _ = dist.layout_specs(
                types.SimpleNamespace(**vars(fake)), layout)
            field = np.arange(2 * 4 * 4 * 4 * int(np.prod(site))).reshape(
                (2, 4, 4, 4) + site)
            seen = np.zeros(field.shape, bool)
            for c in np.ndindex(*shape):
                mesh.coords = dict(zip(axes, c))
                sl = dist.block_slices(mesh, field.shape, psi_spec)
                blk = field[sl]
                assert dist.global_shape(mesh, blk.shape,
                                         psi_spec) == field.shape
                origin = dist.block_origin(mesh, blk.shape, psi_spec)
                assert sum(origin[:3]) % 2 == 0
                assert blk[(0,) * blk.ndim] == field[(0,) + origin]
                seen[sl] = True
            assert seen.all()
            assert gauge_spec == (None,) + psi_spec


@pytest.mark.parametrize("mesh,solve", [(m, s) for m in MESHES
                                        for s in _mesh_solves(m)])
def test_block_entry_is_bitwise_the_global_entry(runs, mesh, solve):
    """``solve(..., blocks=True)`` on each rank's blocks (the entry
    receives block-shaped tensors only): the gathered x bitwise the
    global entry's, the same counts and collectives of the solve, and
    its blockwise verification's true residual within 1e-6 (relative) of
    the global entry's rank-0 verification; the same stats on every
    rank."""
    key = f"{mesh}/{solve}"
    rec = runs["ranks"][0][f"blocks/{key}"]
    assert all(r[f"blocks/{key}"] == rec for r in runs["ranks"][1:])
    assert rec["bitwise"]
    ushape, bshape, xshape = rec["shapes"]
    glob_b = runs["port"][key].shape
    n = dict(zip(MESHES[mesh][1], MESHES[mesh][0]))
    split = [n["data"], n["model"], n.get("pod", 1)]   # T, Z, Y
    lat = len(glob_b) - 6
    want = list(glob_b)
    for mu in range(3):
        want[lat + mu] //= split[mu]
    assert bshape == xshape == want
    assert ushape == [4] + want[lat:lat + 4] + [3, 3]
    st, glob = dict(rec["stats"]), dict(runs["ranks"][0][key])
    rs, rs_glob = (np.array(v.pop("true_residual_norm2"))
                   for v in (st, glob))
    assert st == glob
    assert np.all(np.abs(rs - rs_glob) <= 1e-6 * rs_glob), (rs, rs_glob)
    counts = rec["counts"]
    solve_counts = runs["port_json"][f"counts/{key}"]
    for k in ("all_reduce", "spinor_planes", "link_planes", "ppermute"):
        assert counts.get(k) == solve_counts.get(k), (k, counts)
    # the block entry gathers nothing: its collectives beyond the solve's
    # are the verification's one face all-gather and one all-reduce
    assert "broadcast" not in counts and counts["verify_gather"] == 1
    assert counts["verify_all_reduce"] == 1


def test_block_entry_takes_packed_blocks(runs):
    """The full operator's block entry on packed blocks
    (``layout="packed"``): x gathered bitwise the legacy packed
    ``solve_wilson``'s, the same stats, verified blockwise (the blocks
    unpacked to the natural layout), its true residual within 1e-6 of the
    natural global entry's (rank 0's natural oracle; the packed global
    entry verifies through K4, whose f32 sums put its residual 1e-3
    apart)."""
    rec = runs["ranks"][0]["blocks/2x2/packed_full_cgnr"]
    assert all(r["blocks/2x2/packed_full_cgnr"] == rec
               for r in runs["ranks"][1:])
    assert rec["bitwise"]
    st = dict(rec["stats"])
    glob = dict(runs["ranks"][0]["2x2/solve_wilson_cg"])
    rs = np.array(st.pop("true_residual_norm2"))
    glob.pop("true_residual_norm2")
    assert st == glob
    rs_nat = np.array(runs["ranks"][0]["2x2/full_cgnr"]["true_residual_norm2"])
    assert np.all(np.abs(rs - rs_nat) <= 1e-6 * rs_nat), (rs, rs_nat)


def test_corrupted_halo_solve_is_unverified(runs):
    """The solver's halo transport (``Mesh.ppermute``) scaled every
    spinor plane it delivered by 1.01: the block entry's loop converged
    on its own residual, and the blockwise verification, whose faces
    travel by all-gather, reports it unverified on every rank."""
    st = runs["ranks"][0]["corrupt"]
    assert all(r["corrupt"] == st for r in runs["ranks"][1:])
    assert st["verified"] == [False], st
    assert st["true_residual_norm2"][0] > 1e4 * TOL ** 2, st


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("entry", ["global", "blocks"])
def test_mesh_checkpoint_resumes_on_a_mesh(runs, mesh, entry):
    """The starved 2x2 checkpoint (steps 3 and 6) resumed by
    ``resume_solve`` with a mesh plan, through either entry: from step 6,
    one restarted attempt, verified, x within 1e-5 of the one-shot mesh
    x, the same records on every rank; the directory then holds step 6
    and the step rank 0 banked, and nothing else."""
    rec = runs["ranks"][0][f"resume/{mesh}/{entry}"]
    assert all(r[f"resume/{mesh}/{entry}"] == rec for r in runs["ranks"][1:])
    assert rec["step"] == 6 and rec["banked"] == 6
    att = rec["attempts"]
    assert att[0]["restarted"] and att[-1]["verified"]
    assert rec["stats"]["verified"] == [True]
    assert rec["x_rel_err"] <= 1e-5
    banked = 6 + sum(a["iterations"] for a in att)
    assert rec["listing"] == ["step_00000006", f"step_{banked:08d}"]


def test_defended_solve_on_a_mesh(runs):
    """``defended_solve`` through the block entry with maxiter too short
    for the first rung: attempt 0 unverified, attempt 1 a restart on the
    mesh's plain path (the CPU's default ladder) and verified, x within
    1e-5 of the one-shot mesh x, the same records on every rank."""
    rec = runs["ranks"][0]["defended"]
    assert all(r["defended"] == rec for r in runs["ranks"][1:])
    a0, a1 = rec["attempts"]
    assert not a0["restarted"] and not a0["verified"]
    assert a1["restarted"] and a1["verified"]
    assert a1["plan_desc"] == "eo-schur/wilson/reference/single"
    assert rec["stats"]["verified"] == [True]
    assert rec["x_rel_err"] <= 1e-5


def test_cli_mesh_outside_torchrun_is_an_error(capsys, monkeypatch):
    from repro_torch.launch import solve as cli
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="torchrun"):
        cli.main(["--device", "cpu", "--mesh", "debug", "--parity", "eo"])


if __name__ == "__main__":
    _worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
