"""Dry run of the paper's own workload at production scale, reckoned: the
distributed Dirac-Wilson solve on the 16 x 16 and 2 x 16 x 16 meshes
(:func:`repro_torch.launch.mesh.make_production_mesh`) at 128^3 x 256.

The JAX package's ``repro.launch.dryrun_wilson`` lowers the sharded solve
and reads flops, bytes and collectives per iteration from XLA's cost
analysis.  PyTorch has no compiled-cost analysis, and the port's loops
are Python: every number here is **reckoned** from the code, per rank
and per iteration, for cg (CGNR), pipecg (one fused all-reduce an
iteration, the residual replaced every :data:`RR`) and mpcg (bf16 inner CG,
f32 reliable updates), on the full-lattice path ``solve_wilson`` runs:

* K4 launches, and K1 and K2/K3 launches (0: the mesh loops run plain
  vector algebra, as the JAX package's do);
* HBM bytes: each K4 launch by ``chip_smoke.py``'s bytes model (PERF.md
  section 3: (72/N + 48) reals a site and RHS), each vector-algebra pass
  of the loop body one field read or written (:data:`VECTOR_PASSES`);
* halo planes and bytes, and ``ppermute`` calls: the closed forms behind
  ``Mesh.counts`` (each halo'd launch exchanges two planes a sharded
  direction, in one call), and all-reduces;
* the link planes, exchanged once a solve;
* each rank's resident bytes (:func:`resident`): the path's figure is the
  block entry's (``plan.solve(..., blocks=True)``: the rank's natural
  blocks of U and b, the packed links and the loop's fields); the global
  entry's figure, beside it, is the wrapper's cost (every rank also
  holds the global U and b and the gathered x).

JAX's mesh axis map holds: T over ``data``, Z over ``model``, Y over
``pod``.  :func:`solve_counts` gives a whole solve's counts for k
iterations (and o reliable updates), on either path (the even-odd one's
K1 counts too); the tests hold them equal to the ``Mesh.counts`` and
launch counts of real solves on a small CPU mesh.

The memory term divides the bytes by the card's device-to-device copy
rate, measured as ``chip_smoke.py`` phase 1 does, with the card's name
and power limit; without a card it is not measured.  The compute term
uses the H100's published f32 peak.  No collective time is given: there
is no multi-card box to measure one on.  Fields the port cannot know
(XLA's ``memory_analysis``, ``compile_s``) are absent.

    python -m repro_torch.launch.dryrun_wilson --solver pipecg --mesh pod
    python -m repro_torch.launch.dryrun_wilson --all

Writes ``experiments/dryrun_torch/wilson-<solver>__lattice__<mesh>.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from repro_torch.core.distributed import lattice_specs
from repro_torch.launch.mesh import make_production_mesh

DIMS = (256, 128, 128, 128)          # T, Z, Y, X: 128^3 x 256
SOLVERS = ("cg", "pipecg", "mpcg")
MESH_KINDS = ("pod", "multipod")
PEAK_FP32_FLOPS = 67e12              # H100 SXM data sheet, at 700 W
FLOPS_PER_SITE = 1320                # one dslash, per site and RHS
SPINOR_REALS, LINK_REALS = 24, 18
F32, BF16 = 4, 2
# Vector algebra of one loop iteration in field passes (a field read or
# written once), from the loop bodies of core/solvers.py: CG's dot(p, Ap),
# x += a p, r -= a Ap, ||r||^2 and p = r + b p (11); pipecg's six
# recurrences z, q, p, x, r, w (18) and its fused (r, r), (w, r) (2).
VECTOR_PASSES = {"cg": 11, "pipecg": 20, "mpcg": 11}
# pipecg's residual replacement period, as core/solvers.py's pipecg runs it
RR = 25


def block(dims, mesh, axis_map=None) -> tuple[tuple[int, ...], dict]:
    """This rank's block (T, Z, Y, X) of a ``dims`` lattice and ``{mu:
    n}`` for every lattice axis split over n > 1 ranks."""
    _, _, sharded = lattice_specs(mesh, axis_map)
    local = list(dims)
    split = {}
    for mu, (name, n) in sorted(sharded.items()):
        if dims[mu] % n:
            raise ValueError(f"lattice axis {mu} of extent {dims[mu]} does "
                             f"not split over {n} {name!r} ranks")
        local[mu] //= n
        if n > 1:
            split[mu] = n
    return tuple(local), split


def _plane(local, mu: int, reals: int) -> int:
    """Elements of one mu-plane of a field with ``reals`` components a
    site."""
    return math.prod(local) // local[mu] * reals


def solve_counts(path: str, solver: str, dims, mesh, *, nrhs: int = 1,
                 iterations: int, outer: int = 0,
                 axis_map=None) -> dict:
    """One mesh solve's counts on a rank, keyed as ``Mesh.counts``
    (``all_reduce``, ``ppermute`` calls, ``spinor_planes``/``_bytes``,
    ``link_planes``/``_bytes``, ``all_gather``, ``broadcast``) plus the
    kernel launches ``k1``, ``k4`` (f32) and ``k4_bf16``: for
    ``iterations`` k (mpcg: inner iterations in all, and ``outer``
    reliable updates).  ``path`` "full" (``solver`` cg, pipecg or mpcg)
    or "eo" (cg or pipecg); ``dims`` the global (T, Z, Y, X)."""
    local, split = block(dims, mesh, axis_map)
    k, o = int(iterations), int(outer)
    pipe_mv = 1 + k + 2 * (k // RR)
    c = dict(k1=0, k4=0, k4_bf16=0)
    if path == "full":
        if solver not in SOLVERS:
            raise ValueError(f"full path: unknown solver {solver!r}")
        if solver == "cg":
            c.update(k4=1 + 2 * k, all_reduce=2 + 2 * k)
        elif solver == "pipecg":
            c.update(k4=1 + 2 * pipe_mv, all_reduce=2 + k)
        else:
            c.update(k4=1 + 2 * o, k4_bf16=2 * k,
                     all_reduce=1 + 3 * o + 2 * k)
        fields, site = 1, local
    elif path == "eo":
        if solver not in ("cg", "pipecg"):
            raise ValueError(f"eo path: unknown solver {solver!r} (the "
                             "mesh's even-odd loops are cg and pipecg)")
        mv = k if solver == "cg" else pipe_mv
        c.update(k1=4 * mv + 4, all_reduce=2 + (2 * k if solver == "cg"
                                                 else k))
        fields, site = 2, local[:3] + (local[3] // 2,)
    else:
        raise ValueError(f"path must be 'full' or 'eo', got {path!r}")
    launches = {F32: c["k1"] + c["k4"], BF16: c["k4_bf16"]}
    c["spinor_planes"] = 2 * len(split) * sum(launches.values())
    c["spinor_bytes"] = sum(
        n * es * 2 * nrhs * _plane(site, mu, SPINOR_REALS)
        for es, n in launches.items() for mu in split)
    c["link_planes"] = fields * len(split)
    c["link_bytes"] = fields * sum(F32 * _plane(site, mu, LINK_REALS)
                                   for mu in split)
    c["ppermute"] = (c["spinor_planes"] // 2) + c["link_planes"]
    c["all_gather"] = c["broadcast"] = 1
    return c


def resident(path: str, solver: str, dims, mesh, *, nrhs: int = 1,
             axis_map=None) -> dict:
    """A rank's resident bytes for one mesh solve, reckoned: ``block``,
    the block entry's (the caller's natural blocks of U and b, complex64:
    (4 x 18 + 24 N) x 4 bytes a site; the packed links the loop runs on,
    f32, and a bf16 copy for mpcg; the loop's fields), and
    ``global_entry``, the wrapper's (``block`` plus the global U and b
    every rank holds and the gathered x).  The loop's fields, from the
    loop bodies of core/solvers.py and the operators' intermediates:
    full cg 6 (b, x, r, p, Ap and D p), pipecg 8, mpcg 3 in f32 beside
    the inner CG's 5 in bf16; even-odd (half fields) cg 9 (the RHS
    halves, the Schur RHS, x, r, p, Ap and the Schur operator's two
    intermediates), pipecg 11.  Transients (a kernel's output before it
    replaces its input, the verification's padded blocks) are not
    counted."""
    local, _ = block(dims, mesh, axis_map)
    sites, gsites = math.prod(local), math.prod(dims)
    natural = sites * (4 * LINK_REALS + nrhs * SPINOR_REALS) * F32
    links = 4 * sites * LINK_REALS * F32
    if solver == "mpcg":
        links += 4 * sites * LINK_REALS * BF16
    if path == "full":
        field = sites * SPINOR_REALS * nrhs
        f32, bf16 = {"cg": (6, 0), "pipecg": (8, 0), "mpcg": (3, 5)}[solver]
    elif path == "eo":
        field = sites // 2 * SPINOR_REALS * nrhs
        f32, bf16 = {"cg": (9, 0), "pipecg": (11, 0)}[solver]
    else:
        raise ValueError(f"path must be 'full' or 'eo', got {path!r}")
    blk = natural + links + field * (F32 * f32 + BF16 * bf16)
    glob = gsites * (4 * LINK_REALS + 2 * nrhs * SPINOR_REALS) * F32
    return {"block": int(blk), "global_entry": int(blk + glob)}


def _minus(a: dict, b: dict) -> dict:
    return {key: a[key] - b[key] for key in a}


def reckon(solver: str, mesh_kind: str, *, dims=DIMS,
           hbm_bytes_per_s: float | None = None,
           device: dict | None = None) -> dict:
    """One cell's row: per-iteration, per-solve and resident numbers of a
    rank on the full-lattice path at one right-hand side, reckoned.  ``hbm_bytes_per_s``: the
    card's measured copy rate, or None (the memory term is then not
    measured)."""
    mesh = make_production_mesh(multi_pod=mesh_kind == "multipod")
    local, split = block(dims, mesh)
    sites = math.prod(local)
    field = sites * SPINOR_REALS

    def counts(k, o=0):
        return solve_counts("full", solver, dims, mesh, iterations=k,
                            outer=o)

    setup = counts(0)
    per_it = _minus(counts(2), counts(1))
    low = solver == "mpcg"
    row = {"per_iteration": per_it}
    if solver == "mpcg":
        row["per_reliable_update"] = _minus(counts(0, 1), setup)
    if solver == "pipecg":
        row[f"per_residual_replacement_every_{RR}"] = _minus(
            _minus(counts(RR), counts(RR - 1)), per_it)
    # K4 by the bytes model: (72/N + 48) reals a site and RHS, at N = 1
    per_launch = (72 + 48) * sites
    kb = per_launch * (F32 * per_it["k4"] + BF16 * per_it["k4_bf16"])
    vb = VECTOR_PASSES[solver] * field * (BF16 if low else F32)
    hbm = kb + vb
    flops = FLOPS_PER_SITE * sites * (per_it["k4"] + per_it["k4_bf16"])
    colls = per_it["all_reduce"] + per_it["spinor_planes"]
    terms = {"compute_s": flops / PEAK_FP32_FLOPS,
             "memory_s": (None if hbm_bytes_per_s is None
                          else hbm / hbm_bytes_per_s)}
    terms["dominant"] = ("not measured" if terms["memory_s"] is None else
                         max(("compute", "memory"),
                             key=lambda t: terms[f"{t}_s"]))
    mem = resident("full", solver, dims, mesh)
    gdims = math.prod(dims)
    global_fields = (4 * gdims * LINK_REALS + gdims * SPINOR_REALS) * F32
    lat = "x".join(str(d) for d in dims)
    row.update({
        "arch": f"wilson-{solver}", "shape": f"lattice_{lat}",
        "mesh": mesh_kind, "path": "full", "status": "ok",
        "label": "reckoned", "chips": mesh.size,
        "mesh_shape": dict(mesh.shape), "block": list(local),
        "sharded_axes": sorted(split), "nrhs": 1, "rr": RR,
        "per_setup": setup,
        "per_device_bytes": mem["block"],
        "global_entry_bytes_per_rank": mem["global_entry"],
        "global_fields_bytes_per_rank": int(global_fields),
        "cost_method": ("reckoned per iteration from the port's bytes "
                        "model and the closed forms behind Mesh.counts"),
        "cost_extrapolated": {"flops": float(flops), "bytes": float(hbm),
                              "kernel_bytes": float(kb),
                              "vector_bytes": float(vb),
                              "coll_bytes": float(per_it["spinor_bytes"]
                                                  + 4 * per_it["all_reduce"]),
                              "coll_count": float(colls)},
        "collectives": {
            "all-reduce": {"count": per_it["all_reduce"],
                           "bytes": 4 * per_it["all_reduce"]},
            "collective-permute": {"count": per_it["spinor_planes"],
                                   "bytes": per_it["spinor_bytes"],
                                   "calls": per_it["ppermute"]},
            "links_per_solve": {"count": setup["link_planes"],
                                "bytes": setup["link_bytes"]}},
        "roofline": terms,
        "model_flops_global": float(2 * FLOPS_PER_SITE * gdims),
        "flops_per_device": float(flops),
        "launches_per_iteration": {"k1": per_it["k1"], "k4": per_it["k4"],
                                   "k4_bf16": per_it["k4_bf16"], "k2": 0,
                                   "k3": 0},
        "device": device or {"hbm_bytes_per_s": "not measured"},
    })
    return row


def describe(row: dict) -> str:
    it = row["per_iteration"]
    mem = row["roofline"]["memory_s"]
    mem = "not measured" if mem is None else f"{mem * 1e3:.3f} ms"
    return (f"[dryrun-wilson] reckoned {row['arch']} {row['mesh']} "
            f"({row['path']}, block {'x'.join(map(str, row['block']))}): "
            f"per iteration a rank K1 {it['k1']} K4 {it['k4']} "
            f"K4 bf16 {it['k4_bf16']} K2/K3 0, HBM "
            f"{row['cost_extrapolated']['bytes'] / 1e6:.2f} MB "
            f"(memory {mem}), all-reduce {it['all_reduce']}, "
            f"halo planes {it['spinor_planes']} "
            f"({it['spinor_bytes'] / 1e6:.2f} MB, {it['ppermute']} ppermute "
            f"calls); link planes {row['per_setup']['link_planes']} a "
            f"solve; resident a rank {row['per_device_bytes'] / 2**30:.2f} "
            f"GiB through the block entry (the path's figure), "
            f"{row['global_entry_bytes_per_rank'] / 2**30:.1f} GiB through "
            f"the global entry (the wrapper's: global fields "
            f"{row['global_fields_bytes_per_rank'] / 2**30:.1f} GiB a rank)")


def measure_device() -> tuple[float | None, dict | None]:
    """The card's copy rate (bytes/s, as ``chip_smoke.py`` phase 1
    measures it), name and power limit; (None, None) without a card."""
    import torch

    if not torch.cuda.is_available():
        return None, None
    from repro_torch.kernels import autotune

    dev = torch.device("cuda", 0)
    n = 1 << 28
    src = torch.empty(n, dtype=torch.float32, device=dev).uniform_()
    dst = torch.empty_like(src)
    ms = autotune.time_ms(lambda: dst.copy_(src), reps=10)
    del src, dst
    bw = 2 * 4 * n / (ms * 1e-3)
    return bw, {"name": torch.cuda.get_device_name(0),
                "power_limit": autotune.power_limit(),
                "hbm_bytes_per_s": bw,
                "hbm_source": "device-to-device copy, 1 GiB each way"}


def run_cell(solver: str, mesh_kind: str, out_dir: str, *, bw=None,
             device=None) -> dict:
    row = reckon(solver, mesh_kind, hbm_bytes_per_s=bw, device=device)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"wilson-{solver}__lattice__{mesh_kind}.json")
    with open(out, "w") as f:
        json.dump(row, f, indent=1)
    print(describe(row), flush=True)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--solver", default="cg", choices=SOLVERS)
    p.add_argument("--mesh", default="pod", choices=MESH_KINDS)
    p.add_argument("--all", action="store_true",
                   help="every solver on both meshes")
    p.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = p.parse_args(argv)
    bw, device = measure_device()
    cells = ([(s, m) for s in SOLVERS for m in MESH_KINDS] if args.all
             else [(args.solver, args.mesh)])
    for solver, mesh_kind in cells:
        run_cell(solver, mesh_kind, args.out_dir, bw=bw, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
