#!/usr/bin/env python3
"""Time an earlier version of the port's kernels against the current ones
on one card, in turns, at the main path's shapes.

    mkdir -p build/old && git archive <commit> | tar -x -C build/old
    python3 scripts/compare_kernels.py --old build/old

``--old`` is the root of a checkout of the earlier commit, in a place git
ignores.  Its ``repro_torch`` package is imported beside the current one
(each keeps its own modules), so each version builds its own sources with
its own ``kernels/build.py`` and is called through its own public wrappers
``wilson_hop``, ``cg_xpay`` and ``wilson_full``; their C interfaces may
differ between the versions.

Cases, on the 32^3 x 64 lattice with f32 fields: K1 ``wilson_hop`` at
N = 1 and 4 (the Schur operator's second launch: parity 0, gamma5_out,
the accumulator), K3 ``cg_xpay`` at N = 1 (no gate, with
``torch.addcmul`` timed in each turn) and N = 4 (gated), K4
``wilson_full`` at N = 1 and 4 (the normal operator's dagger launch).
The old result is held against the new one (and K3 against its plain
version) before anything is timed.  Each of ``--turns`` turns times
old, new, new, old, each both ways ``chip_smoke.py`` times a kernel
(``ms``: one call per CUDA event pair; ``ms_back_to_back``: ten calls
per pair).  With ``--rows`` the current K1, with ``--full-rows`` the
current K4, is also timed at other tile heights.  Prints the card's name and power limit, then one JSON object
as its last line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

PACKAGE = "repro_torch"
WRAPPERS = {"wilson_hop": "wilson_dslash.kernel",
            "cg_xpay": "cg_fused.kernel",
            "wilson_full": "wilson_dslash.kernel"}


def _ours() -> list[str]:
    return [k for k in sys.modules
            if k == PACKAGE or k.startswith(PACKAGE + ".")]


def import_old(tree: Path) -> dict:
    """The wrappers and build module of ``tree/src/repro_torch``, imported
    while the current package's modules are set aside and put back after:
    each old module keeps references to old modules only."""
    current = {k: sys.modules.pop(k) for k in _ours()}
    sys.path.insert(0, str(tree / "src"))
    try:
        out = {name: getattr(importlib.import_module(
            f"{PACKAGE}.kernels.{mod}"), name)
            for name, mod in WRAPPERS.items()}
        out["build"] = importlib.import_module(f"{PACKAGE}.kernels.build")
    finally:
        sys.path.remove(str(tree / "src"))
        for k in _ours():
            del sys.modules[k]
        sys.modules.update(current)
    return out


def ptxas(build) -> dict:
    return {name: [ln.strip() for ln in build.build_log(name).splitlines()
                   if "registers" in ln or "spill" in ln
                   or "Function properties" in ln]
            for name in build.sources()}


def turns(old, new, n_turns: int, extra=None) -> dict:
    """``n_turns`` x (old, new, new, old), each timed both ways; ``extra``
    (a library call) once per turn after them."""
    res = {f"{who}_{m}": [] for who in ("old", "new", "library")
           for m in ("ms", "ms_back_to_back")}
    for _ in range(n_turns):
        for who, fn in (("old", old), ("new", new), ("new", new),
                        ("old", old)):
            for m, v in cs.kernel_ms(fn).items():
                res[f"{who}_{m}"].append(v)
        if extra is not None:
            for m, v in cs.kernel_ms(extra).items():
                res[f"library_{m}"].append(v)
    for m in ("ms", "ms_back_to_back"):
        old_t, new_t = res[f"old_{m}"], res[f"new_{m}"]
        res[f"old_{m}_median"] = statistics.median(old_t)
        res[f"new_{m}_median"] = statistics.median(new_t)
        # pairs within a turn: (old 1st, new 2nd) and (old 4th, new 3rd)
        res[f"new_faster_pairs_{m}"] = sum(
            n < o for o, n in zip(old_t, new_t))
        if res[f"library_{m}"]:
            res[f"library_{m}_median"] = statistics.median(
                res[f"library_{m}"])
    res["pairs"] = 2 * n_turns
    return {k: v for k, v in res.items() if v != []}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"compare_kernels: FAIL: {msg}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True,
                    help="root of a checkout of the earlier version")
    ap.add_argument("--turns", type=int, default=5,
                    help="rounds of old, new, new, old per case")
    ap.add_argument("--kernels", default=",".join(WRAPPERS),
                    help="comma-separated subset of " + ",".join(WRAPPERS))
    ap.add_argument("--rows", default="",
                    help="comma-separated K1 tile heights to time as well")
    ap.add_argument("--full-rows", default="",
                    help="comma-separated K4 tile heights to time as well")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    kernels = args.kernels.split(",")
    check(set(kernels) <= set(WRAPPERS), f"unknown kernels {kernels}")
    from repro_torch.core import lattice as tl
    from repro_torch.data import lattice_problem
    from repro_torch.kernels import build
    from repro_torch.kernels.cg_fused import kernel as ck
    from repro_torch.kernels.cg_fused.ref import cg_xpay_ref
    from repro_torch.kernels.wilson_dslash import kernel as wk
    old = import_old(args.old.resolve())
    check(old["build"].CSRC != build.CSRC, "--old is the current tree")
    dev = torch.device("cuda", 0)
    card = cs.smi()
    build.build_all()
    old["build"].build_all()
    res = {"card": card, "turns": args.turns,
           "ptxas_old": ptxas(old["build"]), "ptxas_new": ptxas(build)}

    lat = tl.LatticeShape(*cs.MAIN_DIMS)
    u, b = lattice_problem(lat, seed=0, packed=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = torch.stack([tl.random_spinor(gen, lat) for _ in range(4)])

    if "wilson_hop" in kernels:
        ue, uo = tl.split_eo_gauge(u)
        upe, upo = tl.pack_gauge(ue), tl.pack_gauge(uo)
        del ue, uo
        m = cs.MASS + 4.0
        for n in (1, 4):
            rhs = b[None] if n == 1 else batch
            halves = [tl.split_eo(rhs[i]) for i in range(n)]
            pe = tl.pack_spinor(torch.stack([h[0] for h in halves]))
            po = tl.pack_spinor(torch.stack([h[1] for h in halves]))
            del halves
            if n == 1:
                pe, po = pe[0], po[0]
            kw = dict(parity=0, gamma5_out=True, psi_acc=pe, acc_coeff=m,
                      hop_coeff=-1.0 / m)
            k_old = lambda: old["wilson_hop"](upe, upo, po, **kw)
            k_new = lambda: wk.wilson_hop(upe, upo, po, **kw)
            diff = cs.max_err(k_old(), k_new())
            check(diff <= cs.HOP_TOL * cs.scale(k_new()),
                  f"K1 N={n}: old and new differ by {diff}")
            r = turns(k_old, k_new, args.turns)
            r.update(max_abs_diff=diff, plan=list(
                wk.hop_tile_plan(po.shape[-3], po.shape[-1])))
            if args.rows:
                plan = wk.hop_tile_plan
                r["rows_ms"] = {}
                for rows in map(int, args.rows.split(",")):
                    wk.hop_tile_plan = (
                        lambda y, xh, rows=rows: (rows, *plan(y, xh)[1:]))
                    try:
                        r["rows_ms"][rows] = cs.kernel_ms(k_new)
                    finally:
                        wk.hop_tile_plan = plan
            res[f"wilson_hop_n{n}"] = r
            del pe, po
        del upe, upo

    if "cg_xpay" in kernels:
        length = b.numel()
        for n in (1, 4):
            g = torch.Generator(device=dev)
            g.manual_seed(5)
            rr, pp = (torch.randn(n, length, generator=g, device=dev)
                      for _ in range(2))
            beta = torch.linspace(0.1, 0.9, n, device=dev)
            gate = (torch.ones(n, dtype=torch.bool, device=dev) if n > 1
                    else None)
            k_old = lambda: old["cg_xpay"](beta, rr, pp, gate)
            k_new = lambda: ck.cg_xpay(beta, rr, pp, gate)
            new = k_new()
            err = cs.max_err(new, cg_xpay_ref(beta, rr, pp, gate))
            check(err <= cs.CG_TOL, f"K3 N={n}: error {err}")
            lib = (None if n > 1 else
                   lambda: torch.addcmul(rr, beta.view(n, 1), pp))
            r = turns(k_old, k_new, args.turns, lib)
            r.update(max_abs_err=err,
                     bitwise_equal_old=torch.equal(new, k_old()))
            res[f"cg_xpay_n{n}"] = r
            del rr, pp, new

    if "wilson_full" in kernels:
        up = tl.pack_gauge(u)
        for n in (1, 4):
            pp = tl.pack_spinor(b if n == 1 else batch)
            kw = dict(gamma5_in=True, gamma5_out=True)
            k_old = lambda: old["wilson_full"](up, pp, cs.MASS, **kw)
            k_new = lambda: wk.wilson_full(up, pp, cs.MASS, **kw)
            diff = cs.max_err(k_old(), k_new())
            check(diff <= cs.HOP_TOL * cs.scale(k_new()),
                  f"K4 N={n}: old and new differ by {diff}")
            r = turns(k_old, k_new, args.turns)
            r.update(max_abs_diff=diff, plan=list(
                wk.full_tile_plan(pp.shape[-3], pp.shape[-1])))
            if args.full_rows:
                plan, want = wk.full_tile_plan, k_new()
                r["rows_ms"] = {}
                for rows in map(int, args.full_rows.split(",")):
                    wk.full_tile_plan = (
                        lambda y, x, rows=rows: (rows, *plan(y, x)[1:]))
                    try:
                        # every tile height computes each site alike
                        check(torch.equal(k_new(), want),
                              f"K4 N={n} b={rows} differs from the plan's")
                        r["rows_ms"][rows] = cs.kernel_ms(k_new)
                    finally:
                        wk.full_tile_plan = plan
            res[f"wilson_full_n{n}"] = r
            del pp
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
