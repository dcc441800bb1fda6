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

Cases, on the 32^3 x 64 lattice (or ``--dims``), for each storage type
of ``--dtype``
(float32, bfloat16, float16): K1 ``wilson_hop`` at N = 1 and 4 (the Schur
operator's second launch: parity 0, gamma5_out, the accumulator), K2
``cg_update`` at N = 1 and 4, K3 ``cg_xpay`` at N = 1 (no gate, with
``torch.addcmul`` timed in each turn) and N = 4 (gated), K4
``wilson_full`` at N = 1 and 4 (the normal operator's dagger launch).
float32: the old result is held against the new one (and K2/K3 against
the plain version) before anything is timed, and each of ``--turns``
turns times old, new, new, old.  bfloat16 and float16: where the earlier
version has instances of the type, the old result is held against the
new one bitwise and each turn times old, new, new, old; where it has
none, the new kernel is held against its plain version (at most 1 ulp,
as ``chip_smoke.py`` holds it) and each turn times it twice.  Each
16-bit Wilson case records the instance it ran (``pair``: two sites a
thread, or ``one-site``).  Every timing is taken both ways ``chip_smoke.py``
times a kernel (``ms``: one call per CUDA event pair;
``ms_back_to_back``: ten calls per pair).  With ``--rows`` the current
K1, with ``--full-rows`` the current K4, is also timed at other tile
heights (each storage type, each height checked bitwise against the
plan's).  ``--full-n`` sets K4's right-hand-side counts (default 1,4).
Prints the card's name and power limit, then one JSON object as its last
line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

PACKAGE = "repro_torch"
WRAPPERS = {"wilson_hop": "wilson_dslash.kernel",
            "cg_update": "cg_fused.kernel",
            "cg_xpay": "cg_fused.kernel",
            "wilson_full": "wilson_dslash.kernel"}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


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


def sass(build, names=("wilson_hop", "wilson_full")) -> dict:
    """Static SASS opcode counts of each kernel function of the current
    libraries of ``names`` (``cuobjdump -sass``, from the toolkit beside
    ``nvcc``): the loads and stores by kind and the instructions in all;
    the Wilson kernels' loop bodies are straight-line code, so these are
    the instructions one pass (one or two sites a thread) issues."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    out = {}
    for name in names:
        text = subprocess.run(
            [str(tool), "-sass", str(build._target(name))],
            capture_output=True, text=True, check=True).stdout
        func = None
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                func = m.group(1)
                out[func] = {"all": 0}
                continue
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                         r"([A-Z][A-Z0-9]*)(\.\S*)?", line)
            if func and m:
                op, c = m.group(1), out[func]
                c["all"] += 1
                if op in ("LDG", "LDS", "STG", "LD"):  # with the width
                    op += m.group(2) or ""
                elif op not in ("PRMT", "FFMA", "FADD", "FMUL", "IMAD",
                                "SHF", "LOP3"):
                    continue
                c[op] = c.get(op, 0) + 1
    return out


def turns(old, new, n_turns: int, extra=None) -> dict:
    """``n_turns`` x (old, new, new, old), each timed both ways, or
    (new, new) when ``old`` is None; ``extra`` (a library call) once per
    turn after them."""
    res = {f"{who}_{m}": [] for who in ("old", "new", "library")
           for m in ("ms", "ms_back_to_back")}
    order = ((("new", new),) * 2 if old is None else
             (("old", old), ("new", new), ("new", new), ("old", old)))
    for _ in range(n_turns):
        for who, fn in order:
            for m, v in cs.kernel_ms(fn).items():
                res[f"{who}_{m}"].append(v)
        if extra is not None:
            for m, v in cs.kernel_ms(extra).items():
                res[f"library_{m}"].append(v)
    for m in ("ms", "ms_back_to_back"):
        old_t, new_t = res[f"old_{m}"], res[f"new_{m}"]
        res[f"new_{m}_median"] = statistics.median(new_t)
        res[f"new_{m}_quartiles"] = quartiles(new_t)
        if res[f"library_{m}"]:
            res[f"library_{m}_median"] = statistics.median(
                res[f"library_{m}"])
        if old is None:
            continue
        res[f"old_{m}_median"] = statistics.median(old_t)
        res[f"old_{m}_quartiles"] = quartiles(old_t)
        # pairs within a turn: (old 1st, new 2nd) and (old 4th, new 3rd)
        res[f"new_faster_pairs_{m}"] = sum(
            n < o for o, n in zip(old_t, new_t))
    res["pairs"] = 2 * n_turns
    return {k: v for k, v in res.items() if v != []}


def quartiles(v) -> list[float]:
    """The first and third quartiles of ``v`` (the spread reported)."""
    q = statistics.quantiles(v, n=4)
    return [q[0], q[2]]


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
    ap.add_argument("--dtype", default="float32",
                    help="comma-separated storage types: float32, bfloat16, "
                         "float16")
    ap.add_argument("--sass", action="store_true",
                    help="also count the Wilson kernels' SASS opcodes")
    ap.add_argument("--dims", default=",".join(map(str, cs.MAIN_DIMS)),
                    help="the lattice T,Z,Y,X (even extents)")
    ap.add_argument("--full-n", default="1,4",
                    help="comma-separated right-hand-side counts for K4")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    kernels = args.kernels.split(",")
    check(set(kernels) <= set(WRAPPERS), f"unknown kernels {kernels}")
    dtypes = args.dtype.split(",")
    check(set(dtypes) <= set(DTYPES), f"unknown dtypes {dtypes}")
    from repro_torch.core import lattice as tl
    from repro_torch.data import lattice_problem
    from repro_torch.kernels import build
    from repro_torch.kernels.cg_fused import kernel as ck
    from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
    from repro_torch.kernels.wilson_dslash import kernel as wk
    from repro_torch.kernels.wilson_dslash.ref import (wilson_full_ref,
                                                       wilson_hop_ref)
    old = import_old(args.old.resolve())
    check(old["build"].CSRC != build.CSRC, "--old is the current tree")
    dev = torch.device("cuda", 0)
    card = cs.smi()
    # both trees' nvcc at once, then wait for all of them
    started = [(bm, name, bm._start(name)) for bm in (build, old["build"])
               for name in bm.sources()]
    for bm, name, (target, proc) in started:
        bm._finish(name, target, proc)
    res = {"card": card, "turns": args.turns, "dims": args.dims,
           "ptxas_old": ptxas(old["build"]), "ptxas_new": ptxas(build)}
    if args.sass:
        res["sass_old"], res["sass_new"] = sass(old["build"]), sass(build)

    lat = tl.LatticeShape(*map(int, args.dims.split(",")))
    u, b = lattice_problem(lat, seed=0, packed=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = torch.stack([tl.random_spinor(gen, lat) for _ in range(4)])

    def versus(what, k_old, k_new, ref, exact=False):
        """The old version against the new one (16-bit storage: bitwise),
        or, where the old version has no instance of the storage type, the
        plain version (at most 1 ulp), before timing; returns the case's
        record to fill."""
        new = k_new()
        if k_old is None:
            return dict(max_abs_err=cs.narrow_check(new, ref(), what))
        theirs = k_old()
        diff = cs.max_err(theirs, new)
        exact = exact or new.dtype in cs.NARROW
        check(diff <= (0.0 if exact else cs.HOP_TOL * cs.scale(new)),
              f"{what}: old and new differ by {diff}")
        check(not exact or torch.equal(theirs, new),
              f"{what}: old and new differ bitwise")
        return dict(max_abs_diff=diff,
                    bitwise_equal_old=torch.equal(theirs, new))

    def instance(fn, call, sfx) -> str:
        """The instance one 16-bit call of a Wilson wrapper runs."""
        build.zero_counts(fn)
        call()
        return "pair" if getattr(fn, f"launches{sfx}_pair") else "one-site"

    # the earlier version's storage types
    old_dtypes = getattr(old["build"], "STORAGE", {torch.float32: 0})

    for dname in dtypes:
        dtype = DTYPES[dname]
        f32 = dtype == torch.float32
        sfx = cs.SUFFIX[dtype]
        has_old = dtype in old_dtypes
        if "wilson_hop" in kernels:
            ue, uo = tl.split_eo_gauge(u)
            upe, upo = tl.pack_gauge(ue, dtype), tl.pack_gauge(uo, dtype)
            del ue, uo
            m = cs.MASS + 4.0
            es = 4 if f32 else 2
            for n in (1, 4):
                rhs = b[None] if n == 1 else batch
                halves = [tl.split_eo(rhs[i]) for i in range(n)]
                pe = tl.pack_spinor(torch.stack([h[0] for h in halves]),
                                    dtype)
                po = tl.pack_spinor(torch.stack([h[1] for h in halves]),
                                    dtype)
                del halves
                if n == 1:
                    pe, po = pe[0], po[0]
                kw = dict(parity=0, gamma5_out=True, psi_acc=pe,
                          acc_coeff=m, hop_coeff=-1.0 / m)
                k_old = ((lambda: old["wilson_hop"](upe, upo, po, **kw))
                         if has_old else None)
                k_new = lambda: wk.wilson_hop(upe, upo, po, **kw)
                r = versus(f"K1 {dname} N={n}", k_old, k_new,
                           lambda: wilson_hop_ref(upe, upo, po, **kw))
                if not f32:
                    r["instance"] = instance(wk.wilson_hop, k_new, sfx)
                r.update(turns(k_old, k_new, args.turns))
                r["plan"] = list(wk.hop_tile_plan(po.shape[-3], po.shape[-1],
                                                  es))
                if args.rows:
                    plan, want = wk.hop_tile_plan, k_new()
                    r["rows_ms"] = {}
                    for rows in map(int, args.rows.split(",")):
                        wk.hop_tile_plan = (
                            lambda y, xh, es=4, rows=rows:
                            (rows, *plan(y, xh, es)[1:]))
                        try:
                            # every tile height computes each site alike
                            check(torch.equal(k_new(), want),
                                  f"K1 {dname} N={n} b={rows} differs from "
                                  "the plan's")
                            r["rows_ms"][rows] = cs.kernel_ms(k_new)
                        finally:
                            wk.hop_tile_plan = plan
                res[f"wilson_hop{sfx}_n{n}"] = r
                del pe, po
            del upe, upo

        length = b.numel()
        if "cg_update" in kernels:
            for n in (1, 4):
                g = torch.Generator(device=dev)
                g.manual_seed(5)
                x, rr, pp, ap = (torch.randn(n, length, generator=g,
                                             device=dev).to(dtype)
                                 for _ in range(4))
                alpha = torch.linspace(0.2, 0.8, n, device=dev)
                k_old = ((lambda: old["cg_update"](alpha, x, rr, pp, ap)[1])
                         if has_old else None)
                k_new = lambda: ck.cg_update(alpha, x, rr, pp, ap)[1]
                new_rs = ck.cg_update(alpha, x, rr, pp, ap)[2]
                ref_rs = cg_update_ref(alpha, x, rr, pp, ap)[2]
                rel = float(((new_rs - ref_rs).abs() / ref_rs).max())
                check(rel <= cs.CG_TOL, f"K2 {dname} N={n}: norm error {rel}")
                r = versus(f"K2 {dname} N={n}", k_old, k_new,
                           lambda: cg_update_ref(alpha, x, rr, pp, ap)[1],
                           exact=True)
                r.update(turns(k_old, k_new, args.turns), norm_rel_err=rel)
                res[f"cg_update{sfx}_n{n}"] = r
                del x, rr, pp, ap

        if "cg_xpay" in kernels:
            for n in (1, 4):
                g = torch.Generator(device=dev)
                g.manual_seed(5)
                rr, pp = (torch.randn(n, length, generator=g,
                                      device=dev).to(dtype)
                          for _ in range(2))
                beta = torch.linspace(0.1, 0.9, n, device=dev)
                gate = (torch.ones(n, dtype=torch.bool, device=dev)
                        if n > 1 else None)
                k_old = ((lambda: old["cg_xpay"](beta, rr, pp, gate))
                         if has_old else None)
                k_new = lambda: ck.cg_xpay(beta, rr, pp, gate)
                if f32:
                    err = cs.max_err(k_new(), cg_xpay_ref(beta, rr, pp, gate))
                    check(err <= cs.CG_TOL, f"K3 N={n}: error {err}")
                r = versus(f"K3 {dname} N={n}", k_old, k_new,
                           lambda: cg_xpay_ref(beta, rr, pp, gate),
                           exact=True)
                bv = beta.view(n, 1).to(dtype)
                lib = None if n > 1 else lambda: torch.addcmul(rr, bv, pp)
                r.update(turns(k_old, k_new, args.turns, lib))
                res[f"cg_xpay{sfx}_n{n}"] = r
                del rr, pp

        if "wilson_full" in kernels:
            up = tl.pack_gauge(u, dtype)
            es = 4 if f32 else 2
            for n in map(int, args.full_n.split(",")):
                # N <= 4: the batch's first N; beyond it fresh RHS
                rhs = (b[None] if n == 1 else batch[:n] if n <= 4 else
                       torch.cat([batch] + [tl.random_spinor(gen, lat)[None]
                                            for _ in range(n - 4)]))
                pp = tl.pack_spinor(rhs[0] if n == 1 else rhs, dtype)
                del rhs
                kw = dict(gamma5_in=True, gamma5_out=True)
                k_old = ((lambda: old["wilson_full"](up, pp, cs.MASS, **kw))
                         if has_old else None)
                k_new = lambda: wk.wilson_full(up, pp, cs.MASS, **kw)
                r = versus(f"K4 {dname} N={n}", k_old, k_new,
                           lambda: wilson_full_ref(up, pp, cs.MASS, **kw))
                if not f32:
                    r["instance"] = instance(wk.wilson_full, k_new, sfx)
                r.update(turns(k_old, k_new, args.turns))
                r["plan"] = list(wk.full_tile_plan(pp.shape[-3],
                                                   pp.shape[-1], es))
                if args.full_rows:
                    plan, want = wk.full_tile_plan, k_new()
                    r["rows_ms"] = {}
                    for rows in map(int, args.full_rows.split(",")):
                        wk.full_tile_plan = (
                            lambda y, x, es=4, rows=rows:
                            (rows, *plan(y, x, es)[1:]))
                        try:
                            # every tile height computes each site alike
                            check(torch.equal(k_new(), want),
                                  f"K4 {dname} N={n} b={rows} differs from "
                                  "the plan's")
                            r["rows_ms"][rows] = cs.kernel_ms(k_new)
                        finally:
                            wk.full_tile_plan = plan
                res[f"wilson_full{sfx}_n{n}"] = r
                del pp
            del up
    print(card)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
