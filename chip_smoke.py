#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's kernels from ``src/repro_torch/csrc`` and drives its
two solve paths through ``repro_torch.core.plan.solve`` on the card: the
paper's solve, CGNR on the even-odd Schur complement of the Wilson
operator (``operator="eo-schur"``), and CGNR on the full-lattice normal
operator (``operator="full"``), each in f32 and in mixed precision
(``precision="mixed"``: a bf16 inner CG through the kernels' bf16
instances, f32 reliable updates), and the full lattice's all-bf16 cg16
(``precision="low"``); then the other Krylov loops on the same kernels:
pipelined CG (``solver="pipecg"``), block CG (``solver="blockcg"``, the
hop kernel at 16 RHS) and EigCG deflation (``plan.harvest_deflation``,
``solve(..., deflation=)``).  Phases:

0. build every kernel (one ``nvcc`` per source, all at once);
1. banner: the card's name and power limit, and the measured
   device-to-device copy bandwidth;
2. kernel checks at 8^4, 4x6x8x16, 4x4x6x6 (odd Xh), 4x4x22x8 (Y not
   a multiple of the hop kernel's tile) and 2x2x2x348 (the hop kernel's
   rows read in place); the full-lattice kernel also at 4x4x22x16 (Y
   against its 8-row tile), 4x4x6x5 (odd X: links staged by plain
   loads), 2x2x2x464 (links read in place) and with the spinor's or the
   gauge field's base 4 bytes off alignment: each kernel against its
   plain PyTorch version (the hop kernel for every flag set, the
   full-lattice kernel for every gamma5 flag pair with and without
   twist); both Wilson kernels batched (N = 3) against three single
   launches bitwise; frozen lanes and closed gates bitwise; the xpay
   kernel on views 1-3 floats off 16-byte alignment and on single-RHS
   slices.  Then each bf16 instance against its plain version on the same
   bf16 inputs, at most 1 bf16 ulp per entry (an entry that cancels below
   2^-16 of the field's largest entry is held to the ulp at that floor):
   the hop kernel for every flag set at 8^4, 4x6x8x16, 4^4 (staged by
   plain loads), 4x4x6x6, 4x4x22x8, 2x2x2x348 and 2x2x2x700 (read in
   place), the full-lattice kernel at 8^4, 4x4x8x32 (the X = 32
   instances), 4x4x22x16, 4x4x6x5, 2x2x2x348, 2x2x2x464, 2x2x2x928 (in
   place) and misaligned bases, K2 at N = 1 and 3 with a frozen RHS, K3
   gated and ungated on misaligned views; batched equal to single
   launches bitwise.  K1's even Xh and K4's X = 32 run the Wilson
   kernels' bf16 pair instances (two sites a thread, each component of
   both read as one 32-bit word), other widths and bases 2 bytes off
   4-byte alignment the one-site instances; the pair counts say which
   ran.  At
   16^3 x 32 each pair instance is held bitwise against its one-site
   instance (the same inputs, copied 2 bytes off alignment) for every
   flag set;
3. goldens: the committed 4^4 seed-7 fixture solved through the kernels
   (even-odd: 14 iterations Wilson, 13 twisted mass mu = 0.25, 14 for
   each of 4 batched RHS; full lattice: 27 in each case), and against
   the reference backend on the card; then the mixed goldens (inner
   iterations within 2 of JAX's pallas backend's count, outer equal):
   even-odd Wilson and twisted mass 15 / 4, full N = 1 35 / 5 and N = 4
   33, 33, 35, 33 / 5, cg16 27 (unverified by design), each with its
   launch counts and no plain-version call; then the other Krylov loops
   (fixture batch ``b_batch16``): at mass 0.1 pipecg even-odd 14 (N = 1
   and 4, 15 matvecs) and full 30 (N = 1 and 4, 33 matvecs), blockcg
   N = 4 even-odd 14 and full 27, equal to the JAX twins' counts; at
   mass -1.7 blockcg
   N = 16 (JAX: 71 reference, 90 pallas), the harvest of batch[0] (tol
   1e-8, nev 32, m_max 160: 153 iterations / 185 matvecs), batch[1]
   cold (110) and deflated (109-111), each within 2 of one twin's count
   or between the twins';
4. both paths at full size, 64x32x32x32 (T, Z, Y, X), mass 0.1,
   tol 1e-6.  Even-odd: a single-RHS Wilson solve, a 4-RHS Wilson solve
   and a single-RHS twisted-mass solve, with hop launches 4I+4, update
   and xpay launches I.  Full lattice: a single-RHS Wilson solve, a
   4-RHS Wilson solve and a single-RHS Wilson solve on packed fields,
   with full-lattice launches 2I+1 (2I+2 packed, whose verification
   runs the kernel).  Then mixed precision: even-odd N = 1, full N = 1
   and N = 4, and full cg16 N = 1 (which must converge in bf16 and is
   unverified by design; its true residual is printed), with the time to
   a verified solution beside the f32 solve's of the same path.  Then
   the other Krylov loops: even-odd pipecg N = 1 and 4, full pipecg
   N = 1, even-odd blockcg N = 16 beside even-odd CGNR N = 16, and a
   harvest (nev 8, m_max 48, tol 1e-8, verified at 1e-6) followed by a
   deflated solve of another RHS, each timed beside CGNR at the same N
   (the 16-RHS batch exists only for the N = 16 runs).
   Each solve has every count set to 0 just before it; it must converge and
   verify with a true relative residual below 10 tol, launch no other
   kernel and call no plain version; every bf16 Wilson launch of these
   32^3 x 64 solves must run the pair instance;
5. timings at the main path's shapes: each kernel's median time over
   CUDA events, one call per event pair (``ms``, which includes the
   wrapper's host latency before the launch) and per call over ten
   back-to-back calls (``ms_back_to_back``, where that latency hides
   behind the card's work), held once more against its plain version
   on the same inputs, beside the plain version's time, its bound and,
   for the ungated xpay, one library call computing the same function,
   timed both ways; the bf16 instances likewise, against their bounds at
   2 bytes a real (K3 against ``torch.addcmul`` on bf16), the Wilson
   kernels' labelled with the instance they ran, beside the pair
   kernels' registers and spills from the compiler's report; the hop
   kernel in f32 once more at N = 16, block CG's width, and the hop,
   update and xpay kernels at N = 8, the server's top rung;
6. one traced single-RHS Wilson solve of each path, the 4-RHS
   full-lattice solve, the mixed single-RHS solve of each path, the
   16-RHS even-odd block CG, the single-RHS even-odd pipecg and the
   deflated single-RHS solve (``torch.profiler``): device time by kernel and the card's idle share
   of the solve;
7. durable solves at 64x32x32x32: even-odd f32 and mixed N = 1 and full
   f32 N = 4 checkpointed every 5 iterations (keep 2), each x bitwise
   the unsegmented solve's with equal iterations, launches and the
   expected snapshot steps, the milliseconds of each snapshot printed;
   ``python -m repro_torch.launch.solve --checkpoint-dir`` SIGKILLed
   once its first step lands, then ``--resume`` in a fresh process (the
   same u and b hashes, resumed from a real step, verified); a truncated
   newest step falling back to the one before; ``defended_solve`` on
   healthy f32 and mixed plans at attempt 0 on the kernels with no plain
   call;
8. the solver server: a ``SolverServer`` on the kernels with ladder
   (1, 4, 8), two gauge fields, its kernels loaded; 12 concurrent requests
   (Wilson and twisted mass, tol 1e-6 and 1e-5) all verified, two x
   bitwise their direct ``plan.solve``; one batch at each rung launching
   the hop kernel 4I+4 times and the update and xpay kernels I times
   each, with no plain call; a NaN RHS rejected at admission, an
   overflow RHS (admission off) failing alone; a journaled server
   aborted with four requests in flight and recovered by a fresh one to
   zero incomplete entries; then ``python -m
   repro_torch.launch.serve_solver`` (1 gauge, 32 requests in bursts of
   4, ladder 1,4,8) every 50 ms (an overload: queueing) and every
   1000 ms (below capacity: service time), each with its p50/p99
   latency and solves per second.
   Each phase prints its seconds; the checkpoint and journal
   directories live under ``build/`` and are removed.

Block CG's Gram products must run in full f32: the script checks that
TF32 is off for matrix products before any phase.

Any failure raises; no phase's error is caught.  The last line is the
JSON object ``{"ok": true, "device": {...}}``; the line before it lists
the kernels, the bf16 instances as ``<kernel>_bf16`` (with the Wilson
kernels' instance).  Exits non-zero without printing a result when there is no
CUDA device or the port's sources are missing.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
HOP_FLOPS_PER_SITE = 1320        # per output site and RHS (paper §5)
MAIN_DIMS = (64, 32, 32, 32)     # T, Z, Y, X: the 32^3 x 64 lattice
MASS, TOL, MU = 0.1, 1e-6, 0.25
LIGHT = -1.7                     # near-critical mass of the light-mass goldens
HOP_TOL = 1e-5                   # max-abs over max(1, max |plain|): f32 order
EO_GOLDEN, FULL_GOLDEN = 14, 27  # 4^4 seed-7 Wilson iterations (JAX reference)
CG_TOL = 1e-5                    # max-abs on fields, relative on norms
BF16 = torch.bfloat16
ULP_FLOOR = 2.0 ** -16           # bf16 checks: see bf16_check
# 4^4 seed-7 mixed goldens: (name, plan fields, batched, inner per RHS,
# outer), the inner counts of JAX's pallas backend (its CPU lowering; the
# reference backend's are 33 / 33 x 4 on the full lattice), held to +-2
MIXED_GOLDENS = (
    ("eo_mixed", dict(precision="mixed"), False, [15], 4),
    ("eo_mixed_tm", dict(precision="mixed", operator_family="twisted-mass",
                         mu=0.25), False, [15], 4),
    ("full_mixed", dict(operator="full", precision="mixed"), False, [35], 5),
    ("full_mixed_n4", dict(operator="full", precision="mixed", nrhs=4), True,
     [33, 33, 35, 33], 5),
    ("full_cg16", dict(operator="full", precision="low"), False, [27], 1))
# 4^4 seed-7 goldens of the other Krylov loops at mass 0.1: (name, plan
# fields, RHS count, iterations per RHS, matvecs), the JAX twins' counts
# (reference and pallas backends alike)
KRYLOV_GOLDENS = (
    ("eo_pipecg", dict(solver="pipecg"), 1, [14], 15),
    ("eo_pipecg_n4", dict(solver="pipecg", nrhs=4), 4, [14] * 4, 15),
    ("full_pipecg", dict(operator="full", solver="pipecg"), 1, [30], 33),
    ("full_pipecg_n4", dict(operator="full", solver="pipecg", nrhs=4), 4,
     [30] * 4, 33),
    ("eo_blockcg_n4", dict(solver="blockcg", nrhs=4), 4, [14] * 4, 14),
    ("full_blockcg_n4", dict(operator="full", solver="blockcg", nrhs=4), 4,
     [27] * 4, 27))
# the JAX twins at mass -1.7 (reference, pallas): block CG over b_batch16
# (loop count and per RHS), the harvest of batch[0] (iterations, matvecs),
# batch[1] cold and deflated (iterations)
BLOCKCG16_TWINS = (
    (71, [67, 69, 68, 69, 69, 68, 70, 69, 69, 70, 68, 71, 68, 70, 69, 69]),
    (90, [84, 88, 89, 89, 88, 88, 87, 87, 88, 88, 88, 90, 86, 89, 89, 90]))
HARVEST_TWINS = ((153, 185), (153, 185))
COLD_TWINS, DEFLATED_TWINS = (110, 110), (109, 110)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``inner`` calls of ``fn`` in
    a row, per call, after ``warmup``.  With inner > 1 the host's cost of a
    call overlaps the card's work on the one before, so a sub-millisecond
    kernel is not charged its wrapper's host latency."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_ms(fn, prefix: str = "ms") -> dict:
    """``fn`` timed both ways: one call per event pair (``<prefix>``) and
    ten back-to-back calls per pair (``<prefix>_back_to_back``)."""
    return {prefix: time_ms(fn, reps=20),
            f"{prefix}_back_to_back": time_ms(fn, reps=10, inner=10)}


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype == BF16:
        a, b = a.float(), b.float()
    return float((a - b).abs().max())


def bf16_check(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """A bf16 instance against its plain version: at most 1 bf16 ulp per
    entry.  An entry that cancels below ULP_FLOOR of the field's largest
    entry, where two f32 evaluations of the same sums in another order
    differ by more than its own ulp, is held to the ulp at that floor.
    Returns the max-abs error."""
    check(out.dtype == ref.dtype == BF16, f"{what}: not bf16 ({out.dtype})")
    bits = [v.contiguous().view(torch.int16).int() for v in (out, ref)]
    ords = [torch.where(v < 0, -(v & 0x7FFF), v) for v in bits]
    a, b = out.double(), ref.double()
    _, e = torch.frexp(ULP_FLOOR * b.abs().max())
    floor = torch.ldexp(torch.ones((), dtype=torch.float64, device=b.device),
                        e - 8)
    ulps = (ords[0] - ords[1]).abs()
    ok = (ulps <= 1) | ((a - b).abs() <= floor)
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} entries beyond 1 "
                          f"bf16 ulp (max {int(ulps.max())} ulps)")
    return float((a - b).abs().max())


def agree(out, ref, what: str) -> float:
    """The kernel-against-plain check of the output's dtype: f32 max-abs
    <= HOP_TOL * max(1, max |plain|), bf16 by :func:`bf16_check`."""
    if out.dtype == BF16:
        return bf16_check(out, ref, what)
    err = max_err(out, ref)
    check(err <= HOP_TOL * scale(ref), f"{what}: max-abs error {err}")
    return err


def scale(t: torch.Tensor) -> float:
    return max(1.0, float(t.abs().max()))


# ---------------------------------------------------------------------------
# phase 1: banner
# ---------------------------------------------------------------------------


def copy_bandwidth(dev) -> float:
    """Device-to-device copy rate in bytes/s (1 GiB read + 1 GiB written)."""
    n = 1 << 28
    src = torch.empty(n, dtype=torch.float32, device=dev).uniform_()
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    del src, dst
    return 2 * 4 * n / (ms * 1e-3)


# ---------------------------------------------------------------------------
# phase 2: kernel checks at small shapes
# ---------------------------------------------------------------------------


def random_packed(gen, dims, n, dtype=torch.float32):
    from repro_torch.core import lattice as tl
    lat = tl.LatticeShape(*dims)
    ue, uo = tl.split_eo_gauge(tl.random_gauge(gen, lat))
    psi = torch.stack([tl.split_eo(tl.random_spinor(gen, lat))[0]
                       for _ in range(n)])
    acc = torch.stack([tl.split_eo(tl.random_spinor(gen, lat))[1]
                       for _ in range(n)])
    return (tl.pack_gauge(ue, dtype), tl.pack_gauge(uo, dtype),
            tl.pack_spinor(psi, dtype), tl.pack_spinor(acc, dtype))


def check_hop(dev, gen, dims, dtype=torch.float32) -> float:
    """K1 for every flag set, N = 1 and 3, against its plain version (f32
    or bf16 storage); each batched RHS bitwise against its single launch."""
    from repro_torch.kernels.wilson_dslash.kernel import wilson_hop
    from repro_torch.kernels.wilson_dslash.ref import wilson_hop_ref
    upe, upo, psi, acc = random_packed(gen, dims, 3, dtype)
    worst = 0.0
    for parity, g5in, g5out, has_acc, twist in itertools.product(
            (0, 1), (False, True), (False, True), (False, True),
            (False, True)):
        u_out, u_nbr = (upe, upo) if parity == 0 else (upo, upe)
        kw = dict(parity=parity, gamma5_in=g5in, gamma5_out=g5out,
                  hop_coeff=-0.3 if (has_acc or twist) else 1.0,
                  hop_twist=0.2 if twist else 0.0,
                  acc_coeff=1.7 if has_acc else 0.0,
                  acc_twist=-0.4 if (has_acc and twist) else 0.0)
        for n in (1, 3):
            p = psi[0] if n == 1 else psi
            a = (acc[0] if n == 1 else acc) if has_acc else None
            out = wilson_hop(u_out, u_nbr, p, psi_acc=a, **kw)
            ref = wilson_hop_ref(u_out, u_nbr, p, psi_acc=a, **kw)
            err = agree(out, ref, f"wilson_hop {dtype} {dims} N={n} {kw} "
                                  f"has_acc={has_acc}")
            worst = max(worst, err)
            if n == 3:
                for i in range(3):
                    single = wilson_hop(u_out, u_nbr, psi[i],
                                        psi_acc=acc[i] if has_acc else None,
                                        **kw)
                    check(torch.equal(out[i], single),
                          f"wilson_hop {dims} {kw}: batched RHS {i} differs "
                          "from its single launch")
    torch.cuda.synchronize()
    return worst


def off_by_one_float(v: torch.Tensor, nbytes: int = 4) -> torch.Tensor:
    """A contiguous copy of ``v`` whose data starts ``nbytes`` bytes (4: one
    float, two bf16) past a 16-byte boundary (a view into a larger
    buffer)."""
    k = nbytes // v.element_size()
    buf = torch.empty(v.numel() + 16, dtype=v.dtype, device=v.device)
    out = buf[k:k + v.numel()].view(v.shape)
    out.copy_(v)
    check(out.is_contiguous() and out.data_ptr() % 16 == nbytes,
          f"off_by_one_float: view not {nbytes} bytes off alignment")
    return out


def pair_launches() -> dict:
    from repro_torch import kernels
    return kernels.pair_launches()


def check_pairs(dev, gen, dims) -> dict:
    """The bf16 pair instances of K1 and K4 against their one-site
    instances, bitwise, for every flag set at N = 3: the pair instance on
    the fields as allocated, the one-site instance on copies of the
    spinors 2 bytes off 4-byte alignment; each launch's instance read from
    the pair counts.  Returns the launches of each instance."""
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash.kernel import (wilson_full,
                                                          wilson_hop)
    upe, upo, psi, acc = random_packed(gen, dims, 3, BF16)
    psi2, acc2 = off_by_one_float(psi, 2), off_by_one_float(acc, 2)
    ran = {"pair": 0, "one-site": 0}

    def both(name, pair_call, one_call, what):
        before = pair_launches()[name]
        out = pair_call()
        check(pair_launches()[name] == before + 1,
              f"{what}: the pair instance did not run")
        one = one_call()
        check(pair_launches()[name] == before + 1,
              f"{what}: the one-site instance did not run")
        check(torch.equal(out, one), f"{what}: pair and one-site instances "
                                     "differ")
        ran["pair"] += 1
        ran["one-site"] += 1

    for parity, g5in, g5out, has_acc, twist in itertools.product(
            (0, 1), (False, True), (False, True), (False, True),
            (False, True)):
        u_out, u_nbr = (upe, upo) if parity == 0 else (upo, upe)
        kw = dict(parity=parity, gamma5_in=g5in, gamma5_out=g5out,
                  hop_coeff=-0.3 if (has_acc or twist) else 1.0,
                  hop_twist=0.2 if twist else 0.0,
                  acc_coeff=1.7 if has_acc else 0.0,
                  acc_twist=-0.4 if (has_acc and twist) else 0.0)
        both("wilson_hop_bf16",
             lambda: wilson_hop(u_out, u_nbr, psi,
                                psi_acc=acc if has_acc else None, **kw),
             lambda: wilson_hop(u_out, u_nbr, psi2,
                                psi_acc=acc2 if has_acc else None, **kw),
             f"wilson_hop bf16 {dims} {kw} has_acc={has_acc}")
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), BF16)
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]), BF16)
    pp2 = off_by_one_float(pp, 2)
    for g5in, g5out, twist in itertools.product((False, True),
                                                (False, True), (0.0, MU)):
        kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
        both("wilson_full_bf16", lambda: wilson_full(up, pp, MASS, **kw),
             lambda: wilson_full(up, pp2, MASS, **kw),
             f"wilson_full bf16 {dims} {kw}")
    torch.cuda.synchronize()
    return ran


def check_full(dev, gen, dims, misaligned: str = "",
               dtype=torch.float32) -> float:
    """K4 for every gamma5 flag pair with and without twist, N = 1 and 3,
    against its plain version (f32 or bf16 storage); each batched RHS
    bitwise against its single launch.  ``misaligned`` ("psi" or
    "gauge"): that field's base pointer lies 4 bytes off 16-byte
    alignment."""
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), dtype)
    psi = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                      for _ in range(3)]), dtype)
    if misaligned == "psi":
        psi = off_by_one_float(psi)
    elif misaligned == "gauge":
        up = off_by_one_float(up)
    where = f"{dims}{' ' + misaligned + ' misaligned' if misaligned else ''}"
    worst = 0.0
    for g5in, g5out, twist in itertools.product((False, True),
                                                (False, True), (0.0, MU)):
        kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
        for n in (1, 3):
            p = psi[0] if n == 1 else psi
            out = wilson_full(up, p, MASS, **kw)
            ref = wilson_full_ref(up, p, MASS, **kw)
            worst = max(worst, agree(out, ref, f"wilson_full {dtype} "
                                               f"{where} N={n} {kw}"))
            if n == 3:
                for i in range(3):
                    check(torch.equal(out[i],
                                      wilson_full(up, psi[i], MASS, **kw)),
                          f"wilson_full {where} {kw}: batched RHS {i} "
                          "differs from its single launch")
    torch.cuda.synchronize()
    return worst


def check_cg(dev, gen) -> tuple[float, float]:
    from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
    worst_u = worst_x = 0.0
    for length in (12345, 8 ** 4 * 12, 4 * 6 * 8 * 8 * 24):  # ragged first
        x, r, p, ap = (torch.randn(3, length, generator=gen, device=dev)
                       for _ in range(4))
        alpha = torch.tensor([0.37, 0.0, -1.1], device=dev)
        xo, ro, rs = cg_update(alpha, x, r, p, ap)
        xr, rr, rsr = cg_update_ref(alpha, x, r, p, ap)
        err = max(max_err(xo, xr), max_err(ro, rr))
        rel = float(((rs - rsr).abs() / rsr).max())
        check(err <= CG_TOL and rel <= CG_TOL,
              f"cg_update L={length}: field error {err}, norm error {rel}")
        check(torch.equal(xo[1], x[1]) and torch.equal(ro[1], r[1]),
              f"cg_update L={length}: frozen lane changed")
        for i in range(3):
            sx, sr, srs = cg_update(alpha[i:i + 1], x[i:i + 1], r[i:i + 1],
                                    p[i:i + 1], ap[i:i + 1])
            check(torch.equal(sx[0], xo[i]) and torch.equal(srs[0], rs[i]),
                  f"cg_update L={length}: batched RHS {i} differs from its "
                  "single call")
        worst_u = max(worst_u, err)
        beta = torch.tensor([0.5, 0.25, 2.0], device=dev)
        gate = torch.tensor([True, False, True], device=dev)
        po = cg_xpay(beta, r, p, gate)
        err = max_err(po, cg_xpay_ref(beta, r, p, gate))
        check(err <= CG_TOL, f"cg_xpay L={length}: error {err}")
        check(torch.equal(po[1], p[1]), f"cg_xpay L={length}: closed gate "
                                        "changed p")
        for i in range(3):  # x[i:i+1] starts off 16-byte alignment at 12345
            single = cg_xpay(beta[i:i + 1], r[i:i + 1], p[i:i + 1],
                             gate[i:i + 1])
            check(torch.equal(single[0], po[i]),
                  f"cg_xpay L={length}: batched RHS {i} differs from its "
                  "single call")
        po = cg_xpay(beta, r, p)
        err = max(err, max_err(po, cg_xpay_ref(beta, r, p)))
        check(err <= CG_TOL, f"cg_xpay (no gate) L={length}: error {err}")
        worst_x = max(worst_x, err)
    worst_x = max(worst_x, check_xpay_misaligned(dev, gen))
    torch.cuda.synchronize()
    return worst_u, worst_x


def check_xpay_misaligned(dev, gen) -> float:
    """K3 on views whose data starts 1, 2 or 3 floats off 16-byte
    alignment (r and p alike, and against each other), gate open and
    closed: it must give what the plain version gives, and a closed gate
    p bitwise."""
    from repro_torch.kernels.cg_fused.kernel import cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_xpay_ref
    worst = 0.0
    length = 12345
    buf_r = torch.randn(2 * length + 8, generator=gen, device=dev)
    buf_p = torch.randn(2 * length + 8, generator=gen, device=dev)
    beta = torch.tensor([0.75, -1.5], device=dev)
    for off_r, off_p in ((1, 1), (2, 2), (3, 3), (1, 3), (0, 2)):
        r = buf_r[off_r:off_r + 2 * length].view(2, length)
        p = buf_p[off_p:off_p + 2 * length].view(2, length)
        for gate in (None, torch.tensor([True, False], device=dev)):
            po = cg_xpay(beta, r, p, gate)
            err = max_err(po, cg_xpay_ref(beta, r, p, gate))
            check(err <= CG_TOL, f"cg_xpay offsets {(off_r, off_p)} gate "
                                 f"{gate is not None}: error {err}")
            if gate is not None:
                check(torch.equal(po[1], p[1]), f"cg_xpay offsets "
                      f"{(off_r, off_p)}: closed gate changed p")
            worst = max(worst, err)
    return worst


def check_cg_bf16(dev, gen) -> tuple[float, float]:
    """The bf16 instances of K2 and K3: N = 1 and 4 with a frozen RHS, K3
    gated and ungated, on views 0, 1, 3 and 7 elements off 16-byte
    alignment (alike, and the fields against each other) at a ragged
    length and at a half field's; within 1 bf16 ulp of the plain version,
    the norms (f32, of r' before rounding) 1e-5 relative, frozen lanes and
    closed gates bitwise, each RHS bitwise equal to its single call."""
    from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
    worst_u = worst_x = 0.0
    for length, n, offsets in ((12345, 4, (0, 0)), (12345, 4, (1, 1)),
                               (12345, 1, (3, 3)), (12345, 4, (7, 2)),
                               (8 ** 4 * 12, 4, (0, 0)),
                               (8 ** 4 * 12, 1, (1, 5))):
        bufs = [torch.randn(n * length + 16, generator=gen,
                            device=dev).to(BF16) for _ in range(4)]
        x, r, p, ap = (buf[o:o + n * length].view(n, length)
                       for buf, o in zip(bufs, offsets + offsets))
        where = f"L={length} N={n} offsets {offsets}"
        alpha = torch.linspace(0.3, -0.9, n, device=dev)
        if n > 1:
            alpha[1] = 0.0
        xo, ro, rs = cg_update(alpha, x, r, p, ap)
        xr, rr, rsr = cg_update_ref(alpha, x, r, p, ap)
        worst_u = max(worst_u, bf16_check(xo, xr, f"cg_update bf16 {where}"),
                      bf16_check(ro, rr, f"cg_update bf16 {where}"))
        rel = float(((rs - rsr).abs() / rsr).max())
        check(rs.dtype == torch.float32 and rel <= CG_TOL,
              f"cg_update bf16 {where}: norm error {rel}")
        if n > 1:
            check(torch.equal(xo[1], x[1]) and torch.equal(ro[1], r[1]),
                  f"cg_update bf16 {where}: frozen lane changed")
        beta = torch.linspace(0.1, 0.9, n, device=dev)
        gate = torch.arange(n, device=dev) % 2 == 0
        outs = {}
        for g in (None, gate):
            po = cg_xpay(beta, r, p, g)
            worst_x = max(worst_x, bf16_check(po, cg_xpay_ref(beta, r, p, g),
                                              f"cg_xpay bf16 {where}"))
            if g is not None and n > 1:
                check(torch.equal(po[1], p[1]),
                      f"cg_xpay bf16 {where}: closed gate changed p")
            outs[g is None] = po
        for i in range(n):
            sx, sr, srs = cg_update(alpha[i:i + 1], x[i:i + 1], r[i:i + 1],
                                    p[i:i + 1], ap[i:i + 1])
            check(torch.equal(sx[0], xo[i]) and torch.equal(sr[0], ro[i])
                  and torch.equal(srs[0], rs[i]),
                  f"cg_update bf16 {where}: RHS {i} differs from its single "
                  "call")
            for ungated, po in outs.items():
                single = cg_xpay(beta[i:i + 1], r[i:i + 1], p[i:i + 1],
                                 None if ungated else gate[i:i + 1])
                check(torch.equal(single[0], po[i]),
                      f"cg_xpay bf16 {where}: RHS {i} differs from its "
                      "single call")
    torch.cuda.synchronize()
    return worst_u, worst_x


# ---------------------------------------------------------------------------
# phases 3 and 4: solves
# ---------------------------------------------------------------------------


def counted(dev, fn):
    """``fn()`` with every count set to 0 just before and read just after;
    returns (fn's result, counts, pair launches, wall seconds, peak
    bytes)."""
    from repro_torch import kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.counts()
    return (out, counts, kernels.pair_launches(), wall,
            torch.cuda.max_memory_allocated(dev))


def solve_counted(plan, u, b, dev, layout="natural", mass=MASS, **kw):
    """One counted solve (:func:`counted`); returns (x, stats, counts, pair
    launches, wall seconds, peak bytes)."""
    from repro_torch.core import plan as plan_mod
    (x, st), *rest = counted(dev, lambda: plan_mod.solve(
        plan, u, b, mass, tol=TOL, maxiter=1000, layout=layout, device=dev,
        **kw))
    return (x, st, *rest)


def harvest_counted(plan, u, b, dev, mass, **kw):
    """One counted :func:`harvest_deflation`; returns (x, stats, basis,
    counts, pair launches, wall seconds, peak bytes)."""
    from repro_torch.core import plan as plan_mod
    (x, st, basis), *rest = counted(dev, lambda: plan_mod.harvest_deflation(
        plan, u, b, mass, maxiter=1000, device=dev, **kw))
    return (x, st, basis, *rest)


def want_launches(plan, st, layout="natural", harvest=False) -> dict:
    """Kernel launches of a solve of k (inner) iterations, o reliable
    updates and m Krylov matvecs (k, or k + 1 from a deflated start;
    pipecg k + 1 + 2 (k // 25); a harvest k + min(nev, k)); every other
    kernel runs 0.  Only CGNR drives the fused CG kernels."""
    k, o = st.iterations, st.outer_iterations
    mv = int(torch.atleast_1d(st.matvecs).max())
    packed = int(layout == "packed")
    if plan.operator == "full":
        if plan.precision == "mixed":
            return {"wilson_full_bf16": 2 * k, "wilson_full": 2 * o + 1 + packed}
        if plan.precision == "low":
            return {"wilson_full_bf16": 2 * k, "wilson_full": 1 + packed}
        return {"wilson_full": 2 * mv + 1 + packed}
    if plan.precision == "mixed":
        return {"wilson_hop_bf16": 4 * k, "wilson_hop": 4 * o + 4,
                "cg_update_bf16": k, "cg_xpay_bf16": k}
    if plan.solver != "cgnr" or harvest:
        return {"wilson_hop": 4 * mv + 4}
    return {"wilson_hop": 4 * mv + 4, "cg_update": k, "cg_xpay": k}


def check_launches(name, st, counts, plan, layout="natural", harvest=False):
    want = want_launches(plan, st, layout, harvest)
    for kern in counts:
        n = want.get(kern, 0)
        got = counts[kern]
        check(got["launches"] == n, f"{name}: {kern} launched "
                                    f"{got['launches']} times, want {n}")
        check(got["plain_calls"] == 0, f"{name}: {kern} fell back to its "
                                       "plain version")


def rel_res(st, rhs, batched: bool) -> list[float]:
    """True relative residuals from the solve's verification matvec."""
    rows = rhs if batched else rhs[None]
    bs = torch.stack([(v.abs() ** 2).sum() for v in rows])
    return (torch.atleast_1d(st.true_residual_norm2) / bs).sqrt().tolist()


def check_solve(name, st, rel, verified=True):
    """Converged; verified with a true relative residual below 10 tol,
    or (cg16, ``verified=False``) unverified, as bf16 cannot reach tol."""
    from repro_torch.core import solvers
    verdicts = torch.atleast_1d(st.verdict).tolist()
    check(all(v == solvers.CONVERGED for v in verdicts),
          f"{name}: verdicts {[solvers.verdict_name(v) for v in verdicts]}")
    ver = torch.atleast_1d(st.verified)
    if verified:
        check(bool(ver.all()), f"{name}: unverified")
        check(max(rel) < 10 * TOL, f"{name}: true rel_res {rel}")
    else:
        check(not bool(ver.any()), f"{name}: cg16 verified")


def near_or_between(n: int, twins) -> bool:
    """Within 2 of one twin's count, or between the two twins' counts."""
    return (min(twins) <= n <= max(twins)
            or any(abs(n - t) <= 2 for t in twins))


def check_twin_counts(name, its, want):
    """The mass-0.1 rule: the port's iterations equal the twins'."""
    check(its == want, f"golden {name}: iterations {its}, want {want}")


def goldens(dev):
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.lattice import fields_from_numpy
    import numpy as np
    path = ROOT / "src" / "repro_torch" / "data" / "golden_4x4x4x4_seed7.npz"
    with np.load(path) as f:
        u, b = fields_from_numpy(f["gauge"], f["b"], device=dev)
        _, batch = fields_from_numpy(f["gauge"], f["b_batch"], device=dev)
        _, batch16 = fields_from_numpy(f["gauge"], f["b_batch16"], device=dev)
    check(torch.equal(batch16[:4], batch), "fixture: b_batch16[:4] is not "
                                           "b_batch")
    out = {}
    SP = plan_mod.SolverPlan
    for name, plan, rhs, want in (
            ("eo_smoke", SP(), b, [EO_GOLDEN]),
            ("eo_smoke_tm", SP(operator_family="twisted-mass", mu=MU), b,
             [13]),
            ("batch_sweep_n4", SP(nrhs=4), batch, [EO_GOLDEN] * 4),
            ("full_smoke", SP(operator="full"), b, [FULL_GOLDEN]),
            ("full_smoke_tm", SP(operator="full",
                                 operator_family="twisted-mass", mu=MU), b,
             [FULL_GOLDEN]),
            ("full_batch_n4", SP(operator="full", nrhs=4), batch,
             [FULL_GOLDEN] * 4)):
        x, st, counts, _, _, _ = solve_counted(plan, u, rhs, dev)
        its = (st.rhs_iterations.tolist() if plan.batched
               else [st.iterations])
        check(its == want, f"golden {name}: iterations {its}, want {want}")
        check_solve(name, st, rel_res(st, rhs, plan.batched))
        check_launches(name, st, counts, plan)
        ref_plan = plan_mod.SolverPlan(operator=plan.operator,
                                       operator_family=plan.operator_family,
                                       mu=plan.mu, nrhs=plan.nrhs,
                                       backend="reference")
        xr, _ = plan_mod.solve(ref_plan, u, rhs, MASS, tol=TOL, device=dev)
        err = max_err(x, xr) / float(xr.abs().max())
        check(err <= 1e-4, f"golden {name}: kernels vs reference backend "
                           f"x differ by {err} (relative)")
        out[name] = its
    for name, kw, batched, want, outer in MIXED_GOLDENS:
        plan = SP(**kw)
        x, st, counts, pairs, _, _ = solve_counted(
            plan, u, batch if batched else b, dev)
        its = st.rhs_iterations.tolist() if batched else [st.iterations]
        check(len(its) == len(want)
              and all(abs(i - w) <= 2 for i, w in zip(its, want))
              and st.outer_iterations == outer,
              f"golden {name}: iterations {its} / {st.outer_iterations} "
              f"outer, want {want} (+-2) / {outer}")
        check_solve(name, st, rel_res(st, batch if batched else b, batched),
                    verified=plan.precision == "mixed")
        check_launches(name, st, counts, plan)
        out[name] = dict(inner=its, outer=st.outer_iterations,
                         pair_launches=pairs)
    out.update(krylov_goldens(dev, u, b, batch16))
    return out


def krylov_goldens(dev, u, b, batch16) -> dict:
    """Phase 3's rows of the other Krylov loops (KRYLOV_GOLDENS and the
    light-mass twins): every solve converges, verifies, launches only its
    kernels and calls no plain version."""
    from repro_torch.core import plan as plan_mod
    SP = plan_mod.SolverPlan
    out = {}
    for name, kw, n, want, mv in KRYLOV_GOLDENS:
        plan = SP(**kw)
        rhs = b if n == 1 else batch16[:n]
        x, st, counts, _, _, _ = solve_counted(plan, u, rhs, dev)
        its = st.rhs_iterations.tolist() if plan.batched else [st.iterations]
        check_twin_counts(name, its, want)
        got_mv = torch.atleast_1d(st.matvecs).tolist()
        check(got_mv == [mv] * n,
              f"golden {name}: matvecs {got_mv}, want {mv}")
        check_solve(name, st, rel_res(st, rhs, plan.batched))
        check_launches(name, st, counts, plan)
        xr, _ = plan_mod.solve(dataclasses.replace(plan, backend="reference"),
                               u, rhs, MASS, tol=TOL, device=dev)
        err = max_err(x, xr) / float(xr.abs().max())
        check(err <= 1e-4, f"golden {name}: kernels vs reference backend "
                           f"x differ by {err} (relative)")
        out[name] = dict(iterations=its, matvecs=max(got_mv))
    # mass -1.7: block CG at 16 RHS, the harvest, cold and deflated solves
    plan = SP(solver="blockcg", nrhs=16)
    _, st, counts, _, _, _ = solve_counted(plan, u, batch16, dev, mass=LIGHT)
    its = st.rhs_iterations.tolist()
    check(near_or_between(st.iterations, [t[0] for t in BLOCKCG16_TWINS])
          and all(near_or_between(n, [t[1][i] for t in BLOCKCG16_TWINS])
                  for i, n in enumerate(its)),
          f"golden blockcg_n16_light: iterations {st.iterations} {its}, "
          f"twins {BLOCKCG16_TWINS}")
    check_solve("blockcg_n16_light", st, rel_res(st, batch16, True))
    check_launches("blockcg_n16_light", st, counts, plan)
    out["blockcg_n16_light"] = dict(loop=st.iterations, iterations=its)
    plan = SP()
    _, sh, basis, counts, _, _, _ = harvest_counted(
        plan, u, batch16[0], dev, LIGHT, tol=1e-8, nev=32, m_max=160,
        verify_tol=TOL)
    check(near_or_between(sh.iterations, [t[0] for t in HARVEST_TWINS])
          and int(sh.matvecs) == sh.iterations + 32,
          f"golden harvest_light: {sh.iterations} iterations / "
          f"{int(sh.matvecs)} matvecs, twins {HARVEST_TWINS}")
    check_solve("harvest_light", sh, rel_res(sh, batch16[0], False))
    check_launches("harvest_light", sh, counts, plan, harvest=True)
    runs = {}
    for name, kw, twins in (("cold_light", {}, COLD_TWINS),
                            ("deflated_light", dict(deflation=basis),
                             DEFLATED_TWINS)):
        _, st, counts, _, _, _ = solve_counted(plan, u, batch16[1], dev,
                                               mass=LIGHT, **kw)
        check(near_or_between(st.iterations, twins)
              and int(st.matvecs) == st.iterations + len(kw),
              f"golden {name}: {st.iterations} iterations / "
              f"{int(st.matvecs)} matvecs, twins {twins}")
        check_solve(name, st, rel_res(st, batch16[1], False))
        check_launches(name, st, counts, plan)
        runs[name] = st.iterations
    out["deflation_light"] = dict(harvest=(sh.iterations, int(sh.matvecs)),
                                  **runs)
    return out


def main_path(dev):
    from repro_torch.core import lattice as tl
    from repro_torch.core import plan as plan_mod
    from repro_torch.data import lattice_problem
    lat = tl.LatticeShape(*MAIN_DIMS)
    u, b = lattice_problem(lat, seed=0, packed=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = torch.stack([tl.random_spinor(gen, lat) for _ in range(4)])
    log(f"main path: lattice {lat} ({lat.volume} sites), mass {MASS}, tol "
        f"{TOL}; gauge {u.numel() * 8 / 1e6:.0f} MB (complex64 natural "
        f"and f32 packed alike); RHS {b.numel() * 8 / 1e6:.0f} MB natural, "
        f"{b.numel() * 4 / 1e6:.0f} MB per packed half field")
    runs = {}
    SP = plan_mod.SolverPlan
    for name, plan, rhs, layout in (
            ("wilson_n1", SP(), b, "natural"),
            ("wilson_n4", SP(nrhs=4), batch, "natural"),
            ("twisted_mass_n1", SP(operator_family="twisted-mass", mu=MU), b,
             "natural"),
            ("full_wilson_n1", SP(operator="full"), b, "natural"),
            ("full_wilson_n4", SP(operator="full", nrhs=4), batch,
             "natural"),
            ("full_wilson_n1_packed", SP(operator="full"), b, "packed"),
            # mixed precision: a bf16 inner CG through the bf16 instances
            ("eo_mixed_n1", SP(precision="mixed"), b, "natural"),
            ("full_mixed_n1", SP(operator="full", precision="mixed"), b,
             "natural"),
            ("full_mixed_n4", SP(operator="full", precision="mixed", nrhs=4),
             batch, "natural"),
            ("full_cg16_n1", SP(operator="full", precision="low"), b,
             "natural")):
        gauge = u
        if layout == "packed":
            gauge, rhs = tl.pack_gauge(u), tl.pack_spinor(rhs)
        x, st, counts, pairs, wall, peak = solve_counted(plan, gauge, rhs,
                                                         dev, layout)
        rel = rel_res(st, rhs, plan.batched)
        check_solve(name, st, rel, verified=plan.precision != "low")
        check_launches(name, st, counts, plan, layout)
        for kern, n in pairs.items():   # the pair instances only
            check(n == counts[kern]["launches"],
                  f"{name}: {kern} ran its pair instance {n} of "
                  f"{counts[kern]['launches']} times")
        its = st.rhs_iterations.tolist() if plan.batched else [st.iterations]
        log(f"main path {name}: iterations {its} (loop {st.iterations}, "
            f"outer {st.outer_iterations}), true rel_res "
            f"{[f'{r:.3e}' for r in rel]}, wall {wall:.4f} s, peak memory "
            f"{peak / 2**30:.3f} GiB, launches "
            f"{ {k: v['launches'] for k, v in counts.items() if v['launches']} }")
        runs[name] = dict(iterations=its, loop=st.iterations,
                          outer=st.outer_iterations, rel=rel, wall_s=wall,
                          peak_bytes=peak,
                          launches={k: v["launches"]
                                    for k, v in counts.items()},
                          pair_launches=pairs)
        del x, st, gauge
    batch16, basis = krylov_path(dev, u, b, batch, gen, runs)
    # time to a solution against f32 CGNR on the same path, N and RHS
    for other, single in (("eo_mixed_n1", "wilson_n1"),
                          ("full_mixed_n1", "full_wilson_n1"),
                          ("full_mixed_n4", "full_wilson_n4"),
                          ("full_cg16_n1", "full_wilson_n1"),
                          ("eo_pipecg_n1", "wilson_n1"),
                          ("eo_pipecg_n4", "wilson_n4"),
                          ("full_pipecg_n1", "full_wilson_n1"),
                          ("eo_blockcg_n16", "wilson_n16"),
                          ("eo_harvest_n1", "wilson_n1"),
                          ("eo_deflated_n1", "wilson_n1")):
        m, f = runs[other], runs[single]
        log(f"time to solution {other}: {m['wall_s']:.4f} s "
            f"({'verified' if other != 'full_cg16_n1' else 'unverified'}), "
            f"{single} (cgnr, f32) {f['wall_s']:.4f} s, ratio "
            f"{m['wall_s'] / f['wall_s']:.3f}; peak memory "
            f"{m['peak_bytes'] / 2**30:.3f} against "
            f"{f['peak_bytes'] / 2**30:.3f} GiB")
    return u, b, batch, batch16, basis, runs


def krylov_path(dev, u, b, batch, gen, runs) -> torch.Tensor:
    """Phase 4's runs of the other Krylov loops at 32^3 x 64 (into
    ``runs``): even-odd pipecg N = 1 and 4, full pipecg N = 1, a harvest
    (nev 8, m_max 48, tol 1e-8, verified at tol) on batch[0] followed by a
    deflated solve of b, then even-odd CGNR and block CG at N = 16 (the
    16-RHS batch is made after the smaller runs, so their peak memory
    holds what the earlier phase-4 runs held).  Returns the 16-RHS batch
    (its first 4 are ``batch``)."""
    from repro_torch.core import lattice as tl
    from repro_torch.core import plan as plan_mod
    lat = tl.LatticeShape(*MAIN_DIMS)
    SP = plan_mod.SolverPlan

    def record(name, plan, rhs, st, counts, pairs, wall, peak,
               harvest=False):
        rel = rel_res(st, rhs, plan.batched)
        check_solve(name, st, rel)
        check_launches(name, st, counts, plan, harvest=harvest)
        its = st.rhs_iterations.tolist() if plan.batched else [st.iterations]
        mv = int(torch.atleast_1d(st.matvecs).max())
        log(f"main path {name}: iterations {its} (loop {st.iterations}, "
            f"matvecs {mv}), true rel_res {[f'{r:.3e}' for r in rel]}, wall "
            f"{wall:.4f} s, peak memory {peak / 2**30:.3f} GiB, launches "
            f"{ {k: v['launches'] for k, v in counts.items() if v['launches']} }")
        runs[name] = dict(iterations=its, loop=st.iterations,
                          outer=st.outer_iterations, matvecs=mv, rel=rel,
                          wall_s=wall, peak_bytes=peak,
                          launches={k: v["launches"]
                                    for k, v in counts.items()},
                          pair_launches=pairs)

    for name, plan, rhs in (
            ("eo_pipecg_n1", SP(solver="pipecg"), b),
            ("eo_pipecg_n4", SP(solver="pipecg", nrhs=4), batch),
            ("full_pipecg_n1", SP(operator="full", solver="pipecg"), b)):
        x, st, *rest = solve_counted(plan, u, rhs, dev)
        del x
        record(name, plan, rhs, st, *rest)
    x, st, basis, *rest = harvest_counted(SP(), u, batch[0], dev, MASS,
                                          tol=1e-8, nev=8, m_max=48,
                                          verify_tol=TOL)
    del x
    record("eo_harvest_n1", SP(), batch[0], st, *rest, harvest=True)
    x, st, *rest = solve_counted(SP(), u, b, dev, deflation=basis)
    del x
    record("eo_deflated_n1", SP(), b, st, *rest)
    batch16 = torch.cat([batch, torch.stack([tl.random_spinor(gen, lat)
                                             for _ in range(12)])])
    for name, plan in (("wilson_n16", SP(nrhs=16)),
                       ("eo_blockcg_n16", SP(solver="blockcg", nrhs=16))):
        x, st, *rest = solve_counted(plan, u, batch16, dev)
        del x
        record(name, plan, batch16, st, *rest)
    return batch16, basis


# ---------------------------------------------------------------------------
# phase 5: timings at the main path's shapes
# ---------------------------------------------------------------------------


def bound(nbytes: float, flops: float, bw: float) -> dict:
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FP32_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bound_ms_measured_bw": nbytes / bw * 1e3,
            "model_bytes": nbytes, "model_flops": flops}


def instance_label(dtype, name: str, before: int) -> str:
    """", pair instance" or ", one-site instance" for a bf16 Wilson call
    just made (the pair count was ``before``), "" for f32."""
    if dtype != BF16:
        return ""
    ran = pair_launches()[name] - before
    return ", pair instance" if ran else ", one-site instance"


def ptxas_pairs(name: str) -> list[str]:
    """The compiler's registers and spills for each pair kernel instance
    of csrc/<name>.cu, from its build log."""
    from repro_torch.kernels import build
    out, func = [], None
    for line in build.build_log(name).splitlines():
        if "Function properties for" in line:
            func = line.split(" for ", 1)[1].strip()
        elif func and "_pair_kernel" in func and (
                "registers" in line or "spill" in line):
            # the template arguments: g5in, g5out, staged (and X for K4)
            args = func.split("_pair_kernelI", 1)[1].split("EEEv", 1)[0]
            out.append(f"<{args}>: {line.strip()}")
    return out


def time_hop(u, b, batch, bw, n, dtype=torch.float32):
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash.kernel import wilson_hop
    from repro_torch.kernels.wilson_dslash.ref import wilson_hop_ref
    ue, uo = tl.split_eo_gauge(u)
    upe, upo = tl.pack_gauge(ue, dtype), tl.pack_gauge(uo, dtype)
    del ue, uo
    rhs = b if n == 1 else batch
    halves = ([tl.split_eo(rhs)] if n == 1 else
              [tl.split_eo(rhs[i]) for i in range(n)])
    pe = tl.pack_spinor(torch.stack([h[0] for h in halves]), dtype)
    po = tl.pack_spinor(torch.stack([h[1] for h in halves]), dtype)
    del halves
    if n == 1:
        pe, po = pe[0], po[0]
    # the second Schur launch: D_eo of an odd field, accumulating S psi_e
    m = MASS + 4.0
    kw = dict(parity=0, gamma5_out=True, psi_acc=pe, acc_coeff=m,
              hop_coeff=-1.0 / m)
    before = pair_launches()["wilson_hop_bf16"]
    out = wilson_hop(upe, upo, po, **kw)
    instance = instance_label(dtype, "wilson_hop_bf16", before)
    ref = wilson_hop_ref(upe, upo, po, **kw)
    err = agree(out, ref, f"wilson_hop {dtype} main shape N={n}")
    del out, ref
    ms = kernel_ms(lambda: wilson_hop(upe, upo, po, **kw))
    plain_ms = time_ms(lambda: wilson_hop_ref(upe, upo, po, **kw), reps=3,
                       warmup=1)
    sites = po.shape[-5] * po.shape[-4] * po.shape[-3] * po.shape[-1]
    es = po.element_size()
    # per site and RHS: (144/N + 48) reals (links, spinors in and out) and
    # the accumulator's 24
    nbytes = sites * ((144 + 48 * n) * es + 24 * es * n)
    return dict(**ms, plain_ms=plain_ms, library_ms=None,
                max_abs_err=err, shape=f"N={n} half field "
                f"{tuple(po.shape)} {dtype}, has_acc{instance}",
                **bound(nbytes, HOP_FLOPS_PER_SITE * sites * n, bw))


def time_full(u, b, batch, bw, n, dtype=torch.float32):
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    up = tl.pack_gauge(u, dtype)
    pp = tl.pack_spinor(b if n == 1 else batch, dtype)
    # the normal operator's second launch: D^dag with both gamma5 flags
    kw = dict(gamma5_in=True, gamma5_out=True)
    before = pair_launches()["wilson_full_bf16"]
    out = wilson_full(up, pp, MASS, **kw)
    instance = instance_label(dtype, "wilson_full_bf16", before)
    ref = wilson_full_ref(up, pp, MASS, **kw)
    err = agree(out, ref, f"wilson_full {dtype} main shape N={n}")
    del out, ref
    ms = kernel_ms(lambda: wilson_full(up, pp, MASS, **kw))
    plain_ms = time_ms(lambda: wilson_full_ref(up, pp, MASS, **kw), reps=3,
                       warmup=1)
    sites = pp.shape[-5] * pp.shape[-4] * pp.shape[-3] * pp.shape[-1]
    # each input read once: 4 links (72 reals) a site, 24 in and 24 out
    # per RHS; the JAX package's dslash_intensity model also counts each
    # link twice (forward and backward hop), (144/N + 48) reals per RHS
    es = pp.element_size()
    nbytes = sites * (72 + 48 * n) * es
    model_bytes = sites * (144 + 48 * n) * es
    return dict(**ms, plain_ms=plain_ms, library_ms=None, max_abs_err=err,
                shape=f"N={n} field {tuple(pp.shape)} {dtype}, dagger"
                f"{instance}",
                bound_ms_intensity_model=model_bytes / PEAK_BYTES_PER_S * 1e3,
                bound_ms_intensity_model_measured_bw=model_bytes / bw * 1e3,
                **bound(nbytes, HOP_FLOPS_PER_SITE * sites * n, bw))


def time_cg(dev, bw, n, length, dtype=torch.float32):
    from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    x, r, p, ap = (torch.randn(n, length, generator=gen,
                               device=dev).to(dtype) for _ in range(4))
    alpha = torch.linspace(0.2, 0.8, n, device=dev)
    beta = torch.linspace(0.1, 0.9, n, device=dev)
    gate = torch.ones(n, dtype=torch.bool, device=dev)
    es = x.element_size()
    out = {}
    xo, ro, rs = cg_update(alpha, x, r, p, ap)
    xr, rr, rsr = cg_update_ref(alpha, x, r, p, ap)
    rel = float(((rs - rsr).abs() / rsr).max())
    if dtype == BF16:
        err = max(bf16_check(xo, xr, f"cg_update bf16 main shape N={n}"),
                  bf16_check(ro, rr, f"cg_update bf16 main shape N={n}"))
        check(rel <= CG_TOL, f"cg_update bf16 main shape N={n}: norm "
                             f"error {rel}")
    else:
        err = max(max_err(xo, xr), max_err(ro, rr))
        check(err <= CG_TOL and rel <= CG_TOL,
              f"cg_update main shape N={n}: errors {err}, {rel}")
    del xo, ro, xr, rr
    out["cg_update"] = dict(
        **kernel_ms(lambda: cg_update(alpha, x, r, p, ap)),
        plain_ms=time_ms(lambda: cg_update_ref(alpha, x, r, p, ap), reps=5),
        library_ms=None, max_abs_err=err, norm_rel_err=rel,
        shape=f"N={n} L={length} {dtype}",
        **bound(6.0 * es * n * length, 5.0 * n * length, bw))
    gated = n > 1  # the batched solve passes its gate, the single one none
    g = gate if gated else None
    po = cg_xpay(beta, r, p, g)
    if dtype == BF16:
        err = bf16_check(po, cg_xpay_ref(beta, r, p, g),
                         f"cg_xpay bf16 main shape N={n}")
    else:
        err = max_err(po, cg_xpay_ref(beta, r, p, g))
        check(err <= CG_TOL, f"cg_xpay main shape N={n}: error {err}")
    del po
    lib_ms = {"library_ms": None}
    if not gated:
        bv = beta.view(n, 1).to(dtype)
        lib_ms = kernel_ms(lambda: torch.addcmul(r, bv, p), "library_ms")
    out["cg_xpay"] = dict(
        **kernel_ms(lambda: cg_xpay(beta, r, p, g)),
        plain_ms=time_ms(lambda: cg_xpay_ref(beta, r, p, g), reps=5),
        **lib_ms, max_abs_err=err,
        shape=f"N={n} L={length} {dtype}{' gated' if gated else ''}",
        **bound(3.0 * es * n * length, 2.0 * n * length, bw))
    return out


# ---------------------------------------------------------------------------
# phase 6: where the time of one solve goes
# ---------------------------------------------------------------------------


def profile_solve(plan, u, b, dev, **kw) -> dict:
    """One traced Wilson solve at full size under ``torch.profiler``:
    device time by kernel (device-side events only: an operator's row
    would count its kernels twice) and the card's idle share of the
    solve's wall time, the profiler's own cost included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import plan as plan_mod
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        plan_mod.solve(plan, u, b, MASS, tol=TOL, device=dev, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key[:80]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if rows else None,
            "top": [{"ms": ms, "count": n, "name": name}
                    for ms, n, name in rows[:12]]}


# ---------------------------------------------------------------------------
# phase 7: durable solves
# ---------------------------------------------------------------------------


def run_child(argv, env, timeout_s: float) -> tuple[int, str]:
    """Run a child process, its output merged; on timeout it gets SIGABRT
    first (with PYTHONFAULTHANDLER set, it prints every thread's stack)
    and is killed after.  Returns (exit code, output)."""
    env = dict(env, PYTHONFAULTHANDLER="1")
    proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGABRT)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        fail(f"{argv[2:4]} did not end within {timeout_s} s:\n{out}")
    return proc.returncode, out


def timed_snapshots():
    """Wrap ``plan._snapshot`` so each snapshot's step and milliseconds
    (the card synchronized after it) are recorded; returns (records,
    undo)."""
    from repro_torch.core import plan as plan_mod
    orig, records = plan_mod._snapshot, []

    def timed(checkpoint, prog, carry):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = orig(checkpoint, prog, carry)
        records.append((step, (time.perf_counter() - t0) * 1e3))
        return step

    plan_mod._snapshot = timed
    return records, lambda: setattr(plan_mod, "_snapshot", orig)


def durability(dev, u, b, batch, card) -> dict:
    """Checkpointed solves bitwise their one-shot solves, a SIGKILLed CLI
    resumed in a fresh process, a truncated newest step falling back, and
    a healthy defended solve at attempt 0 on the kernels."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import resilience
    from repro_torch.serve.chaos import run_and_sigkill
    SP = plan_mod.SolverPlan
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=ROOT / "build"))
    out, launches = {}, {}

    def add(c):
        for n, v in c.items():
            launches[n] = launches.get(n, 0) + v["launches"]

    try:
        for name, plan, rhs in (
                ("eo_f32_n1", SP(), b),
                ("eo_mixed_n1", SP(precision="mixed"), b),
                ("full_f32_n4", SP(operator="full", nrhs=4), batch)):
            x1, s1, c1, _, wall1, _ = solve_counted(plan, u, rhs, dev)
            d = tmp / name
            records, undo = timed_snapshots()
            try:
                x2, s2, c2, _, wall2, peak = solve_counted(
                    plan, u, rhs, dev,
                    checkpoint=plan_mod.CheckpointPolicy(str(d), 5, keep=2))
            finally:
                undo()
            steps = [r[0] for r in records]
            add(c1)
            add(c2)
            check(torch.equal(x1, x2), f"durability {name}: checkpointed x "
                                       "is not bitwise the one-shot x")
            check(s1.iterations == s2.iterations
                  and s1.outer_iterations == s2.outer_iterations,
                  f"durability {name}: iterations {s2.iterations} against "
                  f"{s1.iterations}")
            k = s2.iterations
            if plan.precision == "mixed":
                ok = (steps[-1] == k and all(
                    b2 >= a2 + 5 for a2, b2 in zip([0] + steps, steps[:-1])))
            else:
                ok = steps == list(range(5, k, 5)) + [k]
            check(ok and ckpt.valid_steps(str(d)) == steps[-2:],
                  f"durability {name}: snapshot steps {steps}, on disk "
                  f"{ckpt.valid_steps(str(d))}, iterations {k}")
            check_solve(f"durability {name}", s2, rel_res(s2, rhs, plan.batched))
            # a snapshot of an even-odd solve back-substitutes the odd
            # half: one more f32 hop launch a snapshot
            want = {n: v["launches"] for n, v in c1.items()}
            if plan.operator == "eo-schur":
                want["wilson_hop"] += len(steps)
            check(want == {n: v["launches"] for n, v in c2.items()}
                  and not any(v["plain_calls"] for v in c2.values()),
                  f"durability {name}: launches {c2}, want {want}")
            ms = [r[1] for r in records]
            log(f"durability {name}: iterations {k}, snapshots at {steps}, "
                f"ms each {[f'{m:.1f}' for m in ms]} "
                f"({rhs.numel() * 8 / 1e6:.0f} MB of x each), wall "
                f"{wall2:.4f} s against {wall1:.4f} s unsegmented, peak "
                f"{peak / 2**30:.3f} GiB ({card})")
            out[name] = dict(iterations=k, steps=steps, snapshot_ms=ms,
                             wall_s=wall2, one_shot_wall_s=wall1,
                             x_bytes=rhs.numel() * 8, peak_bytes=peak)
            del x1, x2

        # a SIGKILLed CLI, resumed in a fresh process
        d = tmp / "cli"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        argv = [sys.executable, "-m", "repro_torch.launch.solve", "--lattice",
                "x".join(map(str, MAIN_DIMS)), "--parity", "eo", "--solver",
                "cgnr", "--mass", str(MASS), "--tol", str(TOL),
                "--device", dev.type, "--checkpoint-dir", str(d)]
        t0 = time.perf_counter()
        crashed = run_and_sigkill(
            argv + ["--checkpoint-every", "5"],
            kill_when=lambda: bool(ckpt.valid_steps(str(d))), env=env,
            timeout_s=300)
        check(crashed.killed, "durability cli: the solve ended before the "
                              "kill:\n" + crashed.stdout)
        banked = ckpt.valid_steps(str(d))
        rc, resumed = run_child(argv + ["--resume"], env, 300)
        wall = time.perf_counter() - t0
        check(rc == 0, "durability cli: resume failed:\n" + resumed)

        def system(text):
            return [ln for ln in text.splitlines() if "system: u sha256" in ln]

        check(system(resumed) == system(crashed.stdout) != [],
              "durability cli: the resumed process solved another system")
        check(bool(banked) and banked[0] >= 5
              and f"resumed from step {banked[-1]} " in resumed
              and "verdict: converged verified=True" in resumed,
              f"durability cli: banked {banked}:\n{resumed}")
        # every attempt of the resumed process ran on the kernels: the
        # retry ladder never replaced one by its plain version
        attempts = [ln for ln in resumed.splitlines()
                    if ln.startswith("[solve] attempt ")]
        check(bool(attempts) and all(" eo-schur/wilson/kernels/single "
                                     in ln for ln in attempts),
              f"durability cli: attempts off the kernels:\n{resumed}")
        tail = [ln for ln in resumed.splitlines()
                if "resumed from" in ln or "lattice=" in ln
                or ln.startswith("[solve] attempt ")]
        log(f"durability cli: killed with steps {banked} on disk, resumed: "
            + " | ".join(tail) + f" ({wall:.1f} s for both processes)")
        out["cli"] = dict(banked=banked, resumed=tail)

        # a truncated newest step falls back to the one before it
        steps = ckpt.valid_steps(str(d))
        npz = d / f"step_{steps[-1]:08d}" / "arrays.npz"
        npz.write_bytes(npz.read_bytes()[:4096])
        target = {"iteration": ((), "int32"), "rhs_mask": ((), "bool"),
                  "verdict": ((), "int32"), "x": (tuple(b.shape), "c8")}
        step, _ = ckpt.restore_latest(str(d), target)
        check(len(steps) == 2 and step == steps[0],
              f"durability: truncated step {steps[-1]} restored {step}, "
              f"want {steps[0]}")
        log(f"durability: step {steps[-1]} truncated, restore fell back to "
            f"step {step}")

        # the retry ladder on a healthy plan: one attempt, the kernels
        for plan in (SP(), SP(precision="mixed")):
            (x, st, att), c, _, wall, _ = counted(
                dev, lambda: resilience.defended_solve(
                    plan, u, b, MASS, tol=TOL, device=dev))
            add(c)
            want = f"eo-schur/wilson/kernels/{plan.precision}"
            check(len(att) == 1 and att[0].plan_desc == want
                  and not att[0].restarted and att[0].verified
                  and not any(v["plain_calls"] for v in c.values()),
                  f"durability defended {plan.precision}: {att}")
            log(f"durability defended {plan.precision}: attempt 0 on "
                f"{att[0].plan_desc}, {att[0].iterations} iterations, "
                f"wall {wall:.4f} s ({card})")
            del x
        out["defended"] = "attempt 0 on kernels"
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 8: the solver server
# ---------------------------------------------------------------------------


def serving(dev, u, pool, card) -> dict:
    """A SolverServer on the kernels at ladder (1, 4, 8): mixed
    concurrent traffic verified, served x bitwise their direct solves,
    launches per batch at each rung, admission and containment, a
    journaled abort recovered; then the serve_solver CLI under load."""
    from repro_torch import kernels
    from repro_torch.core import lattice as tl
    from repro_torch.core import plan as plan_mod
    from repro_torch.serve import chaos, journal
    from repro_torch.serve.batching import BatchPolicy
    from repro_torch.serve.errors import (RequestFailed, RequestRejected,
                                          ServerClosed)
    from repro_torch.serve.server import SolveRequest, SolverServer
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    gauges = {"cfg0": u, "cfg1": tl.random_gauge(gen, tl.LatticeShape(
        *MAIN_DIMS))}
    families = (("wilson", 0.0), ("twisted-mass", MU))
    out = {}

    def server(**kw):
        srv = SolverServer(mass=MASS, backend="kernels", ladder=(1, 4, 8),
                           device=dev, policy=BatchPolicy(max_wait=0.05),
                           **kw)
        for gid, g in gauges.items():
            srv.register_gauge(gid, g)
        return srv

    async def traffic():
        srv = server()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        warmed = await srv.warmup()
        warm_s = time.perf_counter() - t0
        reqs = [SolveRequest(families[(i // 2) % 2][0], f"cfg{i % 2}",
                             pool[i % len(pool)], tol=(1e-6, 1e-5)[i // 6],
                             mu=families[(i // 2) % 2][1])
                for i in range(12)]
        kernels.reset_counts()
        t0 = time.perf_counter()
        res = await asyncio.gather(*(srv.submit(r) for r in reqs))
        mixed_s = time.perf_counter() - t0
        traffic_counts = kernels.counts()
        per_rung = {}
        for n in (1, 4, 8):
            kernels.reset_counts()
            t0 = time.perf_counter()
            batch = await asyncio.gather(*(srv.submit(SolveRequest(
                "wilson", "cfg0", pool[i % len(pool)], tol=TOL))
                for i in range(n)))
            per_rung[n] = (batch, kernels.counts(),
                           time.perf_counter() - t0)
        try:
            await srv.submit(SolveRequest("wilson", "cfg0",
                                          chaos.poison_nan(pool[0])))
            rejected = None
        except RequestRejected as e:
            rejected = e.reason
        srv.admission_validation = False
        mixed = await asyncio.gather(
            srv.submit(SolveRequest("wilson", "cfg0",
                                    chaos.poison_overflow(pool[1]))),
            srv.submit(SolveRequest("wilson", "cfg0", pool[2])),
            return_exceptions=True)
        metrics = srv.metrics()
        await srv.close()
        metrics["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        return (warmed, warm_s, reqs, res, mixed_s, traffic_counts,
                per_rung, rejected, mixed, metrics)

    (warmed, warm_s, reqs, res, mixed_s, traffic_counts, per_rung, rejected,
     mixed, metrics) = asyncio.run(traffic())
    out["peak_bytes"] = metrics["peak_bytes"]
    check(not any(v["plain_calls"] for v in traffic_counts.values()),
          "serving: a plain version ran")
    out["launches"] = {k: v["launches"] for k, v in traffic_counts.items()}
    check(all(r.stats.verified and r.stats.converged for r in res),
          "serving: a lane did not verify")
    for i in (0, 7):
        want, _ = plan_mod.solve(
            plan_mod.SolverPlan(operator_family=reqs[i].operator_family,
                                mu=reqs[i].mu),
            gauges[reqs[i].gauge_id], reqs[i].rhs, MASS,
            tol=torch.tensor(reqs[i].tol, dtype=torch.float32), device=dev)
        check(torch.equal(res[i].x, want), f"serving: request {i}'s x is "
                                           "not bitwise its direct solve")
    log(f"serving: warmup loaded {warmed} kernel libraries in {warm_s:.2f} s;"
        " 12 concurrent "
        f"requests (2 gauges, Wilson and twisted mass mu = {MU}, tol 1e-6 "
        f"and 1e-5) in {mixed_s:.3f} s, batches "
        f"{sorted((r.stats.batch_size, r.stats.padded_to) for r in res)}, "
        "all verified, requests 0 and 7 bitwise their direct solves; "
        f"peak memory of the server's traffic {metrics['peak_bytes'] / 2**30:.3f}"
        f" GiB ({card})")
    out["launches_per_batch"] = {}
    for n, (batch, c, wall) in per_rung.items():
        its = max(r.stats.iterations for r in batch)
        want = {"wilson_hop": 4 * its + 4, "cg_update": its, "cg_xpay": its}
        got = {k: v["launches"] for k, v in c.items() if v["launches"]}
        check({r.stats.padded_to for r in batch} == {n}
              and all(r.stats.verified for r in batch) and got == want
              and not any(v["plain_calls"] for v in c.values()),
              f"serving rung {n}: launches {got}, want {want} "
              f"(padded to {[r.stats.padded_to for r in batch]})")
        out["launches_per_batch"][n] = dict(iterations=its, launches=got,
                                            wall_s=wall)
        for k, v in c.items():
            out["launches"][k] += v["launches"]
        log(f"serving rung {n}: one batch, {its} iterations, launches "
            f"{got}, no plain call, wall {wall:.4f} s ({card})")
    check(rejected == "nonfinite_rhs", f"serving: NaN RHS admitted "
                                       f"({rejected})")
    check(isinstance(mixed[0], RequestFailed)
          and mixed[0].verdict == "nonfinite"
          and not isinstance(mixed[1], Exception) and mixed[1].stats.verified,
          f"serving: overflow RHS not contained: {mixed}")
    log("serving: NaN RHS rejected at admission; overflow RHS failed alone "
        f"({mixed[0].verdict}), its neighbour served; containment "
        f"{metrics['containment']}")

    # a journaled server aborted mid-solve, recovered by a fresh one
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_journal_",
                              dir=ROOT / "build"))
    try:
        async def crash():
            srv = server(journal_dir=str(d),
                         fault_injector=chaos.BatchFaultInjector(
                             mode="stall", every=1, stall_s=2.0))
            tasks = [asyncio.ensure_future(srv.submit(SolveRequest(
                "wilson", "cfg0", pool[i], tol=TOL))) for i in range(4)]
            for _ in range(100):
                await asyncio.sleep(0.1)
                if len(journal.incomplete_requests(str(d))) == 4:
                    break
            await srv.close(drain=False)
            return await asyncio.gather(*tasks, return_exceptions=True)

        async def recover():
            srv = server(journal_dir=str(d))
            summary = await srv.recover()
            await srv.close()
            return summary

        t0 = time.perf_counter()
        log("serving journal: 4 requests into a journaled server, then an "
            "abort")
        lost = asyncio.run(crash())
        left = len(journal.incomplete_requests(str(d)))
        log(f"serving journal: aborted with {left} incomplete entries; "
            "recovering")
        summary = asyncio.run(recover())
        wall = time.perf_counter() - t0
        check(all(isinstance(r, ServerClosed) for r in lost) and left == 4,
              f"serving journal: abort left {left} entries, outcomes {lost}")
        check(summary["completed"] == 4
              and journal.incomplete_requests(str(d)) == [],
              f"serving journal: recovery {summary}")
        log(f"serving journal: 4 requests aborted, {left} incomplete, "
            f"recovered {summary['completed']}, 0 incomplete after "
            f"({wall:.1f} s with {pool[0].numel() * 8 / 1e6:.0f} MB "
            "journaled a request)")
        out["journal"] = {k: v for k, v in summary.items() if k != "results"}
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # the serve_solver CLI under two open-loop loads: bursts every 50 ms
    # offer 80 requests/s, about eight times what the card serves (its
    # latencies are mostly queueing), bursts every 1000 ms offer 4/s,
    # below that (its latencies are a batch's service time)
    del gauges
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out["serve_solver"] = {}
    for label, gap_ms in (("overload", 50), ("below capacity", 1000)):
        report = Path(tempfile.mkdtemp(prefix="chip_smoke_serve_",
                                       dir=ROOT / "build")) / "serve.json"
        try:
            log(f"serving: serve_solver, bursts of 4 every {gap_ms} ms")
            t0 = time.perf_counter()
            rc, text = run_child(
                [sys.executable, "-m", "repro_torch.launch.serve_solver",
                 "--lattice", "x".join(map(str, MAIN_DIMS)), "--gauges", "1",
                 "--requests", "32", "--burst", "4", "--interarrival-ms",
                 str(gap_ms), "--ladder", "1,4,8", "--device", dev.type,
                 "--out", str(report)], env, 300)
            wall = time.perf_counter() - t0
            check(rc == 0, "serve_solver failed:\n" + text)
            rep = json.loads(report.read_text())
        finally:
            shutil.rmtree(report.parent, ignore_errors=True)
        lat = rep["latency_ms"]
        offered = 4 / (gap_ms / 1e3)
        log(f"serve_solver {label} {'x'.join(map(str, MAIN_DIMS))}, 1 gauge,"
            " 32 requests (Wilson and twisted mass) in bursts of 4 every "
            f"{gap_ms} ms (offered {offered:.0f} requests/s), ladder 1,4,8: "
            f"p50 {lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms, "
            f"{rep['requests_per_s']:.2f} solves/s over {rep['wall_s']:.2f} s,"
            f" batches {rep['batch_hist']}, rungs {rep['rung_hist']}, "
            f"iterations max {rep['iters']['max']} (process {wall:.1f} s; "
            f"{card})")
        out["serve_solver"][label] = dict(
            interarrival_ms=gap_ms, offered_per_s=offered, latency_ms=lat,
            requests_per_s=rep["requests_per_s"], wall_s=rep["wall_s"],
            batch_hist=rep["batch_hist"], rung_hist=rep["rung_hist"],
            iters=rep["iters"])
    return out




def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # block CG's Gram products lose about 10 bits under TF32 and break
    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "float32 matrix products are not full f32 (TF32 is on)")
    t_start = time.perf_counter()
    marks = [t_start]

    def phase_done(n: int):
        now = time.perf_counter()
        log(f"phase {n} done at {now - t_start:.1f} s ({now - marks[-1]:.1f} "
            "s in the phase)")
        marks.append(now)

    # phase 0: build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    marks.append(time.perf_counter())
    for name in libs:
        for line in build.build_log(name).splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties" in line):
                log(f"  ptxas {name}: {line.strip()}")

    # phase 1: banner
    card = smi()
    bw = copy_bandwidth(dev)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device-to-device copy {bw / 1e9:.1f} GB/s")
    phase_done(1)

    # phase 2: kernel checks
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    # 4x4x6x6: odd Xh = 3 (links staged by plain loads); 4x4x22x8: Y = 22
    # against an 8-row tile; 2x2x2x348: rows too wide to stage (in place)
    errs = {"wilson_hop": max(check_hop(dev, gen, dims) for dims in (
        (8, 8, 8, 8), (4, 6, 8, 16), (4, 4, 6, 6), (4, 4, 22, 8),
        (2, 2, 2, 348)))}
    errs["cg_update"], errs["cg_xpay"] = check_cg(dev, gen)
    # K4's link staging modes: bulk copies (8^4, 4x6x8x16, 4x4x6x6,
    # 4x4x22x8, and 4x4x22x16, Y = 22 against an 8-row tile); plain loads at
    # odd X (4x4x6x5) and with the gauge field's base 4 bytes off alignment
    # (the spinor's too, read through L1); one-row tiles looping over X
    # (2x2x2x348); links read in place (2x2x2x464)
    errs["wilson_full"] = max(
        [check_full(dev, gen, dims) for dims in (
            (8, 8, 8, 8), (4, 6, 8, 16), (4, 4, 6, 6), (4, 4, 22, 8),
            (4, 4, 22, 16), (4, 4, 6, 5), (2, 2, 2, 348), (2, 2, 2, 464))]
        + [check_full(dev, gen, (4, 4, 6, 8), which)
           for which in ("psi", "gauge")])
    # the bf16 instances; 4^4 (Xh = 2, 4-byte planes) stages K1's rows by
    # plain loads, 2x2x2x348 stages in bf16 where f32 reads in place,
    # 2x2x2x700 reads in place; K4 at 4x4x8x32 runs its X = 32 instances,
    # at 2x2x2x928 reads its links in place
    from repro_torch.kernels.wilson_dslash import kernel as wk
    check(not wk.hop_bulk(2, *wk.hop_tile_plan(4, 2, 2)[1:], 2)
          and wk.hop_bulk(16, *wk.hop_tile_plan(32, 16, 2)[1:], 2),
          "bf16 K1 staging: plain loads at Xh = 2, TMA at Xh = 16")
    from repro_torch import kernels
    kernels.reset_counts()
    errs["wilson_hop_bf16"] = max(check_hop(dev, gen, dims, BF16) for dims in (
        (8, 8, 8, 8), (4, 6, 8, 16), (4, 4, 4, 4), (4, 4, 6, 6),
        (4, 4, 22, 8), (2, 2, 2, 348), (2, 2, 2, 700)))
    errs["cg_update_bf16"], errs["cg_xpay_bf16"] = check_cg_bf16(dev, gen)
    errs["wilson_full_bf16"] = max(
        [check_full(dev, gen, dims, dtype=BF16) for dims in (
            (8, 8, 8, 8), (4, 4, 8, 32), (4, 4, 22, 16), (4, 4, 6, 5),
            (2, 2, 2, 348), (2, 2, 2, 464), (2, 2, 2, 928))]
        + [check_full(dev, gen, (4, 4, 6, 8), which, BF16)
           for which in ("psi", "gauge")])
    # the bf16 Wilson checks above: even Xh (K1) and X = 32 (K4) ran the
    # pair instances, the other shapes the one-site instances
    c, pairs = kernels.counts(), kernels.pair_launches()
    for name in pairs:
        n = c[name]["launches"]
        check(0 < pairs[name] < n, f"bf16 checks: {name} ran its pair "
                                   f"instance {pairs[name]} of {n} times")
        log(f"bf16 checks: {name} pair instance {pairs[name]} of {n} "
            "launches, one-site the rest")
    # each pair instance bitwise against its one-site instance (at 16^3 x
    # 32 a different rounding would show in a few hundred bf16 entries)
    log("pair against one-site, bitwise: "
        + json.dumps(check_pairs(dev, gen, (16, 16, 16, 32))))
    log("kernels: " + json.dumps({k: {"max_abs_err": v}
                                  for k, v in errs.items()}))
    phase_done(2)

    # phase 3: goldens
    log("goldens: " + json.dumps(goldens(dev)))

    phase_done(3)

    # phase 4: main path
    u, b, batch, batch16, basis, runs = main_path(dev)
    base = ("wilson_hop", "cg_update", "cg_xpay", "wilson_full")
    names = base + tuple(f"{k}_bf16" for k in base)
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in names}
    pair_total = {k: sum(r["pair_launches"][k] for r in runs.values())
                  for k in ("wilson_hop_bf16", "wilson_full_bf16")}
    phase_done(4)

    # phase 5: timings at the main path's shapes
    length = b.numel()  # packed reals of one half field: V/2 sites x 24
    timings = {}
    for n in (1, 4):
        t = {"wilson_hop": time_hop(u, b, batch, bw, n)}
        t.update(time_cg(dev, bw, n, length))
        t["wilson_full"] = time_full(u, b, batch, bw, n)
        t["wilson_hop_bf16"] = time_hop(u, b, batch, bw, n, BF16)
        t.update({f"{k}_bf16": v for k, v in
                  time_cg(dev, bw, n, length, BF16).items()})
        t["wilson_full_bf16"] = time_full(u, b, batch, bw, n, BF16)
        timings[n] = t
        for k, v in t.items():
            lib = ("none" if v["library_ms"] is None
                   else f"{v['library_ms']:.4f} ms (back to back "
                        f"{v['library_ms_back_to_back']:.4f} ms)")
            log(f"timing {k} {v['shape']}: {v['ms']:.4f} ms (back to back "
                f"{v['ms_back_to_back']:.4f} ms), plain "
                f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
                f"({v['bound_by']}; {v['bound_ms_measured_bw']:.4f} ms at "
                f"the measured copy rate), library {lib}, max-abs error "
                f"{v['max_abs_err']:.3e}")
            if "bound_ms_intensity_model" in v:
                log(f"  {k} dslash_intensity-model bound "
                    f"{v['bound_ms_intensity_model']:.4f} ms "
                    f"({v['bound_ms_intensity_model_measured_bw']:.4f} ms "
                    "at the measured copy rate)")

    # the hop kernel in f32 at block CG's width (the N = 16 solve of phase 4)
    hop16 = time_hop(u, b, batch16, bw, 16)
    log(f"timing wilson_hop {hop16['shape']}: {hop16['ms']:.4f} ms (back to "
        f"back {hop16['ms_back_to_back']:.4f} ms), plain "
        f"{hop16['plain_ms']:.4f} ms, bound {hop16['bound_ms']:.4f} ms "
        f"({hop16['bound_by']}; {hop16['bound_ms_measured_bw']:.4f} ms at the "
        f"measured copy rate), max-abs error {hop16['max_abs_err']:.3e}, "
        f"{runs['eo_blockcg_n16']['launches']['wilson_hop']} launches in the "
        "N = 16 block CG solve")
    # K1, K2 and K3 at N = 8, the server's top rung (phase 8)
    n8 = {"wilson_hop": time_hop(u, b, batch16[:8], bw, 8)}
    n8.update(time_cg(dev, bw, 8, length))
    for k, v in n8.items():
        log(f"timing {k} {v['shape']}: {v['ms']:.4f} ms (back to back "
            f"{v['ms_back_to_back']:.4f} ms), plain {v['plain_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}; "
            f"{v['bound_ms_measured_bw']:.4f} ms at the measured copy rate), "
            f"max-abs error {v['max_abs_err']:.3e} ({card})")
    for name in ("wilson_hop", "wilson_full"):
        for line in ptxas_pairs(name):
            log(f"  ptxas {name} pair instance {line}")
    phase_done(5)

    # phase 6: one traced solve of each path
    from repro_torch.core.plan import SolverPlan
    for name, plan, rhs in (
            ("wilson_n1", SolverPlan(), b),
            ("full_wilson_n1", SolverPlan(operator="full"), b),
            ("full_wilson_n4", SolverPlan(operator="full", nrhs=4), batch),
            ("eo_mixed_n1", SolverPlan(precision="mixed"), b),
            ("full_mixed_n1", SolverPlan(operator="full",
                                         precision="mixed"), b),
            ("eo_blockcg_n16", SolverPlan(solver="blockcg", nrhs=16),
             batch16),
            ("eo_pipecg_n1", SolverPlan(solver="pipecg"), b),
            ("eo_deflated_n1", SolverPlan(), b)):
        kw = dict(deflation=basis) if name == "eo_deflated_n1" else {}
        prof = profile_solve(plan, u, rhs, dev, **kw)
        if prof["top"]:
            log(f"profile {name}: wall {prof['wall_ms']:.2f} ms (traced), "
                f"device busy {prof['device_busy_ms']:.2f} ms, idle share "
                f"{prof['idle_share']:.3f}")
            for row in prof["top"]:
                log(f"  {row['ms']:9.3f} ms  x{row['count']:<5d} "
                    f"{row['name']}")
        else:
            log(f"profile {name}: the profiler recorded no device time "
                "(not measured)")
    phase_done(6)

    # phase 7: durable solves; phase 8: the solver server
    durable = durability(dev, u, b, batch, card)
    phase_done(7)
    served = serving(dev, u, batch16[:8], card)
    phase_done(8)

    replaces = {
        "wilson_hop": "src/repro/kernels/wilson_dslash/kernel.py:684",
        "cg_update": "src/repro/kernels/cg_fused/kernel.py:114",
        "cg_xpay": "src/repro/kernels/cg_fused/kernel.py:150",
        "wilson_full": "src/repro/kernels/wilson_dslash/kernel.py:505"}
    sources = {"wilson_hop": "src/repro_torch/csrc/wilson_hop.cu",
               "cg_update": "src/repro_torch/csrc/cg_fused.cu",
               "cg_xpay": "src/repro_torch/csrc/cg_fused.cu",
               "wilson_full": "src/repro_torch/csrc/wilson_full.cu"}
    kernels_line = []
    for name in names:
        t = timings[1][name]
        kernel = name.removesuffix("_bf16")
        kernels_line.append({
            "name": name, "route": "cuda", "source": sources[kernel],
            "replaces": replaces[kernel], "launches": total[name],
            "max_abs_err": max(errs[name], t["max_abs_err"],
                               timings[4][name]["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "ms_back_to_back": t["ms_back_to_back"],
            "library_ms_back_to_back": t.get("library_ms_back_to_back"),
            "shape": t["shape"],
            "pair_launches": pair_total.get(name),
            "batched": {k: timings[4][name][k] for k in
                        ("ms", "ms_back_to_back", "plain_ms", "bound_ms",
                         "library_ms", "shape")}})
        kernels_line[-1]["launches_by_path"] = {
            "main": total[name],
            "durability": durable["launches"].get(name, 0),
            "serving": served["launches"].get(name, 0)}
        if name in n8:
            kernels_line[-1]["max_abs_err"] = max(
                kernels_line[-1]["max_abs_err"], n8[name]["max_abs_err"])
            kernels_line[-1]["n8"] = {
                k: n8[name][k] for k in ("ms", "ms_back_to_back", "plain_ms",
                                         "bound_ms", "bound_by", "shape")}
        if name == "wilson_hop":
            kernels_line[-1]["max_abs_err"] = max(
                kernels_line[-1]["max_abs_err"], hop16["max_abs_err"])
            kernels_line[-1]["n16"] = {
                k: hop16[k] for k in ("ms", "ms_back_to_back", "plain_ms",
                                      "bound_ms", "bound_by", "shape")}
    log("main path runs: " + json.dumps(runs))
    log("durability: " + json.dumps(durable))
    log("serving: " + json.dumps(served))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
