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
(``precision="low"``), and the same on float16 storage (``low=
"float16"``, the kernels' float16 instances); then the other Krylov loops on the same kernels:
pipelined CG (``solver="pipecg"``), block CG (``solver="blockcg"``, the
hop kernel at 16 RHS) and EigCG deflation (``plan.harvest_deflation``,
``solve(..., deflation=)``); last, the LM serving path
(``repro_torch.launch.serve``) for each model family and the LM
training path (``repro_torch.models.steps.make_train_step``,
``repro_torch.launch.train``).  Phases:

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
   launches bitwise.  Then the float16 instances likewise at the same
   shapes (1 float16 ulp, the floor at 2^-13 of the field's largest
   entry).  K1's even Xh and K4's X = 32 run the Wilson kernels' pair
   instances (bf16 and float16: two sites a thread, each component of
   both read as one 32-bit word), other widths and bases 2 bytes off
   4-byte alignment the one-site instances; the pair counts say which
   ran.  At 16^3 x 32 each pair instance, bf16 and float16, is held
   bitwise against its one-site instance (the same inputs, copied 2
   bytes off alignment) for every flag set, and K4's float16 pair
   instance at N = 1-5 at 16^3 x 32 and 3x5x7x32 likewise, each batched
   RHS bitwise its single launch and within 1 float16 ulp of the plain
   version; K2's and K3's float16
   narrowing of products from 2^-14 down past 2^-24 (the subnormals) is
   held bitwise against torch's cast;
3. goldens: the committed 4^4 seed-7 fixture solved through the kernels
   (even-odd: 14 iterations Wilson, 13 twisted mass mu = 0.25, 14 for
   each of 4 batched RHS; full lattice: 27 in each case), and against
   the reference backend on the card; then the mixed goldens (inner
   iterations within 2 of JAX's pallas backend's count, outer equal):
   even-odd Wilson and twisted mass 15 / 4, full N = 1 35 / 5 and N = 4
   33, 33, 35, 33 / 5, cg16 27 (unverified by design), each with its
   launch counts and no plain-version call; the same on float16 storage
   against JAX's float16 counts (15 / 4, 15 / 4, 33 / 5, 33 x 4 / 5, 27),
   and the even-odd and full mixed solves of 1e4 b, past float16's range,
   at JAX's verdict 3 (stagnation) after 0 inner and 50 outer iterations
   with a finite x; then the other Krylov loops
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
   unverified by design; its true residual is printed), and the same four
   on float16 storage, with the time to a verified solution beside the
   f32 solve's of the same path (and a float16 solve's beside its bf16
   twin's).  Then
   the other Krylov loops: even-odd pipecg N = 1 and 4, full pipecg
   N = 1, even-odd blockcg N = 16 beside even-odd CGNR N = 16, and a
   harvest (nev 8, m_max 48, tol 1e-8, verified at 1e-6) followed by a
   deflated solve of another RHS, each timed beside CGNR at the same N
   (the 16-RHS batch exists only for the N = 16 runs).
   Each solve has every count set to 0 just before it; it must converge and
   verify with a true relative residual below 10 tol, launch no other
   kernel and call no plain version; every bf16 Wilson launch of these
   32^3 x 64 solves must run the pair instance, and so must every float16
   Wilson launch;
5. timings at the main path's shapes: each kernel's median time over
   CUDA events, one call per event pair (``ms``, which includes the
   wrapper's host latency before the launch) and per call over ten
   back-to-back calls (``ms_back_to_back``, where that latency hides
   behind the card's work), held once more against its plain version
   on the same inputs, beside the plain version's time, its bound and,
   for the ungated xpay, one library call computing the same function,
   timed both ways; the bf16 and float16 instances likewise, against
   their bounds at 2 bytes a real (K3 against ``torch.addcmul`` on bf16
   and on float16), the Wilson
   kernels' labelled with the instance they ran, beside the pair
   kernels' registers and spills from the compiler's report; the hop
   kernel in f32 once more at N = 16, block CG's width, and the hop,
   update and xpay kernels at N = 8, the server's top rung, and K4 on
   float16 storage at N = 8; each Wilson
   timing names the tile it ran (the launch space's pick: the checked-in
   tuning cache's entry, else the default);
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
   latency and solves per second;
9. multi-device solves (``SolverPlan(mesh=...)``): K1 and K4 checked
   against their plain versions at a rank's block shape (32x16x32x32),
   single-device twins of the four solves below, then four children
   (``chip_smoke.py --mesh-rank R --mesh-dir D``, one per rank, with a
   deadline) on a 2x2 ``data`` x ``model`` mesh (T and Z sharded) at
   64x32x32x32: NCCL when ``torch.cuda.device_count()`` covers the
   ranks, else gloo with all four on card 0 and every halo plane and
   partial sum staged through pinned host memory (the transport, the
   device count and ``nvidia-smi -L`` printed).  Each child holds its
   halo'd K1 (every flag set, within HOP_TOL) and K4 (f32, bf16 and
   float16, reading the neighbours' ghost planes: bitwise) against the
   block of one global launch, then runs even-odd CGNR N = 1, even-odd pipecg
   N = 4 twisted mass mu = 0.25, full CGNR N = 1 and full mpcg N = 1,
   each with its counts set to 0 just before it: converged, verified on
   rank 0 and the same stats on every rank, iterations within 1 of the
   single-device twin (mpcg's inner count within 2, its outer equal), x
   within 1e-5, K1 4I+4 or K4 2I+1 (mpcg: bf16 2k, f32 2o+1) a rank with
   no plain call, all-reduces 2+2I (CGNR), 2+I (pipecg), 1+3o+2k (mpcg),
   the link planes exchanged once a solve; rank 0 traces one more
   even-odd CGNR; a checkpointed even-odd CGNR every 5 iterations
   bitwise the one-shot mesh x, and one starved at 7 iterations that
   the parent resumes on one device to a verified x and the children
   resume on the 2x2 mesh (``resume_solve`` with the mesh plan, from a
   copy); ``defended_solve`` on the mesh starved at 7 iterations
   (attempt 1 restarted and verified); each within 1e-5 of the one-shot
   mesh x, K1 4m+4 an attempt with no plain call, the same records on
   every rank.  Then the block entry (``solve(..., blocks=True)`` on each
   rank's blocks): even-odd and full CGNR N = 1 at 64x32x32x32, x
   gathered bitwise the global entry's, verified blockwise (the plain
   natural operator on each block padded with its neighbours' faces);
   and 64^3x128 (128x64x64x64) even-odd CGNR N = 1 in f32, its u and b
   drawn from seed 0 by the parent, solved once on one device and
   written to .npy files from which each child reads its blocks
   (no child holds a global field: each rank's peak on the card and on
   the host stays below the global fields' bytes): iterations within 1
   of the one-device twin, x within 1e-5 of its block, verified
   blockwise, K1 4I+4 a rank with no plain call, all-reduces 2+2I, the
   link planes exchanged once, no gather; each rank's peak GiB and wall
   printed beside the dry-run's reckoned block and global-entry bytes
   and the reckoned halo bytes a matvec.  Each solve's
   walls, rank 0's host time inside the collectives and each rank's
   peak memory are printed beside the single-device wall and the walls
   measured when K4 corrected its boundary planes afterwards;
10. the launch space: every candidate tile of K1 and K4
   (``repro_torch.kernels.autotune.candidates``: K1's rows b, K4's b and
   block-order chunk tchunk), f32 and bf16, N = 1 and 4, at the main
   path's shapes launched and held bitwise against the default tile's
   output, each timed once (``ms``, ``ms_back_to_back``); phase 4's
   even-odd and full N = 4 solves with the checked-in tuning cache and
   with ``REPRO_TORCH_TUNING_CACHE=0``, equal counts and bitwise x; the
   production dry-run's six rows (cg, pipecg, mpcg at 128^3 x 256 on
   the 16 x 16 and 2 x 16 x 16 meshes, reckoned, the memory term at
   phase 1's copy rate);
11. the LM serving path (``python -m repro_torch.launch.serve``'s
   ``main``: batched prefill, then greedy decode; f32, 4 requests, 16
   generated, random weights from seed 0): glm4-9b at full width and all
   40 layers, then one model of each other family at full width,
   qwen2-moe-a2.7b cut to 2 layers, pixtral-12b to 2 layers with its
   1024 prefix embeddings, recurrentgemma-9b to one (rec, rec, attn)
   period with a prompt of 2048 + 64 tokens (its 2048-slot ring wraps),
   rwkv6-1.6b and seamless-m4t-large-v2 whole, each freed before the
   next.  Each one's logits must be finite and its prefill(S) +
   decode(1) equal forward(S + 1) at the last position within the CPU
   tests' bar scaled by the square root of its depth over its smoke
   config's (the model drawn again from the same seed; a MoE with
   capacity for every token), computed in float64 on a float64 copy
   where its weights fit LM_F64_MAX_BYTES (all but glm4-9b), else in
   float32 (the float32 error printed beside); it prints prefill ms and
   tokens/s, decode
   ms/token, the weight bytes and those a decode step reads with their
   bound at phase 1's copy rate and at 3.35 TB/s, peak GiB, warm step
   times, a traced prefill and decode step, and how far a 1e-7 scaling
   of the embeddings moves its logits.  Then every architecture's smoke
   config is served on the card and on the CPU with the same weights,
   every step's logits within the CPU tests' bar.  For recurrentgemma
   and seamless, whose served first token differed between two card
   runs, the first token's top-2 logit gap is printed beside the spread
   of three prefills and the argmax of one more under
   ``torch.use_deterministic_algorithms(True)``; the prompt drawn again
   three times must equal the served one and the served first tokens
   the argmax (``torch.multinomial`` drew other prompt tokens on every
   call on the card; ``SyntheticLM`` now draws by inverse CDF).  No hand-written kernel
   runs in this phase (the JAX package's LM code reaches no Pallas
   kernel);
12. LM training on one device (no hand-written kernel either): (a)
   ``make_train_step`` on glm4-9b at full width, cut to 8 of its 40
   layers (2.87 B parameters, 45.97 GB of state at 16 bytes a
   parameter), bf16 compute, batch 2 x 1024 tokens, 6 steps on one
   repeated batch at lr 1e-5: each step's ms, tokens/s, model-flops
   share (6 N D, and 8 N D counting remat's second forward, over 989
   TFLOP/s), peak GiB beside the reckoned state, loss and grad norm;
   every loss and grad norm finite and the last loss below the first;
   one warm step traced; (b) every architecture's smoke config, one
   batch's loss and every gradient leaf in f32 on the card against the
   CPU on the same weights, within the CPU tests' bars; (c)
   ``launch/train.py`` on glm4-9b's smoke config, 6 steps against 3
   resumed from a checkpoint (``--resume auto``) for 3 more, under
   deterministic algorithms: bitwise; (d) the phase's seconds;
13. data-parallel LM training on a 2x2 mesh (``make_train_step(...,
   mesh=)``; no hand-written kernel): glm4-9b at full width cut to 1
   layer, bf16 compute, phase 12's batch and learning rate, 3 steps,
   first on one device (the reference), then in four children of
   ``chip_smoke.py --lm-mesh-rank R --lm-mesh-dir D`` (NCCL with a card
   a rank, else gloo on card 0): the state sharded as JAX's
   ``state_specs`` say, the rows over ``data``, tensor-parallel over
   ``model`` with the layer's blocks gathered over ``data`` before use,
   the bf16 gradients reduce-scattered over ``data``; each step's global loss and grad norm within 2 bf16
   ulps of the one-device step's, every rank's step-1 master blocks
   within the gradient bar carried through Adam's first update, the loss
   falling; glm4-9b's smoke config trained 2 steps on the mesh, its mesh
   checkpoint restored on one device bitwise every rank's blocks; step ms, tokens/s, gradient bytes reduced, rank 0's
   seconds in collectives and each rank's peak beside the reckoning and
   beside the rank's peak traced on the meta device, with what that peak
   holds;
15. (run before 14) tensor-parallel LM training and serving on the 2x2
   mesh (``parallel/tp.py``; no hand-written kernel): glm4-9b at full
   width, first on one device (the references), then in four children of
   ``chip_smoke.py --lm-tp-rank R --lm-tp-dir D``: 4 layers trained in
   bf16 on phase 12's batch for 3 steps (KV heads, MLP columns and the
   vocabulary over ``model``, one layer gathered over ``data`` at a
   time), each step's loss and grad norm within 2^-7 of one device's;
   8 layers served in f32, a prefill of 4 x 32 tokens and 4 greedy
   decode steps, every rank's tokens its rows of one device's and its
   logits within 1e-5 of their largest |logit|; step, prefill and decode
   ms, bytes by kind and dtype, rank 0's seconds in each collective,
   each rank's peaks beside the reckoning;
14. the LM dry-run held against the card (``launch/dryrun.py::measure``
   on the meta device, in this process; no hand-written kernel): phase
   11's glm4-9b serving, phase 12's train step, a phase 13 rank and a
   phase 15 rank's train step, prefill and decode traced (the ranks with
   ``launch/mesh.py::RecordingMesh``), and the dry-run
   cell glm4-9b decode_32k on ``pod`` as ``launch/specs.py`` builds it
   (bf16 serving weights with f32 output projections, the rank's 8 rows
   and 32768-slot caches), its arguments then made on the card and the
   step run; the traced matmul flops of each equal to
   ``FlopCounterMode``'s count of one more untimed call on the card; the
   recording mesh's bytes a call equal to every rank's ``Mesh.nbytes``
   every call; every measured wall at or above its bound (the traced
   flops at the H100's peak for their dtype, the traced bytes at phase
   1's copy rate); each traced peak within 10 % of the measured one
   (``max_memory_allocated`` less what was allocated before); the card's
   ``total_memory`` and CUDA context, the dry-run's ``fits`` limit.
   Each phase prints its seconds; the checkpoint, journal and mesh
   directories live under ``build/`` and are removed.

Block CG's Gram products must run in full f32: the script checks that
TF32 is off for matrix products before any phase.

Any failure raises; no phase's error is caught.  The last line is the
JSON object ``{"ok": true, "device": {...}}``; the line before it lists
the kernels, the bf16 and float16 instances as ``<kernel>_bf16`` and
``<kernel>_f16`` (with the Wilson kernels' pair launches).  Exits non-zero without printing a result when there is no
CUDA device or the port's sources are missing.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import itertools
import json
import math
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

import numpy as np  # noqa: E402
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
F16 = torch.float16
# 16-bit storage checks (see narrow_check): the significant bits of each
# type, and the floor below which an entry is held to the floor's ulp
# (2^-16 of the field's largest entry for bf16, 2^-13 for float16: the
# same absolute floor, about 2^-23 of the scale, where two f32 orders of
# the same sums differ)
NARROW = {BF16: (8, 2.0 ** -16), F16: (11, 2.0 ** -13)}
SUFFIX = {torch.float32: "", BF16: "_bf16", F16: "_f16"}
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
# the same goldens on float16 storage (low="float16"): JAX's counts, its
# reference and pallas backends alike, held to +-2 inner
F16_GOLDENS = (
    ("eo_mixed_f16", dict(precision="mixed"), False, [15], 4),
    ("eo_mixed_tm_f16", dict(precision="mixed",
                             operator_family="twisted-mass", mu=0.25), False,
     [15], 4),
    ("full_mixed_f16", dict(operator="full", precision="mixed"), False, [33],
     5),
    ("full_mixed_n4_f16", dict(operator="full", precision="mixed", nrhs=4),
     True, [33] * 4, 5),
    ("full_cg16_f16", dict(operator="full", precision="low"), False, [27], 1))
# b scaled past float16's range: JAX overflows in the first inner matvec
# and stops at verdict 3 (stagnation) after 0 inner and 50 outer
# iterations with a finite x, on both its backends; so must the port
F16_OVERFLOW_SCALE = 1e4
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
    if a.dtype in NARROW:
        a, b = a.float(), b.float()
    return float((a - b).abs().max())


def narrow_check(out: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """A bf16 or float16 instance against its plain version: at most 1 ulp
    of the storage type per entry.  An entry that cancels below the type's
    floor (NARROW) of the field's largest entry, where two f32 evaluations
    of the same sums in another order differ by more than its own ulp, is
    held to the ulp at that floor.  Returns the max-abs error."""
    check(out.dtype == ref.dtype and out.dtype in NARROW,
          f"{what}: not one 16-bit storage type ({out.dtype}, {ref.dtype})")
    bits, floor_frac = NARROW[out.dtype]
    ints = [v.contiguous().view(torch.int16).int() for v in (out, ref)]
    ords = [torch.where(v < 0, -(v & 0x7FFF), v) for v in ints]
    a, b = out.double(), ref.double()
    _, e = torch.frexp(floor_frac * b.abs().max())
    floor = torch.ldexp(torch.ones((), dtype=torch.float64, device=b.device),
                        e - bits)
    ulps = (ords[0] - ords[1]).abs()
    ok = (ulps <= 1) | ((a - b).abs() <= floor)
    check(bool(ok.all()), f"{what}: {int((~ok).sum())} entries beyond 1 "
                          f"{out.dtype} ulp (max {int(ulps.max())} ulps)")
    return float((a - b).abs().max())


def agree(out, ref, what: str) -> float:
    """The kernel-against-plain check of the output's dtype: f32 max-abs
    <= HOP_TOL * max(1, max |plain|), bf16 and float16 by
    :func:`narrow_check`."""
    if out.dtype in NARROW:
        return narrow_check(out, ref, what)
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
    """K1 for every flag set, N = 1 and 3, against its plain version (f32,
    bf16 or float16 storage); each batched RHS bitwise against its single
    launch."""
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


def check_pairs(dev, gen, dims, dtype=BF16) -> dict:
    """The pair instances of K1 and K4 (bf16 or float16 storage) against
    their one-site instances, bitwise, for every flag set at N = 3: the
    pair instance on the fields as allocated, the one-site instance on
    copies of the spinors 2 bytes off 4-byte alignment; each launch's
    instance read from the pair counts (K4 on float16 storage in
    :func:`check_f16_full` instead, at N = 1-5).  Returns the launches of
    each instance."""
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash.kernel import (wilson_full,
                                                          wilson_hop)
    sfx = SUFFIX[dtype]
    upe, upo, psi, acc = random_packed(gen, dims, 3, dtype)
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
        both("wilson_hop" + sfx,
             lambda: wilson_hop(u_out, u_nbr, psi,
                                psi_acc=acc if has_acc else None, **kw),
             lambda: wilson_hop(u_out, u_nbr, psi2,
                                psi_acc=acc2 if has_acc else None, **kw),
             f"wilson_hop {dtype} {dims} {kw} has_acc={has_acc}")
    if dtype == F16:
        torch.cuda.synchronize()
        return ran
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), dtype)
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]), dtype)
    pp2 = off_by_one_float(pp, 2)
    for g5in, g5out, twist in itertools.product((False, True),
                                                (False, True), (0.0, MU)):
        kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
        both("wilson_full" + sfx, lambda: wilson_full(up, pp, MASS, **kw),
             lambda: wilson_full(up, pp2, MASS, **kw),
             f"wilson_full {dtype} {dims} {kw}")
    torch.cuda.synchronize()
    return ran


def check_f16_full(dev, gen, dims) -> dict:
    """K4's float16 pair instance for every gamma5 flag pair with and
    without twist at N = 1-5: bitwise the one-site instance (the spinors
    copied 2 bytes off 4-byte alignment), each batched RHS bitwise its
    single launch, within 1 float16 ulp of the plain version; each
    launch's instance read from the pair counts.  Returns the launches of
    each instance and the max-abs error."""
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), F16)
    pp5 = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                      for _ in range(5)]), F16)
    ran = {"pair": 0, "one-site": 0}
    worst = 0.0

    def launch(call, want, what):
        before = pair_launches()["wilson_full_f16"]
        out = call()
        got = ("pair" if pair_launches()["wilson_full_f16"] > before
               else "one-site")
        check(got == want, f"{what}: the {got} instance ran, want {want}")
        ran[got] += 1
        return out

    for g5in, g5out, twist in itertools.product((False, True),
                                                (False, True), (0.0, MU)):
        kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
        singles = [launch(lambda: wilson_full(up, pp5[i], MASS, **kw),
                          "pair", f"wilson_full f16 {dims} {kw} single")
                   for i in range(5)]
        for n in range(1, 6):
            pp = pp5[0] if n == 1 else pp5[:n].contiguous()
            what = f"wilson_full f16 {dims} N={n} {kw}"
            out = launch(lambda: wilson_full(up, pp, MASS, **kw), "pair",
                         what)
            one = launch(lambda: wilson_full(up, off_by_one_float(pp, 2),
                                             MASS, **kw), "one-site", what)
            check(torch.equal(out, one), f"{what}: differs bitwise from the "
                                         "one-site instance")
            for i in range(n if n > 1 else 0):
                check(torch.equal(out[i], singles[i]),
                      f"{what}: batched RHS {i} differs from its single "
                      "launch")
            worst = max(worst, narrow_check(
                out, wilson_full_ref(up, pp, MASS, **kw), what))
    torch.cuda.synchronize()
    return dict(launches=ran, max_abs_err=worst)


def check_full(dev, gen, dims, misaligned: str = "",
               dtype=torch.float32) -> float:
    """K4 for every gamma5 flag pair with and without twist, N = 1 and 3,
    against its plain version (f32, bf16 or float16 storage); each batched RHS
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


def check_cg_narrow(dev, gen, dtype=BF16) -> tuple[float, float]:
    """The bf16 (or float16) instances of K2 and K3: N = 1 and 4 with a
    frozen RHS, K3 gated and ungated, on views 0, 1, 3 and 7 elements off
    16-byte alignment (alike, and the fields against each other) at a
    ragged length and at a half field's; within 1 ulp of the plain
    version, the norms (f32, of r' before rounding) 1e-5 relative, frozen
    lanes and closed gates bitwise, each RHS bitwise equal to its single
    call."""
    from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
    worst_u = worst_x = 0.0
    for length, n, offsets in ((12345, 4, (0, 0)), (12345, 4, (1, 1)),
                               (12345, 1, (3, 3)), (12345, 4, (7, 2)),
                               (8 ** 4 * 12, 4, (0, 0)),
                               (8 ** 4 * 12, 1, (1, 5))):
        bufs = [torch.randn(n * length + 16, generator=gen,
                            device=dev).to(dtype) for _ in range(4)]
        x, r, p, ap = (buf[o:o + n * length].view(n, length)
                       for buf, o in zip(bufs, offsets + offsets))
        where = f"{dtype} L={length} N={n} offsets {offsets}"
        alpha = torch.linspace(0.3, -0.9, n, device=dev)
        if n > 1:
            alpha[1] = 0.0
        xo, ro, rs = cg_update(alpha, x, r, p, ap)
        xr, rr, rsr = cg_update_ref(alpha, x, r, p, ap)
        worst_u = max(worst_u, narrow_check(xo, xr, f"cg_update {where}"),
                      narrow_check(ro, rr, f"cg_update {where}"))
        rel = float(((rs - rsr).abs() / rsr).max())
        check(rs.dtype == torch.float32 and rel <= CG_TOL,
              f"cg_update {where}: norm error {rel}")
        if n > 1:
            check(torch.equal(xo[1], x[1]) and torch.equal(ro[1], r[1]),
                  f"cg_update {where}: frozen lane changed")
        beta = torch.linspace(0.1, 0.9, n, device=dev)
        gate = torch.arange(n, device=dev) % 2 == 0
        outs = {}
        for g in (None, gate):
            po = cg_xpay(beta, r, p, g)
            worst_x = max(worst_x, narrow_check(po, cg_xpay_ref(beta, r, p, g),
                                                f"cg_xpay {where}"))
            if g is not None and n > 1:
                check(torch.equal(po[1], p[1]),
                      f"cg_xpay {where}: closed gate changed p")
            outs[g is None] = po
        for i in range(n):
            sx, sr, srs = cg_update(alpha[i:i + 1], x[i:i + 1], r[i:i + 1],
                                    p[i:i + 1], ap[i:i + 1])
            check(torch.equal(sx[0], xo[i]) and torch.equal(sr[0], ro[i])
                  and torch.equal(srs[0], rs[i]),
                  f"cg_update {where}: RHS {i} differs from its single "
                  "call")
            for ungated, po in outs.items():
                single = cg_xpay(beta[i:i + 1], r[i:i + 1], p[i:i + 1],
                                 None if ungated else gate[i:i + 1])
                check(torch.equal(single[0], po[i]),
                      f"cg_xpay {where}: RHS {i} differs from its "
                      "single call")
    torch.cuda.synchronize()
    return worst_u, worst_x


def check_f16_narrowing(dev, gen) -> dict:
    """float16's rounding of small values in the kernels, bitwise against
    torch's cast: K2's x' = x + a p with x = 0 and K3's p' = r + b p with
    r = 0 compute the f32 product a p exactly as torch does and narrow it
    once; with p in [0.5, 2) and a = 1.37 * 2^-14 .. 2^-26 (one RHS each)
    the products span float16's subnormal range (below 2^-14) down to
    below its smallest subnormal (2^-24), through the scalar head and tail
    (``__float2half_rn``) and the 16-byte body (``__floats2half2_rn``) of
    a ragged RHS.  Returns the count of entries checked and of subnormal
    and zero results."""
    from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
    length, ks = 12345, range(14, 27)
    a = torch.tensor([1.37 * 2.0 ** -k for k in ks], device=dev)
    n = len(a)
    buf = torch.empty(n * length + 8, device=dev).uniform_(
        0.5, 2.0, generator=gen).to(F16)
    p = buf[3:3 + n * length].view(n, length)   # 6 bytes off 16
    zero = torch.zeros(n, length, dtype=F16, device=dev)
    want = (a[:, None] * p.float()).to(F16)
    xo, _, _ = cg_update(a, zero, zero, p, p)
    check(torch.equal(xo, want), "float16 narrowing (K2): "
          f"{int((xo != want).sum())} entries differ from torch's cast")
    po = cg_xpay(a, zero, p)
    check(torch.equal(po, want), "float16 narrowing (K3): "
          f"{int((po != want).sum())} entries differ from torch's cast")
    torch.cuda.synchronize()
    sub = (want != 0) & (want.float().abs() < 2.0 ** -14)
    return dict(entries=2 * want.numel(), subnormal=int(sub.sum()),
                zero=int((want == 0).sum()))


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
    updates and m Krylov matvecs (the inner ones on the instances of the
    plan's low storage) (k, or k + 1 from a deflated start;
    pipecg k + 1 + 2 (k // 25); a harvest k + min(nev, k)); every other
    kernel runs 0.  Only single-device CGNR drives the fused CG kernels
    (a mesh solve's loops run plain vector algebra, as JAX's do)."""
    k, o = st.iterations, st.outer_iterations
    mv = int(torch.atleast_1d(st.matvecs).max())
    packed = int(layout == "packed")
    lo = SUFFIX.get(plan.low_dtype, "") if plan.precision != "single" else ""
    if plan.operator == "full":
        if plan.precision == "mixed":
            return {"wilson_full" + lo: 2 * k,
                    "wilson_full": 2 * o + 1 + packed}
        if plan.precision == "low":
            return {"wilson_full" + lo: 2 * k, "wilson_full": 1 + packed}
        return {"wilson_full": 2 * mv + 1 + packed}
    if plan.precision == "mixed":
        return {"wilson_hop" + lo: 4 * k, "wilson_hop": 4 * o + 4,
                "cg_update" + lo: k, "cg_xpay" + lo: k}
    if plan.solver != "cgnr" or harvest or plan.mesh is not None:
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
    # bf16 storage, then float16: the same loops on each type's instances
    for table, low in ((MIXED_GOLDENS, "bfloat16"), (F16_GOLDENS, "float16")):
        for name, kw, batched, want, outer in table:
            plan = SP(low=low, **kw)
            x, st, counts, pairs, _, _ = solve_counted(
                plan, u, batch if batched else b, dev)
            its = st.rhs_iterations.tolist() if batched else [st.iterations]
            check(len(its) == len(want)
                  and all(abs(i - w) <= 2 for i, w in zip(its, want))
                  and st.outer_iterations == outer,
                  f"golden {name}: iterations {its} / "
                  f"{st.outer_iterations} outer, want {want} (+-2) / "
                  f"{outer}")
            check_solve(name, st, rel_res(st, batch if batched else b,
                                          batched),
                        verified=plan.precision == "mixed")
            check_launches(name, st, counts, plan)
            check(bool(torch.isfinite(x).all()),
                  f"golden {name}: x not finite")
            out[name] = dict(inner=its, outer=st.outer_iterations,
                             pair_launches=pairs)
    # past float16's range: JAX's verdict and counts, a finite x
    from repro_torch.core import solvers
    for name, kw in (("eo_mixed_f16_overflow", {}),
                     ("full_mixed_f16_overflow", dict(operator="full"))):
        plan = SP(low="float16", precision="mixed", **kw)
        x, st, counts, _, _, _ = solve_counted(plan, u,
                                               b * F16_OVERFLOW_SCALE, dev)
        check(int(st.verdict) == solvers.STAGNATION and st.iterations == 0
              and st.outer_iterations == 50 and not bool(st.verified)
              and bool(torch.isfinite(x).all()),
              f"golden {name}: verdict {int(st.verdict)}, {st.iterations} / "
              f"{st.outer_iterations}, verified {bool(st.verified)}, want "
              "verdict 3 (stagnation) after 0 / 50 with a finite x")
        check(not any(v["plain_calls"] for v in counts.values()),
              f"golden {name}: a plain version ran")
        out[name] = dict(verdict=int(st.verdict), inner=st.iterations,
                         outer=st.outer_iterations)
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
             "natural"),
            # float16 storage: the same solves on the float16 instances
            ("eo_mixed_f16_n1", SP(precision="mixed", low="float16"), b,
             "natural"),
            ("full_mixed_f16_n1", SP(operator="full", precision="mixed",
                                     low="float16"), b, "natural"),
            ("full_mixed_f16_n4", SP(operator="full", precision="mixed",
                                     low="float16", nrhs=4), batch,
             "natural"),
            ("full_cg16_f16_n1", SP(operator="full", precision="low",
                                    low="float16"), b, "natural")):
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
                          ("eo_mixed_f16_n1", "wilson_n1"),
                          ("full_mixed_f16_n1", "full_wilson_n1"),
                          ("full_mixed_f16_n4", "full_wilson_n4"),
                          ("full_cg16_f16_n1", "full_wilson_n1"),
                          ("eo_pipecg_n1", "wilson_n1"),
                          ("eo_pipecg_n4", "wilson_n4"),
                          ("full_pipecg_n1", "full_wilson_n1"),
                          ("eo_blockcg_n16", "wilson_n16"),
                          ("eo_harvest_n1", "wilson_n1"),
                          ("eo_deflated_n1", "wilson_n1")):
        m, f = runs[other], runs[single]
        bf = ""   # a float16 solve beside the same solve on bf16 storage
        if "_f16" in other:
            twin = runs[other.replace("_f16", "")]
            bf = (f", on bf16 storage {twin['wall_s']:.4f} s (iterations "
                  f"{twin['iterations']} / {twin['outer']} outer against "
                  f"{m['iterations']} / {m['outer']})")
        log(f"time to solution {other}: {m['wall_s']:.4f} s "
            f"({'unverified' if 'cg16' in other else 'verified'}), "
            f"{single} (cgnr, f32) {f['wall_s']:.4f} s, ratio "
            f"{m['wall_s'] / f['wall_s']:.3f}{bf}; peak memory "
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
    """", pair instance" or ", one-site instance" for a 16-bit Wilson call
    just made (the pair count was ``before``), "" for f32."""
    if dtype not in NARROW:
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
    pname = "wilson_hop" + (SUFFIX[dtype] or "_bf16")
    before = pair_launches()[pname]
    out = wilson_hop(upe, upo, po, **kw)
    instance = instance_label(dtype, pname, before)
    ref = wilson_hop_ref(upe, upo, po, **kw)
    err = agree(out, ref, f"wilson_hop {dtype} main shape N={n}")
    del out, ref
    ms = kernel_ms(lambda: wilson_hop(upe, upo, po, **kw))
    tile = wilson_hop.last_tile
    plain_ms = time_ms(lambda: wilson_hop_ref(upe, upo, po, **kw), reps=3,
                       warmup=1)
    sites = po.shape[-5] * po.shape[-4] * po.shape[-3] * po.shape[-1]
    es = po.element_size()
    # per site and RHS: (144/N + 48) reals (links, spinors in and out) and
    # the accumulator's 24
    nbytes = sites * ((144 + 48 * n) * es + 24 * es * n)
    return dict(**ms, plain_ms=plain_ms, library_ms=None,
                max_abs_err=err, shape=f"N={n} half field "
                f"{tuple(po.shape)} {dtype}, has_acc{instance}, tile "
                f"b={tile['b']} (picked {tile['picked']})", tile=tile,
                **bound(nbytes, HOP_FLOPS_PER_SITE * sites * n, bw))


def time_full(u, b, batch, bw, n, dtype=torch.float32):
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    up = tl.pack_gauge(u, dtype)
    pp = tl.pack_spinor(b if n == 1 else batch, dtype)
    # the normal operator's second launch: D^dag with both gamma5 flags
    kw = dict(gamma5_in=True, gamma5_out=True)
    pname = "wilson_full" + (SUFFIX[dtype] or "_bf16")
    before = pair_launches()[pname]
    out = wilson_full(up, pp, MASS, **kw)
    instance = instance_label(dtype, pname, before)
    ref = wilson_full_ref(up, pp, MASS, **kw)
    err = agree(out, ref, f"wilson_full {dtype} main shape N={n}")
    del out, ref
    ms = kernel_ms(lambda: wilson_full(up, pp, MASS, **kw))
    tile = wilson_full.last_tile
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
                f"{instance}, tile b={tile['b']} tchunk={tile['tchunk']} "
                f"(picked {tile['picked']})", tile=tile,
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
    if dtype in NARROW:
        err = max(narrow_check(xo, xr, f"cg_update {dtype} main shape N={n}"),
                  narrow_check(ro, rr, f"cg_update {dtype} main shape N={n}"))
        check(rel <= CG_TOL, f"cg_update {dtype} main shape N={n}: norm "
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
    if dtype in NARROW:
        err = narrow_check(po, cg_xpay_ref(beta, r, p, g),
                           f"cg_xpay {dtype} main shape N={n}")
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
    """One traced Wilson solve at full size (:func:`profile_call`)."""
    from repro_torch.core import plan as plan_mod
    return profile_call(lambda: plan_mod.solve(plan, u, b, MASS, tol=TOL,
                                               device=dev, **kw))


def profile_call(fn) -> dict:
    """``fn()`` traced under ``torch.profiler``: device time by kernel
    (device-side events only: an operator's row would count its kernels
    twice) and the card's idle share of the call's wall time, the
    profiler's own cost included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
            "launches": sum(r[1] for r in rows),
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

    def timed(checkpoint, prog, carry, *mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = orig(checkpoint, prog, carry, *mesh)
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




# ---------------------------------------------------------------------------
# phase 9: multi-device solves on a 2x2 mesh
# ---------------------------------------------------------------------------

MESH_WORLD = 4
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")   # T over data, Z over model
# (name, plan fields, RHS: "b" or the 4-RHS "batch")
MESH_SOLVES = (
    ("eo_cgnr_n1", {}, "b"),
    ("eo_pipecg_n4_tm", dict(solver="pipecg", nrhs=4,
                             operator_family="twisted-mass", mu=MU), "batch"),
    ("full_cgnr_n1", dict(operator="full"), "b"),
    ("full_mpcg_n1", dict(operator="full", precision="mixed"), "b"))
MESH_STARVE = 7          # the starved checkpointed run's maxiter
MESH_PG_TIMEOUT_S = 120  # every collective of the children
MESH_DEADLINE_S = 900    # the children's join deadline
# the halo'd K4 bf16's max-abs against one global launch on the card when
# it corrected its boundary planes afterwards (0.125, one bf16 ulp at |x|
# in [16, 32)); it now reads ghost planes and is held bitwise
MESH_BF16_MAX_ABS_BEFORE = 0.125
# each mesh solve's wall on the card (seconds, the slowest rank) in the two
# runs with K4's plane corrections (PERF.md section 6): printed beside
# this run's
MESH_WALLS_BEFORE = {"eo_cgnr_n1": (2.2896, 2.2419),
                     "eo_pipecg_n4_tm": (8.2832, 8.8186),
                     "full_cgnr_n1": (3.3403, 2.7437),
                     "full_mpcg_n1": (3.4331, 2.3943)}
# the solves phase 9 also runs through the block entry at MAIN_DIMS, held
# bitwise to their global-entry x
MESH_BLOCK_SOLVES = ("eo_cgnr_n1", "full_cgnr_n1")
# the block entry's large run: 64^3 x 128 (T, Z, Y, X), even-odd CGNR
# N = 1 in f32 on the 2x2 mesh; no child holds its global fields (they
# read their blocks from .npy files by positioned reads)
BIG_DIMS = (128, 64, 64, 64)


def mesh_fields(dev):
    """The main path's u, b and 4-RHS batch (phase 4), rebuilt from their
    seeds on ``dev``."""
    from repro_torch.core import lattice as tl
    from repro_torch.data import lattice_problem
    lat = tl.LatticeShape(*MAIN_DIMS)
    u, b = lattice_problem(lat, seed=0, packed=False, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = torch.stack([tl.random_spinor(gen, lat) for _ in range(4)])
    return u, b, batch


def sha256(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(
        t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def halo_kernel_checks(mesh, u, b) -> dict:
    """The halo'd K1 and K4 on this rank's block against the block of one
    global launch: K1 for every flag set of phase 2 (f32, within HOP_TOL:
    its boundary planes are corrected afterwards), K4 for every gamma5
    flag pair with and without twist, f32, bf16 and float16, bitwise (it
    reads the neighbours' ghost planes)."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import lattice as tl
    from repro_torch.kernels.wilson_dslash import ops as wops
    psi_spec, gauge_spec, sharded = dist.lattice_specs(mesh)
    u_e, u_o = tl.split_eo_gauge(u)
    upe, upo = tl.pack_gauge(u_e), tl.pack_gauge(u_o)
    b_e, b_o = tl.split_eo(b)
    pe, po = tl.pack_spinor(b_e), tl.pack_spinor(b_o)
    del u_e, u_o, b_e, b_o
    ue, uo, pel, pol = (dist.local_block(mesh, v, spec) for v, spec in (
        (upe, gauge_spec), (upo, gauge_spec), (pe, psi_spec),
        (po, psi_spec)))
    prev = (dist.link_halos(mesh, sharded, ue),
            dist.link_halos(mesh, sharded, uo))
    worst = {"wilson_hop": 0.0, "wilson_full": 0.0, "wilson_full_bf16": 0.0,
             "wilson_full_f16": 0.0}
    for parity, g5in, g5out, has_acc, twist in itertools.product(
            (0, 1), (False, True), (False, True), (False, True),
            (False, True)):
        which = "eo" if parity == 0 else "oe"
        src, src_l = (po, pol) if parity == 0 else (pe, pel)
        acc, acc_l = (pe, pel) if parity == 0 else (po, pol)
        kw = dict(gamma5_in=g5in, gamma5_out=g5out,
                  hop_coeff=-0.3 if (has_acc or twist) else 1.0,
                  hop_twist=0.2 if twist else 0.0,
                  acc_coeff=1.7 if has_acc else 0.0,
                  acc_twist=-0.4 if (has_acc and twist) else 0.0)
        ref = dist.local_block(mesh, wops.hop_block(
            upe, upo, src, which=which, psi_acc=acc if has_acc else None,
            **kw), psi_spec)
        out = dist.parity_hop_halo(which, ue, uo, src_l, mesh, sharded,
                                   psi_acc=acc_l if has_acc else None,
                                   u_prev=prev, **kw)
        err = max_err(out, ref)
        check(err <= HOP_TOL * scale(ref),
              f"mesh halo K1 {which} {kw}: max-abs error {err}")
        worst["wilson_hop"] = max(worst["wilson_hop"], err)
    del upe, upo, pe, po, ue, uo, pel, pol, prev
    up, pp = tl.pack_gauge(u), tl.pack_spinor(b)
    for dtype in (torch.float32, BF16, F16):
        name = "wilson_full" + SUFFIX[dtype]
        upd, ppd = up.to(dtype), pp.to(dtype)
        upl, ppl = dist.shard_lattice_fields(mesh, upd, ppd)
        prev = dist.link_halos(mesh, sharded, upl)
        for g5in, g5out, twist in itertools.product(
                (False, True), (False, True), (0.0, MU)):
            kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
            ref = dist.local_block(mesh, wops.dslash(upd, ppd, MASS, **kw),
                                   psi_spec)
            out = dist.dslash_halo(upl, ppl, MASS, mesh, sharded, u_prev=prev,
                                   **kw)
            err = max_err(out, ref)
            check(out.dtype == dtype and torch.equal(out, ref),
                  f"mesh halo {name} {kw}: not bitwise one global launch "
                  f"(max-abs error {err})")
            worst[name] = max(worst[name], err)
        del upd, ppd, upl, ppl, prev
    torch.cuda.synchronize()
    return worst


def mesh_child(rank: int, d: Path) -> int:
    """One rank of phase 9 (``chip_smoke.py --mesh-rank R --mesh-dir D``):
    the halo'd kernels against global launches, the four solves of
    MESH_SOLVES on the 2x2 mesh, and the checkpointed even-odd CGNR run
    to its end and starved; writes ``rank<R>.json`` (and rank 0 each
    solve's x) into D."""
    import datetime
    import torch.distributed as tdist
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import distributed as dist
    from repro_torch.core import plan as plan_mod
    cfg = json.loads((d / "mesh.json").read_text())
    transport = cfg["transport"]
    dev = torch.device(cfg["device_type"], rank if transport == "nccl" else 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=MESH_PG_TIMEOUT_S)
    tdist.init_process_group(transport, init_method=f"file://{d}/rendezvous",
                             rank=rank, world_size=MESH_WORLD,
                             timeout=timeout)
    try:
        mesh = dist.Mesh(MESH_SHAPE, MESH_AXES, device=dev,
                         transport=transport, timeout=timeout)
        u, b, batch = mesh_fields(dev)
        out = {"coords": mesh.coords, "device": str(dev),
               "sha": [sha256(v) for v in (u, b, batch)]}
        out["halo_checks"] = halo_kernel_checks(mesh, u, b)
        SP = plan_mod.SolverPlan
        out["solves"] = {}
        x_eo, x_glob = None, {}
        for name, kw, rhs_name in MESH_SOLVES:
            plan = SP(mesh=mesh, **kw)
            rhs = b if rhs_name == "b" else batch
            mesh.barrier()
            before, before_s = dict(mesh.counts), dict(mesh.seconds)
            x, st, counts, pairs, wall, peak = solve_counted(plan, u, rhs, dev)
            check_launches(f"mesh {name} rank {rank}", st, counts, plan)
            out["solves"][name] = dict(
                stats=mesh_stats(st), wall_s=wall, peak_bytes=peak,
                launches={k: v["launches"] for k, v in counts.items()},
                collectives={k: v - before.get(k, 0)
                             for k, v in mesh.counts.items()},
                collective_s={k: v - before_s.get(k, 0.0)
                              for k, v in mesh.seconds.items()})
            if rank == 0:
                torch.save(x.cpu(), d / f"{name}.pt")
            if name == "eo_cgnr_n1":
                x_eo = x
            if name in MESH_BLOCK_SOLVES:
                x_glob[name] = x
            del x
        # rank 0 traces one more even-odd CGNR (the others run it untraced)
        plan = SP(mesh=mesh)
        mesh.barrier()
        if rank == 0:
            out["profile"] = profile_solve(plan, u, b, dev)
        else:
            plan_mod.solve(plan, u, b, MASS, tol=TOL, device=dev)
        # the checkpointed even-odd CGNR: to its end (bitwise the one-shot
        # x above), and starved for the parent to resume on one device
        mesh.barrier()
        x2, st2, counts, _, wall, peak = solve_counted(
            plan, u, b, dev, checkpoint=plan_mod.CheckpointPolicy(
                str(d / "ck_mesh"), 5, keep=100))
        steps = ckpt.valid_steps(str(d / "ck_mesh"))
        want = dict(out["solves"]["eo_cgnr_n1"]["launches"])
        want["wilson_hop"] += len(steps)   # each snapshot's odd half
        check(torch.equal(x_eo, x2), f"mesh rank {rank}: checkpointed x is "
                                     "not bitwise the one-shot x")
        check(want == {k: v["launches"] for k, v in counts.items()}
              and not any(v["plain_calls"] for v in counts.values()),
              f"mesh rank {rank} checkpointed: launches {counts}, want {want}")
        del x2
        _, st3 = plan_mod.solve(
            plan, u, b, MASS, tol=TOL, maxiter=MESH_STARVE, device=dev,
            checkpoint=plan_mod.CheckpointPolicy(str(d / "ck_starved"), 5,
                                                 keep=100))
        out["durable"] = dict(
            stats=mesh_stats(st2), wall_s=wall, peak_bytes=peak, steps=steps,
            starved=mesh_stats(st3),
            starved_steps=ckpt.valid_steps(str(d / "ck_starved")))
        out["mesh_resume"] = mesh_resume_child(mesh, d, u, b, x_eo, dev)
        del x_eo
        out["block_entry"] = block_entry_child(mesh, u, b, x_glob, out, dev)
        del u, b, batch, x_glob
        torch.cuda.empty_cache()
        out["big"] = big_child(mesh, d, dev)
        (d / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        tdist.destroy_process_group()
    return 0


def mesh_resume_child(mesh, d: Path, u, b, x_one, dev) -> dict:
    """The starved 2x2 checkpoint resumed on the 2x2 mesh
    (``resume_solve`` with the mesh plan, from a copy of the directory:
    the parent resumes the original on one device), then
    ``defended_solve`` starved at MESH_STARVE iterations: attempt 0
    unverified, attempt 1 restarted and verified.  Each x within 1e-5
    (relative max-abs) of the one-shot mesh x ``x_one``; K1 4m + 4 a
    solve of m iterations, no plain call."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import resilience
    plan = plan_mod.SolverPlan(mesh=mesh)
    if mesh.rank == 0:
        shutil.copytree(d / "ck_starved", d / "ck_starved_mesh")
    mesh.barrier()
    out = {}
    (x, st, rec), counts, _, wall, peak = counted(
        dev, lambda: resilience.resume_solve(
            plan, u, b, MASS, checkpoint_dir=str(d / "ck_starved_mesh"),
            tol=TOL, maxiter=1000, device=dev))
    att = [dataclasses.asdict(a) for a in rec.attempts]
    want = sum(4 * a["iterations"] + 4 for a in att
               if "/kernels/" in a["plan_desc"])
    err = max_err(x, x_one) / scale(x_one)
    check(rec.resumed_from_step == MESH_STARVE and att[0]["restarted"]
          and bool(st.verified) and err <= 1e-5,
          f"mesh rank {mesh.rank} resume on the mesh: from "
          f"{rec.resumed_from_step}, attempts {att}, x rel err {err}")
    check(counts["wilson_hop"]["launches"] == want
          and not any(v["plain_calls"] for v in counts.values()),
          f"mesh rank {mesh.rank} resume: launches {counts}, want K1 {want}")
    out["resume"] = dict(step=rec.resumed_from_step, attempts=att,
                         x_rel_err=err, wall_s=wall, peak_bytes=peak,
                         k1=want, steps=sorted(os.listdir(
                             d / "ck_starved_mesh")))
    del x
    (x, st, att), counts, _, wall, peak = counted(
        dev, lambda: resilience.defended_solve(
            plan, u, b, MASS, tol=TOL, maxiter=MESH_STARVE, device=dev))
    att = [dataclasses.asdict(a) for a in att]
    want = sum(4 * a["iterations"] + 4 for a in att
               if "/kernels/" in a["plan_desc"])
    err = max_err(x, x_one) / scale(x_one)
    check(len(att) == 2 and not att[0]["verified"] and att[1]["restarted"]
          and att[1]["verified"] and bool(st.verified) and err <= 1e-5,
          f"mesh rank {mesh.rank} defended, starved at {MESH_STARVE}: "
          f"attempts {att}, x rel err {err}")
    check(counts["wilson_hop"]["launches"] == want
          and not any(v["plain_calls"] for v in counts.values()),
          f"mesh rank {mesh.rank} defended: launches {counts}, want K1 "
          f"{want}")
    out["defended"] = dict(attempts=att, x_rel_err=err, wall_s=wall,
                           peak_bytes=peak, k1=want)
    return out


def block_entry_child(mesh, u, b, x_glob, out, dev) -> dict:
    """MESH_BLOCK_SOLVES through the block entry (``solve(...,
    blocks=True)`` on this rank's blocks): x gathered bitwise the global
    entry's, its counts and the solve's collectives equal to the global
    entry's (no gather, no broadcast: the verification's one face
    all-gather and one all-reduce instead), verified blockwise."""
    from repro_torch.core import distributed as dist
    from repro_torch.core import plan as plan_mod
    res = {}
    for name, kw, _ in MESH_SOLVES:
        if name not in MESH_BLOCK_SOLVES:
            continue
        plan = plan_mod.SolverPlan(mesh=mesh, **kw)
        ul, bl = dist.shard_lattice_fields(mesh, u, b, layout="natural")
        mesh.barrier()
        before = dict(mesh.counts)
        xl, st, counts, _, wall, peak = solve_counted(plan, ul, bl, dev,
                                                      blocks=True)
        coll = {k: v - before.get(k, 0) for k, v in mesh.counts.items()
                if v != before.get(k, 0)}
        x = dist.gather_blocks(mesh, xl, dist.layout_specs(
            mesh, "natural")[0], b.shape)
        glob = out["solves"][name]
        same = {k: coll.get(k) == glob["collectives"].get(k)
                for k in ("all_reduce", "spinor_planes", "link_planes")}
        check(torch.equal(x, x_glob[name]) and all(same.values())
              and coll.get("verify_gather") == 1
              and "broadcast" not in coll
              and {k: v["launches"] for k, v in counts.items()}
              == glob["launches"]
              and mesh_stats(st)["iterations"] == glob["stats"]["iterations"]
              and bool(st.verified),
              f"mesh rank {mesh.rank} block entry {name}: bitwise "
              f"{torch.equal(x, x_glob[name])}, collectives {coll} against "
              f"{glob['collectives']}, verified {st.verified}")
        res[name] = dict(stats=mesh_stats(st), wall_s=wall, peak_bytes=peak,
                         collectives=coll, bitwise=True, launches={
                             k: v["launches"] for k, v in counts.items()})
        del ul, bl, xl, x
    return res


def host_rss() -> int:
    """This process's resident host bytes now (``/proc/self/statm``)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def read_npy_block(path: Path, mesh, spec) -> np.ndarray:
    """This rank's block (``dist.block_slices`` of ``spec``) of a C-order
    .npy file, read run by run with positioned reads into the block's
    buffer: the file is never mapped, so the process's resident bytes
    grow by the block alone (a memory-mapped read of the 2x2 block of
    BIG_DIMS' u made a child's resident bytes grow by 11.25 GiB)."""
    from repro_torch.core import distributed as dist
    with open(path, "rb", buffering=0) as f:
        version = np.lib.format.read_magic(f)
        header = {(1, 0): np.lib.format.read_array_header_1_0,
                  (2, 0): np.lib.format.read_array_header_2_0}[version]
        shape, fortran, dtype = header(f)
        check(not fortran, f"{path}: a Fortran-order array")
        base = f.tell()
        sl = dist.block_slices(mesh, shape, spec)
        lo = [s.start or 0 for s in sl]
        hi = [n if s.stop is None else s.stop for s, n in zip(sl, shape)]
        out = np.empty([b - a for a, b in zip(lo, hi)], dtype)
        # the runs are contiguous from the innermost sliced axis on
        k = max([i for i, n in enumerate(shape) if (lo[i], hi[i]) != (0, n)],
                default=0)
        stride = [int(np.prod(shape[i + 1:])) * dtype.itemsize
                  for i in range(len(shape))]
        run = (hi[k] - lo[k]) * stride[k]
        buf = memoryview(out.reshape(-1).view(np.uint8))
        pos = 0
        for idx in np.ndindex(*out.shape[:k]):
            f.seek(base + sum((lo[i] + j) * stride[i]
                              for i, j in enumerate(idx)) + lo[k] * stride[k])
            end = pos + run
            while pos < end:
                got = f.readinto(buf[pos:end])
                check(got > 0, f"{path}: short read")
                pos += got
    return out


def big_child(mesh, d: Path, dev) -> dict:
    """BIG_DIMS through the block entry: this rank's blocks of u and b
    read from the parent's .npy files (:func:`read_npy_block`: the rank
    holds no global field, on the card or in its host memory; its card's
    peak after the read and its host's resident bytes during it are
    recorded), even-odd CGNR N = 1 f32 on the kernels, verified
    blockwise; x's block written to D."""
    import resource

    from repro_torch.core import distributed as dist
    from repro_torch.core import plan as plan_mod
    psi_spec, gauge_spec, _ = dist.layout_specs(mesh, "natural")
    torch.cuda.reset_peak_memory_stats(dev)
    host = {"before": host_rss(), "lifetime_peak_before": resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024}
    host["read_peak"] = host["before"]
    t0 = time.perf_counter()
    blocks = []
    for name, spec in (("u", gauge_spec), ("b", psi_spec)):
        blk = read_npy_block(d / f"big_{name}.npy", mesh, spec)
        host["read_peak"] = max(host["read_peak"], host_rss())
        blocks.append(torch.from_numpy(blk).to(dev))
        del blk
    ul, bl = blocks
    del blocks
    host["blocks"] = sum(v.numel() * v.element_size() for v in (ul, bl))
    load_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated(dev)
    plan = plan_mod.SolverPlan(mesh=mesh)
    mesh.barrier()
    before = dict(mesh.counts)
    before_s = dict(mesh.seconds)
    xl, st, counts, _, wall, peak = solve_counted(plan, ul, bl, dev,
                                                  blocks=True)
    coll = {k: v - before.get(k, 0) for k, v in mesh.counts.items()
            if v != before.get(k, 0)}
    secs = {k: v - before_s.get(k, 0.0) for k, v in mesh.seconds.items()
            if v != before_s.get(k, 0.0)}
    check_launches(f"mesh big rank {mesh.rank}", st, counts, plan)
    torch.save(xl.cpu(), d / f"big_x{mesh.rank}.pt")
    host["after"] = host_rss()
    host["lifetime_peak"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    return dict(stats=mesh_stats(st), wall_s=wall, peak_bytes=peak,
                load_peak_bytes=load_peak, load_s=load_s,
                collectives=coll, collective_s=secs,
                launches={k: v["launches"] for k, v in counts.items()},
                block_shapes=[list(ul.shape), list(bl.shape)], host=host)


def mesh_stats(st) -> dict:
    def lst(v):
        return None if v is None else torch.atleast_1d(v).tolist()
    return dict(iterations=st.iterations, outer=st.outer_iterations,
                rhs_iterations=lst(st.rhs_iterations),
                converged=lst(st.converged), verdict=lst(st.verdict),
                verified=lst(st.verified), matvecs=lst(st.matvecs),
                true_residual_norm2=lst(st.true_residual_norm2))


def run_children(argvs, env, timeout_s: float) -> list[tuple[int, str]]:
    """Run processes side by side, each one's output merged into a file;
    past the deadline each gets SIGABRT (with PYTHONFAULTHANDLER set, it
    prints every thread's stack) and is killed after.  Returns (exit
    code, output) of each."""
    env = dict(env, PYTHONFAULTHANDLER="1")
    logs = [tempfile.TemporaryFile("w+") for _ in argvs]
    procs = [subprocess.Popen(a, env=env, stdout=f, stderr=subprocess.STDOUT,
                              text=True) for a, f in zip(argvs, logs)]
    deadline = time.perf_counter() + timeout_s
    late = False
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            late = True
    if late:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGABRT)
        time.sleep(30)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    res = []
    for p, f in zip(procs, logs):
        f.seek(0)
        res.append((p.returncode, f.read()))
        f.close()
    if late:
        fail(f"mesh children did not end within {timeout_s} s:\n"
             + "\n".join(o[-3000:] for _, o in res))
    return res


def big_twin(dev, tmp: Path) -> dict:
    """BIG_DIMS on one device: u and b drawn from seed 0 on the card and
    written to ``tmp`` as .npy files (the children read their blocks of
    them, :func:`read_npy_block`), then the even-odd CGNR N = 1 solved once,
    counted: its x kept on the host."""
    from repro_torch.core import lattice as tl
    from repro_torch.core import plan as plan_mod
    from repro_torch.data import lattice_problem
    plan = plan_mod.SolverPlan()
    u, b = lattice_problem(tl.LatticeShape(*BIG_DIMS), seed=0, packed=False,
                           device=dev)
    t0 = time.perf_counter()
    for name, v in (("u", u), ("b", b)):
        np.save(tmp / f"big_{name}.npy", v.cpu().numpy())
    write_s = time.perf_counter() - t0
    x, st, counts, _, wall, peak = solve_counted(plan, u, b, dev)
    check_solve("mesh big single", st, rel_res(st, b, False))
    check_launches("mesh big single", st, counts, plan)
    out = dict(x=x.cpu(), stats=mesh_stats(st), wall_s=wall, peak_bytes=peak,
               write_s=write_s, global_fields_bytes=(
                   u.numel() * u.element_size() + b.numel() * b.element_size()),
               launches={k: v["launches"] for k, v in counts.items()})
    del u, b, x
    torch.cuda.empty_cache()
    return out


def mesh_new_entries(ranks, big, tmp: Path, card) -> dict:
    """The parent's reading of the children's resume and defended solves
    on the mesh, the block entry at MAIN_DIMS, and the block entry at
    BIG_DIMS against its one-device twin ``big``."""
    import types

    from repro_torch.core import distributed as dist
    from repro_torch.launch import dryrun_wilson as dw
    from repro_torch.launch.mesh import MeshShape
    out = {}
    for what in ("resume", "defended"):
        recs = [rk["mesh_resume"][what] for rk in ranks]
        check(all(r["attempts"] == recs[0]["attempts"] for r in recs),
              f"mesh {what}: records differ between ranks")
        att = recs[0]["attempts"]
        log(f"mesh {what} on the 2x2 mesh: "
            + (f"from step {recs[0]['step']}, " if what == "resume" else "")
            + "attempts " + "; ".join(
                f"{a['attempt']}: {a['plan_desc']} restarted={a['restarted']}"
                f" iterations={a['iterations']} verified={a['verified']}"
                for a in att)
            + f", the same on every rank; K1 {recs[0]['k1']} a rank, no "
            f"plain call; x rel err {max(r['x_rel_err'] for r in recs):.2e} "
            f"against the one-shot mesh x; wall "
            f"{max(r['wall_s'] for r in recs):.4f} s ({card})")
        out[f"mesh_{what}"] = dict(
            attempts=att, x_rel_err=[r["x_rel_err"] for r in recs],
            walls_s=[r["wall_s"] for r in recs], k1=recs[0]["k1"],
            step=recs[0].get("step"), steps=recs[0].get("steps"))
    for name in MESH_BLOCK_SOLVES:
        recs = [rk["block_entry"][name] for rk in ranks]
        check(all(r["stats"] == recs[0]["stats"] for r in recs),
              f"mesh block entry {name}: stats differ between ranks")
        st = recs[0]["stats"]
        log(f"mesh block entry {name} at {MAIN_DIMS}: x bitwise the global "
            f"entry's on every rank, {st['iterations']} iterations, "
            f"verified blockwise {st['verified']} (true residual^2 "
            f"{st['true_residual_norm2']}; the global entry's "
            f"{ranks[0]['solves'][name]['stats']['true_residual_norm2']}), "
            f"collectives {recs[0]['collectives']}, wall "
            f"{max(r['wall_s'] for r in recs):.4f} s, peak "
            f"{[round(r['peak_bytes'] / 2**30, 3) for r in recs]} GiB a rank "
            f"({card})")
        out[f"block_entry_{name}"] = dict(
            stats=st, walls_s=[r["wall_s"] for r in recs],
            peaks_gib=[r["peak_bytes"] / 2**30 for r in recs],
            collectives=recs[0]["collectives"])
    # the block entry at BIG_DIMS
    bigs = [rk["big"] for rk in ranks]
    st, one = bigs[0]["stats"], big["stats"]
    k = st["iterations"]
    check(all(bk["stats"] == st for bk in bigs),
          "mesh big: stats differ between ranks")
    check(all(v == 0 for v in st["verdict"]) and all(st["verified"])
          and abs(k - one["iterations"]) <= 1,
          f"mesh big: verdict {st['verdict']}, verified {st['verified']}, "
          f"iterations {k} against {one['iterations']} on one device")
    shape = MeshShape(dict(zip(MESH_AXES, MESH_SHAPE)), MESH_AXES)
    psi_spec = dist.layout_specs(shape, "natural")[0]
    mem = dw.resident("eo", "cg", BIG_DIMS, shape)
    log("mesh big, each rank (card peak after the read / the solve's card "
        "peak / host resident before, at the read's peak, after, lifetime "
        "peak, GiB): " + "; ".join(
            f"{r}: {bk['load_peak_bytes'] / 2**30:.3f} / "
            f"{bk['peak_bytes'] / 2**30:.3f} / "
            + ", ".join(f"{bk['host'][k] / 2**30:.3f}" for k in (
                "before", "read_peak", "after", "lifetime_peak"))
            + f" (blocks {bk['host']['blocks'] / 2**30:.3f})"
            for r, bk in enumerate(bigs)))
    errs = []
    for r, rk in enumerate(ranks):
        at = types.SimpleNamespace(shape=shape.shape, coords=rk["coords"])
        want = big["x"][dist.block_slices(at, big["x"].shape, psi_spec)]
        got = torch.load(tmp / f"big_x{r}.pt")
        errs.append(max_err(got, want) / scale(big["x"]))
        coll = bigs[r]["collectives"]
        check(coll.get("all_reduce") == 2 + 2 * k
              and coll.get("link_planes") == 4
              and coll.get("verify_gather") == 1
              and "all_gather" not in coll and "broadcast" not in coll,
              f"mesh big rank {r}: collectives {coll}, want {2 + 2 * k} "
              "all-reduces, 4 link planes, one face all-gather")
        # the blocks, on the card and on the host while they were read,
        # stay below the global fields; the solve's working set below
        # what the global entry needs
        host = bigs[r]["host"]
        check(bigs[r]["load_peak_bytes"] < big["global_fields_bytes"]
              and host["read_peak"] - host["before"]
              <= host["blocks"] + 2**30
              and bigs[r]["peak_bytes"] < mem["global_entry"],
              f"mesh big rank {r}: {bigs[r]['load_peak_bytes']} B on the "
              f"card after the read, host {host} B, solve peak "
              f"{bigs[r]['peak_bytes']} B; the global fields "
              f"{big['global_fields_bytes']} B, the global entry "
              f"{mem['global_entry']} B")
    check(max(errs) <= 1e-5, f"mesh big: x blocks differ from the "
                             f"single-device x by {errs} (relative)")
    per = dw.solve_counts("eo", "cg", BIG_DIMS, shape, iterations=2)
    per1 = dw.solve_counts("eo", "cg", BIG_DIMS, shape, iterations=1)
    halo = per["spinor_bytes"] - per1["spinor_bytes"]
    coll = bigs[0]["collectives"]
    log(f"mesh big {BIG_DIMS} (T, Z, Y, X) through the block entry, "
        f"blocks {bigs[0]['block_shapes']}: {k} iterations (one device "
        f"{one['iterations']}), verified blockwise, x rel err "
        f"{max(errs):.2e} against the one-device x; K1 "
        f"{bigs[0]['launches'].get('wilson_hop')} a rank (4I + 4 = "
        f"{4 * k + 4}), all-reduces {coll['all_reduce']} (2 + 2I), link "
        f"planes {coll['link_planes']}, spinor planes "
        f"{coll.get('spinor_planes')} ({coll.get('spinor_bytes', 0) / 1e6:.1f}"
        f" MB sent a rank; reckoned {halo / 1e6:.2f} MB a matvec); walls "
        f"{[round(bk['wall_s'], 4) for bk in bigs]} s against "
        f"{big['wall_s']:.4f} s on one device; blocks read in "
        f"{[round(bk['load_s'], 2) for bk in bigs]} s; peak "
        f"{[round(bk['peak_bytes'] / 2**30, 3) for bk in bigs]} GiB a rank "
        f"on the card (after reading the blocks "
        f"{[round(bk['load_peak_bytes'] / 2**30, 3) for bk in bigs]}), host "
        f"resident at the read's peak "
        f"{[round(bk['host']['read_peak'] / 2**30, 3) for bk in bigs]} GiB; "
        f"reckoned: the block entry {mem['block'] / 2**30:.3f} GiB a rank, "
        f"the global entry {mem['global_entry'] / 2**30:.3f} GiB a rank "
        f"(global fields {big['global_fields_bytes'] / 2**30:.3f} GiB); "
        f"one device peak {big['peak_bytes'] / 2**30:.3f} GiB; rank 0's "
        f"host wall inside collectives "
        f"{ {n: round(v, 4) for n, v in bigs[0]['collective_s'].items()} } "
        f"s ({card})")
    out["big"] = dict(
        dims=BIG_DIMS, iterations=k, single_iterations=one["iterations"],
        x_rel_err=errs, walls_s=[bk["wall_s"] for bk in bigs],
        single_wall_s=big["wall_s"], single_peak_gib=big["peak_bytes"] / 2**30,
        peaks_gib=[bk["peak_bytes"] / 2**30 for bk in bigs],
        load_peaks_gib=[bk["load_peak_bytes"] / 2**30 for bk in bigs],
        host_gib=[{k: v / 2**30 for k, v in bk["host"].items()}
                  for bk in bigs],
        load_s=[bk["load_s"] for bk in bigs], collectives=coll,
        collective_s=bigs[0]["collective_s"],
        launches=bigs[0]["launches"], reckoned_block_gib=mem["block"] / 2**30,
        reckoned_global_entry_gib=mem["global_entry"] / 2**30,
        reckoned_halo_bytes_per_matvec=halo,
        true_residual_norm2=st["true_residual_norm2"],
        single_true_residual_norm2=one["true_residual_norm2"])
    return out


def mesh_phase(dev, card) -> dict:
    """Phase 9: the kernel checks at a rank's block shapes, the single-
    device twins, four ranks on a 2x2 mesh (NCCL with a card a rank, else
    gloo on card 0 with halos staged through the host), every count held
    to its twin's, and the starved mesh checkpoint resumed here."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import resilience
    SP = plan_mod.SolverPlan
    n_cards = torch.cuda.device_count()
    transport = "nccl" if n_cards >= MESH_WORLD else "gloo"
    cards = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60).stdout.strip()
    log(f"mesh: {MESH_SHAPE} {MESH_AXES} over {MESH_WORLD} ranks, transport "
        f"{transport}, torch.cuda.device_count() {n_cards}; nvidia-smi -L: "
        + " | ".join(cards.splitlines()))
    if transport == "gloo":
        log("mesh: the 4 ranks share one card and route every halo plane "
            "and partial sum through the host: the walls below are no "
            "scaling figure")
    # K1 and K4 at a rank's block shapes (T and Z halved)
    local = (MAIN_DIMS[0] // 2, MAIN_DIMS[1] // 2) + MAIN_DIMS[2:]
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    errs = {"wilson_hop": check_hop(dev, gen, local),
            "wilson_full": check_full(dev, gen, local),
            "wilson_full_bf16": check_full(dev, gen, local, dtype=BF16),
            "wilson_full_f16": check_full(dev, gen, local, dtype=F16)}
    log(f"mesh: kernels at the block shape {local}: " + json.dumps(errs))
    u, b, batch = mesh_fields(dev)
    sha = [sha256(v) for v in (u, b, batch)]
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=ROOT / "build"))
    singles = {}
    for name, kw, rhs_name in MESH_SOLVES:
        plan = SP(**kw)
        rhs = b if rhs_name == "b" else batch
        x, st, counts, _, wall, peak = solve_counted(plan, u, rhs, dev)
        check_solve(f"mesh single {name}", st, rel_res(st, rhs, plan.batched))
        check_launches(f"mesh single {name}", st, counts, plan)
        singles[name] = dict(x=x.cpu(), stats=mesh_stats(st), wall_s=wall,
                             peak_bytes=peak)
        del x
    torch.cuda.empty_cache()
    out = {"transport": transport, "device_count": n_cards,
           "world": MESH_WORLD, "block_kernel_errs": errs}
    try:
        log(f"mesh big: {BIG_DIMS} (T, Z, Y, X), "
            f"{shutil.disk_usage(tmp).free / 2**30:.1f} GiB free on the disk "
            f"of {tmp.parent}; this process holds "
            f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB of the card")
        big = big_twin(dev, tmp)
        log(f"mesh big single device: {big['stats']['iterations']} "
            f"iterations, verified {big['stats']['verified']}, wall "
            f"{big['wall_s']:.4f} s, peak {big['peak_bytes'] / 2**30:.3f} "
            f"GiB, u and b written in {big['write_s']:.1f} s "
            f"({big['global_fields_bytes'] / 2**30:.3f} GiB) ({card})")
        (tmp / "mesh.json").write_text(json.dumps(
            {"transport": transport, "device_type": dev.type}))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = run_children(
            [[sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
              str(r), "--mesh-dir", str(tmp)] for r in range(MESH_WORLD)],
            env, MESH_DEADLINE_S)
        out["children_s"] = time.perf_counter() - t0
        for r, (rc, text) in enumerate(res):
            check(rc == 0, f"mesh rank {r} failed (rc {rc}):\n{text[-6000:]}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]
        for r, rk in enumerate(ranks):
            check(rk["sha"] == sha, f"mesh rank {r}: u, b or the batch differ "
                                    "from the parent's")
        for name, kw, rhs_name in MESH_SOLVES:
            plan = SP(**kw)
            one = singles[name]
            st = ranks[0]["solves"][name]["stats"]
            check(all(rk["solves"][name]["stats"] == st for rk in ranks),
                  f"mesh {name}: stats differ between ranks")
            check(all(v == 0 for v in st["verdict"]) and all(st["verified"]),
                  f"mesh {name}: verdicts {st['verdict']}, verified "
                  f"{st['verified']}")
            mine = st["rhs_iterations"] or [st["iterations"]]
            theirs = (one["stats"]["rhs_iterations"]
                      or [one["stats"]["iterations"]])
            # bf16 inner counts sit on rounding (MIXED_GOLDENS: +-2)
            slack = 2 if plan.precision == "mixed" else 1
            check(all(abs(a - c) <= slack for a, c in zip(mine, theirs))
                  and st["outer"] == one["stats"]["outer"],
                  f"mesh {name}: iterations {mine} / {st['outer']} outer, "
                  f"single device {theirs} / {one['stats']['outer']}")
            x = torch.load(tmp / f"{name}.pt")
            err = max_err(x, one["x"]) / float(one["x"].abs().max())
            check(err <= 1e-5, f"mesh {name}: x differs from the single-"
                               f"device x by {err} (relative)")
            coll = ranks[0]["solves"][name]["collectives"]
            k, o = st["iterations"], st["outer"]
            want_ar = {"cgnr": 2 + 2 * k, "pipecg": 2 + k}[plan.solver]
            if plan.precision == "mixed":
                want_ar = 1 + 3 * o + 2 * k
            fields = 2 if plan.operator == "eo-schur" else 1
            check(coll.get("all_reduce") == want_ar
                  and coll.get("link_planes") == 2 * fields
                  and coll.get("all_gather") == 1,
                  f"mesh {name}: collectives {coll}, want {want_ar} "
                  f"all-reduces and {2 * fields} link planes")
            secs = ranks[0]["solves"][name]["collective_s"]
            walls = [rk["solves"][name]["wall_s"] for rk in ranks]
            peaks = [rk["solves"][name]["peak_bytes"] / 2**30 for rk in ranks]
            ran = {n: v for n, v in
                   ranks[0]["solves"][name]["launches"].items() if v}
            log(f"mesh {name}: iterations {mine} (outer {st['outer']}; single "
                f"device {theirs}), x rel err {err:.2e}, launches per rank "
                f"{ran}, "
                f"all-reduces {coll['all_reduce']} ({want_ar}), spinor "
                f"planes {coll.get('spinor_planes', 0)} "
                f"({coll.get('spinor_bytes', 0) / 1e6:.1f} MB sent), link "
                f"planes {coll['link_planes']}; wall {max(walls):.4f} s "
                f"(ranks {[f'{w:.4f}' for w in walls]}; with K4's plane "
                f"corrections {MESH_WALLS_BEFORE[name][0]} and "
                f"{MESH_WALLS_BEFORE[name][1]} s) against "
                f"{one['wall_s']:.4f} s on one device; rank 0's host wall "
                f"inside collectives "
                f"{ {k: round(v, 4) for k, v in secs.items() if v} } s; "
                f"peak {[f'{p:.3f}' for p in peaks]} GiB a rank ({card})")
            out[name] = dict(iterations=mine, outer=st["outer"],
                             single=theirs, x_rel_err=err, walls_s=walls,
                             walls_before_s=MESH_WALLS_BEFORE[name],
                             single_wall_s=one["wall_s"], peaks_gib=peaks,
                             launches=ranks[0]["solves"][name]["launches"],
                             collectives=coll, collective_s=secs)
        dur = [rk["durable"] for rk in ranks]
        st = dur[0]["stats"]
        k = st["iterations"]
        check(all(dd["stats"] == st for dd in dur)
              and dur[0]["steps"] == list(range(5, k, 5)) + [k]
              and dur[0]["starved_steps"] == [5, MESH_STARVE],
              f"mesh checkpointed: steps {dur[0]['steps']}, starved "
              f"{dur[0]['starved_steps']}, iterations {k}")
        (x, st_r, rec), counts, _, wall, _ = counted(
            dev, lambda: resilience.resume_solve(
                SP(), u, b, MASS, checkpoint_dir=str(tmp / "ck_starved"),
                tol=TOL, maxiter=1000, device=dev))
        check(rec.resumed_from_step == MESH_STARVE and bool(st_r.verified)
              and not any(v["plain_calls"] for v in counts.values()),
              f"mesh resume: from {rec.resumed_from_step}, verified "
              f"{st_r.verified}, attempts {rec.attempts}")
        log(f"mesh checkpointed eo_cgnr_n1: x bitwise the one-shot mesh x, "
            f"snapshots at {dur[0]['steps']}, wall {dur[0]['wall_s']:.4f} s; "
            f"starved at {MESH_STARVE} (steps {dur[0]['starved_steps']}) and "
            f"resumed on one device from step {rec.resumed_from_step}: "
            f"{rec.attempts[-1].iterations} more iterations, verified, "
            f"{wall:.4f} s ({card})")
        out["durable"] = dict(steps=dur[0]["steps"],
                              wall_s=dur[0]["wall_s"],
                              resumed_from=rec.resumed_from_step,
                              resume_wall_s=wall)
        out.update(mesh_new_entries(ranks, big, tmp, card))
        out["rank_peak_gib"] = [
            max(s["peak_bytes"] for s in rk["solves"].values()) / 2**30
            for rk in ranks]
        out["halo_checks"] = [rk["halo_checks"] for rk in ranks]
        prof = ranks[0]["profile"]
        out["profile_rank0_eo_cgnr_n1"] = prof
        if prof["top"]:
            log(f"mesh profile eo_cgnr_n1, rank 0: wall {prof['wall_ms']:.2f} "
                f"ms (traced), rank 0's device busy "
                f"{prof['device_busy_ms']:.2f} ms, its idle share "
                f"{prof['idle_share']:.3f} (the card also runs 3 other "
                f"ranks' work) ({card})")
            for row in prof["top"]:
                log(f"  {row['ms']:9.3f} ms  x{row['count']:<5d} "
                    f"{row['name']}")
        else:
            log("mesh profile eo_cgnr_n1: the profiler recorded no device "
                "time (not measured)")
        launches = {}
        for rk_solve in (list(ranks[0]["solves"].values())
                         + list(ranks[0]["block_entry"].values())
                         + [ranks[0]["big"]]):
            for n, v in rk_solve["launches"].items():
                launches[n] = launches.get(n, 0) + v
        out["launches"] = launches
        log(f"mesh: each rank's peak {[f'{p:.3f}' for p in out['rank_peak_gib']]}"
            f" GiB; halo'd kernels against global launches (max-abs) "
            f"{json.dumps(ranks[0]['halo_checks'])}; children "
            f"{out['children_s']:.1f} s ({card})")
        k4 = {n: max(rk["halo_checks"][n] for rk in ranks)
              for n in ("wilson_full", "wilson_full_bf16", "wilson_full_f16")}
        log(f"mesh: K4 halo'd (ghost reads) against one global launch, "
            f"bitwise in f32, bf16 and float16 on every rank: max-abs "
            f"{json.dumps(k4)} (bf16 with plane corrections: "
            f"{MESH_BF16_MAX_ABS_BEFORE}) ({card})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: the launch space
# ---------------------------------------------------------------------------

# the main path's K1 (half field T, Z, Y, Xh) and K4 (T, Z, Y, X) shapes
LAUNCH_SHAPES = (("wilson_hop", MAIN_DIMS[:3] + (MAIN_DIMS[3] // 2,)),
                 ("wilson_full", MAIN_DIMS))


def launch_space(dev, card: str, bw: float) -> dict:
    """Every candidate tile of K1 and K4 (f32 and bf16, N = 1 and 4) at
    the main path's shapes launched once, its output held bitwise against
    the default tile's, and timed once (``autotune.sweep`` with one
    round); phase 4's even-odd and full N = 4 solves with the checked-in
    tuning cache and with ``REPRO_TORCH_TUNING_CACHE=0``: equal counts,
    bitwise x; the production dry-run's six rows, reckoned."""
    from repro_torch import kernels
    from repro_torch.core.plan import SolverPlan
    from repro_torch.kernels import autotune, dispatch
    from repro_torch.launch import dryrun_wilson as dw
    out = {"sweeps": {}, "solves": {}, "dryrun": []}
    cache = dispatch.read_tuning_cache()
    for kernel, dims in LAUNCH_SHAPES:
        for dtype in (torch.float32, BF16):
            for n in (1, 4):
                key = dispatch.cache_key(kernel, dispatch.BACKEND, dims, n,
                                         dtype)
                _, rows = autotune.sweep(kernel, dims, n, dtype, rounds=1,
                                         device=dev)
                hit = cache.get(key)
                # an entry of None keeps the default tile (rows[0])
                hit = hit and tuple(
                    rows[0][k] if hit[k] is None else hit[k]
                    for k in ("b", "tchunk"))
                for i, r in enumerate(rows):
                    check(r["bitwise"], f"launch space {key}: tile b="
                          f"{r['b']} tchunk={r['tchunk']} differs from the "
                          "default tile's bits")
                    tags = (["default"] if i == 0 else []) + (
                        ["cached"] if hit == (r["b"], r["tchunk"]) else [])
                    log(f"launch space {key} b={r['b']} tchunk="
                        f"{r['tchunk']}: {r['ms']:.4f} ms (back to back "
                        f"{r['ms_back_to_back']:.4f} ms), bitwise "
                        f"{' '.join(tags)} ({card})")
                out["sweeps"][key] = [
                    {k: r[k] for k in ("b", "tchunk", "ms",
                                       "ms_back_to_back", "bitwise")}
                    for r in rows]
    u, b, batch = mesh_fields(dev)
    for name, plan in (("wilson_n4", SolverPlan(nrhs=4)),
                       ("full_wilson_n4", SolverPlan(operator="full",
                                                     nrhs=4))):
        x1, st1, c1, _, wall1, _ = solve_counted(plan, u, batch, dev)
        used = {k: kernels.WRAPPERS[k].last_tile
                for k in ("wilson_hop", "wilson_full")
                if c1[k]["launches"]}
        old = os.environ.get("REPRO_TORCH_TUNING_CACHE")
        os.environ["REPRO_TORCH_TUNING_CACHE"] = "0"
        try:
            x0, st0, c0, _, wall0, _ = solve_counted(plan, u, batch, dev)
            off = {k: kernels.WRAPPERS[k].last_tile for k in used}
        finally:
            if old is None:
                os.environ.pop("REPRO_TORCH_TUNING_CACHE")
            else:
                os.environ["REPRO_TORCH_TUNING_CACHE"] = old
        its1, its0 = st1.rhs_iterations.tolist(), st0.rhs_iterations.tolist()
        check(its1 == its0 and torch.equal(x1, x0)
              and all(c1[k]["launches"] == c0[k]["launches"] for k in c1),
              f"launch space {name}: the cached tiles gave {its1}, the "
              f"defaults {its0} (x bitwise {torch.equal(x1, x0)})")
        log(f"launch space {name}: iterations {its1} with the checked-in "
            f"cache (tiles {used}, {wall1:.4f} s) and without (tiles {off}, "
            f"{wall0:.4f} s), x bitwise equal ({card})")
        out["solves"][name] = dict(iterations=its1, tiles_cached=used,
                                   tiles_default=off, wall_cached_s=wall1,
                                   wall_default_s=wall0)
        del x1, x0
    del u, b, batch
    device = {"card": card, "hbm_bytes_per_s": bw,
              "hbm_source": "device-to-device copy of phase 1"}
    for solver in dw.SOLVERS:
        for mesh_kind in dw.MESH_KINDS:
            row = dw.reckon(solver, mesh_kind, hbm_bytes_per_s=bw,
                            device=device)
            log(dw.describe(row) + f" ({card})")
            out["dryrun"].append({k: row[k] for k in (
                "arch", "mesh", "label", "block", "per_iteration",
                "per_setup", "per_device_bytes", "roofline")})
    torch.cuda.synchronize()
    return out


# ---------------------------------------------------------------------------
# phase 11: the LM serving path
# ---------------------------------------------------------------------------

# (architecture, layers kept or None for all, prompt tokens): glm4-9b at
# full width and depth, and one representative of each other family at
# full width, cut in depth where noted; 4 requests, 16 generated, f32
LM_SERVED = (
    ("glm4-9b", None, 32),
    ("qwen2-moe-a2.7b", 2, 32),
    ("pixtral-12b", 2, 32),
    # one (rec, rec, attn) period; 2048 + 64 prompt tokens wrap the
    # 2048-slot ring at full width
    ("recurrentgemma-9b", 3, 2048 + 64),
    ("rwkv6-1.6b", None, 32),
    ("seamless-m4t-large-v2", None, 32))
LM_REQUESTS, LM_GEN = 4, 16
# the models whose served first token differed between two card runs of
# the same code: their first token's margin is probed (lm_first_token)
LM_TIE_PROBE = ("recurrentgemma-9b", "seamless-m4t-large-v2")
LM_PROBE_RUNS = 3
# prefill + decode against forward is held in float64 for every served
# model whose weights fit this size in float64 (all but glm4-9b's 75 GB),
# else in float32: in float32 the random weights carry a rounding through
# the layers (rwkv6: 2.3e-6 at 1 layer, 4.7e-4 at 24, the model's own
# amplification of a 1e-7 input scaling growing alike; float64 3.7e-12;
# scripts/lm_decode_depth.py), and a cache-path fault shows in either
LM_F64_MAX_BYTES = 32 * 2**30
# logits against a reference, as a fraction of its largest |logit|: the
# bars of the CPU tests (tests/test_torch_lm_*.py), set at the smoke
# configs' depths
LM_BAR = {"hybrid": 1e-4, "ssm": 1e-4}
LM_ATTN_BAR = 1e-5


def lm_bar(cfg, smoke) -> float:
    """The CPU tests' bar for ``cfg``'s family, scaled by the square root
    of its decoder depth over its smoke config's: two f32 evaluations of
    the same layers (other GEMM shapes, so other summation orders) differ
    by rounding that adds up layer by layer in quadrature.  (The encoder,
    where there is one, runs the same shapes on both sides.)"""
    depth = max(1.0, cfg.num_layers / smoke.num_layers)
    return LM_BAR.get(cfg.family, LM_ATTN_BAR) * depth ** 0.5


def lm_decode_read_bytes(cfg, model) -> int:
    """Weight bytes one decode step reads: every parameter but the
    encoder's (run once, in prefill) and an untied input table's (one row
    a request)."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if not name.startswith(("encoder.", "enc_norm"))
               and not (name == "embed.tok" and not cfg.tie_embeddings))


def lm_no_drop(cfg):
    """A MoE config whose capacity is the whole group (factor E/k), so
    forward drops no token; decoding never does."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.padded / cfg.moe.top_k))


@contextlib.contextmanager
def float64_models():
    """The LM models' float32 casts and constants made float64 inside the
    block (``Tensor.float`` keeps a float64 tensor; each model module's
    ``F32``), restored after: a float64 model then computes in float64
    throughout."""
    from repro_torch.models import encdec, layers, moe, recurrent
    from repro_torch.models import transformer
    mods = (layers, recurrent, transformer, encdec, moe)
    narrow, saved = torch.Tensor.float, [m.F32 for m in mods]
    torch.Tensor.float = lambda self, *a, **k: (
        self if self.dtype == torch.float64 else narrow(self, *a, **k))
    for m in mods:
        m.F32 = torch.float64
    try:
        yield
    finally:
        torch.Tensor.float = narrow
        for m, v in zip(mods, saved):
            m.F32 = v


def lm_decode_vs_forward(cfg, model, batch, nxt, dev,
                         dtype=torch.float32) -> tuple[float, float]:
    """prefill(S) + decode(next token) against forward(S + 1) at the last
    position, computed in ``dtype`` (float64: a float64 model inside
    :func:`float64_models`): (max-abs error, largest |logit|)."""
    from repro_torch.models import steps
    mod = steps.model_module(cfg)
    toks = batch["tokens"]
    extra = {k: v.to(dtype) for k, v in batch.items() if k != "tokens"}
    pre = cfg.num_prefix_embeds
    s = toks.shape[1]
    _, caches = mod.prefill(cfg, model, toks, cache_len=pre + s + 1,
                            compute_dtype=dtype, **extra)
    ld, _ = mod.decode_step(cfg, model, nxt, pre + s, caches,
                            compute_dtype=dtype)
    full, _ = mod.forward(cfg, model, torch.cat([toks, nxt], dim=1),
                          compute_dtype=dtype, **extra)
    full = full[:, -1]
    del caches
    # the scale leaves out the masked vocabulary padding (-1e30 on both)
    return (float((full - ld[:, 0]).abs().max()),
            float(full[:, :cfg.vocab_size].abs().max()))


def lm_sensitivity(cfg, model, batch) -> float:
    """How far the model itself moves its last-position logits when the
    embedding table is scaled by 1 + 1e-7 (about one f32 rounding): the
    relative change, largest |logit| for scale.  Rounding differences
    between two f32 evaluations grow through the layers at this rate.
    Changes the model's weights."""
    from repro_torch.models import steps
    mod = steps.model_module(cfg)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    before, _ = mod.forward(cfg, model, batch["tokens"], **extra)
    before = before[:, -1, :cfg.vocab_size]
    with torch.no_grad():
        model.embed.tok.mul_(1 + 1e-7)
    after, _ = mod.forward(cfg, model, batch["tokens"], **extra)
    after = after[:, -1, :cfg.vocab_size]
    return float((after - before).abs().max() / before.abs().max())


def lm_smoke_against_cpu(dev) -> dict:
    """Each architecture's smoke config served on the card and on the CPU
    with the same weights (drawn on the CPU, copied over) and prompt:
    prefill and 4 decode steps fed the CPU's greedy tokens, every step's
    logits within the family's bar of the CPU's largest |logit|."""
    import copy
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import steps
    out = {}
    for arch in configs.all_arch_names():
        cfg = configs.get_smoke(arch)
        gen = torch.Generator().manual_seed(0)
        cpu_model = steps.model_module(cfg).init_params(cfg, gen,
                                                        device="cpu")
        card_model = copy.deepcopy(cpu_model).to(dev)
        pre = cfg.num_prefix_embeds
        batch = SyntheticLM(cfg, batch=2, seq_len=pre + 20, seed=1,
                            device="cpu").batch_at(0)
        worst = 0.0
        runs = []
        for model, where in ((cpu_model, "cpu"), (card_model, dev)):
            b = {k: v.to(where) for k, v in batch.items()}
            prefill = steps.make_prefill_step(cfg, cache_len=pre + 25,
                                              compute_dtype=torch.float32)
            decode = steps.make_decode_step(cfg, compute_dtype=torch.float32)
            logits, caches = prefill(model, b)
            steps_logits = [logits[:, -1].cpu()]
            for i in range(4):
                tok = (runs[0][i].argmax(-1)[:, None] if runs else
                       steps_logits[-1].argmax(-1)[:, None]).to(where)
                _, logits, caches = decode(model, caches, tok, pre + 20 + i)
                steps_logits.append(logits[:, -1].cpu())
            runs.append(steps_logits)
        for ref, got in zip(*runs):
            scale = float(ref[:, :cfg.vocab_size].abs().max())
            err = float((got - ref).abs().max())
            bar = lm_bar(cfg, cfg)
            check(bool(torch.isfinite(got).all()) and err <= bar * scale,
                  f"LM smoke {arch}: card logits {err} from the CPU's "
                  f"(largest |logit| {scale}, bar {bar})")
            worst = max(worst, err / scale)
        out[arch] = worst
        del cpu_model, card_model
    return out


def lm_first_token(cfg, prefill, model, batch, served, redraw) -> dict:
    """The first generated token's margin: the last prompt position's
    logits (the unpadded vocabulary) from LM_PROBE_RUNS prefills in this
    process, their run-to-run spread (max-abs against the first), each
    request's top-2 gap, the argmax against the served first tokens
    ``served``, and one more prefill under
    ``torch.use_deterministic_algorithms(True)``.  A gap above the spread
    by orders of magnitude rules a near-tie out.  ``redraw()`` draws the
    prompt again: LM_PROBE_RUNS redraws must equal ``batch``."""
    def first():
        logits, _ = prefill(model, batch)
        return logits[:, -1, :cfg.vocab_size].float()

    runs = [first() for _ in range(LM_PROBE_RUNS)]
    big = float(runs[0].abs().max())
    spread = max(float((r - runs[0]).abs().max()) for r in runs[1:])
    top2 = torch.topk(runs[0], 2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = first()
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    same = [all(torch.equal(v, batch[k]) for k, v in redraw().items())
            for _ in range(LM_PROBE_RUNS)]
    return dict(largest_logit=big, top2_gaps=gaps, redraws_equal=same,
                min_gap_rel=min(gaps) / big, spread=spread,
                spread_rel=spread / big,
                argmax=runs[0].argmax(-1).tolist(), served=served.tolist(),
                deterministic_argmax=det.argmax(-1).tolist(),
                deterministic_max_abs=float((det - runs[0]).abs().max()))


def lm_phase(dev, card: str, bw: float, scale: str = "full") -> dict:
    """Phase 11: ``repro_torch.launch.serve.main`` on the card for each of
    LM_SERVED (``scale="smoke"`` rehearses it on smoke configs), each
    model freed before the next; each one's logits finite and its
    prefill(S) + decode(1) equal to forward(S + 1) at the last position
    (the model drawn again from the same seed); then every smoke config's
    card logits against the CPU's."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import steps
    get = configs.get if scale == "full" else configs.get_smoke
    out = {"served": {}, "smoke_against_cpu": {}}
    for arch, layers, prompt in LM_SERVED:
        cfg = get(arch)
        full_layers = cfg.num_layers
        if layers is not None and scale == "full":
            cfg = dataclasses.replace(cfg, num_layers=layers)
        cut = (f"{cfg.num_layers} of {full_layers} layers"
               if cfg.num_layers != full_layers else "all layers")
        if cfg.is_encdec:
            cut += f", encoder {cfg.encoder_layers} layers"
        if cfg.num_prefix_embeds:
            cut += f", {cfg.num_prefix_embeds} prefix embeddings"
        # what earlier phases still hold, inside the run's measured peak
        # (their cyclic garbage collected first: a collection during the
        # run would free it after this reading)
        gc.collect()
        torch.cuda.empty_cache()
        allocated_before = torch.cuda.memory_allocated(dev)
        res = serve.main(["--arch", arch, "--scale", scale, "--requests",
                          str(LM_REQUESTS), "--prompt-len", str(prompt),
                          "--gen", str(LM_GEN), "--device", str(dev)],
                         cfg=cfg)
        check(bool(torch.isfinite(res["last_logits"]).all()),
              f"LM {arch}: non-finite logits")
        check(tuple(res["tokens"].shape) == (LM_REQUESTS, LM_GEN)
              and int(res["tokens"].max()) < cfg.vocab_size,
              f"LM {arch}: tokens {tuple(res['tokens'].shape)}")
        # the served model again from the same seed, for the check
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = steps.model_module(cfg).init_params(cfg, gen, device=dev)
        read = lm_decode_read_bytes(cfg, model)
        batch = SyntheticLM(cfg, batch=LM_REQUESTS,
                            seq_len=prompt + cfg.num_prefix_embeds, seed=0,
                            device=str(dev)).batch_at(0)
        nxt = res["tokens"][:, :1].to(dev)
        err, big = lm_decode_vs_forward(lm_no_drop(cfg), model, batch, nxt,
                                        dev)
        bar = lm_bar(cfg, configs.get_smoke(arch))
        wide = 2 * res["weight_bytes"] <= LM_F64_MAX_BYTES
        if not wide:
            check(err <= bar * big,
                  f"LM {arch}: prefill + decode {err} from forward (largest "
                  f"|logit| {big}, bar {bar}; float32)")
        # warm steps (median), then the prefill and one decode step traced
        prefill = steps.make_prefill_step(
            cfg, cache_len=cfg.num_prefix_embeds + prompt + 1,
            compute_dtype=torch.float32)
        decode = steps.make_decode_step(cfg, compute_dtype=torch.float32)
        _, caches = prefill(model, batch)
        pos = cfg.num_prefix_embeds + prompt

        def one_decode():
            decode(model, caches, nxt, pos)
        warm = {"prefill_ms": time_ms(lambda: prefill(model, batch), 3, 1),
                "decode_ms": time_ms(one_decode, 5, 1)}
        if arch == LM_DRY_ARCH:  # phase 14's counts: one more of each
            warm["flops_counted"] = {"prefill": counted_flops(
                lambda: prefill(model, batch)),
                "decode": counted_flops(one_decode)}
        traces = {"prefill": profile_call(lambda: prefill(model, batch)),
                  "decode": profile_call(one_decode)}
        for what, prof in traces.items():
            if not prof["top"]:
                log(f"LM {arch} traced {what}: the profiler recorded no "
                    "device time (not measured)")
                continue
            log(f"LM {arch} traced {what}: wall {prof['wall_ms']:.2f} ms, "
                f"device busy {prof['device_busy_ms']:.2f} ms, idle share "
                f"{prof['idle_share']:.3f}, {prof['launches']} kernels")
            for r in prof["top"][:6]:
                log(f"  {r['ms']:9.3f} ms  x{r['count']:<5d} {r['name']}")
        del caches
        probe = None
        if arch in LM_TIE_PROBE:
            probe = lm_first_token(
                cfg, prefill, model, batch, res["tokens"][:, 0],
                lambda: SyntheticLM(
                    cfg, batch=LM_REQUESTS,
                    seq_len=prompt + cfg.num_prefix_embeds, seed=0,
                    device=str(dev)).batch_at(0))
            log(f"LM {arch} first token: top-2 gaps {probe['top2_gaps']} "
                f"(smallest {probe['min_gap_rel']:.3e} of the largest "
                f"|logit| {probe['largest_logit']:.4f}), spread of "
                f"{LM_PROBE_RUNS} prefills {probe['spread']:.3e} "
                f"({probe['spread_rel']:.3e}); argmax {probe['argmax']}, "
                f"served {probe['served']}, under deterministic algorithms "
                f"{probe['deterministic_argmax']} (max-abs "
                f"{probe['deterministic_max_abs']:.3e} from the first "
                f"prefill); the prompt drawn again equal "
                f"{probe['redraws_equal']} ({card})")
            check(all(probe["redraws_equal"])
                  and probe["served"] == probe["argmax"]
                  == probe["deterministic_argmax"],
                  f"LM {arch}: the served first tokens {probe['served']} "
                  f"are not the prompt's argmax {probe['argmax']}, or the "
                  f"prompt drawn again differs {probe['redraws_equal']}")
        sensitivity = lm_sensitivity(cfg, model, batch)
        del model
        torch.cuda.empty_cache()
        err64 = big64 = None
        if wide:  # the same check on a float64 copy of the model
            gen.manual_seed(0)
            model = steps.model_module(cfg).init_params(cfg, gen,
                                                        device=dev).double()
            with float64_models():
                err64, big64 = lm_decode_vs_forward(
                    lm_no_drop(cfg), model, batch, nxt, dev, torch.float64)
            del model
            torch.cuda.empty_cache()
            check(err64 <= bar * big64,
                  f"LM {arch}: prefill + decode {err64} from forward in "
                  f"float64 (largest |logit| {big64}, bar {bar})")
        del batch
        tokens_in = LM_REQUESTS * (prompt + cfg.num_prefix_embeds)
        row = {
            "config": cfg.name, "cut": cut, "requests": LM_REQUESTS,
            "prompt": prompt, "prefix": cfg.num_prefix_embeds,
            "gen": LM_GEN, "prefill_ms": res["prefill_ms"],
            "prefill_tokens_per_s": tokens_in / (res["prefill_ms"] * 1e-3),
            "decode_ms_per_token": res["decode_ms_per_token"],
            "decode_tokens_per_s": LM_REQUESTS
            / (res["decode_ms_per_token"] * 1e-3),
            "weight_bytes": res["weight_bytes"],
            "decode_read_bytes": read,
            "decode_bound_ms_measured_bw": read / bw * 1e3,
            "decode_bound_ms_peak": read / PEAK_BYTES_PER_S * 1e3,
            "peak_gib": (None if res["peak_bytes"] is None
                         else res["peak_bytes"] / 2 ** 30),
            "allocated_before": allocated_before,
            "decode_vs_forward": err / big, "bar": bar,
            "decode_vs_forward_f64": (None if err64 is None
                                      else err64 / big64),
            "held_in": "float64" if wide else "float32",
            "sensitivity": sensitivity, "warm": warm, "traces": traces,
            "first_token": probe}
        out["served"][arch] = row
        peak = ("not measured" if row["peak_gib"] is None
                else f"{row['peak_gib']:.3f} GiB")
        log(f"LM {arch} ({cfg.name}, {cut}; {LM_REQUESTS} requests, prompt "
            f"{prompt}, {LM_GEN} generated, f32): prefill "
            f"{row['prefill_ms']:.2f} ms ({row['prefill_tokens_per_s']:.0f} "
            f"tokens/s), decode {row['decode_ms_per_token']:.3f} ms/token "
            f"({row['decode_tokens_per_s']:.1f} tokens/s); weights "
            f"{row['weight_bytes'] / 1e9:.3f} GB, a decode step reads "
            f"{read / 1e9:.3f} GB: bound "
            f"{row['decode_bound_ms_measured_bw']:.3f} ms at the measured "
            "copy rate, "
            f"{row['decode_bound_ms_peak']:.3f} ms at 3.35 TB/s; peak "
            f"{peak}; warm: prefill {warm['prefill_ms']:.2f} ms, decode "
            f"{warm['decode_ms']:.3f} ms/token; prefill + decode against "
            f"forward {err:.3e} (largest |logit| {big:.3e}: {err / big:.3e}"
            + ("" if err64 is None else
               f"; in float64 {err64 / big64:.3e}, held to")
            + f" bar {bar:.3e}); logits moved {sensitivity:.3e} by a 1e-7 "
            f"scaling of the embeddings ({card})")
    out["smoke_against_cpu"] = lm_smoke_against_cpu(dev)
    log("LM smoke configs, card against CPU (worst error / largest "
        "|logit|): " + json.dumps(out["smoke_against_cpu"]))
    return out


# ---------------------------------------------------------------------------
# phase 12: LM training on one device
# ---------------------------------------------------------------------------

# (a): glm4-9b at full width, 8 of its 40 layers (the whole model's 9.40 B
# parameters at 16 bytes each, 150 GB, do not fit one card), bf16 compute,
# batch 2 x 1024 tokens, 6 steps on one repeated batch at the constant
# schedule (warmup_cosine's scale is 0 at step 0).  lr 1e-5: at 1e-4
# Adam's first, sign-like steps overshoot at this width and the loss
# swings 12.60 -> 22.42 -> 16.36 -> 17.89 -> 11.07 -> 16.85, the same in
# f32 and bf16 compute; at 1e-5 it falls every step (12.60 -> 4.14;
# scripts/lm_train_lr.py on an H100)
LM_TRAIN_ARCH, LM_TRAIN_LAYERS = "glm4-9b", 8
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 2, 1024, 6
LM_TRAIN_LR = 1e-5
# bytes of train state a parameter: f32 master, f32 m and v, a bf16
# compute copy and its bf16 gradient
LM_TRAIN_STATE_BYTES = 16
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet, 700 W)


def lm_grads(cfg, model, batch, compute_dtype=torch.float32):
    """(loss, {name: gradient}) as ``make_train_step`` takes them: with
    respect to ``cast_compute``'s copy."""
    from repro_torch.models import steps
    cmodel = steps.cast_compute(cfg, model, compute_dtype)
    loss, _ = steps.loss_fn(cfg, cmodel, batch, compute_dtype)
    names, leaves = zip(*cmodel.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), dict(zip(names, grads))


def lm_train_full_width(dev, card: str, scale: str = "full") -> dict:
    """(a): steps of ``make_train_step`` on glm4-9b at full width, cut to
    LM_TRAIN_LAYERS layers: per step its ms, tokens/s, model-flops share,
    peak memory, loss and grad norm; then one warm step traced.
    ``scale="smoke"`` rehearses it on the smoke config."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig
    full = (configs.get if scale == "full" else configs.get_smoke)(
        LM_TRAIN_ARCH)
    cfg = dataclasses.replace(full, num_layers=LM_TRAIN_LAYERS)
    opt = AdamWConfig(lr=LM_TRAIN_LR)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    # what earlier phases still hold, inside the steps' measured peaks
    gc.collect()
    allocated_before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    state = steps.init_train_state(cfg, gen, opt, device=dev)
    n_params = sum(p.numel() for p in state["params"].parameters())
    reckoned = LM_TRAIN_STATE_BYTES * n_params
    batch = SyntheticLM(cfg, batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                        seed=0, device=str(dev)).batch_at(0)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    step = steps.make_train_step(cfg, opt, compute_dtype=BF16)
    log(f"LM train: {cfg.name} at full width, {LM_TRAIN_LAYERS} of "
        f"{full.num_layers} layers, {n_params / 1e9:.4f} B parameters; "
        f"state reckoned {reckoned / 1e9:.2f} GB ({reckoned / 2 ** 30:.2f} "
        f"GiB) at {LM_TRAIN_STATE_BYTES} B a parameter; batch "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, bf16 compute ({card})")
    rows = []
    for i in range(LM_TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        flops6 = 6 * n_params * tokens
        row = {"step": i, "ms": ms, "tokens_per_s": tokens / (ms * 1e-3),
               "mfu_6nd": flops6 / (ms * 1e-3) / PEAK_BF16_FLOPS,
               "mfu_8nd_remat": flops6 * 8 / 6 / (ms * 1e-3)
               / PEAK_BF16_FLOPS,
               "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
        rows.append(row)
        log(f"LM train step {i}{' (warm)' if i else ' (first)'}: "
            f"{ms:.2f} ms, {row['tokens_per_s']:.1f} tokens/s, model-flops "
            f"share {row['mfu_6nd']:.4f} (6 N D; {row['mfu_8nd_remat']:.4f} "
            f"counting remat's second forward, 8 N D) of 989 TFLOP/s bf16; "
            f"peak {row['peak_gib']:.3f} GiB against the state's reckoned "
            f"{reckoned / 2 ** 30:.2f} GiB; loss {row['loss']:.6f}, grad "
            f"norm {row['grad_norm']:.6f} ({card})")
    for r in rows:
        check(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]),
              f"LM train step {r['step']}: loss {r['loss']}, grad norm "
              f"{r['grad_norm']}")
    check(rows[-1]["loss"] < rows[0]["loss"],
          f"LM train: the loss did not fall ({rows[0]['loss']} -> "
          f"{rows[-1]['loss']})")
    prof = profile_call(lambda: step(state, batch))
    if prof["top"]:
        log(f"LM train traced warm step: wall {prof['wall_ms']:.2f} ms, "
            f"device busy {prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f}, {prof['launches']} kernels")
        for r in prof["top"][:8]:
            log(f"  {r['ms']:9.3f} ms  x{r['count']:<5d} {r['name']}")
    else:
        log("LM train traced warm step: the profiler recorded no device "
            "time (not measured)")
    flops_counted = counted_flops(lambda: step(state, batch))
    warm = [r["ms"] for r in rows[1:]]
    out = {"config": cfg.name, "layers": LM_TRAIN_LAYERS,
           "of_layers": full.num_layers, "params": n_params,
           "flops_counted": flops_counted,
           "allocated_before": allocated_before,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "state_reckoned_bytes": reckoned, "steps": rows,
           "warm_ms_median": statistics.median(warm),
           "trace": prof}
    del state, batch
    torch.cuda.empty_cache()
    return out


def lm_train_smoke_against_cpu(dev) -> dict:
    """(b): every architecture's smoke config, one batch's loss and every
    gradient leaf in f32 on the card against the CPU on the same weights
    (drawn on the CPU, copied over), within the CPU tests' bars: bar x
    max(the leaf's largest |g|, 1e-3 x the tree's largest |g|)."""
    import copy
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import steps
    out = {}
    for arch in configs.all_arch_names():
        cfg = configs.get_smoke(arch)
        gen = torch.Generator().manual_seed(0)
        cpu_model = steps.model_module(cfg).init_params(cfg, gen,
                                                        device="cpu")
        card_model = copy.deepcopy(cpu_model).to(dev)
        batch = SyntheticLM(cfg, batch=2, seq_len=cfg.num_prefix_embeds + 24,
                            seed=1, device="cpu").batch_at(0)
        loss_c, g_c = lm_grads(cfg, cpu_model, batch)
        loss_d, g_d = lm_grads(cfg, card_model,
                               {k: v.to(dev) for k, v in batch.items()})
        bar = lm_bar(cfg, cfg)
        big = max(float(g.abs().max()) for g in g_c.values())
        worst = 0.0
        for name, g in g_c.items():
            scale = max(float(g.abs().max()), 1e-3 * big)
            err = float((g_d[name].cpu() - g).abs().max())
            check(err <= bar * scale,
                  f"LM train smoke {arch}: gradient {name} on the card "
                  f"{err} from the CPU's (scale {scale}, bar {bar})")
            worst = max(worst, err / scale)
        check(abs(loss_d - loss_c) <= bar * abs(loss_c),
              f"LM train smoke {arch}: loss {loss_d} on the card, {loss_c} "
              "on the CPU")
        out[arch] = {"loss_rel": abs(loss_d - loss_c) / abs(loss_c),
                     "worst_grad_rel": worst, "bar": bar}
        del cpu_model, card_model, g_c, g_d
    return out


def lm_train_resume(dev, card: str) -> dict:
    """(c): ``launch/train.py`` on the card, glm4-9b's smoke config: 6
    steps uninterrupted (checkpoints at 3 and 6), then a fresh process
    state resumed from the step-3 checkpoint to step 6 with ``--resume
    auto``, under ``torch.use_deterministic_algorithms(True)``: the two
    step-6 states' largest difference (held to 0: bitwise)."""
    from repro_torch.launch import train
    root = ROOT / "build" / "lm_train_resume"
    shutil.rmtree(root, ignore_errors=True)
    whole, resumed = root / "whole", root / "resumed"
    argv = ["--arch", LM_TRAIN_ARCH, "--scale", "smoke", "--steps", "6",
            "--ckpt-every", "3", "--log-every", "1", "--device", str(dev)]
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        train.main(argv + ["--ckpt-dir", str(whole)])
        resumed.mkdir(parents=True)
        shutil.copytree(whole / "step_00000003", resumed / "step_00000003")
        train.main(argv + ["--ckpt-dir", str(resumed), "--resume", "auto"])
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    diffs = {}
    with np.load(whole / "step_00000006" / "arrays.npz") as a, \
            np.load(resumed / "step_00000006" / "arrays.npz") as b:
        check(sorted(a.files) == sorted(b.files), "LM train resume: keys")
        for k in a.files:
            x, y = a[k], b[k]
            if x.dtype.kind == "V":      # bf16 moments: compare as bits
                same = x.tobytes() == y.tobytes()
                diffs[k] = 0.0 if same else float("inf")
            else:
                diffs[k] = float(np.abs(x.astype(np.float64)
                                        - y.astype(np.float64)).max())
    shutil.rmtree(root, ignore_errors=True)
    params = {k: v for k, v in diffs.items() if k.startswith("params")}
    worst = max(diffs.values())
    log(f"LM train resume on the card ({LM_TRAIN_ARCH} smoke, 3 + 3 steps "
        f"against 6, deterministic algorithms): largest parameter "
        f"difference {max(params.values()):.3e}, largest state difference "
        f"{worst:.3e} over {len(diffs)} leaves ({card})")
    check(worst == 0.0, f"LM train resume: the resumed state differs from "
                        f"the uninterrupted one by {worst}")
    return {"largest_param_diff": max(params.values()),
            "largest_state_diff": worst, "leaves": len(diffs)}


def lm_train_phase(dev, card: str, scale: str = "full") -> dict:
    """Phase 12: (a) glm4-9b full width at a cut depth (``scale="smoke"``
    rehearses it on the smoke config), (b) the ten smoke configs'
    gradients on the card against the CPU, (c) a resumed run bitwise an
    uninterrupted one; (d) the phase's seconds."""
    t0 = time.perf_counter()
    out = {"full_width": lm_train_full_width(dev, card, scale),
           "smoke_against_cpu": lm_train_smoke_against_cpu(dev)}
    log("LM train smoke configs, card against CPU (loss and worst gradient "
        "error / scale): " + json.dumps(out["smoke_against_cpu"]))
    out["resume"] = lm_train_resume(dev, card)
    out["seconds"] = time.perf_counter() - t0
    log(f"LM train phase: {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: data-parallel LM training on a 2x2 mesh
# ---------------------------------------------------------------------------

# glm4-9b at full width, cut to LM_MESH_LAYERS layer(s) so that four ranks
# fit one card (the reckoning: ``lm_rank_reckoning``, PERF.md section 6),
# bf16 compute, phase 12's global batch (2 x 1024 tokens, one row a data
# shard), its learning rate, LM_MESH_STEPS steps on one repeated batch.
# The mesh checkpoint is held on glm4-9b's smoke config
# (LM_MESH_CKPT_STEPS steps, batch 4 x 32): the full-width state's
# (17.35 GB) took 80.4 s to write and 50.6 s to restore on an H100
# (PERF.md section 6), past the phase's budget
LM_MESH_LAYERS, LM_MESH_STEPS, LM_MESH_CKPT_STEPS = 1, 3, 2
LM_MESH_SHAPE, LM_MESH_AXES = (2, 2), ("data", "model")
LM_MESH_WORLD = 4
LM_MESH_PG_TIMEOUT_S = 300   # every collective of the children
LM_MESH_DEADLINE_S = 600     # the children's join deadline
# the bf16 bar: 2 bf16 ulps (2^-7) of the one-device value, relative, for
# the loss and the gradient norm (tests/test_torch_lm_parallel.py holds the
# reduced gradients within 2 ulps of each leaf's largest |g|)
LM_MESH_BF16_BAR = 2.0 ** -7
ADAM_B1, ADAM_EPS = 0.9, 1e-8


def lm_mesh_config(scale: str):
    from repro_torch import configs
    full = (configs.get if scale == "full" else configs.get_smoke)(
        LM_TRAIN_ARCH)
    return full, dataclasses.replace(full, num_layers=LM_MESH_LAYERS)


def lm_mesh_batch(cfg, dev):
    from repro_torch.data import SyntheticLM
    return SyntheticLM(cfg, batch=LM_TRAIN_BATCH, seq_len=LM_TRAIN_SEQ,
                       seed=0, device=str(dev)).batch_at(0)


def lm_mesh_ckpt_config():
    from repro_torch import configs
    return configs.get_smoke(LM_TRAIN_ARCH)


def lm_mesh_ckpt_batch(cfg, dev, i: int):
    from repro_torch.data import SyntheticLM
    return SyntheticLM(cfg, batch=4, seq_len=32, seed=0,
                       device=str(dev)).batch_at(i)


def lm_mesh_child(rank: int, d: Path) -> int:
    """One rank of phase 13 (``chip_smoke.py --lm-mesh-rank R
    --lm-mesh-dir D``): the train state on the 2x2 mesh drawn from the
    one-device run's seed, LM_MESH_STEPS steps of ``make_train_step(...,
    mesh=)`` on the one-device run's batch, after step 1 its master blocks
    against the one-device master's (``D/ref/<name>.npy``); then glm4-9b's
    smoke config trained LM_MESH_CKPT_STEPS steps on the same mesh, a
    mesh checkpoint of it and the sha256 of its blocks; writes
    ``rank<R>.json``."""
    import datetime
    import hashlib
    import torch.distributed as tdist
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import distributed as dist
    from repro_torch.models import convert, steps
    from repro_torch.optim import AdamWConfig
    cfg_json = json.loads((d / "mesh.json").read_text())
    transport = cfg_json["transport"]
    cuda = cfg_json["device_type"] == "cuda"
    dev = torch.device("cuda", rank if transport == "nccl" else 0) \
        if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=LM_MESH_PG_TIMEOUT_S)
    tdist.init_process_group(transport, init_method=f"file://{d}/rendezvous",
                             rank=rank, world_size=LM_MESH_WORLD,
                             timeout=timeout)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    try:
        mesh = dist.Mesh(LM_MESH_SHAPE, LM_MESH_AXES, device=dev,
                         transport=transport, timeout=timeout)
        _, cfg = lm_mesh_config(cfg_json["scale"])
        opt = AdamWConfig(lr=LM_TRAIN_LR)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        state = steps.init_train_state(cfg, gen, opt, device=dev, mesh=mesh)
        sync()
        out = {"coords": mesh.coords, "init_s": time.perf_counter() - t0}
        if cuda:
            out["init_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.empty_cache()   # the whole draw, for the other ranks
            torch.cuda.reset_peak_memory_stats(dev)
        batch = lm_mesh_batch(cfg, dev)
        specs = steps.state_specs(cfg, state)["params"]
        step = steps.make_train_step(cfg, opt, mesh=mesh, compute_dtype=BF16)
        rows = []
        for i in range(LM_MESH_STEPS):
            before = (dict(mesh.counts), dict(mesh.seconds),
                      dict(mesh.nbytes))
            mesh.barrier()
            sync()
            if cuda:   # the step's own peak (not the check after step 1)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            ms = (time.perf_counter() - t0) * 1e3
            rows.append({
                "step": i, "ms": ms, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "counts": {k: v - before[0].get(k, 0)
                           for k, v in mesh.counts.items()},
                "seconds": {k: v - before[1].get(k, 0.0)
                            for k, v in mesh.seconds.items()},
                "nbytes": {k: v - before[2].get(k, 0)
                           for k, v in mesh.nbytes.items()},
                "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                               if cuda else None)})
            if i == 0:
                out["after_step1"] = lm_mesh_against_reference(
                    mesh, state, specs, d / "ref")
        out["steps"] = rows
        out["peak_bytes"] = (max(r["peak_bytes"] for r in rows)
                             if cuda else None)
        out["totals"] = {"counts": dict(mesh.counts),
                         "seconds": dict(mesh.seconds),
                         "nbytes": dict(mesh.nbytes)}
        # phase 14's count: one more step, untimed
        t0 = time.perf_counter()
        out["flops_counted"] = counted_flops(lambda: step(state, batch))
        sync()
        out["counted_step_s"] = time.perf_counter() - t0
        del state, step, batch, m
        if cuda:
            torch.cuda.empty_cache()
        # a mesh checkpoint (whole arrays, rank 0 writes) of the smoke
        # config trained on the same mesh
        cfg = lm_mesh_ckpt_config()
        gen.manual_seed(0)
        state = steps.init_train_state(cfg, gen, opt, device=dev, mesh=mesh)
        step = steps.make_train_step(cfg, opt, mesh=mesh, compute_dtype=BF16)
        for i in range(LM_MESH_CKPT_STEPS):
            state, _ = step(state, lm_mesh_ckpt_batch(cfg, dev, i))
        t0 = time.perf_counter()
        jspecs = convert.train_state_specs_to_jax(
            cfg, steps.state_specs(cfg, state))
        ckpt.save_checkpoint(str(d / "ck"), LM_MESH_CKPT_STEPS,
                             convert.train_state_tree(cfg, state), mesh=mesh,
                             specs=jspecs)
        out["ckpt_s"] = time.perf_counter() - t0
        out["sha"] = {}
        for part, tree in (("params", dict(state["params"]
                                           .named_parameters())),
                           ("m", state["opt"]["m"]), ("v", state["opt"]["v"])):
            for name, t in tree.items():
                h = hashlib.sha256(t.detach().cpu().contiguous().view(
                    torch.uint8).numpy())
                out["sha"][f"{part}/{name}"] = h.hexdigest()
        (d / f"rank{rank}.json").write_text(json.dumps(out))
        del state
        mesh.barrier()
    finally:
        tdist.destroy_process_group()
    return 0


def lm_mesh_against_reference(mesh, state, specs, ref: Path) -> dict:
    """After step 1: this rank's master blocks against the same blocks of
    the one-device master (read from ``ref/<name>.npy``).  Both started
    from the same bits, so a difference is the update's: Adam's first step
    moves an entry by lr (g / (|g| + eps) + wd p), and a gradient entry
    within delta of the one-device one moves it at most lr eps delta /
    (|g| - delta + eps)^2 (at most 2 lr) further, delta the bf16 bar
    (LM_MESH_BF16_BAR) x max(the leaf's largest |g|, 1e-3 x the tree's);
    the f32 rounding of the update and of p adds lr 1e-5 + 2^-22 |p|.  g is
    this rank's block of the reduced, clipped gradient, m / (1 - b1)."""
    from repro_torch.parallel import sharding as shd
    names = list(specs)
    grads = {n: state["opt"]["m"][n].float() / (1 - ADAM_B1) for n in names}
    local = torch.tensor([float(grads[n].abs().max()) for n in names],
                         dtype=torch.float32, device=mesh.device)
    gmax = torch.stack(mesh.all_gather(local, kind="check_gather")).amax(0)
    gbig = float(gmax.max())
    master = dict(state["params"].named_parameters())
    worst, moved, entries = 0.0, 0.0, 0
    lr = LM_TRAIN_LR
    for i, n in enumerate(names):
        arr = np.load(ref / f"{n}.npy", mmap_mode="r")
        sl = shd.block_slices(mesh, specs[n], arr.shape)
        want = torch.from_numpy(np.ascontiguousarray(arr[sl])).to(
            mesh.device)
        g = grads[n]
        delta = LM_MESH_BF16_BAR * max(float(gmax[i]), 1e-3 * gbig)
        room = torch.clamp(ADAM_EPS * delta / (torch.clamp(
            g.abs() - delta, min=0.0) + ADAM_EPS) ** 2, max=2.0)
        allowed = lr * (room + 1e-5) + 2.0 ** -22 * want.abs()
        err = (master[n].detach() - want).abs()
        worst = max(worst, float((err / allowed).max()))
        moved = max(moved, float(err.max()) / lr)
        entries += err.numel()
        del arr, want, g, room, allowed, err
    return {"worst_over_allowed": worst, "largest_diff_over_lr": moved,
            "entries": entries}


def lm_mesh_phase(dev, card: str, scale: str = "full") -> dict:
    """Phase 13: the one-device reference (LM_MESH_STEPS steps of
    ``make_train_step`` on the whole batch, its step-1 master written
    under build/), then four ranks on a 2x2 mesh (NCCL with a card a rank,
    else gloo on card 0), each step's global loss and grad norm within
    the bf16 bar of the one-device step's, the step-1 master blocks within
    the carried bar, the loss falling, and the mesh's checkpoint of
    glm4-9b's smoke config restored onto one device bitwise every rank's
    blocks.  ``scale="smoke"`` with ``dev`` the CPU rehearses it."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch import kernels
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import convert, steps
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import sharding as shd
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    launches_before = kernels.counts()
    full, cfg = lm_mesh_config(scale)
    opt = AdamWConfig(lr=LM_TRAIN_LR)
    n_cards = torch.cuda.device_count() if cuda else 0
    transport = "nccl" if n_cards >= LM_MESH_WORLD else "gloo"
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_",
                                dir=ROOT / "build"))
    try:
        # the one-device reference
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = steps.init_train_state(cfg, gen, opt, device=dev)
        n_params = sum(p.numel() for p in state["params"].parameters())
        reck = lm_rank_reckoning(cfg, n_params)
        log(f"LM mesh train: {cfg.name} at full width, {LM_MESH_LAYERS} of "
            f"{full.num_layers} layers, {n_params / 1e9:.4f} B parameters, "
            f"on a {LM_MESH_SHAPE} {LM_MESH_AXES} mesh of {LM_MESH_WORLD} "
            f"ranks, transport {transport} ({n_cards} cards); batch "
            f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, bf16 compute, lr "
            f"{LM_TRAIN_LR}; a rank's peak reckoned "
            f"{reck['total'] / 2 ** 30:.2f} GiB ("
            + ", ".join(f"{k} {v / 2 ** 30:.2f}" for k, v in reck.items()
                        if k != "total") + f" GiB) ({card})")
        log("LM mesh train: this path launches none of K1-K4 (the LM "
            "layers are plain torch)")
        batch = lm_mesh_batch(cfg, dev)
        step = steps.make_train_step(cfg, opt, compute_dtype=BF16)
        one = []
        for i in range(LM_MESH_STEPS):
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            if cuda:
                torch.cuda.synchronize(dev)
            one.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])})
            if i == 0:
                (tmp / "ref").mkdir()
                for name, p in state["params"].named_parameters():
                    np.save(tmp / "ref" / f"{name}.npy",
                            p.detach().cpu().numpy())
        log("LM mesh train one-device reference: " + json.dumps(one))
        del state, batch, step, m
        if cuda:
            torch.cuda.empty_cache()
        # the ranks
        (tmp / "mesh.json").write_text(json.dumps(
            {"transport": transport, "device_type": dev.type,
             "scale": scale}))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = run_children(
            [[sys.executable, str(ROOT / "chip_smoke.py"), "--lm-mesh-rank",
              str(r), "--lm-mesh-dir", str(tmp)]
             for r in range(LM_MESH_WORLD)], env, LM_MESH_DEADLINE_S)
        children_s = time.perf_counter() - t0
        for r, (rc, text) in enumerate(res):
            check(rc == 0, f"LM mesh rank {r} failed (rc {rc}):\n"
                           f"{text[-6000:]}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(LM_MESH_WORLD)]
        # every rank's metrics the same, and the one-device step's
        for r, rk in enumerate(ranks):
            for i, row in enumerate(rk["steps"]):
                for key in ("loss", "grad_norm"):
                    w = one[i][key]
                    check(row[key] == ranks[0]["steps"][i][key],
                          f"LM mesh step {i} rank {r}: {key} {row[key]} "
                          f"against rank 0's {ranks[0]['steps'][i][key]}")
                    check(abs(row[key] - w) <= LM_MESH_BF16_BAR * abs(w),
                          f"LM mesh step {i}: {key} {row[key]} against the "
                          f"one-device {w} (bar {LM_MESH_BF16_BAR})")
            ok = rk["after_step1"]
            check(ok["worst_over_allowed"] <= 1.0,
                  f"LM mesh rank {r}: step-1 master blocks off the "
                  f"one-device master: {ok}")
        losses = [row["loss"] for row in ranks[0]["steps"]]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"LM mesh train: the loss did not fall: {losses}")
        # the mesh checkpoint onto one device, bitwise every rank's blocks
        t0 = time.perf_counter()
        ck_cfg = lm_mesh_ckpt_config()
        skel = steps.init_train_state(ck_cfg, None, opt, device="meta")
        tree = ckpt.restore_checkpoint(
            str(tmp / "ck"), LM_MESH_CKPT_STEPS,
            convert.train_state_shapes(ck_cfg, skel), device=dev)
        restored = convert.train_state_from_jax(ck_cfg, tree, device=dev)
        del tree
        restore_s = time.perf_counter() - t0
        check(int(restored["opt"]["step"]) == LM_MESH_CKPT_STEPS,
              "LM mesh checkpoint: step")
        specs = steps.state_specs(ck_cfg, restored)["params"]
        shape = MeshShape(dict(zip(LM_MESH_AXES, LM_MESH_SHAPE)),
                          LM_MESH_AXES)
        whole = {f"params/{n}": p.detach()
                 for n, p in restored["params"].named_parameters()}
        for part in ("m", "v"):
            whole.update({f"{part}/{n}": t
                          for n, t in restored["opt"][part].items()})

        def digest(job):
            key, coords = job
            t = whole[key]
            blk = t[shd.block_slices(shape, specs[key.split("/", 1)[1]],
                                     t.shape, coords)]
            return hashlib.sha256(blk.cpu().contiguous().view(
                torch.uint8).numpy()).hexdigest()

        t0 = time.perf_counter()
        jobs = [(key, rk["coords"]) for rk in ranks for key in whole]
        with ThreadPoolExecutor(8) as pool:
            got = list(pool.map(digest, jobs))
        hash_s = time.perf_counter() - t0
        want = [rk["sha"][key] for rk in ranks for key in whole]
        bad = [j[0] for j, a, b in zip(jobs, got, want) if a != b]
        check(not bad and len(want) == len(got),
              f"LM mesh checkpoint restored on one device differs from the "
              f"ranks' blocks at {bad[:8]}")
        del restored, whole
        if cuda:
            torch.cuda.empty_cache()
        check(kernels.counts() == launches_before,
              "LM mesh train launched a kernel of K1-K4")
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        r0 = ranks[0]["steps"]
        for i, row in enumerate(r0):
            grad = {k: v for k, v in row["nbytes"].items()
                    if k.startswith("grad_") and v}
            log(f"LM mesh step {i}{' (warm)' if i else ' (first)'}: rank 0 "
                f"{row['ms']:.2f} ms (ranks "
                + ", ".join(f"{rk['steps'][i]['ms']:.2f}" for rk in ranks)
                + f"), {tokens / (row['ms'] * 1e-3):.1f} tokens/s; loss "
                f"{row['loss']:.6f} (one device {one[i]['loss']:.6f}), grad "
                f"norm {row['grad_norm']:.6f} ({one[i]['grad_norm']:.6f}); "
                f"gradient bytes reduced by rank 0 {grad}, parameters "
                f"gathered {row['nbytes'].get('param_gather/bfloat16', 0)} "
                f"bf16 bytes, tensor-parallel all-reduces "
                + json.dumps({k: v for k, v in row["nbytes"].items()
                              if k.startswith("tp_") and v}) + "; "
                "rank 0's seconds in collectives "
                + json.dumps({k: round(v, 4) for k, v in
                              row["seconds"].items()})
                + f"; rank 0's peak {(row['peak_bytes'] or 0) / 2 ** 30:.3f} "
                f"GiB ({card})")
        gib = [((rk["peak_bytes"] or 0) / 2 ** 30,
                (rk.get("init_peak_bytes") or 0) / 2 ** 30) for rk in ranks]
        log("LM mesh ranks' peaks: "
            + ", ".join(f"rank {r} {p:.3f} GiB (init {i:.3f})"
                        for r, (p, i) in enumerate(gib))
            + f" against the reckoned {reck['total'] / 2 ** 30:.2f} GiB ("
            f"{card})")
        traced = lm_mesh_traced(cfg, ranks[0]["coords"])
        log(f"LM mesh rank traced on the meta device "
            f"(launch/dryrun.py::measure): peak "
            f"{traced['peak_bytes'] / 2 ** 30:.3f} GiB, holding "
            + ", ".join(f"{k} {v / 2 ** 30:.3f}" for k, v in
                        list(traced["peak_holds"].items())[:10])
            + f" GiB; the reckoning {reck['total'] / 2 ** 30:.2f} GiB ("
            + ", ".join(f"{k} {v / 2 ** 30:.2f}" for k, v in reck.items()
                        if k != "total") + f" GiB) ({card})")
        log(f"LM mesh step-1 master blocks against the one-device master: "
            + json.dumps([rk["after_step1"] for rk in ranks]))
        seconds = time.perf_counter() - t_phase
        log(f"LM mesh checkpoint ({ck_cfg.name}, {LM_MESH_CKPT_STEPS} steps "
            f"on the mesh): written in {ranks[0]['ckpt_s']:.2f} s (gathers "
            f"and rank 0's write), restored on one device in "
            f"{restore_s:.2f} s, {len(jobs)} blocks bitwise ({hash_s:.2f} s "
            f"hashing); ranks' state set-up "
            + ", ".join(f"{rk['init_s']:.1f}" for rk in ranks)
            + f" s; children {children_s:.1f} s; phase 13 {seconds:.1f} s "
            f"({card})")
        warm = [row["ms"] for row in r0[1:]]
        return {"config": cfg.name, "layers": LM_MESH_LAYERS,
                "params": n_params, "transport": transport,
                "reckoned_rank_bytes": reck, "one_device": one,
                "ranks": [{k: rk[k] for k in ("coords", "steps",
                                              "after_step1", "ckpt_s",
                                              "peak_bytes", "init_s",
                                              "totals", "flops_counted",
                                              "counted_step_s")}
                          for rk in ranks],
                "warm_ms_median": statistics.median(warm) if warm else None,
                "restore_s": restore_s, "hash_s": hash_s,
                "children_s": children_s, "seconds": seconds,
                "traced": traced}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 15: tensor-parallel LM training and serving on a 2x2 mesh
# ---------------------------------------------------------------------------

# glm4-9b at full width on the 2x2 (data, model) mesh, the attention's KV
# heads, the MLP's hidden columns and the vocabulary split over ``model``,
# each layer's blocks gathered over ``data`` just before use: training
# (bf16 compute, phase 12's batch and learning rate) cut to LM_TP_LAYERS
# layers, enough that one layer at a time shows in a rank's peak (0.67 GiB
# a layer traced; four ranks on one card hold the whole f32 draw of each
# during set-up); serving (f32, a prefill of LM_REQUESTS x LM_TP_PROMPT
# tokens and LM_TP_DECODE greedy decode steps) cut to LM_TP_SERVE_LAYERS
# layers
LM_TP_LAYERS, LM_TP_STEPS = 4, 3
LM_TP_SERVE_LAYERS, LM_TP_PROMPT, LM_TP_DECODE = 8, 32, 4


def lm_tp_configs(scale: str):
    from repro_torch import configs
    full = (configs.get if scale == "full" else configs.get_smoke)(
        LM_TRAIN_ARCH)
    return (dataclasses.replace(full, num_layers=LM_TP_LAYERS),
            dataclasses.replace(full, num_layers=LM_TP_SERVE_LAYERS))


def lm_tp_prompt(cfg, dev):
    from repro_torch.data import SyntheticLM
    return SyntheticLM(cfg, batch=LM_REQUESTS, seq_len=LM_TP_PROMPT, seed=0,
                       device=str(dev)).batch_at(0)


def lm_rank_reckoning(cfg, n_params: int) -> dict:
    """Bytes a 2x2 rank of the tensor-parallel train step holds at its
    peak, reckoned from the shapes as the trace finds it (in the backward
    of the logits): its block of the f32 master, m and v (12 B a
    parameter over 4 ranks) and of the bf16 compute copy (2 B), the f32
    copy of its gathered vocabulary rows of ``embed.out`` and their f32
    gradient (4 B each an entry), and one f32 logits-sized tensor of its
    1024 tokens' vocabulary columns."""
    world = math.prod(LM_MESH_SHAPE)
    rows = cfg.padded_vocab // LM_MESH_SHAPE[1]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ // LM_MESH_SHAPE[0]
    parts = {"state_block": 12 * n_params // world,
             "compute_block": 2 * n_params // world,
             "out_f32_copy_and_grad": 2 * 4 * rows * cfg.d_model,
             "logits": 4 * tokens * rows}
    parts["total"] = sum(parts.values())
    return parts


def _mark(mesh) -> tuple:
    return dict(mesh.counts), dict(mesh.seconds), dict(mesh.nbytes)


def _since(mesh, before) -> dict:
    return {"counts": {k: v - before[0].get(k, 0)
                       for k, v in mesh.counts.items()
                       if v - before[0].get(k, 0)},
            "seconds": {k: v - before[1].get(k, 0.0)
                        for k, v in mesh.seconds.items()
                        if v - before[1].get(k, 0.0)},
            "nbytes": {k: v - before[2].get(k, 0)
                       for k, v in mesh.nbytes.items()
                       if v - before[2].get(k, 0)}}


def lm_tp_child(rank: int, d: Path) -> int:
    """One rank of phase 15 (``chip_smoke.py --lm-tp-rank R --lm-tp-dir
    D``): LM_TP_STEPS tensor-parallel train steps of the state drawn from
    the one-device run's seed, then the f32 serving model's blocks, a
    prefill of this rank's rows and LM_TP_DECODE decode steps; each call
    timed, its collectives, peak and ``FlopCounterMode`` count of one
    more untimed call; writes ``rank<R>.json`` and this rank's tokens and
    logits (``serve<R>.npz``)."""
    import datetime
    import torch.distributed as tdist
    from repro_torch.core import distributed as dist
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig
    from repro_torch.parallel import tp
    spec = json.loads((d / "mesh.json").read_text())
    transport, cuda = spec["transport"], spec["device_type"] == "cuda"
    dev = torch.device("cuda", rank if transport == "nccl" else 0) \
        if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    timeout = datetime.timedelta(seconds=LM_MESH_PG_TIMEOUT_S)
    tdist.init_process_group(transport, init_method=f"file://{d}/rendezvous",
                             rank=rank, world_size=LM_MESH_WORLD,
                             timeout=timeout)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def fresh_peak():
        sync()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def peak():
        return torch.cuda.max_memory_allocated(dev) if cuda else None

    try:
        mesh = dist.Mesh(LM_MESH_SHAPE, LM_MESH_AXES, device=dev,
                         transport=transport, timeout=timeout)
        cfg, scfg = lm_tp_configs(spec["scale"])
        opt = AdamWConfig(lr=LM_TRAIN_LR)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = steps.init_train_state(cfg, gen, opt, device=dev, mesh=mesh)
        out = {"coords": mesh.coords}
        fresh_peak()
        batch = lm_mesh_batch(cfg, dev)
        step = steps.make_train_step(cfg, opt, mesh=mesh, compute_dtype=BF16)
        rows = []
        for i in range(LM_TP_STEPS):
            mesh.barrier()
            before = _mark(mesh)
            sync()
            t0 = time.perf_counter()
            tp.CASES.clear()
            state, m = step(state, batch)
            sync()
            rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "cases": dict(tp.CASES), **_since(mesh, before)})
        out["train"] = {"steps": rows, "peak_bytes": peak(),
                        "flops_counted": counted_flops(
                            lambda: step(state, batch))}
        del state, step, batch, m
        mesh.barrier()
        # serving: the f32 model drawn whole from the seed, this rank's
        # blocks kept
        gen.manual_seed(0)
        model = steps.shard_model(scfg, steps.model_module(scfg).init_params(
            scfg, gen, device=dev), mesh)
        local = steps.local_batch(scfg, lm_tp_prompt(scfg, dev), mesh)
        f32 = torch.float32
        prefill = steps.make_prefill_step(
            scfg, cache_len=LM_TP_PROMPT + LM_TP_DECODE + 1, mesh=mesh,
            compute_dtype=f32)
        decode = steps.make_decode_step(scfg, mesh=mesh, compute_dtype=f32)
        fresh_peak()
        mesh.barrier()
        before = _mark(mesh)
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, caches = prefill(model, local)
        sync()
        serve = {"prefill_ms": (time.perf_counter() - t0) * 1e3,
                 "prefill": _since(mesh, before),
                 "prefill_peak_bytes": peak()}
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        toks, lgs = [tok], [logits]
        fresh_peak()
        mesh.barrier()
        t0 = time.perf_counter()
        per_step = []
        with torch.no_grad():
            for i in range(LM_TP_DECODE):
                before = _mark(mesh)
                tok, logits, caches = decode(model, caches, tok,
                                             LM_TP_PROMPT + i)
                per_step.append(_since(mesh, before))
                toks.append(tok)
                lgs.append(logits)
        sync()
        serve.update(decode_ms_per_token=(time.perf_counter() - t0) * 1e3
                     / LM_TP_DECODE, decode=per_step,
                     decode_peak_bytes=peak())
        with torch.no_grad():
            serve["prefill_flops_counted"] = counted_flops(
                lambda: prefill(model, local))
            serve["decode_flops_counted"] = counted_flops(
                lambda: decode(model, caches, tok, LM_TP_PROMPT +
                               LM_TP_DECODE - 1))
        out["serve"] = serve
        np.savez(d / f"serve{rank}.npz",
                 tokens=torch.cat(toks, 1).cpu().numpy(),
                 logits=torch.cat(lgs, 1).cpu().numpy())
        (d / f"rank{rank}.json").write_text(json.dumps(out))
        del model, caches
        mesh.barrier()
    finally:
        tdist.destroy_process_group()
    return 0


def lm_tp_serve_traced(cfg, coords: dict) -> dict:
    """A phase 15 rank's f32 prefill and decode step traced on the meta
    device (``launch/dryrun.py::measure``) with a recording 2x2 mesh at
    ``coords`` (one for each): this rank's blocks and rows, the decode's
    caches those a prefill made."""
    from repro_torch.launch.dryrun import measure
    from repro_torch.models import steps
    f32 = torch.float32
    out = {}
    for what in ("prefill", "decode"):
        m = lm_tp_mesh(coords)
        model = steps.shard_model(cfg, steps.model_module(cfg).init_params(
            cfg, None, device="meta"), m)
        batch = steps.local_batch(cfg, {"tokens": torch.empty(
            (LM_REQUESTS, LM_TP_PROMPT), dtype=torch.int64,
            device="meta")}, m)
        prefill = steps.make_prefill_step(
            cfg, cache_len=LM_TP_PROMPT + LM_TP_DECODE + 1, mesh=m,
            compute_dtype=f32)
        with torch.no_grad():
            if what == "prefill":
                out[what] = measure(prefill, {"model": model,
                                              "batch": batch}, m)
                continue
            _, caches = prefill(model, batch)
            decode = steps.make_decode_step(cfg, mesh=m, compute_dtype=f32)
            tokens = torch.empty((batch["tokens"].shape[0], 1),
                                 dtype=torch.int64, device="meta")
            out[what] = measure(decode, {"model": model, "caches": caches,
                                         "tokens": tokens,
                                         "pos": LM_TP_PROMPT}, m)
    return out


def lm_tp_phase(dev, card: str, scale: str = "full") -> dict:
    """Phase 15: glm4-9b at full width, tensor-parallel over ``model`` on
    the 2x2 mesh with one layer gathered over ``data`` at a time, against
    one device.  First the one-device references on this process: the
    LM_TP_LAYERS-layer bf16 train step (LM_TP_STEPS steps) and the
    LM_TP_SERVE_LAYERS-layer f32 prefill and decode; then four children
    (NCCL with a card a rank, else gloo on card 0) run the same on the
    mesh from the same seed.  Each step's loss and grad norm within 2^-7
    of the one-device step's, the same on every rank, KV heads over
    ``model`` in every attention; every rank's tokens its rows of the
    one-device tokens and its logits within 1e-5 of their largest
    |logit|.  ``scale="smoke"`` with ``dev`` the CPU rehearses it."""
    from repro_torch import kernels
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig
    from repro_torch.launch.mesh import MeshShape
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    launches_before = kernels.counts()
    cfg, scfg = lm_tp_configs(scale)
    opt = AdamWConfig(lr=LM_TRAIN_LR)
    n_cards = torch.cuda.device_count() if cuda else 0
    transport = "nccl" if n_cards >= LM_MESH_WORLD else "gloo"
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_lm_tp_",
                                dir=ROOT / "build"))

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    try:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = steps.init_train_state(cfg, gen, opt, device=dev)
        n_params = sum(p.numel() for p in state["params"].parameters())
        reck = lm_rank_reckoning(cfg, n_params)
        log(f"LM TP: {cfg.name} at full width on a {LM_MESH_SHAPE} "
            f"{LM_MESH_AXES} mesh of {LM_MESH_WORLD} ranks, transport "
            f"{transport} ({n_cards} cards): training {LM_TP_LAYERS} "
            f"layers ({n_params / 1e9:.4f} B parameters, bf16 compute, batch "
            f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, lr {LM_TRAIN_LR}, "
            f"{LM_TP_STEPS} steps), serving {LM_TP_SERVE_LAYERS} layers in "
            f"f32 ({LM_REQUESTS} x {LM_TP_PROMPT} prompt, {LM_TP_DECODE} "
            f"decode steps); a training rank's peak reckoned "
            f"{reck['total'] / 2 ** 30:.3f} GiB ("
            + ", ".join(f"{k} {v / 2 ** 30:.3f}" for k, v in reck.items()
                        if k != "total") + f" GiB) ({card})")
        batch = lm_mesh_batch(cfg, dev)
        step = steps.make_train_step(cfg, opt, compute_dtype=BF16)
        one = []
        for _ in range(LM_TP_STEPS):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            sync()
            one.append({"ms": (time.perf_counter() - t0) * 1e3,
                        "loss": float(m["loss"]),
                        "grad_norm": float(m["grad_norm"])})
        log("LM TP one-device train reference: " + json.dumps(one))
        del state, batch, step, m
        gen.manual_seed(0)
        model = steps.model_module(scfg).init_params(scfg, gen, device=dev)
        prompt = lm_tp_prompt(scfg, dev)
        f32 = torch.float32
        prefill = steps.make_prefill_step(
            scfg, cache_len=LM_TP_PROMPT + LM_TP_DECODE + 1,
            compute_dtype=f32)
        decode = steps.make_decode_step(scfg, compute_dtype=f32)
        with torch.no_grad():
            logits, caches = prefill(model, prompt)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            toks, lgs = [tok], [logits]
            for i in range(LM_TP_DECODE):
                tok, logits, caches = decode(model, caches, tok,
                                             LM_TP_PROMPT + i)
                toks.append(tok)
                lgs.append(logits)
        ref_tokens = torch.cat(toks, 1).cpu().numpy()
        ref_logits = torch.cat(lgs, 1).cpu().numpy()
        del model, caches, logits, lgs, toks, prompt
        if cuda:
            torch.cuda.empty_cache()
        (tmp / "mesh.json").write_text(json.dumps(
            {"transport": transport, "device_type": dev.type,
             "scale": scale}))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = run_children(
            [[sys.executable, str(ROOT / "chip_smoke.py"), "--lm-tp-rank",
              str(r), "--lm-tp-dir", str(tmp)]
             for r in range(LM_MESH_WORLD)], env, LM_MESH_DEADLINE_S)
        children_s = time.perf_counter() - t0
        for r, (rc, text) in enumerate(res):
            check(rc == 0, f"LM TP rank {r} failed (rc {rc}):\n"
                           f"{text[-6000:]}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(LM_MESH_WORLD)]
        for r, rk in enumerate(ranks):
            for i, row in enumerate(rk["train"]["steps"]):
                check(row["cases"] == {"kv": 2 * LM_TP_LAYERS},
                      f"LM TP rank {r} step {i}: attention cases "
                      f"{row['cases']}")
                for key in ("loss", "grad_norm"):
                    w = one[i][key]
                    check(row[key] == ranks[0]["train"]["steps"][i][key],
                          f"LM TP step {i} rank {r}: {key} differs from "
                          "rank 0's")
                    check(abs(row[key] - w) <= LM_MESH_BF16_BAR * abs(w),
                          f"LM TP step {i}: {key} {row[key]} against the "
                          f"one-device {w} (bar {LM_MESH_BF16_BAR})")
        shape = {"data": LM_MESH_SHAPE[0], "model": LM_MESH_SHAPE[1]}
        v = scfg.vocab_size
        worst = 0.0
        for r, rk in enumerate(ranks):
            with np.load(tmp / f"serve{r}.npz") as f:
                got_t, got_l = f["tokens"], f["logits"]
            dp = steps.dp_axes_for(MeshShape(shape, LM_MESH_AXES),
                                   LM_REQUESTS)
            n = LM_REQUESTS // math.prod(shape[a] for a in dp)
            i0 = rk["coords"]["data"] * n
            want_t, want_l = ref_tokens[i0:i0 + n], ref_logits[i0:i0 + n]
            check(np.array_equal(got_t, want_t),
                  f"LM TP rank {r}: tokens {got_t.tolist()} against the "
                  f"one-device {want_t.tolist()}")
            top = float(np.abs(want_l[..., :v]).max())
            err = float(np.abs(got_l[..., :v].astype(np.float64)
                               - want_l[..., :v]).max()) / top
            worst = max(worst, err)
            check(err <= LM_ATTN_BAR,
                  f"LM TP rank {r}: logits {err} of the largest |logit| "
                  f"off the one-device ones (bar {LM_ATTN_BAR})")
        check(kernels.counts() == launches_before,
              "LM TP launched a kernel of K1-K4")
        tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
        r0 = ranks[0]
        for i, row in enumerate(r0["train"]["steps"]):
            log(f"LM TP train step {i}{' (warm)' if i else ' (first)'}: "
                f"rank 0 {row['ms']:.2f} ms (ranks "
                + ", ".join(f"{rk['train']['steps'][i]['ms']:.2f}"
                            for rk in ranks)
                + f"), {tokens / (row['ms'] * 1e-3):.1f} tokens/s; loss "
                f"{row['loss']:.6f} (one device {one[i]['loss']:.6f}, "
                f"{one[i]['ms']:.2f} ms), grad norm {row['grad_norm']:.6f} "
                f"({one[i]['grad_norm']:.6f}); rank 0's bytes "
                + json.dumps(row["nbytes"]) + "; its seconds in collectives "
                + json.dumps({k: round(s, 4) for k, s in
                              row["seconds"].items()}) + f" ({card})")
        sv = r0["serve"]
        log(f"LM TP serving ({LM_TP_SERVE_LAYERS} layers, f32): prefill "
            f"{sv['prefill_ms']:.2f} ms (ranks "
            + ", ".join(f"{rk['serve']['prefill_ms']:.2f}" for rk in ranks)
            + f"), decode {sv['decode_ms_per_token']:.2f} ms/token (ranks "
            + ", ".join(f"{rk['serve']['decode_ms_per_token']:.2f}"
                        for rk in ranks)
            + f"); tokens equal the one-device ones on every rank, logits "
            f"within {worst:.3e} of their largest |logit|; rank 0's prefill "
            f"bytes " + json.dumps(sv["prefill"]["nbytes"]) + ", seconds "
            + json.dumps({k: round(s, 4) for k, s in
                          sv["prefill"]["seconds"].items()})
            + "; a decode step's bytes " + json.dumps(sv["decode"][0][
                "nbytes"]) + f" ({card})")
        gib = 2 ** 30
        log("LM TP ranks' peaks: train "
            + ", ".join(f"{(rk['train']['peak_bytes'] or 0) / gib:.3f}"
                        for rk in ranks)
            + f" GiB against the reckoned {reck['total'] / gib:.3f} GiB; "
            "prefill "
            + ", ".join(f"{(rk['serve']['prefill_peak_bytes'] or 0) / gib:.3f}"
                        for rk in ranks)
            + ", decode "
            + ", ".join(f"{(rk['serve']['decode_peak_bytes'] or 0) / gib:.3f}"
                        for rk in ranks) + f" GiB ({card})")
        traced = {"train": lm_train_traced(cfg, lm_tp_mesh(
            ranks[0]["coords"])), **lm_tp_serve_traced(scfg,
                                                        ranks[0]["coords"])}
        seconds = time.perf_counter() - t_phase
        log(f"LM TP: children {children_s:.1f} s; phase 15 {seconds:.1f} s "
            f"({card})")
        return {"config": cfg.name, "layers": LM_TP_LAYERS,
                "serve_layers": LM_TP_SERVE_LAYERS, "params": n_params,
                "transport": transport, "reckoned_rank_bytes": reck,
                "one_device": one, "ranks": ranks, "traced": traced,
                "logits_worst": worst, "children_s": children_s,
                "seconds": seconds}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def lm_tp_mesh(coords: dict):
    from repro_torch.launch.mesh import MeshShape, RecordingMesh
    return RecordingMesh(MeshShape(dict(zip(LM_MESH_AXES, LM_MESH_SHAPE)),
                                   LM_MESH_AXES), coords)


# ---------------------------------------------------------------------------
# phase 14: the LM dry-run held against the card
# ---------------------------------------------------------------------------

# phase 11's model whose serving the dry-run traces, and the dry-run cell
# run on the card as launch/specs.py builds it
LM_DRY_ARCH, LM_DRY_SHAPE = "glm4-9b", "decode_32k"
# a traced peak against the card's max_memory_allocated (less what earlier
# phases still held): the share of the measured peak they may differ by
LM_DRY_PEAK_TOL = 0.10


def counted_flops(fn) -> int:
    """``fn()``'s flops by ``torch.utils.flop_counter.FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def lm_serve_traced(cfg, prompt: int) -> dict:
    """Phase 11's f32 serving of ``cfg``, each program traced by
    ``launch/dryrun.py::measure`` on the meta device: ``run``, the served
    run of ``launch/serve.py`` (a prefill of the LM_REQUESTS x ``prompt``
    batch into caches of ``prompt`` + LM_GEN slots, then LM_GEN - 1
    greedy decode steps); ``prefill`` and ``decode``, phase 11's warm
    steps (caches of ``prompt`` + 1 slots)."""
    from repro_torch.launch.dryrun import measure
    from repro_torch.models import steps
    f32 = torch.float32
    model = steps.model_module(cfg).init_params(cfg, None, device="meta")
    batch = {"tokens": torch.empty((LM_REQUESTS, prompt), dtype=torch.int64,
                                   device="meta")}

    def served(model, batch):
        prefill = steps.make_prefill_step(cfg, cache_len=prompt + LM_GEN,
                                          compute_dtype=f32)
        decode = steps.make_decode_step(cfg, compute_dtype=f32)
        logits, caches = prefill(model, batch)
        toks = [torch.argmax(logits[:, -1], dim=-1)[:, None]]
        for i in range(LM_GEN - 1):
            tok, _, caches = decode(model, caches, toks[-1], prompt + i)
            toks.append(tok)
        return torch.cat(toks, dim=1)

    prefill = steps.make_prefill_step(cfg, cache_len=prompt + 1,
                                      compute_dtype=f32)
    decode = steps.make_decode_step(cfg, compute_dtype=f32)
    _, caches = prefill(model, batch)   # the warm decode's caches
    tokens = torch.empty((LM_REQUESTS, 1), dtype=torch.int64, device="meta")
    return {"run": measure(served, {"model": model, "batch": batch}),
            "prefill": measure(prefill, {"model": model, "batch": batch}),
            "decode": measure(decode, {"model": model, "caches": caches,
                                       "tokens": tokens, "pos": prompt})}


def lm_train_traced(cfg, mesh=None) -> dict:
    """Phase 12's (``mesh`` None) or a phase 13 rank's train step, traced
    by ``launch/dryrun.py::measure`` on the meta device: the state (this
    rank's blocks on a mesh) and the LM_TRAIN_BATCH x LM_TRAIN_SEQ batch
    live from the start, one step, with the collectives the recording
    mesh tallied."""
    from repro_torch.launch.dryrun import measure
    from repro_torch.models import steps
    from repro_torch.optim import AdamWConfig
    opt = AdamWConfig(lr=LM_TRAIN_LR)
    state = steps.init_train_state(cfg, None, opt, device="meta", mesh=mesh)
    batch = {"tokens": torch.empty((LM_TRAIN_BATCH, LM_TRAIN_SEQ),
                                   dtype=torch.int64, device="meta")}
    step = steps.make_train_step(cfg, opt, mesh=mesh, compute_dtype=BF16)
    return measure(step, {"state": state, "batch": batch}, mesh)


def lm_mesh_traced(cfg, coords: dict) -> dict:
    """A phase 13 rank (at ``coords`` of the 2x2 mesh) traced on the meta
    device with a recording mesh (``launch/mesh.py::RecordingMesh``)."""
    return lm_train_traced(cfg, lm_tp_mesh(coords))


def _on_card(obj, dev, gen, vocab: int):
    """A dry-run cell's meta-device arguments made on ``dev``: a module's
    parameters drawn N(0, 0.02^2) from ``gen`` in their dtypes, token ids
    uniform below ``vocab``, every other tensor (the caches) zero; in
    nested containers; anything else as it is."""
    if isinstance(obj, torch.nn.Module):
        obj = obj.to_empty(device=dev)
        with torch.no_grad():
            for p in obj.parameters():
                p.normal_(0.0, 0.02, generator=gen)
        return obj
    if isinstance(obj, dict):
        return {k: (torch.randint(vocab, v.shape, device=dev, generator=gen)
                    if k == "tokens" else _on_card(v, dev, gen, vocab))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_on_card(v, dev, gen, vocab) for v in obj)
    if isinstance(obj, torch.Tensor):
        return torch.zeros(obj.shape, dtype=obj.dtype, device=dev)
    return obj


def lm_dry_cell(dev, arch: str, shape_name: str) -> dict:
    """The dry-run cell ``arch`` x ``shape_name`` on ``pod``, as the rank
    at coordinates 0 runs it (``launch/specs.py::input_specs``: for
    serving, ``serving_params``' bf16 weights with f32 output
    projections, this rank's rows and caches): traced by
    ``launch/dryrun.py::measure`` on the meta device, then the same
    arguments made on the card from seed 0 (:func:`_on_card`) and the
    step run once for the peak (``max_memory_allocated`` less what was
    allocated before), once under ``FlopCounterMode``, then timed."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import RecordingMesh, make_production_mesh
    mesh = RecordingMesh(make_production_mesh())
    fn, kwargs, _ = specs.input_specs(arch, shape_name, mesh)
    traced = dryrun.measure(fn, kwargs, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = _on_card(kwargs, dev, gen, configs.get(arch).vocab_size)
    fn(**card)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.max_memory_reserved(dev)
    counted = counted_flops(lambda: fn(**card))
    ms = time_ms(lambda: fn(**card), 3, 1)
    del card
    gc.collect()
    torch.cuda.empty_cache()
    return {"traced": traced, "measured_ms": ms, "counted": counted,
            "peak": peak, "before": before, "reserved": reserved}


def _bound_ms(span: dict, bw: float) -> dict:
    """The roofline bound of a traced span at copy rate ``bw``: its
    matmul flops at the H100's peak for their dtype, its bytes at ``bw``,
    the larger."""
    from repro_torch.launch.dryrun import compute_seconds
    compute_ms = compute_seconds(span["flops_by_dtype"]) * 1e3
    memory_ms = span["bytes"] / bw * 1e3
    return {"compute_ms": compute_ms, "memory_ms": memory_ms,
            "bound_ms": max(compute_ms, memory_ms),
            "bound_by": "operations" if compute_ms >= memory_ms else "bytes"}


def dryrun_phase(dev, card: str, bw: float, lm: dict, lm_train: dict,
                 lm_mesh: dict, lm_tp: dict) -> dict:
    """Phase 14: the LM dry-run's measure (``launch/dryrun.py::measure``
    on the meta device, in this process) of the configurations phases
    11-13 and 15 ran (phase 15's train step, prefill and decode step of a
    rank), and of one dry-run cell as ``launch/specs.py``
    builds it (glm4-9b decode_32k on ``pod``: bf16 serving), held against
    the card: the traced matmul flops equal to ``FlopCounterMode``'s count
    of one more untimed step on the card; the recording mesh's bytes
    equal to a phase 13 rank's ``Mesh.nbytes`` every step; every measured
    wall at or above its roofline bound at phase 1's copy rate; each
    traced peak within LM_DRY_PEAK_TOL of the card's
    ``max_memory_allocated``.  It also prints what the dry-run's ``fits``
    holds a peak against: the card's ``total_memory`` and its CUDA
    context.  It launches none of K1-K4."""
    from repro_torch import configs, kernels
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    launches_before = kernels.counts()
    free, total = torch.cuda.mem_get_info(dev)
    context = total - free - torch.cuda.memory_reserved(dev)
    total_memory = torch.cuda.get_device_properties(dev).total_memory
    log(f"dry run: total_memory {total_memory} bytes (the dry-run's "
        f"{dryrun.HBM_BYTES}: equal {total_memory == dryrun.HBM_BYTES}); "
        f"the CUDA context holds {context} bytes of it (mem_get_info: total "
        f"{total}, free {free}, less torch's reserve "
        f"{torch.cuda.memory_reserved(dev)}; within the dry-run's "
        f"{dryrun.CONTEXT_BYTES}: {context <= dryrun.CONTEXT_BYTES}) "
        f"({card})")
    serve_cfg = configs.get(LM_DRY_ARCH)
    served = lm["served"][LM_DRY_ARCH]
    prompt = served["prompt"]
    rows = {}

    def held(name, measured_ms, span, counted, measured_peak, peak,
             before=0):
        """One row: ``measured_peak`` (max_memory_allocated) less
        ``before``, what was allocated before the run, is the run's
        own."""
        b = _bound_ms(span, bw)
        if measured_peak:
            measured_peak -= before
        row = {"measured_ms": measured_ms, **b,
               "traced_flops": int(span["flops"]), "counted_flops": counted,
               "traced_bytes": int(span["bytes"]),
               "measured_peak_bytes": measured_peak,
               "held_before_bytes": before,
               "traced_peak_bytes": peak["peak_bytes"],
               "peak_holds": dict(list(peak["peak_holds"].items())[:8])}
        if measured_peak:
            row["peak_ratio"] = peak["peak_bytes"] / measured_peak
        rows[name] = row
        check(row["traced_flops"] == counted,
              f"dry run {name}: traced flops {row['traced_flops']} against "
              f"FlopCounterMode's {counted} on the card")
        check(measured_ms >= b["bound_ms"],
              f"dry run {name}: measured {measured_ms:.3f} ms under its "
              f"bound {b['bound_ms']:.3f} ms")
        check(not measured_peak
              or abs(row["peak_ratio"] - 1.0) <= LM_DRY_PEAK_TOL,
              f"dry run {name}: traced peak {peak['peak_bytes']} bytes "
              f"against the measured {measured_peak}")
        peak_txt = "not measured" if not measured_peak else (
            f"{measured_peak / 2 ** 30:.3f} GiB measured (less "
            f"{before / 2 ** 30:.3f} GiB allocated before), traced "
            f"{peak['peak_bytes'] / 2 ** 30:.3f} GiB (ratio "
            f"{row['peak_ratio']:.4f})")
        log(f"dry run {name}: measured {measured_ms:.3f} ms >= bound "
            f"{b['bound_ms']:.3f} ms (compute {b['compute_ms']:.3f} ms at "
            f"the H100's f32/bf16 peaks, memory {b['memory_ms']:.3f} ms of "
            f"{span['bytes'] / 1e9:.3f} GB at {bw / 1e9:.1f} GB/s); flops "
            f"traced {row['traced_flops']} = counted {counted}; peak "
            f"{peak_txt}, holding "
            + ", ".join(f"{k} {v / 2 ** 30:.3f}" for k, v in
                        list(peak["peak_holds"].items())[:6])
            + f" GiB ({card})")

    # phase 11: glm4-9b served whole in f32 (the peak: launch/serve.py's
    # run; the counts and walls: phase 11's warm prefill and decode)
    tr11 = lm_serve_traced(serve_cfg, prompt)
    peak_11 = (None if served["peak_gib"] is None
               else served["peak_gib"] * 2 ** 30)
    fc = served["warm"]["flops_counted"]
    for what in ("prefill", "decode"):
        held(f"phase 11 {LM_DRY_ARCH} {what}", served["warm"][f"{what}_ms"],
             tr11[what], fc[what], peak_11, tr11["run"],
             served["allocated_before"])

    # phase 12: the 8-layer train step on one device
    tcfg = dataclasses.replace(configs.get(LM_TRAIN_ARCH),
                               num_layers=LM_TRAIN_LAYERS)
    tr12 = lm_train_traced(tcfg)
    fw = lm_train["full_width"]
    peaks = [r["peak_gib"] for r in fw["steps"] if r["peak_gib"]]
    held(f"phase 12 {LM_TRAIN_ARCH} {LM_TRAIN_LAYERS} layers train step",
         fw["warm_ms_median"], tr12, fw["flops_counted"],
         max(peaks) * 2 ** 30 if peaks else None, tr12,
         fw["allocated_before"])

    # phase 13: a rank of the 2x2 mesh
    tr13 = lm_mesh["traced"]
    want = tr13["collectives"]["nbytes"]
    ranks = lm_mesh["ranks"]
    counted = {rk["flops_counted"] for rk in ranks}
    check(len(counted) == 1, f"phase 13 ranks counted different flops "
                             f"{counted}")
    for r, rk in enumerate(ranks):
        for i, st in enumerate(rk["steps"]):
            got = {k: v for k, v in st["nbytes"].items() if v}
            check(got == want,
                  f"dry run: phase 13 rank {r} step {i} moved {got}, the "
                  f"recording mesh {want}")
    log("dry run: the recording mesh's bytes a step equal every phase 13 "
        "rank's Mesh.nbytes every step: " + json.dumps(want) + f" ({card})")
    peaks = [rk["peak_bytes"] for rk in ranks if rk["peak_bytes"]]
    r0 = [st["ms"] for st in ranks[0]["steps"][1:]]
    held(f"phase 13 rank ({LM_MESH_LAYERS} layer, 2x2) train step",
         statistics.median(r0), tr13, counted.pop(),
         max(peaks) if peaks else None, tr13)

    # phase 15: a rank of the tensor-parallel 2x2 mesh, its train step,
    # prefill and decode step; every rank's bytes each call against the
    # recording mesh's
    tr15, ranks15 = lm_tp["traced"], lm_tp["ranks"]
    calls = {"train": [st["nbytes"] for rk in ranks15
                       for st in rk["train"]["steps"]],
             "prefill": [rk["serve"]["prefill"]["nbytes"] for rk in ranks15],
             "decode": [st["nbytes"] for rk in ranks15
                        for st in rk["serve"]["decode"]]}
    for what, seen in calls.items():
        want = tr15[what]["collectives"]["nbytes"]
        bad = [got for got in seen if got != want]
        check(not bad, f"dry run: a phase 15 rank's {what} moved {bad[:1]}, "
                       f"the recording mesh {want}")
        log(f"dry run: the recording mesh's bytes of a phase 15 {what} call "
            f"equal every rank's Mesh.nbytes of every call: "
            + json.dumps(want) + f" ({card})")
    gib = {what: max((rk[part][key] for rk in ranks15
                      if rk[part][key]), default=None)
           for what, part, key in (("train", "train", "peak_bytes"),
                                   ("prefill", "serve", "prefill_peak_bytes"),
                                   ("decode", "serve", "decode_peak_bytes"))}
    counted = {what: {rk[part][key] for rk in ranks15}
               for what, part, key in (
                   ("train", "train", "flops_counted"),
                   ("prefill", "serve", "prefill_flops_counted"),
                   ("decode", "serve", "decode_flops_counted"))}
    for what, c in counted.items():
        check(len(c) == 1, f"phase 15 ranks counted different {what} flops "
                           f"{c}")
    sv = ranks15[0]["serve"]
    held(f"phase 15 rank ({LM_TP_LAYERS} layers, 2x2, TP) train step",
         statistics.median(st["ms"] for st in
                           ranks15[0]["train"]["steps"][1:]),
         tr15["train"], counted["train"].pop(), gib["train"], tr15["train"])
    held(f"phase 15 rank ({LM_TP_SERVE_LAYERS} layers, 2x2, TP) f32 prefill",
         sv["prefill_ms"], tr15["prefill"], counted["prefill"].pop(),
         gib["prefill"], tr15["prefill"])
    held(f"phase 15 rank ({LM_TP_SERVE_LAYERS} layers, 2x2, TP) f32 decode "
         "step", sv["decode_ms_per_token"], tr15["decode"],
         counted["decode"].pop(), gib["decode"], tr15["decode"])

    # a dry-run cell as launch/specs.py builds it: bf16 serving
    cell = lm_dry_cell(dev, LM_DRY_ARCH, LM_DRY_SHAPE)
    held(f"cell {LM_DRY_ARCH} {LM_DRY_SHAPE} pod (bf16, f32 output "
         "projections)", cell["measured_ms"], cell["traced"],
         cell["counted"], cell["peak"], cell["traced"], cell["before"])
    log(f"dry run cell {LM_DRY_ARCH} {LM_DRY_SHAPE}: the allocator reserved "
        f"{cell['reserved'] / 2 ** 30:.3f} GiB at most for "
        f"{cell['peak'] / 2 ** 30:.3f} GiB allocated ({card})")
    check(kernels.counts() == launches_before,
          "the dry run launched a kernel of K1-K4")
    seconds = time.perf_counter() - t0
    log(f"dry run: phase 14 launched none of K1-K4 (the LM layers are "
        f"plain torch); {seconds:.1f} s ({card})")
    return {"rows": rows, "seconds": seconds,
            "total_memory": total_memory, "context_bytes": context,
            "cell_reserved_bytes": cell["reserved"],
            "mesh_counted_step_s": [rk["counted_step_s"] for rk in ranks]}


def main() -> int:
    if "--mesh-rank" in sys.argv:
        i = sys.argv.index
        return mesh_child(int(sys.argv[i("--mesh-rank") + 1]),
                          Path(sys.argv[i("--mesh-dir") + 1]))
    if "--lm-mesh-rank" in sys.argv:
        i = sys.argv.index
        return lm_mesh_child(int(sys.argv[i("--lm-mesh-rank") + 1]),
                             Path(sys.argv[i("--lm-mesh-dir") + 1]))
    if "--lm-tp-rank" in sys.argv:
        i = sys.argv.index
        return lm_tp_child(int(sys.argv[i("--lm-tp-rank") + 1]),
                           Path(sys.argv[i("--lm-tp-dir") + 1]))
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
    errs["cg_update_bf16"], errs["cg_xpay_bf16"] = check_cg_narrow(dev, gen)
    errs["wilson_full_bf16"] = max(
        [check_full(dev, gen, dims, dtype=BF16) for dims in (
            (8, 8, 8, 8), (4, 4, 8, 32), (4, 4, 22, 16), (4, 4, 6, 5),
            (2, 2, 2, 348), (2, 2, 2, 464), (2, 2, 2, 928))]
        + [check_full(dev, gen, (4, 4, 6, 8), which, BF16)
           for which in ("psi", "gauge")])
    # the float16 instances at the bf16 shapes
    errs["wilson_hop_f16"] = max(check_hop(dev, gen, dims, F16) for dims in (
        (8, 8, 8, 8), (4, 6, 8, 16), (4, 4, 4, 4), (4, 4, 6, 6),
        (4, 4, 22, 8), (2, 2, 2, 348), (2, 2, 2, 700)))
    errs["cg_update_f16"], errs["cg_xpay_f16"] = check_cg_narrow(dev, gen,
                                                                 F16)
    errs["wilson_full_f16"] = max(
        [check_full(dev, gen, dims, dtype=F16) for dims in (
            (8, 8, 8, 8), (4, 4, 8, 32), (4, 4, 22, 16), (4, 4, 6, 5),
            (2, 2, 2, 348), (2, 2, 2, 464), (2, 2, 2, 928))]
        + [check_full(dev, gen, (4, 4, 6, 8), which, F16)
           for which in ("psi", "gauge")])
    # the 16-bit Wilson checks above: even Xh (K1) and X = 32 (K4) ran the
    # pair instances, the other shapes the one-site instances
    c, pairs = kernels.counts(), kernels.pair_launches()
    for name in pairs:
        n = c[name]["launches"]
        check(0 < pairs[name] < n, f"16-bit checks: {name} ran its pair "
                                   f"instance {pairs[name]} of {n} times")
        log(f"16-bit checks: {name} pair instance {pairs[name]} of {n} "
            "launches, one-site the rest")
    # each pair instance bitwise against its one-site instance (at 16^3 x
    # 32 a different rounding would show in a few hundred entries)
    for dtype in (BF16, F16):
        log(f"pair against one-site, bitwise, {dtype}: "
            + json.dumps(check_pairs(dev, gen, (16, 16, 16, 32), dtype)))
    # K4's float16 pair instance at N = 1-5, at 16^3 x 32 and at odd T, Z,
    # Y (one 7-row tile)
    f16_full = [check_f16_full(dev, gen, dims)
                for dims in ((16, 16, 16, 32), (3, 5, 7, 32))]
    log("K4 float16 pair against one-site and singles, bitwise, N = 1-5: "
        + json.dumps(f16_full))
    errs["wilson_full_f16"] = max(errs["wilson_full_f16"],
                                  *(r["max_abs_err"] for r in f16_full))
    log("float16 narrowing of small values bitwise torch's cast: "
        + json.dumps(check_f16_narrowing(dev, gen)))
    log("kernels: " + json.dumps({k: {"max_abs_err": v}
                                  for k, v in errs.items()}))
    phase_done(2)

    # phase 3: goldens
    log("goldens: " + json.dumps(goldens(dev)))

    phase_done(3)

    # phase 4: main path
    u, b, batch, batch16, basis, runs = main_path(dev)
    base = ("wilson_hop", "cg_update", "cg_xpay", "wilson_full")
    names = base + tuple(k + sfx for sfx in ("_bf16", "_f16") for k in base)
    total = {k: sum(r["launches"][k] for r in runs.values()) for k in names}
    pair_total = {k + sfx: sum(r["pair_launches"][k + sfx]
                               for r in runs.values())
                  for k in ("wilson_hop", "wilson_full")
                  for sfx in ("_bf16", "_f16")}
    phase_done(4)

    # phase 5: timings at the main path's shapes
    length = b.numel()  # packed reals of one half field: V/2 sites x 24
    timings = {}
    for n in (1, 4):
        t = {"wilson_hop": time_hop(u, b, batch, bw, n)}
        t.update(time_cg(dev, bw, n, length))
        t["wilson_full"] = time_full(u, b, batch, bw, n)
        for dtype in (BF16, F16):
            sfx = SUFFIX[dtype]
            t["wilson_hop" + sfx] = time_hop(u, b, batch, bw, n, dtype)
            t.update({k + sfx: v for k, v in
                      time_cg(dev, bw, n, length, dtype).items()})
            t["wilson_full" + sfx] = time_full(u, b, batch, bw, n, dtype)
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
    n8["wilson_full_f16"] = time_full(u, b, batch16[:8], bw, 8, F16)
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

    # phase 9: multi-device solves on a 2x2 mesh
    del u, b, batch, batch16, basis
    torch.cuda.empty_cache()
    meshed = mesh_phase(dev, card)
    phase_done(9)

    # phase 10: the launch space
    torch.cuda.empty_cache()
    tiles = launch_space(dev, card, bw)
    phase_done(10)

    # phase 11: the LM serving path
    torch.cuda.empty_cache()
    log(f"LM phase: {torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB "
        "still allocated by earlier phases")
    lm = lm_phase(dev, card, bw)
    phase_done(11)

    # phase 12: LM training on one device
    torch.cuda.empty_cache()
    log(f"LM train phase: {torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} "
        "GiB still allocated by earlier phases")
    lm_train = lm_train_phase(dev, card)
    phase_done(12)

    # phase 13: data-parallel LM training on a 2x2 mesh
    torch.cuda.empty_cache()
    log(f"LM mesh train phase: "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} GiB still "
        "allocated by earlier phases")
    lm_mesh = lm_mesh_phase(dev, card)
    phase_done(13)

    # phase 15: tensor-parallel LM training and serving on a 2x2 mesh (run
    # before phase 14, which holds its steps too)
    torch.cuda.empty_cache()
    log(f"LM TP phase: {torch.cuda.memory_allocated(dev) / 2 ** 30:.3f} "
        "GiB still allocated by earlier phases")
    lm_tp = lm_tp_phase(dev, card)
    phase_done(15)

    # phase 14: the LM dry-run held against phases 11-13 and 15
    dry = dryrun_phase(dev, card, bw, lm, lm_train, lm_mesh, lm_tp)
    phase_done(14)

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
        kernel = name.removesuffix("_bf16").removesuffix("_f16")
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
            "serving": served["launches"].get(name, 0),
            "mesh_rank0": meshed["launches"].get(name, 0)}
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
    log("mesh: " + json.dumps(meshed))
    log("launch space: " + json.dumps(tiles))
    log("lm: " + json.dumps(lm))
    log("lm train: " + json.dumps(lm_train))
    log("lm mesh train: " + json.dumps(lm_mesh))
    log("lm dry run: " + json.dumps(dry))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
