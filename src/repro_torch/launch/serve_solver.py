"""Solver-serving launcher: a continuous-batching solve service under load.

    python -m repro_torch.launch.serve_solver --requests 200 --burst 4
    python -m repro_torch.launch.serve_solver --lattice 64x32x32x32 \
        --gauges 1 --requests 32 --burst 4 --ladder 1,4,8
    python -m repro_torch.launch.serve_solver --device cpu \
        --backend reference --requests 16 --verify

Stands up :class:`repro_torch.serve.SolverServer` (queue, coalesce, pad
to the batch-shape ladder, masked batched even-odd Schur CGNR through the
kernels, per-request return), registers ``--gauges`` random hot gauge
fields, warms the ladder (the kernels are built there), then drives the
open-loop load generator: bursts of ``--burst`` requests every
``--interarrival-ms``, cycling gauge fields, operator families and a pool
of right-hand sides.  Reports requests/s, p50/p99 latency, the batch-size
histogram and plan-cache hit rates; ``--verify`` re-solves every response
through a direct unbatched ``plan.solve`` and fails on a deviation over
1e-5.  The flags are the JAX launcher's, with ``--backend
reference|kernels`` (default ``kernels``) and ``--device`` (default
``cuda``).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.serve.loadgen import WorkloadConfig, run_workload

# family name -> its mu parameter when selected (0 for families without one)
_FAMILY_MU = {"wilson": 0.0, "twisted-mass": 0.25}


def build_config(args) -> WorkloadConfig:
    """Resolve the CLI axes to a WorkloadConfig (pure; unit-tested)."""
    lattice = tuple(int(v) for v in args.lattice.split("x"))
    if len(lattice) != 4:
        raise ValueError(f"--lattice must be TxZxYxX, got {args.lattice!r}")
    families = []
    for name in args.families.split(","):
        name = name.strip()
        if name not in _FAMILY_MU:
            raise ValueError(f"unknown family {name!r}; known: "
                             f"{sorted(_FAMILY_MU)}")
        families.append((name, args.mu if name == "twisted-mass"
                         else _FAMILY_MU[name]))
    ladder = tuple(int(v) for v in args.ladder.split(","))
    return WorkloadConfig(
        lattice=lattice, n_gauge=args.gauges, families=tuple(families),
        mass=args.mass, tol=args.tol, requests=args.requests,
        burst=args.burst, interarrival_s=args.interarrival_ms / 1e3,
        rhs_pool=args.rhs_pool, seed=args.seed, ladder=ladder,
        max_wait_s=args.max_wait_ms / 1e3, max_batch=args.max_batch,
        backend=args.backend, device=args.device, maxiter=args.maxiter,
        warmup=not args.no_warmup, verify=args.verify,
        deadline_s=args.deadline_ms / 1e3 if args.deadline_ms else None,
        chaos=args.chaos, chaos_poison_fraction=args.chaos_poison_fraction,
        chaos_fault_every=args.chaos_fault_every,
        chaos_fault_mode=args.chaos_fault_mode,
        journal_dir=args.journal_dir,
        deflation_nev=args.deflation_nev,
        deflation_m_max=args.deflation_m_max,
        deflation_harvest_tol=args.deflation_harvest_tol)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lattice", default="4x4x4x4", help="TxZxYxX extents")
    p.add_argument("--gauges", type=int, default=2,
                   help="number of hot gauge fields")
    p.add_argument("--families", default="wilson,twisted-mass",
                   help="comma list of operator families to mix")
    p.add_argument("--mu", type=float, default=0.25,
                   help="twisted-mass site parameter")
    p.add_argument("--mass", type=float, default=0.1)
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--burst", type=int, default=4,
                   help="requests fired per arrival instant")
    p.add_argument("--interarrival-ms", type=float, default=50.0,
                   help="open-loop spacing between bursts")
    p.add_argument("--rhs-pool", type=int, default=8,
                   help="distinct right-hand sides cycled across requests")
    p.add_argument("--ladder", default="1,4,8",
                   help="comma list of pre-compiled batch shapes")
    p.add_argument("--max-wait-ms", type=float, default=250.0,
                   help="batching deadline from the first queued request")
    p.add_argument("--max-batch", type=int, default=None,
                   help="dispatch cap (default: top ladder rung)")
    p.add_argument("--backend", choices=["reference", "kernels"],
                   default="kernels")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions")
    p.add_argument("--maxiter", type=int, default=500)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--no-warmup", action="store_true",
                   help="skip building the kernels before the load (the "
                        "first batch pays for it)")
    p.add_argument("--verify", action="store_true",
                   help="re-solve every response directly and compare")
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline; expired requests fail with "
                        "SolveTimeout without consuming a batch slot")
    p.add_argument("--chaos", action="store_true",
                   help="poison a fraction of the RHS stream and (with "
                        "--chaos-fault-every) inject transient faults; "
                        "report goodput + containment counters")
    p.add_argument("--chaos-poison-fraction", type=float, default=0.1,
                   help="fraction of requests given a corrupted RHS "
                        "(alternating NaN and overflow poisons)")
    p.add_argument("--chaos-fault-every", type=int, default=0,
                   help="fire a transient fault on every N-th primary "
                        "batch dispatch (0 = off)")
    p.add_argument("--chaos-fault-mode", default="gauge_nan_plane",
                   choices=["gauge_nan_plane", "gauge_bitflip", "stall",
                            "raise"],
                   help="transient fault model for --chaos-fault-every")
    p.add_argument("--journal-dir", default=None,
                   help="write-ahead journal directory: "
                        "admitted requests become durable; after a crash, "
                        "SolverServer.recover() replays the incomplete "
                        "entries")
    p.add_argument("--deflation-nev", type=int, default=0,
                   help="EigCG deflation basis size per (gauge, operator) "
                        "coalesce key (0 = off); the first verified solve "
                        "on each key harvests the basis, later requests "
                        "start deflated and converge in fewer iterations")
    p.add_argument("--deflation-m-max", type=int, default=160,
                   help="Lanczos-vector recording depth of the harvest "
                        "solve")
    p.add_argument("--deflation-harvest-tol", type=float, default=None,
                   help="harvest-solve tolerance (default: the triggering "
                        "request's tol; tighter = deeper Krylov space = "
                        "better basis on ill-conditioned operators)")
    p.add_argument("--out", default=None,
                   help="write the JSON report here")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    try:
        cfg = build_config(args)
    except ValueError as e:
        print(f"[serve_solver] invalid config: {e}")
        return 1
    print(f"[serve_solver] lattice={args.lattice} gauges={cfg.n_gauge} "
          f"families={[f for f, _ in cfg.families]} "
          f"requests={cfg.requests} burst={cfg.burst} "
          f"ladder={list(cfg.ladder)} backend={cfg.backend} "
          f"device={cfg.device}")
    report = run_workload(cfg)
    lat = report["latency_ms"]
    print(f"[serve_solver] {report['requests']} requests in "
          f"{report['wall_s']:.2f}s = {report['requests_per_s']:.1f} req/s")
    print(f"[serve_solver] latency p50={lat['p50']:.1f}ms "
          f"p99={lat['p99']:.1f}ms mean={lat['mean']:.1f}ms")
    print(f"[serve_solver] batches={report['batches']} "
          f"batch_hist={report['batch_hist']} "
          f"padded_slots={report['padded_slots']}")
    ok = bool(report["all_converged"])
    if not ok:
        print("[serve_solver] FAIL: not every served request converged "
              "and verified")
    if "chaos" in report:
        c = report["chaos"]
        print(f"[serve_solver] chaos: poisoned={c['poisoned']} "
              f"(failed={c['poisoned_failed']} "
              f"served={c['poisoned_served']}) healthy={c['healthy']} "
              f"(ok={c['healthy_ok']} failed={c['healthy_failed']} "
              f"unverified={c['healthy_unverified']} "
              f"rescued={c['healthy_rescued_by_retry']})")
        print(f"[serve_solver] chaos: goodput={c['goodput_rps']:.1f} req/s "
              f"failure_verdicts={c['failure_verdicts']} "
              f"containment={'OK' if c['containment_ok'] else 'FAIL'}")
        ok = ok and c["containment_ok"]
    if "deflation_drop" in report:
        d = report["deflation_drop"]
        cache = report["deflation"]
        print(f"[serve_solver] deflation: {cache['harvests']} harvests, "
              f"{d['hit_requests']} cache-hit requests "
              f"(hit_rate={cache['hit_rate']:.3f}), iteration drop "
              f"{'OK' if d['all_hits_dropped'] else 'FAIL'}")
        ok = ok and d["all_hits_dropped"] and d["hit_requests"] > 0
    if "verify" in report:
        v = report["verify"]
        print(f"[serve_solver] verify: {v['checked']} responses vs "
              f"{v['direct_solves']} direct solves, "
              f"max_abs_err={v['max_abs_err']:.2e} "
              f"({'OK' if v['passed'] else 'FAIL'})")
        ok = ok and v["passed"]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"[serve_solver] wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
