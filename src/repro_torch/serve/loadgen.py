"""Synthetic open-loop load generator for the solver server.

Open-loop means arrival times are fixed by the workload (bursts of
``burst`` requests every ``interarrival_s`` seconds), NOT by service
completions — the generator never waits for a response before firing the
next request, so a slow server accumulates backlog and the latency
percentiles honestly include queueing.  This is the standard serving-
benchmark discipline (closed-loop generators hide overload).

The workload models the production shape the ROADMAP names: a small set
of hot gauge fields (``n_gauge``), several operator families
(wilson + twisted-mass by default), and a pool of distinct right-hand
sides cycled deterministically across requests — every (gauge, family)
pair sees traffic, so the plan cache and every per-gauge queue are
exercised.

``run_workload`` is the sync entry point: builds the fields, drives the
server under ``asyncio.run``, and returns the report (requests/s,
p50/p99 latency, batch-size histogram, plan-cache counters, iteration
stats), the JAX package's ``BENCH_serve.json`` schema.  With
``verify=True`` every response is re-solved through a direct unbatched
``plan.solve`` and compared (max abs deviation <= 1e-5).

The fields come from a ``torch.Generator`` seeded with ``seed`` on the
server's device (torch cannot replay ``jax.random``), so the port's
workload has the JAX package's shape, not its numbers.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time

import torch

from repro_torch.core.lattice import (LatticeShape, random_gauge,
                                      random_spinor, resolve_device)
from repro_torch.serve.batching import BatchPolicy
from repro_torch.serve.server import (ServerClosed, SolveRequest,
                                      SolveResult, SolverServer)

VERIFY_TOL = 1e-5


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """A synthetic serving workload, fully determined by its fields."""

    lattice: tuple[int, int, int, int] = (4, 4, 4, 4)
    n_gauge: int = 2
    families: tuple[tuple[str, float], ...] = (("wilson", 0.0),
                                               ("twisted-mass", 0.25))
    mass: float = 0.1
    tol: float = 1e-6
    requests: int = 200
    burst: int = 4              # requests fired at each arrival instant
    interarrival_s: float = 0.05  # spacing between bursts
    rhs_pool: int = 8           # distinct right-hand sides, cycled
    seed: int = 7
    # (1, 4, 8): the smoke ladder; production ladders pass
    # serve.batching.DEFAULT_LADDER
    ladder: tuple[int, ...] = (1, 4, 8)
    max_wait_s: float = 0.25
    max_batch: int | None = None
    backend: str = "kernels"
    device: str = "cuda"
    maxiter: int = 500
    warmup: bool = True
    verify: bool = False
    # optional per-request deadline (seconds in queue before SolveTimeout)
    deadline_s: float | None = None
    # -- chaos mode: deterministic fault injection -------------------------
    chaos: bool = False
    # fraction of the stream poisoned; every round(1/f)-th request gets a
    # corrupted RHS, alternating NaN (admission-ring test) and overflow
    # (finite entries, overflowing norm — the defense-in-depth test that
    # must be caught by the solve taxonomy + verification instead)
    chaos_poison_fraction: float = 0.1
    # fire a transient gauge fault on every N-th primary batch dispatch
    # (0 = off); the server's individual clean re-solve must rescue every
    # healthy member of an affected batch
    chaos_fault_every: int = 0
    chaos_fault_mode: str = "gauge_nan_plane"
    # write-ahead journal directory: admitted requests
    # become durable and a crashed run's incomplete entries can be
    # replayed by SolverServer.recover()
    journal_dir: str | None = None
    # -- EigCG deflation: per-gauge-field basis cache ----------------------
    # 0 = off (the plain serving lane keeps its golden metrics bitwise);
    # > 0 turns on harvest-on-first-verified-solve per coalesce key and
    # the report gains a "deflation_drop" section proving hits converge
    # in strictly fewer iterations than the cold solve
    deflation_nev: int = 0
    deflation_m_max: int = 160
    # None: harvest at the triggering request's tol; ill-conditioned
    # operators want a tighter harvest (deeper Krylov space, better basis)
    deflation_harvest_tol: float | None = None


def poisoned_indices(cfg: WorkloadConfig) -> frozenset[int]:
    """Which request indices the chaos mode poisons (deterministic)."""
    if not cfg.chaos or cfg.chaos_poison_fraction <= 0:
        return frozenset()
    stride = max(1, round(1.0 / cfg.chaos_poison_fraction))
    return frozenset(range(0, cfg.requests, stride))


def build_workload(cfg: WorkloadConfig
                   ) -> tuple[dict[str, torch.Tensor], list[SolveRequest]]:
    """Deterministic gauge fields + request list for a workload config:
    one ``torch.Generator`` seeded with ``cfg.seed`` on ``cfg.device``
    draws the gauge fields, then the RHS pool."""
    from repro_torch.serve.chaos import poison_nan, poison_overflow

    lat = LatticeShape(*cfg.lattice)
    gen = torch.Generator(device=resolve_device(cfg.device))
    gen.manual_seed(cfg.seed)
    gauges = {f"cfg{g}": random_gauge(gen, lat) for g in range(cfg.n_gauge)}
    pool = [random_spinor(gen, lat) for _ in range(cfg.rhs_pool)]
    gauge_ids = sorted(gauges)
    poison = poisoned_indices(cfg)
    requests = []
    for i in range(cfg.requests):
        family, mu = cfg.families[i % len(cfg.families)]
        rhs = pool[i % cfg.rhs_pool]
        if i in poison:
            # alternate the two poison classes: NaN exercises the
            # admission ring, overflow (finite entries) must sail through
            # admission and be caught by taxonomy + verification
            rhs = (poison_nan(rhs) if (i // max(1, round(
                1.0 / cfg.chaos_poison_fraction))) % 2 == 0
                else poison_overflow(rhs))
        requests.append(SolveRequest(
            operator_family=family, mu=mu,
            gauge_id=gauge_ids[(i // len(cfg.families)) % cfg.n_gauge],
            rhs=rhs, tol=cfg.tol, deadline_s=cfg.deadline_s))
    return gauges, requests


async def drive_open_loop(server: SolverServer,
                          requests: list[SolveRequest], *, burst: int,
                          interarrival_s: float
                          ) -> tuple[list[tuple[float, object]], float]:
    """Fire the request schedule; [(latency_s, outcome)] in request order.

    An outcome is a :class:`SolveResult` OR the structured exception the
    server failed the request with — an open-loop generator must keep
    firing through failures (that is the point of the chaos lane), so
    failures are data here, not aborts.
    """

    async def fire(req: SolveRequest, delay: float):
        await asyncio.sleep(delay)
        t0 = time.perf_counter()
        try:
            result = await server.submit(req)
        except Exception as e:  # containment failures are outcomes
            return time.perf_counter() - t0, e
        return time.perf_counter() - t0, result

    t0 = time.perf_counter()
    tasks = [asyncio.ensure_future(fire(req, (i // burst) * interarrival_s))
             for i, req in enumerate(requests)]
    out = await asyncio.gather(*tasks)
    return list(out), time.perf_counter() - t0


def percentile(sorted_vals: list[float], p: float) -> float:
    """Nearest-rank percentile of an already-sorted sample."""
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def verify_against_direct(gauges: dict, requests: list[SolveRequest],
                          results: list[tuple[float, SolveResult]],
                          cfg: WorkloadConfig,
                          deflation_bases: dict | None = None) -> dict:
    """Re-solve every request through a direct unbatched plan.solve.

    The masked-freeze contract says a served solution is the iterate its
    own independent solve would have produced — so the direct solve is
    the oracle.  A response served off a deflation-cache hit is re-solved
    with the SAME basis (``deflation_bases``: the server cache snapshot):
    the contract for a deflated lane is "the iterate an independent
    DEFLATED solve would have produced".  Distinct (gauge, family, mu,
    rhs, deflated?) combinations are memoized since the workload cycles a
    finite RHS pool.
    """
    from repro_torch.core import plan as plan_mod
    bases = deflation_bases or {}
    memo: dict = {}
    max_err = 0.0
    checked = 0
    for req, (_, res) in zip(requests, results):
        if not isinstance(res, SolveResult):
            continue  # failed outcomes carry no x to verify
        checked += 1
        mass = cfg.mass if req.mass is None else float(req.mass)
        deflated = bool(res.stats.deflation_cache_hit)
        key = (req.gauge_id, req.operator_family, float(req.mu), mass,
               float(req.tol), id(req.rhs), deflated)
        x_direct = memo.get(key)
        if x_direct is None:
            plan = plan_mod.SolverPlan(
                operator="eo-schur", operator_family=req.operator_family,
                mu=float(req.mu), backend=cfg.backend)
            basis = (bases[(req.gauge_id, req.operator_family,
                            float(req.mu), mass)] if deflated else None)
            x_direct, _ = plan_mod.solve(
                plan, gauges[req.gauge_id], req.rhs, mass,
                tol=torch.tensor(float(req.tol), dtype=torch.float32),
                maxiter=cfg.maxiter, deflation=basis, device=cfg.device)
            memo[key] = x_direct
        err = float((res.x - x_direct.to(res.x.device)).abs().max())
        max_err = max(max_err, err)
    return {"checked": checked, "direct_solves": len(memo),
            "max_abs_err": max_err, "tol": VERIFY_TOL,
            "passed": max_err <= VERIFY_TOL}


def summarize_deflation(cfg: WorkloadConfig, requests: list[SolveRequest],
                        results: list[tuple[float, object]]) -> dict:
    """The warm-gauge acceptance check, per coalesce key.

    For every key: the COLD iteration count is the first served request
    that did NOT hit the deflation cache (the solve that triggered the
    harvest); every deflation-cache HIT on that key must have converged
    in strictly fewer iterations.  ``all_hits_dropped`` is the guarded
    bool (vacuously true for keys that never got a hit — the companion
    ``hit_requests`` floor keeps the check from passing emptily).
    """
    per_key: dict[tuple, dict] = {}
    hit_requests = 0
    for req, (_, res) in zip(requests, results):
        if not isinstance(res, SolveResult):
            continue
        mass = cfg.mass if req.mass is None else float(req.mass)
        key = (req.gauge_id, req.operator_family, float(req.mu), mass)
        entry = per_key.setdefault(
            key, {"cold_iters": None, "hits": 0, "hit_iters_max": 0})
        if res.stats.deflation_cache_hit:
            hit_requests += 1
            entry["hits"] += 1
            entry["hit_iters_max"] = max(entry["hit_iters_max"],
                                         res.stats.iterations)
        elif entry["cold_iters"] is None and not res.stats.retried:
            entry["cold_iters"] = res.stats.iterations
    dropped = all(
        e["hits"] == 0 or (e["cold_iters"] is not None
                           and e["hit_iters_max"] < e["cold_iters"])
        for e in per_key.values())
    return {
        "keys": {"|".join(str(v) for v in k): dict(e)
                 for k, e in sorted(per_key.items())},
        "hit_requests": hit_requests,
        "all_hits_dropped": bool(dropped),
    }


def summarize_chaos(cfg: WorkloadConfig,
                    results: list[tuple[float, object]],
                    wall_s: float, recovery: dict | None = None) -> dict:
    """Containment scorecard: goodput + blast-radius accounting.

    The chaos gate: every HEALTHY request must return a
    verified solution, every POISONED request must fail with a classified
    verdict, and nothing else may fail — blast radius exactly 1 per
    poisoned request.

    Crash accounting: requests that died with the process
    (:class:`ServerClosed`) are NOT containment failures — they are
    counted in their own ``*_crash_lost`` buckets and must be balanced by
    the recovery summary (``SolverServer.recover``) when one is supplied:
    every crash-lost healthy request must come back completed, every
    crash-lost poisoned request must come back with a classified failure.
    Every submitted request lands in exactly one bucket
    (``all_accounted``).
    """
    poison = poisoned_indices(cfg)
    healthy_ok = healthy_failed = healthy_unverified = 0
    poisoned_failed = poisoned_served = 0
    healthy_crash_lost = poisoned_crash_lost = 0
    rescued = 0
    verdict_hist: dict[str, int] = {}
    for i, (_, res) in enumerate(results):
        if isinstance(res, SolveResult):
            if i in poison:
                poisoned_served += 1  # containment HOLE: must stay 0
            elif not (res.stats.converged and res.stats.verified):
                healthy_unverified += 1  # server must never deliver this
            else:
                healthy_ok += 1
                if res.stats.retried:
                    rescued += 1
        elif isinstance(res, ServerClosed):
            # died with the process — the journal, not this run's results,
            # is responsible for these
            if i in poison:
                poisoned_crash_lost += 1
            else:
                healthy_crash_lost += 1
        else:
            verdict = getattr(res, "verdict",
                              getattr(res, "reason", type(res).__name__))
            verdict_hist[verdict] = verdict_hist.get(verdict, 0) + 1
            if i in poison:
                poisoned_failed += 1
            else:
                healthy_failed += 1
    crash_lost = healthy_crash_lost + poisoned_crash_lost
    accounted = (healthy_ok + healthy_failed + healthy_unverified
                 + poisoned_failed + poisoned_served + crash_lost)
    summary = {
        "poisoned": len(poison),
        "poisoned_failed": poisoned_failed,
        "poisoned_served": poisoned_served,
        "poisoned_crash_lost": poisoned_crash_lost,
        "healthy": len(results) - len(poison),
        "healthy_ok": healthy_ok,
        "healthy_failed": healthy_failed,
        "healthy_unverified": healthy_unverified,
        "healthy_crash_lost": healthy_crash_lost,
        "healthy_rescued_by_retry": rescued,
        "crash_lost": crash_lost,
        "resumed_after_recovery": (0 if recovery is None
                                   else int(recovery.get("completed", 0))),
        "all_accounted": accounted == len(results),
        "failure_verdicts": dict(sorted(verdict_hist.items())),
        "goodput_rps": healthy_ok / max(wall_s, 1e-9),
        "fault_every": cfg.chaos_fault_every,
        "poison_fraction": cfg.chaos_poison_fraction,
        # the acceptance criterion as one bool: blast radius == 1 per
        # poisoned request and zero healthy casualties among requests the
        # process lived to answer
        "containment_ok": (
            healthy_failed == 0 and healthy_unverified == 0
            and poisoned_served == 0
            and poisoned_failed == len(poison) - poisoned_crash_lost),
        # the crash ledger balances: nothing was lost, or a recovery pass
        # completed every crash-lost healthy request and classified every
        # crash-lost poisoned one
        "recovery_ok": (crash_lost == 0 or (
            recovery is not None
            and int(recovery.get("completed", 0)) == healthy_crash_lost
            and int(recovery.get("failed", 0)) == poisoned_crash_lost)),
    }
    if recovery is not None:
        summary["recovery"] = {k: v for k, v in recovery.items()
                               if k != "results"}
    return summary


def run_workload(cfg: WorkloadConfig) -> dict:
    """Build, serve and summarize one synthetic workload (sync wrapper)."""
    gauges, requests = build_workload(cfg)
    injector = None
    if cfg.chaos and cfg.chaos_fault_every > 0:
        from repro_torch.serve.chaos import BatchFaultInjector
        injector = BatchFaultInjector(mode=cfg.chaos_fault_mode,
                                      every=cfg.chaos_fault_every)

    async def main():
        server = SolverServer(
            mass=cfg.mass, backend=cfg.backend, ladder=cfg.ladder,
            device=cfg.device,
            policy=BatchPolicy(max_wait=cfg.max_wait_s,
                               max_batch=cfg.max_batch),
            maxiter=cfg.maxiter, fault_injector=injector,
            journal_dir=cfg.journal_dir,
            deflation_nev=cfg.deflation_nev,
            deflation_m_max=cfg.deflation_m_max,
            deflation_harvest_tol=cfg.deflation_harvest_tol)
        for gid, u in gauges.items():
            server.register_gauge(gid, u)
        try:
            warmed = await server.warmup() if cfg.warmup else 0
            results, wall_s = await drive_open_loop(
                server, requests, burst=cfg.burst,
                interarrival_s=cfg.interarrival_s)
            return (results, wall_s, warmed, server.metrics(),
                    server.deflations.bases())
        finally:
            await server.close()

    results, wall_s, warmed, metrics, bases = asyncio.run(main())

    served = [(lat, res) for lat, res in results
              if isinstance(res, SolveResult)]
    lats_ms = sorted(lat * 1e3 for lat, _ in served)
    iters = [res.stats.iterations for _, res in served]
    report = {
        "schema": 1, "bench": "serve",
        "generated_by": "repro_torch.serve.loadgen",
        "lattice": "x".join(str(v) for v in cfg.lattice),
        "mass": cfg.mass, "tol": cfg.tol, "seed": cfg.seed,
        "backend": cfg.backend, "device": str(cfg.device),
        "n_gauge": cfg.n_gauge,
        "families": [list(f) for f in cfg.families],
        "requests": len(results),
        "served": len(served),
        "failed": len(results) - len(served),
        "burst": cfg.burst, "interarrival_s": cfg.interarrival_s,
        "ladder": list(cfg.ladder), "max_wait_s": cfg.max_wait_s,
        "warmup_kernels": warmed,
        "wall_s": wall_s,
        "requests_per_s": len(served) / max(wall_s, 1e-9),
        "latency_ms": {
            "p50": percentile(lats_ms, 50),
            "p99": percentile(lats_ms, 99),
            "mean": sum(lats_ms) / max(len(lats_ms), 1),
            "max": lats_ms[-1] if lats_ms else float("nan"),
        },
        "iters": {"max": max(iters) if iters else 0,
                  "mean": sum(iters) / max(len(iters), 1)},
        # every SERVED request must be converged AND verified — failures
        # surface as structured exceptions, never as a bad x
        "all_converged": all(res.stats.converged and res.stats.verified
                             for _, res in served),
        # server metrics count ADMITTED requests; the report's "requests"
        # above counts all outcomes including admission rejections
        **{("admitted" if k == "requests" else k): v
           for k, v in metrics.items()},
    }
    if cfg.chaos:
        report["chaos"] = summarize_chaos(cfg, results, wall_s)
    if cfg.deflation_nev > 0:
        report["deflation_drop"] = summarize_deflation(cfg, requests,
                                                       results)
    if cfg.verify:
        report["verify"] = verify_against_direct(gauges, requests, results,
                                                 cfg, deflation_bases=bases)
    return report
