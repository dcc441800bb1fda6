"""Continuous-batching solver server: solve-as-a-service over SolverPlan.

The production shape of "many applications on one optimized CG core" is
a request stream: many independent clients firing right-hand sides at a
small set of hot gauge fields.  :class:`SolverServer` is that shape as
code (the JAX package's ``repro.serve.server``, on the port's plans):

    admit → queue → coalesce → pad to ladder rung → masked batched solve
          → verify → contain → return

* Requests (:class:`SolveRequest`) name ``(operator_family, mu, gauge_id,
  rhs, tol)``; gauge fields are registered once and referenced by id.
* Requests sharing a COALESCE KEY ``(gauge_id, family, mu, mass)`` land
  in one queue and are dispatched together into the gauge-amortized
  multi-RHS batched EO-Schur CGNR path: one batched solve reads each
  gauge plane once for the whole batch (K1, K2 and K3 at the batch's
  rung on the kernels backend).
* Batch formation follows :class:`repro_torch.serve.batching.BatchPolicy`:
  dispatch when ``max_batch`` requests are queued or ``max_wait`` seconds
  after the first one, whichever comes first — a lone request is never
  starved.
* Dispatched batches are padded to a fixed ladder of batch shapes and
  solved by ``plan.solve`` of the rung's plan (the port compiles nothing
  per plan: its kernels are built once a process).
* Per-request tolerances ride a per-RHS tolerance vector (a runtime
  argument of the solve), so mixed-tolerance requests coalesce into one
  batch instead of fragmenting the queue.
* Each request completes with the masked-freeze guarantee: its
  returned solution is bitwise the iterate an independent solve would
  have produced at ITS OWN convergence point — the batch running on for
  slower systems never perturbs it — and its :class:`RequestStats` report
  the freeze iteration (``SolveStats.rhs_iterations``), queue time and
  batch size.

Defense layer:

* **Admission**: non-finite RHS / tolerance / parameters are rejected at
  ``submit`` with :class:`~repro_torch.serve.errors.RequestRejected` before
  ever touching a queue.
* **Deadlines**: ``SolveRequest.deadline_s`` seconds after submission an
  undispatched request fails with
  :class:`~repro_torch.serve.errors.SolveTimeout` and its batch slot is freed.
* **Backpressure**: each coalesce-key queue is bounded
  (``max_queue_depth``); an arrival over the bound fails immediately
  with :class:`~repro_torch.serve.errors.ServerOverloaded`.
* **Verification + blast-radius containment**: every solved lane must
  pass the plan's true-residual verification (``converged`` AND
  ``verified``).  A failing lane in a multi-request batch is re-solved
  INDIVIDUALLY once (rescuing victims of a transient fault or of a
  poisoned neighbour); a batch whose solve RAISES is bisected the same
  way.  A lane that still fails gets a classified
  :class:`~repro_torch.serve.errors.RequestFailed` — so the blast radius of
  one poisoned RHS is exactly that one request.
* **Drain on close**: ``close()`` completes queued and in-flight work
  before shutting down; ``close(drain=False)`` aborts, failing every
  pending request with :class:`~repro_torch.serve.errors.ServerClosed` instead
  of hanging its awaiter.
* **Fault injection**: ``fault_injector`` (see :mod:`repro_torch.serve.chaos`)
  wraps the worker's view of ``(gauge, rhs)`` — the chaos harness that
  drives the containment tests and the ``loadgen --chaos`` lane.

Single-accelerator model: one worker thread executes solves in dispatch
order (the asyncio loop keeps ingesting and batching while a solve runs:
continuous batching, not stop-and-wait).  The worker builds the kernels
(in :meth:`SolverServer.warmup`, or at first use), launches them,
synchronizes the card and reads each batch's stats to the host in one
transfer; the event loop never waits on the device.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.lattice import resolve_device
from repro_torch.core.solvers import verdict_name
from repro_torch.serve import journal as journal_mod
from repro_torch.serve.batching import (BatchPolicy, DEFAULT_LADDER,
                                        pad_batch, pad_tols, rung_for,
                                        validate_ladder)
from repro_torch.serve.errors import (RequestFailed, RequestRejected,
                                      ServerClosed, ServerOverloaded,
                                      SolveTimeout)
from repro_torch.serve.plan_cache import DeflationCache

Array = torch.Tensor

# drain sentinel: close() pushes one through each coalesce queue so the
# dispatcher finishes everything queued ahead of it, then exits cleanly
_CLOSE = object()


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One client solve: which operator, which gauge field, which RHS.

    ``rhs`` is a natural-layout (T, Z, Y, X, 4, 3) complex spinor field,
    a tensor (on any device) or a numpy array.  ``mass`` defaults to the
    server's configured mass; like ``mu`` it is folded into the kernels'
    launches, so it is part of the coalesce key (requests with different
    masses cannot share a batch).  ``tol`` is a runtime per-RHS argument
    and never fragments batching.

    ``deadline_s`` (seconds from submission, None = no deadline) bounds
    the time the request may sit in the batching queue: a request still
    undispatched at its deadline fails with :class:`SolveTimeout` and
    does NOT consume a slot in the batch it would have joined.
    """

    operator_family: str
    gauge_id: str
    rhs: Array
    tol: float = 1e-6
    mu: float = 0.0
    mass: float | None = None
    deadline_s: float | None = None


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request serving telemetry."""

    queue_s: float          # submit -> batch dispatch
    solve_s: float          # the batch solve's wall time (shared)
    batch_size: int         # real requests in the dispatched batch
    padded_to: int          # ladder rung the batch was padded to
    iterations: int         # this request's convergence-mask freeze step
    converged: bool
    residual_norm2: float   # final per-RHS ||r||² of the masked CG
    verdict: str = "converged"        # classified exit (VERDICTS name)
    verified: bool = True             # true-residual verification gate
    true_residual_norm2: float = 0.0  # ‖b - D x‖² from the verify matvec
    retried: bool = False   # served by the individual containment re-solve
    resumed: bool = False   # replayed from the journal after a crash
    # solved with a cached DeflationBasis for this coalesce key (the
    # warm-gauge-field fast path; strictly fewer iterations than the cold
    # solve that harvested the basis)
    deflation_cache_hit: bool = False


@dataclasses.dataclass(frozen=True)
class SolveResult:
    x: Array
    stats: RequestStats


class _Pending(NamedTuple):
    request: SolveRequest
    future: asyncio.Future
    t_enqueue: float
    t_deadline: float | None
    rid: int | None = None    # journal record id (None: journaling off)


def _host(rhs) -> np.ndarray:
    """A request's RHS as a host numpy array (the journal's format)."""
    if isinstance(rhs, torch.Tensor):
        return rhs.detach().cpu().numpy()
    return np.asarray(rhs)


def _stats_to_host(stats) -> tuple[np.ndarray, ...]:
    """A batch's per-RHS stats in one device-to-host transfer: (freeze
    iteration, converged, ||r||^2, verdict, verified, true ||r||^2), each
    an (N,) numpy array.  Every field is exact in float64."""
    fields = (stats.rhs_iterations, stats.converged, stats.residual_norm2,
              stats.verdict, stats.verified, stats.true_residual_norm2)
    host = torch.stack([f.to(torch.float64) for f in fields]).cpu().numpy()
    return (host[0].astype(np.int64), host[1] != 0, host[2],
            host[3].astype(np.int64), host[4] != 0, host[5])


class SolverServer:
    """Async continuous-batching front end over the SolverPlan stack."""

    def __init__(self, *, mass: float = 0.1, backend: str = "kernels",
                 ladder=DEFAULT_LADDER, policy: BatchPolicy | None = None,
                 maxiter: int = 1000, device="cuda",
                 admission_validation: bool = True,
                 max_queue_depth: int = 256,
                 fault_injector: Callable | None = None,
                 journal_dir: str | None = None,
                 deflation_nev: int = 0, deflation_m_max: int = 160,
                 deflation_harvest_tol: float | None = None,
                 deflation_cache: DeflationCache | None = None):
        self.mass = float(mass)
        self.backend = backend
        self.ladder = validate_ladder(ladder)
        self.policy = policy or BatchPolicy()
        self.maxiter = int(maxiter)
        self.device = resolve_device(device)
        self.admission_validation = bool(admission_validation)
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        self.max_queue_depth = int(max_queue_depth)
        # test hook (serve/chaos.py): rewrites the worker's (u, b) view
        self.fault_injector = fault_injector
        # EigCG deflation, off by default (nev=0): the
        # first verified solve on a coalesce key harvests a low-mode
        # basis; later primary dispatches on that key start from the
        # Galerkin projection and converge in strictly fewer iterations.
        # A deflated solve still passes the full verification gate
        # against the ORIGINAL system, so deflation can only ever cost
        # a harvest solve, never correctness.
        if deflation_nev < 0:
            raise ValueError(
                f"deflation_nev must be >= 0, got {deflation_nev}")
        self.deflation_nev = int(deflation_nev)
        self.deflation_m_max = int(deflation_m_max)
        self.deflation_harvest_tol = (
            None if deflation_harvest_tol is None
            else float(deflation_harvest_tol))
        self.deflations = deflation_cache or DeflationCache()
        self._harvest_failures = 0
        # write-ahead journal (serve/journal.py): admitted requests are
        # durable; recover() replays whatever a crash left incomplete
        self.journal = (journal_mod.RequestJournal(journal_dir)
                        if journal_dir is not None else None)
        # continue rids past a previous process's entries when journaling
        # into the same directory (restart-into-same-journal is the
        # recover() deployment shape)
        self._next_rid = (0 if self.journal is None else 1 + max(
            (int(ev["rid"]) for ev in journal_mod.scan_journal(journal_dir)),
            default=-1))
        self._gauges: dict[str, Array] = {}
        self._queues: dict[tuple, asyncio.Queue] = {}
        self._dispatchers: dict[tuple, asyncio.Task] = {}
        # one worker thread = one card: solves execute in dispatch order
        # while the event loop keeps forming the next batches
        self._exec = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="solve")
        self._closed = False
        # serving counters (metrics())
        self._n_requests = 0
        self._n_batches = 0
        self._batch_hist: dict[int, int] = {}
        self._rung_hist: dict[int, int] = {}
        self._padded_slots = 0
        # containment counters (metrics()["containment"])
        self._admission_rejected = 0
        self._overload_rejected = 0
        self._deadline_expired = 0
        self._batch_failures = 0
        self._lane_retries = 0
        self._lane_retries_rescued = 0
        self._failed_requests = 0
        self._verdict_hist: dict[str, int] = {}

    # -- gauge registry ----------------------------------------------------

    def register_gauge(self, gauge_id: str, u: Array) -> None:
        """Register a hot gauge field clients may reference by id.

        Re-registering an id installs the new field and invalidates every
        deflation basis harvested on the old one: a low-mode basis is a
        statement about one specific gauge configuration.  The field is
        moved to the server's device once, here.
        """
        gid = str(gauge_id)
        if gid in self._gauges:
            self.deflations.invalidate_gauge(gid)
        self._gauges[gid] = torch.as_tensor(u, device=self.device)

    def gauge_ids(self) -> tuple[str, ...]:
        return tuple(self._gauges)

    async def warmup(self) -> int:
        """Build and load every kernel in the worker thread (backend
        ``"kernels"`` on the card), so that no request pays for it and the
        event loop never waits on ``nvcc``.  Returns the number of kernel
        libraries loaded: 0 on the CPU or the reference backend, where
        nothing is built."""
        if self.backend != "kernels" or self.device.type != "cuda":
            return 0
        from repro_torch.kernels import build

        def build_kernels():
            build.build_all()
            names = build.sources()
            for name in names:
                build.library(name)
            return len(names)

        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(self._exec, build_kernels)

    def _sync(self) -> None:
        """Wait for the card (worker thread only)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- request path ------------------------------------------------------

    def _plan_for(self, request: SolveRequest, nrhs: int | None
                  ) -> plan_mod.SolverPlan:
        return plan_mod.SolverPlan(
            operator="eo-schur", operator_family=request.operator_family,
            mu=float(request.mu), backend=self.backend, nrhs=nrhs)

    def _coalesce_key(self, request: SolveRequest) -> tuple:
        mass = self.mass if request.mass is None else float(request.mass)
        return (str(request.gauge_id), request.operator_family,
                float(request.mu), mass)

    def _admit(self, request: SolveRequest) -> None:
        """Admission-time validation: reject a poisoned request before it
        can touch a queue (first containment ring; see module docstring).
        One host-synced all-finite reduction per request — admission cost,
        never solve-loop cost."""
        tol = float(request.tol) if np.ndim(request.tol) == 0 else None
        if tol is None or not math.isfinite(tol) or tol <= 0:
            self._admission_rejected += 1
            raise RequestRejected(
                f"tol must be a finite positive scalar, got {request.tol!r}",
                reason="bad_tol")
        for name, value in (("mu", request.mu), ("mass", request.mass),
                            ("deadline_s", request.deadline_s)):
            if value is not None and not math.isfinite(float(value)):
                self._admission_rejected += 1
                raise RequestRejected(
                    f"{name} must be finite, got {value!r}",
                    reason=f"bad_{name}")
        if not bool(torch.isfinite(torch.as_tensor(request.rhs)).all()):
            self._admission_rejected += 1
            raise RequestRejected(
                "rhs contains non-finite entries", reason="nonfinite_rhs")

    async def submit(self, request: SolveRequest) -> SolveResult:
        """Enqueue one request; resolves when its solution is ready."""
        if self._closed:
            raise RuntimeError("SolverServer is closed")
        if str(request.gauge_id) not in self._gauges:
            raise KeyError(
                f"unknown gauge_id {request.gauge_id!r}; registered: "
                f"{sorted(self._gauges)}")
        self._plan_for(request, None)  # validate family/mu NOW, not in batch
        if self.admission_validation:
            self._admit(request)
        loop = asyncio.get_running_loop()
        key = self._coalesce_key(request)
        queue = self._queues.get(key)
        if queue is None:
            queue = asyncio.Queue()
            self._queues[key] = queue
            self._dispatchers[key] = loop.create_task(
                self._dispatch_loop(key, queue))
        if queue.qsize() >= self.max_queue_depth:
            self._overload_rejected += 1
            raise ServerOverloaded(
                f"queue for coalesce key {key} is at its bound "
                f"({self.max_queue_depth}); back off and retry",
                queue_depth=queue.qsize())
        future: asyncio.Future = loop.create_future()
        self._n_requests += 1
        rid = None
        if self.journal is not None:
            # write-ahead: the admit record (RHS included) is fsync'd
            # BEFORE the request can be queued — from here on, a SIGKILL
            # cannot lose it, only leave it for recover() to replay
            rid = self._next_rid
            self._next_rid += 1
            self.journal.admit(
                rid, operator_family=request.operator_family,
                gauge_id=str(request.gauge_id), rhs=_host(request.rhs),
                tol=float(request.tol), mu=float(request.mu),
                mass=request.mass, deadline_s=request.deadline_s)
        now = loop.time()
        deadline = (None if request.deadline_s is None
                    else now + float(request.deadline_s))
        queue.put_nowait(_Pending(request, future, now, deadline, rid))
        return await future

    async def _dispatch_loop(self, key: tuple, queue: asyncio.Queue):
        """Form batches: dispatch at max_batch or max_wait after the first."""
        loop = asyncio.get_running_loop()
        max_batch = self.policy.resolved_max_batch(self.ladder)
        while True:
            first = await queue.get()
            if first is _CLOSE:
                return
            batch = [first]
            draining = False
            deadline = loop.time() + self.policy.max_wait
            while len(batch) < max_batch and not draining:
                # drain whatever is already queued before sleeping on the
                # deadline — a backlog dispatches as full batches at once
                while not queue.empty() and len(batch) < max_batch:
                    item = queue.get_nowait()
                    if item is _CLOSE:
                        draining = True
                        break
                    batch.append(item)
                if draining or len(batch) >= max_batch:
                    break
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    item = await asyncio.wait_for(queue.get(), timeout)
                except asyncio.TimeoutError:
                    break
                except asyncio.CancelledError:
                    # abort-path close() while a batch is forming: its
                    # members have left the queue, so close() cannot
                    # reach them; fail them here, never leave an awaiter
                    # hanging
                    for p in batch:
                        if not p.future.done():
                            p.future.set_exception(ServerClosed(
                                "server closed before dispatch"))
                    raise
                if item is _CLOSE:
                    draining = True
                    break
                batch.append(item)
            await self._solve_batch(batch)
            if draining:
                return

    def _journal_complete(self, p: _Pending, status: str):
        if self.journal is not None and p.rid is not None:
            self.journal.complete(p.rid, status)

    def _fail(self, p: _Pending, exc: Exception, verdict: str | None = None):
        self._failed_requests += 1
        if verdict is not None:
            self._verdict_hist[verdict] = (
                self._verdict_hist.get(verdict, 0) + 1)
        # a classified failure IS a completion (the client got a durable
        # answer); ServerClosed is NOT — those requests died with the
        # process and must remain in the replay set
        if not isinstance(exc, ServerClosed):
            self._journal_complete(
                p, verdict if verdict is not None else type(exc).__name__)
        if not p.future.done():
            p.future.set_exception(exc)

    def _drop_expired(self, batch: list[_Pending],
                      now: float) -> list[_Pending]:
        """Deadline containment: an expired request fails with
        SolveTimeout and frees its slot BEFORE the batch is shaped."""
        live = []
        for p in batch:
            if p.t_deadline is not None and now > p.t_deadline:
                self._deadline_expired += 1
                self._fail(p, SolveTimeout(
                    f"deadline_s={p.request.deadline_s} expired after "
                    f"{now - p.t_enqueue:.3f}s in queue"))
            else:
                live.append(p)
        return live

    async def _solve_batch(self, batch: list[_Pending], *,
                           retried: bool = False):
        loop = asyncio.get_running_loop()
        t_dispatch = loop.time()
        batch = self._drop_expired(batch, t_dispatch)
        if not batch:
            return
        requests = [p.request for p in batch]
        first = requests[0]
        rung = rung_for(len(batch), self.ladder)
        mass = self.mass if first.mass is None else float(first.mass)
        key = self._coalesce_key(first)
        # warm-gauge fast path: primary dispatches on a key with a
        # harvested basis run the deflated program; containment re-solves
        # deliberately do NOT (a retry must be the plainest possible
        # solve — if the basis itself were somehow bad, deflation-free
        # retries keep it out of the blast radius)
        basis = (self.deflations.lookup(key)
                 if self.deflation_nev > 0 and not retried else None)
        try:
            plan = self._plan_for(first, rung)
            u = self._gauges[str(first.gauge_id)]
            b = pad_batch([r.rhs for r in requests], rung, self.device)
            tol = pad_tols([r.tol for r in requests], rung, self.device)
            # the containment re-solve IS the clean retry of the transient
            # fault model: the injector only sees primary dispatches
            injector = None if retried else self.fault_injector

            def run():
                uu, bb = (u, b) if injector is None else injector(u, b)
                x, stats = plan_mod.solve(plan, uu, bb, mass, tol=tol,
                                          maxiter=self.maxiter,
                                          deflation=basis,
                                          device=self.device)
                host = _stats_to_host(stats)   # one transfer
                self._sync()
                return x, host

            x, host = await loop.run_in_executor(self._exec, run)
        except asyncio.CancelledError:
            # abort-path close() cancelled the dispatcher mid-solve: never
            # leave awaiters hanging on futures nobody will complete
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(
                        ServerClosed("server closed while solving"))
            raise
        except Exception as e:
            # batch-failure bisection: re-solve members individually so
            # one poisoned request cannot take its neighbours down.  A
            # singleton gets the same single clean re-solve — a transient
            # fault must not kill a lone healthy request either.
            if not retried:
                self._batch_failures += 1
                for p in batch:
                    self._lane_retries += 1
                    await self._solve_batch([p], retried=True)
                return
            for p in batch:
                self._fail(p, RequestFailed(
                    f"solve failed: {e!r}", verdict="error",
                    retried=retried), verdict="error")
            return
        solve_s = loop.time() - t_dispatch
        self._n_batches += 1
        self._batch_hist[len(batch)] = self._batch_hist.get(len(batch), 0) + 1
        self._rung_hist[rung] = self._rung_hist.get(rung, 0) + 1
        self._padded_slots += rung - len(batch)
        rhs_iters, converged, res2, verdicts, verified, true_res2 = host
        retry: list[_Pending] = []
        for i, p in enumerate(batch):
            verdict = verdict_name(verdicts[i])
            ok = bool(converged[i]) and bool(verified[i])
            if not ok:
                if not retried:
                    # containment: one clean INDIVIDUAL re-solve — rescues
                    # a healthy lane hit by a transient fault or by batch
                    # effects of a poisoned neighbour; a genuinely poisoned
                    # request fails the retry too (classified, terminal)
                    retry.append(p)
                else:
                    self._fail(p, RequestFailed(
                        f"request failed verification (verdict={verdict}, "
                        f"true ‖r‖²={float(true_res2[i]):.3e})",
                        verdict=verdict, retried=retried), verdict=verdict)
            else:
                if retried:
                    self._lane_retries_rescued += 1
                st = RequestStats(
                    queue_s=t_dispatch - p.t_enqueue, solve_s=solve_s,
                    batch_size=len(batch), padded_to=rung,
                    iterations=int(rhs_iters[i]),
                    converged=bool(converged[i]),
                    residual_norm2=float(res2[i]), verdict=verdict, verified=bool(verified[i]),
                    true_residual_norm2=float(true_res2[i]), retried=retried,
                    deflation_cache_hit=basis is not None)
                self._journal_complete(p, "ok")
                if not p.future.done():
                    p.future.set_result(SolveResult(x=x[i], stats=st))
        for p in retry:
            self._lane_retries += 1
            await self._solve_batch([p], retried=True)
        # EigCG harvest: the FIRST verified primary batch on a cold key
        # pays one extra unbatched solve to mine the low modes every
        # later request on this (gauge, operator) reuses.  Only a lane
        # that passed the full verification gate may seed the basis — a
        # poisoned or faulted lane never can.
        if (self.deflation_nev > 0 and not retried and basis is None
                and self.deflations.peek(key) is None):
            for i, p in enumerate(batch):
                if bool(converged[i]) and bool(verified[i]):
                    await self._harvest_basis(key, p.request)
                    break

    async def _harvest_basis(self, key: tuple, request: SolveRequest):
        """Harvest a DeflationBasis from one just-verified request.

        Runs :func:`repro_torch.core.plan.harvest_deflation`, an unbatched
        solve of the same system recording its Lanczos data — on the
        worker thread (one accelerator, dispatch order preserved).  The
        harvest tolerance defaults to the triggering request's tol;
        ``deflation_harvest_tol`` overrides it when the operator is ill-
        conditioned enough that a deeper Krylov space buys a better basis.

        Deflation is an accelerator, never a correctness dependency: a
        harvest that fails, diverges, fails verification or produces
        non-finite arrays is dropped (counted in
        ``metrics()["deflation"]["harvest_failures"]``) and serving
        continues undeflated.
        """
        loop = asyncio.get_running_loop()
        u = self._gauges[str(request.gauge_id)]
        mass = key[3]
        htol = (float(request.tol) if self.deflation_harvest_tol is None
                else self.deflation_harvest_tol)
        plan = self._plan_for(request, None)
        nev, m_max, maxiter = (self.deflation_nev, self.deflation_m_max,
                               self.maxiter)

        def run():
            # verification of the harvest x gates at the REQUEST tol: the
            # harvest may deliberately iterate past it (see
            # harvest_deflation), and only the basis is kept anyway
            _, stats, harvested = plan_mod.harvest_deflation(
                plan, u, request.rhs, mass, tol=htol, maxiter=maxiter,
                nev=nev, m_max=m_max, verify_tol=float(request.tol),
                device=self.device)
            flags = torch.stack([
                stats.converged.reshape(()), stats.verified.reshape(()),
                torch.isfinite(harvested.w).all(),
                torch.isfinite(harvested.gram).all()]).cpu()
            self._sync()
            return harvested if bool(flags.all()) else None

        try:
            harvested = await loop.run_in_executor(self._exec, run)
        except Exception:
            harvested = None
        if harvested is not None:
            self.deflations.store(key, harvested)
        else:
            self._harvest_failures += 1

    # -- lifecycle / telemetry --------------------------------------------

    def metrics(self) -> dict:
        """Serving counters: requests, batches, histograms, containment."""
        return {
            "requests": self._n_requests,
            "batches": self._n_batches,
            "batch_hist": {str(k): v for k, v
                           in sorted(self._batch_hist.items())},
            "rung_hist": {str(k): v for k, v
                          in sorted(self._rung_hist.items())},
            "padded_slots": self._padded_slots,
            "deflation": {
                "enabled": self.deflation_nev > 0,
                "nev": self.deflation_nev,
                "harvest_failures": self._harvest_failures,
                **self.deflations.stats(),
            },
            "containment": {
                "admission_rejected": self._admission_rejected,
                "overload_rejected": self._overload_rejected,
                "deadline_expired": self._deadline_expired,
                "batch_failures": self._batch_failures,
                "lane_retries": self._lane_retries,
                "lane_retries_rescued": self._lane_retries_rescued,
                "failed_requests": self._failed_requests,
                "verdict_hist": dict(sorted(self._verdict_hist.items())),
            },
        }

    async def recover(self, journal_dir: str | None = None) -> dict:
        """Replay a dead process's journal: every admitted-but-incomplete
        request is re-submitted through the normal pipeline.

        ``journal_dir`` defaults to this server's own journal directory
        (the usual shape: start a fresh journaled server over the same
        directory, then recover).  Replayed requests drop their original
        deadline — it was measured against a clock that died with the old
        process.  Each replayed entry is retired in the OLD journal with a
        ``recovered`` / ``recovered_failed:*`` mark so a second recovery
        pass finds nothing; requests whose gauge was never re-registered
        are retired as ``skipped_unknown_gauge`` rather than left to poison
        every future recovery.

        Returns a summary: ``{"found", "replayed", "completed", "failed",
        "skipped_unknown_gauge", "results": [(rid, "ok" | "<ExcType>")]}``.
        """
        if journal_dir is None:
            if self.journal is None:
                raise ValueError(
                    "recover() needs a journal_dir when the server itself "
                    "is not journaled")
            journal_dir = self.journal.dir
        entries = journal_mod.incomplete_requests(journal_dir)
        summary = {"found": len(entries), "replayed": 0, "completed": 0,
                   "failed": 0, "skipped_unknown_gauge": 0, "results": []}
        pending: list[tuple[int, asyncio.Future]] = []
        for ev in entries:
            rid = int(ev["rid"])
            if str(ev["gauge_id"]) not in self._gauges:
                journal_mod.mark_complete(
                    journal_dir, rid, "skipped_unknown_gauge")
                summary["skipped_unknown_gauge"] += 1
                continue
            req = SolveRequest(
                operator_family=str(ev["operator_family"]),
                gauge_id=str(ev["gauge_id"]),
                rhs=torch.from_numpy(journal_mod.load_rhs(journal_dir, ev)),
                tol=float(ev["tol"]), mu=float(ev["mu"]),
                mass=ev["mass"], deadline_s=None)
            pending.append(
                (rid, asyncio.ensure_future(self.submit(req))))
            summary["replayed"] += 1
        for rid, fut in pending:
            try:
                res = await fut
            except Exception as exc:
                journal_mod.mark_complete(
                    journal_dir, rid, f"recovered_failed:{type(exc).__name__}")
                summary["failed"] += 1
                summary["results"].append((rid, type(exc).__name__))
            else:
                journal_mod.mark_complete(journal_dir, rid, "recovered")
                summary["completed"] += 1
                summary["results"].append((rid, "ok"))
                object.__setattr__(res.stats, "resumed", True)
        return summary

    async def close(self, drain: bool = True):
        """Shut down; by default DRAIN (complete queued + in-flight work).

        ``drain=True``: reject new submissions, push a close sentinel
        through every coalesce queue, and wait for the dispatchers to
        finish everything queued ahead of it — every outstanding future
        completes (with a result or a structured failure) before the
        worker thread is released.  ``drain=False``: abort — cancel
        dispatchers and fail everything still pending with
        :class:`ServerClosed` so no awaiter ever hangs.
        """
        self._closed = True
        if drain:
            for queue in self._queues.values():
                queue.put_nowait(_CLOSE)
            for task in self._dispatchers.values():
                await task
        else:
            for task in self._dispatchers.values():
                task.cancel()
            for task in self._dispatchers.values():
                try:
                    await task
                except asyncio.CancelledError:
                    pass
            # anything still sitting in a queue never reached a dispatcher
            for queue in self._queues.values():
                while not queue.empty():
                    item = queue.get_nowait()
                    if item is _CLOSE:
                        continue
                    if not item.future.done():
                        item.future.set_exception(
                            ServerClosed("server closed before dispatch"))
        self._dispatchers.clear()
        self._queues.clear()
        self._exec.shutdown(wait=True)
        if self.journal is not None:
            self.journal.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()
