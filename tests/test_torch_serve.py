"""The port's solver server against the JAX package's serving stack.

``repro_torch.serve`` (batching, journal, plan cache, server, chaos,
loadgen) and ``repro_torch.launch.serve_solver`` on the CPU, the kernels
backend through the kernels' plain versions, at 2x4x2x8 (the fixture of
4^4 seed 7 where the JAX package is the reference).  What crosses
packages is held bitwise: the journal (both ways, a torn tail included),
the poisons, the ladder helpers and the chaos scorecard.  The server's
own contracts: a padded batch is bitwise the unpadded solve, a served x
bitwise the direct solve of its RHS, and each batch launches the hop
kernel 4I+4 times and the fused CG kernels I times each at its rung.
"""

import asyncio
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import batching as jbatching
from repro.serve import chaos as jchaos
from repro.serve import journal as jjournal
from repro.serve import loadgen as jloadgen
from repro.serve import server as jserver
from repro_torch.core import plan as tplan
from repro_torch.core.lattice import (LatticeShape, fields_from_numpy,
                                      random_gauge, random_spinor)
from repro_torch.kernels import counts, reset_counts
from repro_torch.launch import serve_solver
from repro_torch.serve import batching, chaos, journal, loadgen
from repro_torch.serve import server as tserver
from repro_torch.serve.errors import (RequestFailed, RequestRejected,
                                      ServerClosed, ServerOverloaded,
                                      SolveTimeout)
from repro_torch.serve.server import (RequestStats, SolveRequest,
                                      SolveResult, SolverServer)

GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "src"
          / "repro_torch" / "data" / "golden_4x4x4x4_seed7.npz")
LAT = LatticeShape(2, 4, 2, 8)
MASS, TOL = 0.1, 1e-6


@pytest.fixture(scope="module")
def fields():
    gen = torch.Generator()
    gen.manual_seed(3)
    gauges = {"g0": random_gauge(gen, LAT), "g1": random_gauge(gen, LAT)}
    pool = [random_spinor(gen, LAT) for _ in range(8)]
    return gauges, pool


def _server(gauges, **kw):
    kw.setdefault("policy", batching.BatchPolicy(max_wait=0.02))
    srv = SolverServer(mass=MASS, ladder=kw.pop("ladder", (1, 4, 8)),
                       device="cpu", **kw)
    for gid, u in gauges.items():
        srv.register_gauge(gid, u)
    return srv


def _req(pool, i, gid="g0", family="wilson", **kw):
    mu = 0.25 if family == "twisted-mass" else 0.0
    return SolveRequest(operator_family=family, gauge_id=gid, rhs=pool[i],
                        mu=mu, **kw)


def _direct(u, rhs, tol, family="wilson", backend="kernels"):
    plan = tplan.SolverPlan(operator_family=family, backend=backend,
                            mu=0.25 if family == "twisted-mass" else 0.0)
    return tplan.solve(plan, u, rhs, MASS, tol=torch.tensor(
        tol, dtype=torch.float32), device="cpu")[0]


# ---------------------------------------------------------------------------
# what crosses packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_crosses_packages(tmp_path, writer):
    """Each package's scan reads the other's journal: admits, completions,
    the journaled RHS bitwise, a torn tail skipped, a torn middle line an
    IOError."""
    write = journal if writer == "port" else jjournal
    rng = np.random.default_rng(0)
    rhs = [(rng.standard_normal((2, 4, 2, 8, 4, 3))
            + 1j * rng.standard_normal((2, 4, 2, 8, 4, 3))).astype(
                np.complex64) for _ in range(3)]
    j = write.RequestJournal(str(tmp_path))
    for rid in range(3):
        j.admit(rid, operator_family="wilson", gauge_id="g0", rhs=rhs[rid],
                tol=1e-6, mu=0.0, mass=None, deadline_s=None)
    j.complete(1, "ok")
    j.close()
    # the other package retires rid 0, then a crash tears the next append
    other = jjournal if writer == "port" else journal
    other.mark_complete(str(tmp_path), 0, "recovered")
    with open(tmp_path / "journal.jsonl", "a") as f:
        f.write('{"event": "comp')
    for read in (journal, jjournal):
        assert [e["rid"] for e in read.incomplete_requests(str(tmp_path))] \
            == [2]
        for rid in range(3):
            assert read.load_rhs(str(tmp_path), {"rhs": f"rhs/{rid}.npy"}) \
                .tobytes() == rhs[rid].tobytes()
    assert journal.scan_journal(str(tmp_path)) == \
        jjournal.scan_journal(str(tmp_path))
    lines = (tmp_path / "journal.jsonl").read_text().splitlines()
    lines.insert(1, '{"torn')
    (tmp_path / "journal.jsonl").write_text("\n".join(lines) + "\n")
    for read in (journal, jjournal):
        with pytest.raises(IOError, match="line 2"):
            read.scan_journal(str(tmp_path))


@pytest.mark.parametrize("name,args", [
    ("poison_nan", ()), ("poison_nan", (37,)), ("poison_overflow", ()),
    ("nan_plane", ()), ("nan_plane", (1,)), ("bit_flip", ()),
    ("bit_flip", (41,))])
def test_poisons_are_bitwise_jax(fields, name, args):
    gauges, pool = fields
    src = (gauges["g0"] if name in ("nan_plane", "bit_flip")
           else pool[0]).numpy()
    ours = getattr(chaos, name)(src, *args)
    theirs = np.asarray(getattr(jchaos, name)(src, *args))
    assert ours.numpy().dtype == theirs.dtype
    assert ours.numpy().tobytes() == theirs.tobytes()


def test_ladder_helpers_equal_jax():
    for ladder in ((1, 4, 8, 16), (8, 1, 4, 4)):
        assert batching.validate_ladder(ladder) == \
            jbatching.validate_ladder(ladder)
        lad = batching.validate_ladder(ladder)
        assert [batching.rung_for(n, lad) for n in range(1, lad[-1] + 1)] \
            == [jbatching.rung_for(n, lad) for n in range(1, lad[-1] + 1)]
    assert batching.pad_tols([1e-6, 1e-5], 4).numpy().tobytes() == \
        np.asarray(jbatching.pad_tols([1e-6, 1e-5], 4)).tobytes()
    with pytest.raises(ValueError, match="top ladder rung"):
        batching.rung_for(9, (1, 4, 8))
    pol = batching.BatchPolicy(max_batch=32)
    assert pol.resolved_max_batch((1, 4, 8)) == \
        jbatching.BatchPolicy(max_batch=32).resolved_max_batch((1, 4, 8))


def _outcomes(pkg_result, pkg_closed, pkg_failed, stats_cls, **extra):
    """A fixed request-outcome list in one package's types: served,
    served after a retry, unverified, classified failures, crash lost."""
    def served(retried=False, ok=True):
        st = stats_cls(queue_s=0.0, solve_s=0.0, batch_size=1, padded_to=1,
                       iterations=3, converged=ok, residual_norm2=0.0,
                       verified=ok, retried=retried, **extra)
        return pkg_result(x=None, stats=st)
    kinds = [served(), pkg_failed("x", verdict="nonfinite"), served(True),
             pkg_closed("gone"), served(), served(ok=False),
             pkg_failed("x", verdict="error"), served(),
             pkg_closed("gone"), served(), served(),
             pkg_failed("x", verdict="nonfinite")]
    return [(0.01 * i, o) for i, o in enumerate(kinds)]


def test_summarize_chaos_equals_jax():
    """The containment scorecard buckets of the same workload and the
    same outcomes are the JAX package's."""
    kw = dict(requests=12, chaos=True, chaos_poison_fraction=0.25,
              chaos_fault_every=3)
    cfg, jcfg = loadgen.WorkloadConfig(**kw), jloadgen.WorkloadConfig(**kw)
    assert loadgen.poisoned_indices(cfg) == jloadgen.poisoned_indices(jcfg)
    ours = _outcomes(SolveResult, ServerClosed, RequestFailed, RequestStats)
    theirs = _outcomes(jserver.SolveResult, jserver.ServerClosed,
                       jserver.RequestFailed, jserver.RequestStats,
                       plan_cache_hit=True)
    recovery = {"found": 2, "replayed": 2, "completed": 1, "failed": 1,
                "skipped_unknown_gauge": 0, "results": []}
    for rec in (None, recovery):
        assert loadgen.summarize_chaos(cfg, ours, 1.5, rec) == \
            jloadgen.summarize_chaos(jcfg, theirs, 1.5, rec)


# ---------------------------------------------------------------------------
# the batch contracts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,rung", [(1, 4), (3, 4), (5, 8)])
def test_padded_batch_is_bitwise_unpadded(fields, k, rung):
    """k requests padded to a rung with zero RHS: the first k solutions
    bitwise the unpadded k-RHS solve's, with the same per-RHS counts."""
    gauges, pool = fields
    tols = [1e-6, 1e-5, 1e-6, 1e-5, 1e-6][:k]
    b = batching.pad_batch(pool[:k], rung)
    assert b.shape[0] == rung and not bool(b[k:].abs().any())
    xp, sp = tplan.solve(tplan.SolverPlan(nrhs=rung), gauges["g0"], b, MASS,
                         tol=batching.pad_tols(tols, rung), device="cpu")
    xu, su = tplan.solve(tplan.SolverPlan(nrhs=k), gauges["g0"],
                         torch.stack(pool[:k]), MASS,
                         tol=torch.tensor(tols), device="cpu")
    assert torch.equal(xp[:k], xu)
    assert sp.rhs_iterations[:k].tolist() == su.rhs_iterations.tolist()
    assert sp.rhs_iterations[k:].tolist() == [0] * (rung - k)
    assert bool(sp.verified.all())
    # each lane is its own single solve (the masked freeze)
    assert torch.equal(xp[0], _direct(gauges["g0"], pool[0], tols[0]))


def test_server_coalesces_verifies_and_counts(fields):
    """Two gauges, Wilson and twisted mass, tolerances 1e-6 and 1e-5:
    every lane verifies, each served x is bitwise its direct solve, and a
    batch of 4 runs the hop kernel's plain version 4I+4 times and the
    fused CG kernels' I times, from the worker thread."""
    gauges, pool = fields

    async def main():
        srv = _server(gauges, policy=batching.BatchPolicy(max_wait=0.05))
        assert await srv.warmup() == 0   # the CPU builds no kernel
        reqs = [_req(pool, i, gid=("g0", "g1")[i % 2],
                     family=("wilson", "twisted-mass")[(i // 2) % 2],
                     tol=(1e-6, 1e-5)[(i // 4) % 2]) for i in range(8)]
        out = await asyncio.gather(*(srv.submit(r) for r in reqs))
        reset_counts()
        batch = await asyncio.gather(*(srv.submit(
            _req(pool, i, gid="g1", tol=1e-6)) for i in range(4)))
        c = counts()
        m = srv.metrics()
        await srv.close()
        return reqs, out, batch, c, m

    reqs, out, batch, c, m = asyncio.run(main())
    assert all(r.stats.verified and r.stats.converged for r in out + batch)
    for i in (0, 5):
        want = _direct(gauges[reqs[i].gauge_id], pool[i], reqs[i].tol,
                       reqs[i].operator_family)
        assert torch.equal(out[i].x, want)
    its = max(r.stats.iterations for r in batch)
    assert {r.stats.padded_to for r in batch} == {4}
    got = {k: v["plain_calls"] for k, v in c.items() if v["plain_calls"]}
    assert got == {"wilson_hop": 4 * its + 4, "cg_update": its,
                   "cg_xpay": its}
    assert m["requests"] == 12 == sum(
        int(k) * v for k, v in m["batch_hist"].items())


def test_admission_overflow_and_bisection(fields):
    """A NaN RHS is rejected at admission; with admission off an
    overflow RHS fails alone (classified nonfinite, its neighbours
    served); a batch whose solve raises is bisected and every member
    served by its individual re-solve."""
    gauges, pool = fields

    async def main():
        srv = _server(gauges)
        with pytest.raises(RequestRejected) as e:
            await srv.submit(SolveRequest("wilson", "g0",
                                          chaos.poison_nan(pool[0])))
        reason = e.value.reason
        with pytest.raises(RequestRejected):
            await srv.submit(_req(pool, 0, tol=float("nan")))
        await srv.close()
        srv = _server(gauges, admission_validation=False)
        reqs = [_req(pool, 1), SolveRequest("wilson", "g0",
                                            chaos.poison_overflow(pool[2])),
                _req(pool, 3)]
        out = await asyncio.gather(*(srv.submit(r) for r in reqs),
                                   return_exceptions=True)
        m1 = srv.metrics()["containment"]
        await srv.close()
        inj = chaos.BatchFaultInjector(mode="raise", every=100)
        srv = _server(gauges, fault_injector=inj)
        bis = await asyncio.gather(*(srv.submit(_req(pool, i))
                                     for i in range(3)))
        m2 = srv.metrics()["containment"]
        await srv.close()
        return reason, out, m1, bis, m2

    reason, out, m1, bis, m2 = asyncio.run(main())
    assert reason == "nonfinite_rhs"
    assert isinstance(out[1], RequestFailed) and out[1].verdict == "nonfinite"
    assert all(isinstance(out[i], SolveResult) and out[i].stats.verified
               for i in (0, 2))
    assert m1["failed_requests"] == 1 and m1["lane_retries"] >= 1
    assert all(r.stats.retried and r.stats.verified for r in bis)
    assert m2["batch_failures"] == 1 and m2["lane_retries"] == 3


def test_deadlines_backpressure_drain_and_abort(fields):
    """A stalled worker: the queue bound rejects the overflow arrival
    (ServerOverloaded), an expired deadline fails with SolveTimeout
    without a batch slot, ``close()`` drains what is queued, and
    ``close(drain=False)`` fails what is pending with ServerClosed."""
    gauges, pool = fields

    async def main():
        inj = chaos.BatchFaultInjector(mode="stall", every=1, stall_s=0.3)
        srv = _server(gauges, fault_injector=inj, max_queue_depth=2,
                      policy=batching.BatchPolicy(max_wait=0.0,
                                                  max_batch=1))
        first = asyncio.ensure_future(srv.submit(_req(pool, 0)))
        await asyncio.sleep(0.05)       # the worker stalls on it
        late = asyncio.ensure_future(srv.submit(_req(pool, 1,
                                                     deadline_s=0.01)))
        kept = asyncio.ensure_future(srv.submit(_req(pool, 2)))
        await asyncio.sleep(0.01)
        with pytest.raises(ServerOverloaded):
            await srv.submit(_req(pool, 3))
        await srv.close()               # drain
        drained = await asyncio.gather(first, late, kept,
                                       return_exceptions=True)
        srv = _server(gauges, fault_injector=chaos.BatchFaultInjector(
            mode="stall", every=1, stall_s=0.3))
        pending = [asyncio.ensure_future(srv.submit(_req(pool, i)))
                   for i in range(2)]
        await asyncio.sleep(0.05)
        await srv.close(drain=False)
        aborted = await asyncio.gather(*pending, return_exceptions=True)
        return drained, aborted

    drained, aborted = asyncio.run(main())
    assert isinstance(drained[0], SolveResult)
    assert isinstance(drained[1], SolveTimeout)
    assert isinstance(drained[2], SolveResult)
    assert all(isinstance(a, ServerClosed) for a in aborted)


def test_abort_while_a_batch_forms(fields):
    """``close(drain=False)`` while requests wait in a forming batch (off
    the queue, not yet dispatched) fails each with ServerClosed instead
    of leaving its awaiter hanging."""
    gauges, pool = fields

    async def main():
        srv = _server(gauges, policy=batching.BatchPolicy(max_wait=30.0))
        tasks = [asyncio.ensure_future(srv.submit(_req(pool, i)))
                 for i in range(2)]
        await asyncio.sleep(0.2)
        await srv.close(drain=False)
        return await asyncio.wait_for(
            asyncio.gather(*tasks, return_exceptions=True), 10)

    out = asyncio.run(main())
    assert len(out) == 2 and all(isinstance(r, ServerClosed) for r in out)


def test_journal_crash_then_recover(fields, tmp_path):
    """A journaled server aborted mid-solve leaves its requests in the
    journal; a fresh server over the same directory recovers them (each
    verified, each bitwise its direct solve) and leaves zero incomplete
    entries, which the JAX package's scan confirms."""
    gauges, pool = fields
    d = str(tmp_path)

    async def crash():
        srv = _server(gauges, journal_dir=d,
                      fault_injector=chaos.BatchFaultInjector(
                          mode="stall", every=1, stall_s=0.3))
        pending = [asyncio.ensure_future(srv.submit(_req(pool, i)))
                   for i in range(3)]
        await asyncio.sleep(0.05)
        await srv.close(drain=False)
        return await asyncio.gather(*pending, return_exceptions=True)

    async def recover():
        srv = _server(gauges, journal_dir=d)
        summary = await srv.recover()
        await srv.close()
        return summary

    lost = asyncio.run(crash())
    assert all(isinstance(r, ServerClosed) for r in lost)
    assert len(jjournal.incomplete_requests(d)) == 3
    summary = asyncio.run(recover())
    assert summary["found"] == summary["completed"] == 3
    assert journal.incomplete_requests(d) == []
    assert jjournal.incomplete_requests(d) == []


def test_deflation_cache_serves_verified_lanes(fields):
    """With ``deflation_nev`` the first verified batch on a key harvests
    a basis; later requests on the key are served deflated, verified and
    bitwise their direct deflated solve; re-registering the gauge
    invalidates the basis."""
    gauges, pool = fields

    async def main():
        srv = _server(gauges, deflation_nev=2, deflation_m_max=16,
                      deflation_harvest_tol=1e-8)
        first = await srv.submit(_req(pool, 0))
        later = await asyncio.gather(*(srv.submit(_req(pool, i))
                                       for i in (1, 2)))
        bases = srv.deflations.bases()
        m = srv.metrics()["deflation"]
        srv.register_gauge("g0", gauges["g0"])
        inval = srv.deflations.stats()["invalidations"]
        await srv.close()
        return first, later, bases, m, inval

    first, later, bases, m, inval = asyncio.run(main())
    assert not first.stats.deflation_cache_hit
    assert all(r.stats.deflation_cache_hit and r.stats.verified
               for r in later)
    assert m["harvests"] == 1 and m["hits"] == 1 and inval == 1
    cfg = loadgen.WorkloadConfig(lattice=(2, 4, 2, 8), device="cpu",
                                 mass=MASS)
    reqs = [_req(pool, i) for i in (1, 2)]
    v = loadgen.verify_against_direct(gauges, reqs, [(0.0, r) for r in later],
                                      cfg, deflation_bases=bases)
    # the batched Galerkin start sums in another order than the single
    # one, so a deflated lane agrees to the loadgen's 1e-5, not bitwise
    assert v["checked"] == 2 and v["passed"]


# ---------------------------------------------------------------------------
# the load generator and the CLI
# ---------------------------------------------------------------------------


def test_run_workload_chaos_and_journal(tmp_path):
    """A chaos workload: poisoned requests fail alone, a transient gauge
    fault's healthy victims are rescued by the individual re-solve, every
    served response is bitwise its direct solve; the journal ends with
    no incomplete entry."""
    cfg = loadgen.WorkloadConfig(
        lattice=(2, 4, 2, 8), device="cpu", requests=12, burst=4,
        interarrival_s=0.01, max_wait_s=0.02, rhs_pool=4, chaos=True,
        chaos_poison_fraction=0.25, chaos_fault_every=2, verify=True,
        journal_dir=str(tmp_path))
    report = loadgen.run_workload(cfg)
    c = report["chaos"]
    assert c["containment_ok"] and c["all_accounted"]
    assert c["poisoned"] == 3 and c["healthy_ok"] == 9
    assert report["verify"]["passed"] and report["verify"]["max_abs_err"] == 0
    assert journal.incomplete_requests(str(tmp_path)) == []


def test_serve_solver_cli(capsys):
    rc = serve_solver.main(["--device", "cpu", "--lattice", "2x4x2x8",
                            "--requests", "8", "--burst", "4",
                            "--interarrival-ms", "5", "--max-wait-ms", "20",
                            "--verify"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "verify: 8 responses" in out and "(OK)" in out
    assert serve_solver.main(["--lattice", "2x4x2"]) == 1


def test_fixture_problem_served_on_the_reference_backend():
    """The 4^4 seed-7 fixture served by JAX's server on its reference
    backend and by the port's on each backend: one request (the JAX
    golden count, 14) and three requests padded to rung 4 with mixed
    tolerances.  x within 1e-5, equal per-request iterations, verdicts
    and rungs; the port's served x bitwise its direct solve."""
    with np.load(GOLDEN) as f:
        gauge, b1, b3 = f["gauge"], f["b"], f["b_batch"][:3]
    tols = (1e-6, 1e-5, 1e-6)

    async def serve(mod, server_kw, u, rhs):
        srv = mod.SolverServer(mass=MASS, ladder=(1, 4),
                               policy=mod.BatchPolicy(max_wait=0.5),
                               **server_kw)
        srv.register_gauge("fx", u)
        one = await srv.submit(mod.SolveRequest("wilson", "fx", rhs[0],
                                                tol=TOL))
        three = await asyncio.gather(*(srv.submit(mod.SolveRequest(
            "wilson", "fx", r, tol=t)) for r, t in zip(rhs[1:], tols)))
        await srv.close()
        return [one] + list(three)

    theirs = asyncio.run(serve(
        jserver, dict(backend="reference"), jnp.asarray(gauge),
        [jnp.asarray(b1)] + [jnp.asarray(v) for v in b3]))
    u, b = fields_from_numpy(gauge, b1, device="cpu")
    _, bb = fields_from_numpy(gauge, b3, device="cpu")
    for backend in ("reference", "kernels"):
        ours = asyncio.run(serve(
            tserver, dict(backend=backend, device="cpu"), u,
            [b] + list(bb)))
        for o, t in zip(ours, theirs):
            assert (o.stats.iterations, o.stats.verdict, o.stats.padded_to,
                    o.stats.batch_size) == (
                int(t.stats.iterations), t.stats.verdict,
                t.stats.padded_to, t.stats.batch_size)
            assert o.stats.verified and t.stats.verified
            np.testing.assert_allclose(o.x.numpy(), np.asarray(t.x),
                                       rtol=0, atol=1e-5)
        assert ours[0].stats.iterations == 14
        assert [o.stats.padded_to for o in ours] == [1, 4, 4, 4]
        assert torch.equal(ours[0].x, _direct(u, b, TOL, backend=backend))


def test_kernel_counts_survive_concurrent_threads():
    """The launch and plain-call counts are bumped under a lock: more
    threads than cores, a short switch interval, no lost update."""
    import sys
    import threading

    from repro_torch.kernels import build
    from repro_torch.kernels.wilson_dslash.kernel import wilson_hop

    reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            build.count(wilson_hop, "plain_calls", torch.float32)
            for _ in range(2000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts()["wilson_hop"]["plain_calls"] == 16 * 2000
    reset_counts()
