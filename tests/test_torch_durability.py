"""Durable solves of the port against the JAX package's.

The segmented solve (``solve(checkpoint=CheckpointPolicy)``), the
checkpoint store (``repro_torch.checkpoint.ckpt``), the retry ladder and
``resume_solve`` (``repro_torch.core.resilience``) and the CLI's
``--checkpoint-dir``/``--resume``, each held against its JAX twin on the
4^4 seed-7 fixture (``src/repro_torch/data/golden_4x4x4x4_seed7.npz``),
mass 0.1, tol 1e-6.  The port runs on the CPU (the kernels backend
through the kernels' plain versions); the JAX twin on its reference
backend.  Checkpoints are the same bytes in both packages, so each
restores the other's bitwise; a segmented solve is bitwise its one-shot
solve and writes the JAX solve's step numbers.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro.core import SolverPlan as JaxPlan
from repro.core import plan as jplan
from repro.core import resilience as jres
from repro_torch.checkpoint import ckpt
from repro_torch.core import plan as tplan
from repro_torch.core import resilience as res
from repro_torch.core import solvers
from repro_torch.core.lattice import fields_from_numpy
from repro_torch.serve.chaos import run_and_sigkill

import torch_one_thread  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "data" / "golden_4x4x4x4_seed7.npz"
MASS, TOL = 0.1, 1e-6


@pytest.fixture(scope="module")
def fx():
    with np.load(GOLDEN) as f:
        d = {k: f[k] for k in f.files}
    ut, bt = fields_from_numpy(d["gauge"], d["b"], device="cpu")
    _, b4t = fields_from_numpy(d["gauge"], d["b_batch16"][:4], device="cpu")
    return dict(u=jnp.asarray(d["gauge"]), b=jnp.asarray(d["b"]),
                b4=jnp.asarray(d["b_batch16"][:4]), ut=ut, bt=bt, b4t=b4t)


def rel_err(x, ref) -> float:
    ref = np.asarray(ref)
    return float(np.max(np.abs(np.asarray(x) - ref)) / np.max(np.abs(ref)))


def _tree(x, iteration, n=None):
    shape = () if n is None else (n,)
    return {"x": x, "iteration": np.asarray(iteration, np.int32),
            "verdict": np.zeros(shape, np.int32),
            "rhs_mask": np.ones(shape, np.bool_)}


def _jax_target(b):
    return {"iteration": jax.ShapeDtypeStruct((), jnp.int32),
            "rhs_mask": jax.ShapeDtypeStruct((), jnp.bool_),
            "verdict": jax.ShapeDtypeStruct((), jnp.int32),
            "x": jax.ShapeDtypeStruct(b.shape, b.dtype)}


def _port_target(b):
    return {"iteration": ((), np.int32), "rhs_mask": ((), np.bool_),
            "verdict": ((), np.int32), "x": (tuple(b.shape), b.dtype)}


def test_checkpoint_policy_validation(tmp_path):
    tplan.CheckpointPolicy(dir=str(tmp_path))
    with pytest.raises(ValueError, match="dir"):
        tplan.CheckpointPolicy(dir="")
    with pytest.raises(ValueError, match="every_iters"):
        tplan.CheckpointPolicy(dir=str(tmp_path), every_iters=0)
    with pytest.raises(ValueError, match="keep"):
        tplan.CheckpointPolicy(dir=str(tmp_path), keep=0)


# ---------------------------------------------------------------------------
# the store: one format, both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_cross_packages(fx, tmp_path, writer):
    """A checkpoint written by either package restores bitwise through the
    other's ``restore_latest``: the same keys, dtypes and manifest."""
    x = np.array(fx["b"])
    if writer == "port":
        ckpt.save_checkpoint(str(tmp_path), 7, _tree(torch.from_numpy(x), 7))
        step, tree = jckpt.restore_latest(str(tmp_path), _jax_target(x))
        got = {k: np.asarray(v) for k, v in tree.items()}
    else:
        jckpt.save_checkpoint(str(tmp_path), 7, _tree(jnp.asarray(x), 7))
        step, tree = ckpt.restore_latest(str(tmp_path), _port_target(x))
        got = {k: v.numpy() for k, v in tree.items()}
    want = _tree(x, 7)
    assert step == 7
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    manifest = json.loads((tmp_path / "step_00000007" / "manifest.json")
                          .read_text())
    assert sorted(manifest) == ["jax_process_count", "keys", "sha256", "step"]
    assert manifest["keys"] == ["iteration", "rhs_mask", "verdict", "x"]


def test_port_solve_snapshot_restores_in_jax(fx, tmp_path):
    """The snapshots of the port's checkpointed solve restore through the
    JAX package's store: the last one holds the solve's x, its iteration
    count, verdict and convergence mask."""
    x, st = tplan.solve(tplan.SolverPlan(), fx["ut"], fx["bt"], MASS,
                        tol=TOL, device="cpu",
                        checkpoint=tplan.CheckpointPolicy(str(tmp_path), 5))
    step, tree = jckpt.restore_latest(str(tmp_path), _jax_target(fx["b"]))
    assert step == st.iterations == int(tree["iteration"]) == 14
    assert np.asarray(tree["x"]).tobytes() == x.numpy().tobytes()
    assert int(tree["verdict"]) == solvers.CONVERGED
    assert bool(tree["rhs_mask"])


def _corrupt_newest(d: pathlib.Path, how: str) -> list[int]:
    steps = ckpt.valid_steps(str(d))
    newest = d / f"step_{steps[-1]:08d}"
    if how == "truncated":
        npz = newest / "arrays.npz"
        npz.write_bytes(npz.read_bytes()[:100])
    else:
        (newest / "manifest.json").write_text('{"step": %d}' % steps[-1])
    return steps


@pytest.mark.parametrize("how", ["truncated", "tampered"])
def test_corrupt_newest_step_falls_back(fx, tmp_path, how):
    """A truncated npz or a manifest without its checksum sends both
    packages' restores to the step before; when every step is corrupt the
    restore raises IOError, an empty directory FileNotFoundError."""
    x = fx["bt"]
    for step in (5, 10):
        ckpt.save_checkpoint(str(tmp_path), step, _tree(x * step, step))
    steps = _corrupt_newest(tmp_path, how)
    assert steps == [5, 10]
    step, tree = ckpt.restore_latest(str(tmp_path), _port_target(x))
    jstep, jtree = jckpt.restore_latest(str(tmp_path), _jax_target(fx["b"]))
    assert step == jstep == 5
    assert torch.equal(tree["x"], x * 5)
    assert np.asarray(jtree["x"]).tobytes() == tree["x"].numpy().tobytes()
    assert ckpt.restore_checkpoint(str(tmp_path), 10,
                                   _port_target(x))["iteration"] == 5
    (tmp_path / "step_00000005" / "arrays.npz").write_bytes(b"")
    with pytest.raises(IOError):
        ckpt.restore_latest(str(tmp_path), _port_target(x))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_latest(str(tmp_path / "empty"), _port_target(x))
    ckpt.prune_checkpoints(str(tmp_path), 1)
    assert ckpt.valid_steps(str(tmp_path)) == [10]
    assert ckpt.latest_step(str(tmp_path)) == 10


# ---------------------------------------------------------------------------
# segmented solves: bitwise the one-shot solve, JAX's step numbers
# ---------------------------------------------------------------------------

SEGMENTED = {"eo": (dict(), None), "eo-mixed": (dict(precision="mixed"), None),
             "full-n4": (dict(operator="full", nrhs=4), 4),
             "pipecg": (dict(solver="pipecg"), None)}


@pytest.fixture(scope="module")
def jax_runs(fx, tmp_path_factory):
    """The JAX package's segmented solves (reference backend, every 3,
    every step kept): {name: checkpoint directory}."""
    out = {}
    for name, (kw, n) in SEGMENTED.items():
        d = tmp_path_factory.mktemp(f"jax-{name}")
        jplan.solve(JaxPlan(backend="reference", **kw), fx["u"],
                    fx["b"] if n is None else fx["b4"], MASS, tol=TOL,
                    checkpoint=jplan.CheckpointPolicy(str(d), 3, keep=100))
        out[name] = d
    return out


# on the CPU both backends of the full path run K4's plain version, so
# the full lattice runs on one
@pytest.mark.parametrize("name,backend", [
    (name, backend) for name in SEGMENTED
    for backend in ("kernels", "reference")
    if (name, backend) != ("full-n4", "reference")])
def test_segmented_solve_is_bitwise_one_shot(fx, jax_runs, tmp_path, name,
                                             backend):
    kw, n = SEGMENTED[name]
    plan = tplan.SolverPlan(backend=backend, **kw)
    b = fx["bt"] if n is None else fx["b4t"]
    x1, s1 = tplan.solve(plan, fx["ut"], b, MASS, tol=TOL, device="cpu")
    x2, s2 = tplan.solve(plan, fx["ut"], b, MASS, tol=TOL, device="cpu",
                         checkpoint=tplan.CheckpointPolicy(str(tmp_path), 3,
                                                           keep=100))
    assert torch.equal(x1, x2)
    assert s1.iterations == s2.iterations
    assert s1.outer_iterations == s2.outer_iterations
    assert torch.equal(torch.atleast_1d(s1.verdict),
                       torch.atleast_1d(s2.verdict))
    assert bool(torch.atleast_1d(s2.verified).all())
    assert ckpt.valid_steps(str(tmp_path)) == \
        jckpt.valid_steps(str(jax_runs[name]))


def test_loop_program_steps_to_the_solve(fx):
    """``loop_program`` steps segment by segment (the bound reads the
    host-int counter) and finalizes to the one-shot solve's x; block CG
    has no segmented program, in JAX's words."""
    prog = tplan.loop_program(tplan.SolverPlan(solver="pipecg"), fx["ut"],
                              fx["bt"], MASS, tol=TOL, device="cpu")
    carry, cont = prog.start()
    seen = []
    while cont:
        carry, cont = prog.step(carry, prog.counter(carry) + 4)
        seen.append(prog.counter(carry))
    assert seen == [4, 8, 12, 14]
    x, st = prog.finalize(carry)
    x1, _ = tplan.solve(tplan.SolverPlan(solver="pipecg"), fx["ut"],
                        fx["bt"], MASS, tol=TOL, device="cpu")
    assert torch.equal(x, x1) and st.iterations == 14
    with pytest.raises(NotImplementedError, match="blockcg has no segmented"):
        tplan.solve(tplan.SolverPlan(solver="blockcg", nrhs=2), fx["ut"],
                    fx["b4t"][:2], MASS, device="cpu",
                    checkpoint=tplan.CheckpointPolicy("unused"))


# ---------------------------------------------------------------------------
# the retry ladder and resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(precision="mixed"), dict(operator="full", precision="low"),
    dict(backend="reference"), dict(precision="mixed", backend="reference")])
@pytest.mark.parametrize("policy", [
    dict(), dict(escalate_precision=False), dict(fallback_backend=False)])
def test_retry_ladder_equals_jax(kw, policy):
    """Rung for rung the JAX ladder, the port's ``kernels`` where JAX
    names ``pallas``."""
    ours = res.RetryPolicy(**policy).ladder(tplan.SolverPlan(**kw))
    jkw = dict(kw, backend="pallas" if kw.get("backend") != "reference"
               else "reference")
    theirs = jres.RetryPolicy(**policy).ladder(JaxPlan(**jkw))
    assert [res._plan_desc(p) for p in ours] == [
        jres._plan_desc(p).replace("/pallas/", "/kernels/") for p in theirs]


@pytest.mark.parametrize("kw", [dict(), dict(precision="mixed")])
def test_default_policy_has_no_backend_rung_on_cuda(kw):
    """A call that passes no policy keeps the kernels on a CUDA device:
    its ladder has no ``reference`` rung there, and is JAX's default on
    the CPU."""
    plan = tplan.SolverPlan(**kw)
    on_card = res.default_policy("cuda").ladder(plan)
    assert [res._plan_desc(p).split("/")[2] for p in on_card] == \
        ["kernels"] * len(on_card)
    assert res.default_policy("cpu") == res.RetryPolicy()
    assert len(res.default_policy("cpu").ladder(plan)) > len(on_card)


def test_defended_solve_healthy_and_ladder(fx):
    """A healthy plan is one attempt on its own rung; a maxiter too short
    to converge walks the ladder with defect-correction restarts and
    returns a verified x, or raises SolveFailure with every attempt."""
    x, st, att = res.defended_solve(tplan.SolverPlan(), fx["ut"], fx["bt"],
                                    MASS, tol=TOL, device="cpu")
    assert len(att) == 1 and att[0].attempt == 0 and not att[0].restarted
    assert att[0].plan_desc == "eo-schur/wilson/kernels/single"
    assert att[0].verified and bool(st.verified)
    x, st, att = res.defended_solve(tplan.SolverPlan(), fx["ut"], fx["bt"],
                                    MASS, tol=TOL, maxiter=6,
                                    policy=res.RetryPolicy(max_attempts=5),
                                    device="cpu")
    assert [a.restarted for a in att][:2] == [False, True]
    assert [a.plan_desc for a in att][:2] == [
        "eo-schur/wilson/kernels/single", "eo-schur/wilson/reference/single"]
    assert att[-1].verified and bool(st.verified)
    with pytest.raises(res.SolveFailure) as e:
        res.defended_solve(tplan.SolverPlan(), fx["ut"], fx["bt"], MASS,
                           tol=TOL, maxiter=2,
                           policy=res.RetryPolicy(max_attempts=2),
                           device="cpu")
    assert len(e.value.attempts) == 2 and e.value.verdict != "converged"


def test_resume_from_a_jax_checkpoint_matches_jax(fx, jax_runs, tmp_path):
    """The port's ``resume_solve`` of a JAX checkpoint (the even-odd solve
    with its steps past 6 removed: what a crash after step 6 leaves)
    gives x within 1e-5 of JAX's ``resume_solve`` of the same
    checkpoint, with equal attempt records, and banks the verified
    result as JAX does."""
    for copy in ("a", "b"):
        shutil.copytree(jax_runs["eo"], tmp_path / copy)
        for s in jckpt.valid_steps(str(tmp_path / copy)):
            if s > 6:
                shutil.rmtree(tmp_path / copy / f"step_{s:08d}")
    assert jckpt.valid_steps(str(tmp_path / "a")) == [3, 6]
    x, st, rec = res.resume_solve(tplan.SolverPlan(backend="reference"),
                                  fx["ut"], fx["bt"], MASS,
                                  checkpoint_dir=str(tmp_path / "a"),
                                  tol=TOL, device="cpu")
    xj, sj, recj = jres.resume_solve(JaxPlan(backend="reference"), fx["u"],
                                     fx["b"], MASS,
                                     checkpoint_dir=str(tmp_path / "b"),
                                     tol=TOL)
    assert rel_err(x, xj) <= 1e-5
    assert (rec.resumed_from_step, rec.checkpoint_iterations,
            rec.checkpoint_verdict) == (recj.resumed_from_step,
                                        recj.checkpoint_iterations,
                                        recj.checkpoint_verdict) == (
        6, 6, "maxiter_exhausted")
    fields = ("attempt", "restarted", "iterations", "verdict", "verified")
    assert [tuple(getattr(a, f) for f in fields) for a in rec.attempts] == [
        tuple(getattr(a, f) for f in fields) for a in recj.attempts]
    assert [a.plan_desc for a in rec.attempts] == [
        a.plan_desc for a in recj.attempts]
    assert bool(st.verified)
    assert (ckpt.valid_steps(str(tmp_path / "a"))
            == jckpt.valid_steps(str(tmp_path / "b")))


def test_resume_missing_ok_and_corrupt(fx, tmp_path):
    """No checkpoint: ``missing_ok`` runs a fresh checkpointed solve (else
    FileNotFoundError); a corrupt newest step resumes from the one
    before; every step corrupt stays an IOError under ``missing_ok``."""
    plan = tplan.SolverPlan()
    with pytest.raises(FileNotFoundError):
        res.resume_solve(plan, fx["ut"], fx["bt"], MASS,
                         checkpoint_dir=str(tmp_path), tol=TOL, device="cpu")
    x, st, rec = res.resume_solve(plan, fx["ut"], fx["bt"], MASS,
                                  checkpoint_dir=str(tmp_path), tol=TOL,
                                  missing_ok=True, device="cpu")
    assert rec.resumed_from_step is None and bool(st.verified)
    assert ckpt.valid_steps(str(tmp_path))
    d = tmp_path / "crashed"
    for step in (5, 10):
        ckpt.save_checkpoint(str(d), step, _tree(x, step))
    _corrupt_newest(d, "truncated")
    _, st, rec = res.resume_solve(plan, fx["ut"], fx["bt"], MASS,
                                  checkpoint_dir=str(d), tol=TOL,
                                  device="cpu")
    assert rec.resumed_from_step == 5 and bool(st.verified)
    for s in ckpt.valid_steps(str(d)):
        (d / f"step_{s:08d}" / "arrays.npz").write_bytes(b"x")
    with pytest.raises(IOError):
        res.resume_solve(plan, fx["ut"], fx["bt"], MASS,
                         checkpoint_dir=str(d), tol=TOL, missing_ok=True,
                         device="cpu")


# ---------------------------------------------------------------------------
# the CLI: killed mid-solve, resumed in a fresh process
# ---------------------------------------------------------------------------


def test_cli_sigkill_and_resume(tmp_path):
    """``--checkpoint-dir`` in a child killed with SIGKILL once its first
    step lands (a tolerance it cannot reach keeps it iterating), then
    ``--resume`` in a fresh process: the same u and b hashes, resumed
    from a real step, converged and verified."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    d = tmp_path / "ckpt"
    base = [sys.executable, "-m", "repro_torch.launch.solve", "--device",
            "cpu", "--lattice", "4x4x4x4", "--parity", "eo", "--solver",
            "cgnr", "--checkpoint-dir", str(d)]
    crashed = run_and_sigkill(
        base + ["--tol", "1e-12", "--maxiter", "1000000",
                "--checkpoint-every", "5"],
        kill_when=lambda: bool(ckpt.valid_steps(str(d))), env=env,
        timeout_s=120)
    assert crashed.killed
    banked = ckpt.valid_steps(str(d))
    assert banked and banked[0] >= 5
    out = subprocess.run(base + ["--resume"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

    def system(text):
        return [ln for ln in text.splitlines() if "system: u sha256" in ln]

    assert system(out.stdout) == system(crashed.stdout) != []
    assert f"resumed from step {banked[-1]}" in out.stdout
    assert "verdict: converged verified=True" in out.stdout
    attempts = [ln for ln in out.stdout.splitlines()
                if ln.startswith("[solve] attempt ")]
    assert attempts and all(" eo-schur/wilson/kernels/single " in ln
                            for ln in attempts), out.stdout
