"""The port's example twins (``examples/torch_*.py``), each run at a smoke
size on the CPU: the quickstart's two solves on its 4^3 x 8 lattice, the
serving example with the JAX example's arguments, the training driver on
glm4-9b's smoke widths for a few steps and resumed from its checkpoint,
and the distributed solve on the smallest mesh it takes, two gloo ranks
under ``torchrun``.  None imports JAX or the JAX package."""

import ast
import importlib.util
import os
import pathlib
import subprocess
import sys

import pytest

import torch_one_thread  # noqa: F401  (one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
TWINS = ("torch_quickstart", "torch_distributed_solve", "torch_serve_lm",
         "torch_train_lm")


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _run(argv, timeout: float) -> str:
    proc = subprocess.run([sys.executable, *argv], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_only_the_port(name):
    """Each twin's imports name ``repro_torch`` and never ``jax`` or the
    JAX package ``repro``; its JAX example is there beside it."""
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert "repro_torch" in mods and not mods & {"jax", "repro"}, mods
    assert (EXAMPLES / f"{name.removeprefix('torch_')}.py").exists()


def test_quickstart_twin():
    out = _run([str(EXAMPLES / "torch_quickstart.py"), "--device", "cpu"],
               120)
    assert "wilson eo-schur cgnr:" in out and "wilson eo-schur mpcg:" in out


def test_serve_twin():
    out = _run([str(EXAMPLES / "torch_serve_lm.py"), "--arch", "glm4-9b",
                "--requests", "4", "--prompt-len", "32", "--gen", "12",
                "--device", "cpu"], 120)
    assert "[serve] arch=glm4-9b-smoke requests=4 prompt=32 gen=12" in out
    assert "[serve] sample continuations:" in out


def test_train_twin_resumes(tmp_path, capsys):
    """The driver's ``main`` on glm4-9b's smoke widths (its 100M model
    swapped out): 3 steps with a checkpoint at the last, then resumed to
    4; every loss finite."""
    from repro_torch import configs
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm", EXAMPLES / "torch_train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.model_100m = lambda: configs.get_smoke("glm4-9b")
    argv = ["--batch", "2", "--seq-len", "16", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    assert mod.main(argv + ["--steps", "3"]) == 0
    assert mod.main(argv + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "[example] resuming from step 3" in out
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.splitlines() if "loss=" in ln]
    assert len(losses) == 4 and all(abs(v) < 1e3 for v in losses), out


def test_distributed_twin_two_ranks():
    out = _run(["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2",
                str(EXAMPLES / "torch_distributed_solve.py"), "--mesh",
                "1x1x2", "--device", "cpu"], 180)
    assert "[dist] ranks=2" in out
    for solver in ("pipecg", "mpcg"):
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"[dist] {solver}:")]
        assert len(line) == 1 and float(line[0].split("rel_res=")[1]) < 1e-5
