"""The port's LM training loop, checkpoints and CLI on the CPU: twins of
tests/test_steps_and_ckpt.py (the loss falls, a restored run continues
bitwise, a corrupted checkpoint is refused, the data stream restarts
deterministically), train-state checkpoints that cross between the two
packages, and ``python -m repro_torch.launch.train`` killed with SIGTERM
and resumed with ``--resume auto``.

A train state crosses as JAX's tree (``models/convert.py::
train_state_to_jax``) written under JAX's keys.  bf16 moments (the
nemotron configs) are stored as JAX stores them, 2-byte void entries;
JAX's own ``restore_checkpoint`` cannot put those on a device (a finding
about the reference, ROADMAP), so for them only the port's restores are
held.
"""

import os
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_lm_twins as tw
from repro import configs as jconfigs
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.models import steps as JS
from repro.optim import AdamWConfig as JAdamW
from repro_torch import configs
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.models import convert
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig
import torch_one_thread  # noqa: F401  (one intra-op thread)

OPT = AdamWConfig(lr=1e-3, weight_decay=0.01)
ROOT = Path(__file__).resolve().parents[1]


def _train(arch, steps, seed=0, state=None, start=0):
    """tests/test_steps_and_ckpt.py::_train on the port (f32 compute,
    batch 4, 48 tokens after any prefix)."""
    cfg = configs.get_smoke(arch)
    if state is None:
        state = S.init_train_state(cfg, torch.Generator().manual_seed(seed),
                                   OPT, device="cpu")
    fn = S.make_train_step(cfg, OPT, compute_dtype=torch.float32)
    seq = 48 + (cfg.num_prefix_embeds or 0)
    data = SyntheticLM(cfg, batch=4, seq_len=seq, seed=seed, device="cpu")
    losses = []
    for i in range(start, start + steps):
        state, m = fn(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    return state, losses


def _jax_leaves(cfg, state) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(
                convert.train_state_to_jax(cfg, state))[0]}


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("arch", ["glm4-9b", "qwen2-moe-a2.7b",
                                  "recurrentgemma-9b",
                                  "seamless-m4t-large-v2"])
def test_loss_decreases(arch):
    _, losses = _train(arch, 25)
    assert losses[-1] < losses[0] - 0.3, losses[::6]
    assert np.isfinite(losses).all()


def test_checkpoint_roundtrip_and_resume():
    """A train state saved and restored is bitwise the saved one, and 3
    more steps from it are bitwise 3 more steps in memory."""
    cfg = configs.get_smoke("glm4-9b")
    state, _ = _train("glm4-9b", 6)
    with tempfile.TemporaryDirectory() as d:
        save_checkpoint(d, 6, convert.train_state_to_jax(cfg, state))
        assert latest_step(d) == 6
        tree = restore_checkpoint(d, 6, convert.train_state_shapes(cfg, state))
        restored = convert.train_state_from_jax(cfg, tree, device="cpu")
        _assert_same(_jax_leaves(cfg, restored), _jax_leaves(cfg, state))
        s1, l1 = _train("glm4-9b", 3, state=restored, start=6)
        s2, l2 = _train("glm4-9b", 3, state=state, start=6)
        assert l1 == l2
        _assert_same(_jax_leaves(cfg, s1), _jax_leaves(cfg, s2))


def test_checkpoint_checksum_detects_corruption():
    cfg = configs.get_smoke("glm4-9b")
    state, _ = _train("glm4-9b", 1)
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(d, 1, convert.train_state_to_jax(cfg, state))
        npz = os.path.join(path, "arrays.npz")
        raw = bytearray(open(npz, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(npz, "wb").write(bytes(raw))
        with pytest.raises(IOError):
            restore_checkpoint(d, 1, convert.train_state_shapes(cfg, state))


def test_data_pipeline_deterministic_restart():
    cfg = configs.get_smoke("glm4-9b")
    d1 = SyntheticLM(cfg, batch=4, seq_len=32, seed=3, device="cpu")
    d2 = SyntheticLM(cfg, batch=4, seq_len=32, seed=3, device="cpu")
    assert torch.equal(d1.batch_at(17)["tokens"], d2.batch_at(17)["tokens"])
    assert not torch.equal(d1.batch_at(17)["tokens"],
                           d1.batch_at(18)["tokens"])


def _jax_state_tree(arch, moment_dtype, seed=5):
    """A JAX train state as numpy: the shared tree, moments drawn with
    numpy (v positive) in ``moment_dtype``, step 7."""
    jcfg = jconfigs.get_smoke(arch)
    params = tw.np_tree(jcfg, seed)
    rng = np.random.default_rng(seed)

    def moment(positive):
        return jax.tree.map(
            lambda p: (np.abs(rng.standard_normal(p.shape)) if positive else
                       rng.standard_normal(p.shape)).astype(moment_dtype),
            params)
    return jcfg, {"params": params,
                  "opt": {"step": np.asarray(7, np.int32), "m": moment(False),
                          "v": moment(True)}}


def _flat_np(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_train_checkpoint_crosses_packages_f32():
    """glm4 (f32 moments): the port's checkpoint restores in JAX's
    ``restore_checkpoint`` against ``jax.eval_shape`` of its
    ``init_train_state``, and JAX's restores in the port, leaf for leaf
    bitwise; the restored state then trains."""
    cfg = configs.get_smoke("glm4-9b")
    jcfg, jtree = _jax_state_tree("glm4-9b", np.float32)
    target = jax.eval_shape(lambda: JS.init_train_state(
        jcfg, jax.random.PRNGKey(0), JAdamW()))
    with tempfile.TemporaryDirectory() as d:
        # JAX -> port
        jsave(d, 7, jtree)
        shapes = convert.train_state_shapes(
            cfg, S.init_train_state(cfg, None, OPT, device="cpu"))
        state = convert.train_state_from_jax(
            cfg, restore_checkpoint(d, 7, shapes), device="cpu")
        _assert_same(_jax_leaves(cfg, state), _flat_np(jtree))
        # port -> JAX, after a step of the port's
        state, _ = _train("glm4-9b", 1, state=state, start=7)
        assert int(state["opt"]["step"]) == 8
        save_checkpoint(d, 8, convert.train_state_to_jax(cfg, state))
        back = jrestore(d, 8, target)
        _assert_same(_flat_np(back), _jax_leaves(cfg, state))


def test_train_checkpoint_bf16_moments():
    """nemotron (bf16 moments, stored as 2-byte void entries): a JAX-written
    checkpoint restores in the port bitwise, the port's own round trip is
    bitwise, and JAX's own restore of either raises (a finding about the
    reference: ``jax.device_put`` refuses ``|V2`` arrays)."""
    arch = "nemotron-4-340b"
    cfg = configs.get_smoke(arch)
    assert cfg.opt_state_dtype == "bfloat16"
    jcfg, jtree = _jax_state_tree(arch, jax.numpy.bfloat16)
    target = jax.eval_shape(lambda: JS.init_train_state(
        jcfg, jax.random.PRNGKey(0), JAdamW()))
    with tempfile.TemporaryDirectory() as d:
        jsave(d, 7, jtree)
        with pytest.raises(TypeError, match="V2"):
            jrestore(d, 7, target)
        shapes = convert.train_state_shapes(
            cfg, S.init_train_state(cfg, None, OPT, device="cpu"))
        state = convert.train_state_from_jax(
            cfg, restore_checkpoint(d, 7, shapes), device="cpu")
        assert state["opt"]["m"]["layers.0.attn.wq"].dtype == torch.bfloat16
        got = _jax_leaves(cfg, state)
        want = {k: v.view(np.uint16).view("V2") if v.dtype.name == "bfloat16"
                else v for k, v in _flat_np(jtree).items()}
        _assert_same(got, want)
        # the port's own round trip, after a step (bf16 moments updated)
        state, _ = _train(arch, 1, state=state, start=7)
        save_checkpoint(d, 8, convert.train_state_to_jax(cfg, state))
        again = convert.train_state_from_jax(
            cfg, restore_checkpoint(d, 8, shapes), device="cpu")
        _assert_same(_jax_leaves(cfg, again), _jax_leaves(cfg, state))
        with pytest.raises(TypeError, match="V2"):
            jrestore(d, 8, target)


def _cli(args, ckpt_dir, wait=True):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "glm4-9b", "--device", "cpu", "--steps", "40", "--batch", "2",
           "--seq-len", "32", "--warmup", "3", "--log-every", "1",
           "--ckpt-dir", ckpt_dir, *args]
    if wait:
        return subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=120)
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _npz(ckpt_dir, step) -> dict:
    with np.load(Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def test_cli_sigterm_then_resume_is_bitwise_uninterrupted():
    """The CLI killed with SIGTERM after its first step checkpoints and
    exits 0; ``--resume auto`` continues from that step to the same final
    state, bitwise, as an uninterrupted run."""
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        whole = _cli([], a)
        assert whole.returncode == 0, whole.stderr
        assert latest_step(a) == 40
        proc = _cli([], b, wait=False)
        try:
            for line in proc.stdout:
                if line.startswith("[train] step=0 "):
                    proc.send_signal(signal.SIGTERM)
                    break
            out, err = proc.communicate(timeout=120)
        finally:
            proc.kill()
        assert proc.returncode == 0, err
        assert "SIGTERM received" in out, out
        killed_at = latest_step(b)
        assert killed_at is not None and killed_at < 40, killed_at
        resumed = _cli(["--resume", "auto"], b)
        assert resumed.returncode == 0, resumed.stderr
        assert f"resuming from step {killed_at}" in resumed.stdout
        assert latest_step(b) == 40
        want, got = _npz(a, 40), _npz(b, 40)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].tobytes() == got[k].tobytes(), k


def test_cli_refuses_a_mesh_and_defaults_to_the_card(monkeypatch):
    """``--mesh debug`` outside a ``torchrun`` job is refused, naming
    torchrun (the mesh is its ranks; tests/test_torch_lm_parallel.py runs
    it under torchrun); without ``--device`` the CLI asks for the card,
    which is not here."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(["--arch", "glm4-9b", "--mesh", "debug",
                        "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "glm4-9b"])
