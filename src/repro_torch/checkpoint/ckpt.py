"""Checkpointing: atomic, checksummed, in the JAX package's format.

Layout:  <dir>/step_<N:08d>/arrays.npz + manifest.json  (written in a tmp
dir and renamed into place, so a crash mid-write never corrupts the
latest complete checkpoint).

The bytes are the JAX package's: leaves are stored as full host numpy
arrays keyed by their tree path (dict keys and sequence indices joined
by ``§``), and the manifest holds the same keys (``step``, ``sha256``,
``keys``, ``jax_process_count``).  A checkpoint written by either package
restores in the other, so the port can resume a solve the JAX package
checkpointed, and the reverse.

A tree is a nest of dicts (keys sorted, as JAX flattens them) over
leaves: torch tensors, numpy arrays or scalars on save; on restore, a
``(shape, dtype)`` pair or anything with a ``shape``, which stands where
the JAX package takes a ``ShapeDtypeStruct``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

_SEP = "§"


def _warn(msg: str) -> None:
    print(f"[ckpt] {msg}", file=sys.stderr)


def _leaves(tree, path=()):
    """(key, leaf) pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield _SEP.join(path), tree


def _rebuild(tree, values: dict, path=()):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, path + (str(k),))
                for k in tree}
    return values[_SEP.join(path)]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _process_count() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Atomically write ``tree`` as step_<step>. Returns the final path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {key: _host(leaf) for key, leaf in _leaves(tree)}
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        npz = os.path.join(tmp, "arrays.npz")
        np.savez(npz, **arrays)
        with open(npz, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        # the manifest's keys are the JAX package's, its process count
        # included, so either package reads the other's checkpoints
        manifest = {"step": int(step), "sha256": digest,
                    "keys": sorted(arrays.keys()),
                    "jax_process_count": _process_count()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        final = os.path.join(ckpt_dir, f"step_{int(step):08d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        return final
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def valid_steps(ckpt_dir: str) -> list[int]:
    """Ascending list of step numbers with a COMPLETE ``step_<N>`` dir.

    Complete means the atomic rename landed (manifest.json present); the
    contents may still fail the checksum, which :func:`restore_checkpoint`
    verifies per step.
    """
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete all but the newest ``keep`` complete checkpoints."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    for step in valid_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{step:08d}"),
                      ignore_errors=True)


def _restore_step(ckpt_dir: str, step: int, target_tree, device):
    """Restore exactly ``step_<step>``; IOError on any corruption
    (unreadable or tampered manifest, truncated or checksum-failing npz)."""
    path = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with open(os.path.join(path, "arrays.npz"), "rb") as f:
            raw = f.read()
    except (OSError, ValueError) as e:
        raise IOError(f"checkpoint {path} is unreadable ({e})") from e
    if not isinstance(manifest, dict) or "sha256" not in manifest:
        raise IOError(f"checkpoint {path} has a tampered manifest")
    if hashlib.sha256(raw).hexdigest() != manifest["sha256"]:
        raise IOError(f"checkpoint {path} failed checksum verification")
    # the checksum passed, so the bytes are the writer's: an error past
    # here is the caller's (a wrong target tree), raised, and never
    # triggers the fallback walk
    data = np.load(io.BytesIO(raw))
    values = {}
    for key, spec in _leaves(target_tree):
        arr = data[key]
        shape = tuple(spec.shape if hasattr(spec, "shape") else spec[0])
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {shape}")
        values[key] = torch.from_numpy(np.array(arr)).to(device)
    return _rebuild(target_tree, values)


def restore_checkpoint(ckpt_dir: str, step: int, target_tree,
                       device="cpu"):
    """Restore into the structure of ``target_tree`` (shapes must match),
    as tensors on ``device``.

    Corruption-tolerant: when ``step_<step>`` fails its checksum (or is
    truncated or unreadable), the restore falls back to the previous
    complete step instead of raising.  Raises IOError only when no step
    at or below ``step`` restores cleanly.
    """
    candidates = [s for s in valid_steps(ckpt_dir) if s <= int(step)]
    last_err: IOError | None = None
    for s in sorted(candidates, reverse=True):
        try:
            return _restore_step(ckpt_dir, s, target_tree, device)
        except IOError as e:
            last_err = e
            _warn(f"{e}; falling back to the previous complete step")
    if last_err is not None:
        raise last_err
    raise IOError(f"no complete checkpoint at or below step {int(step)} "
                  f"in {ckpt_dir}")


def restore_latest(ckpt_dir: str, target_tree, device="cpu"):
    """``(step, tree)`` from the newest checkpoint that restores cleanly.

    Walks complete steps newest first, skipping any that fail checksum
    verification (with a warning).  Raises FileNotFoundError when the
    directory holds no complete checkpoint at all, IOError when every
    complete checkpoint is corrupt.
    """
    steps = valid_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    last_err: IOError | None = None
    for s in reversed(steps):
        try:
            return s, _restore_step(ckpt_dir, s, target_tree, device)
        except IOError as e:
            last_err = e
            _warn(f"{e}; falling back to the previous complete step")
    raise last_err
