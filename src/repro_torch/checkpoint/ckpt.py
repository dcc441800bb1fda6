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

A tree is a nest of dicts (keys sorted, as JAX flattens them) and lists
or tuples (keyed by index, as JAX keys a sequence) over leaves: torch
tensors, numpy arrays or scalars on save; on restore, a ``(shape,
dtype)`` pair or anything with a ``shape``, which stands where the JAX
package takes a ``ShapeDtypeStruct``.  A bf16 leaf is stored as JAX
stores one, as 2-byte void entries (``np.savez`` of an ml_dtypes array
loads back as ``|V2``), and restores as bf16 bitwise.

Elastic (the JAX launcher's restore re-shards on load): a state sharded
over a mesh is saved as whole arrays, so it restores onto any mesh or
onto one device.  ``save_checkpoint(..., mesh=, specs=)`` gathers each
leaf from its blocks (every rank takes part), rank 0 writes, and every
rank waits at a barrier; ``restore_checkpoint(..., mesh=, specs=)``
reads the whole leaves and keeps this rank's blocks.  ``specs`` is a
tree of the data tree's structure whose leaves are spec tuples
(``parallel/sharding.py``).
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

from repro_torch.parallel import sharding as shd

_SEP = "§"


def _warn(msg: str) -> None:
    print(f"[ckpt] {msg}", file=sys.stderr)


def _is_tuple_pair(tree) -> bool:
    """A ``(shape, dtype)`` restore spec, a leaf though it is a tuple."""
    return (isinstance(tree, tuple) and len(tree) == 2
            and isinstance(tree[0], (tuple, list, torch.Size)))


def _leaves(tree, path=()):
    """(key, leaf) pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not _is_tuple_pair(tree):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _specs(specs, path=()) -> dict:
    """``{key: spec}`` of a specs tree: dicts and lists are nodes, tuples
    the specs."""
    if isinstance(specs, dict):
        out = {}
        for k in specs:
            out.update(_specs(specs[k], path + (str(k),)))
        return out
    if isinstance(specs, list):
        out = {}
        for i, v in enumerate(specs):
            out.update(_specs(v, path + (str(i),)))
        return out
    return {_SEP.join(path): tuple(specs)}


def _rebuild(tree, values: dict, path=()):
    """``tree``'s structure with each leaf replaced by ``values[key]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], values, path + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)) and not _is_tuple_pair(tree):
        return type(tree)(_rebuild(v, values, path + (str(i),))
                          for i, v in enumerate(tree))
    return values[_SEP.join(path)]


def host_array(leaf) -> np.ndarray:
    """A leaf as the numpy array a checkpoint stores: a bf16 tensor as
    2-byte void entries, the form JAX's bf16 arrays take in a file."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def from_host(arr) -> torch.Tensor:
    """A stored array (or a JAX leaf as numpy) as a tensor on the CPU: 2-byte
    void entries and ml_dtypes bfloat16 (which numpy lacks) as bf16."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _process_count() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return 1


def save_checkpoint(ckpt_dir: str, step: int, tree, *, mesh=None,
                    specs=None) -> str:
    """Atomically write ``tree`` as step_<step>. Returns the final path.

    With ``mesh``, ``tree`` holds this rank's blocks (``specs``: their
    specs) and every rank calls this together: each leaf is gathered
    whole (``sharding.unshard_leaf``), rank 0 writes the whole arrays,
    and every rank returns after a barrier."""
    final = os.path.join(ckpt_dir, f"step_{int(step):08d}")
    if mesh is None:
        _write(ckpt_dir, final, step,
               {key: host_array(leaf) for key, leaf in _leaves(tree)})
        return final
    spec = _specs(specs)
    arrays = {}
    for key, leaf in _leaves(tree):
        whole = shd.unshard_leaf(mesh, leaf, spec[key], kind="ckpt_gather")
        if mesh.rank == 0:
            arrays[key] = host_array(whole)
        del whole
    if mesh.rank == 0:
        _write(ckpt_dir, final, step, arrays)
    del arrays
    mesh.barrier()
    return final


def _write(ckpt_dir: str, final: str, step: int, arrays: dict) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        npz = os.path.join(tmp, "arrays.npz")
        np.savez(npz, **arrays)
        sha = hashlib.sha256()
        with open(npz, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 26), b""):
                sha.update(chunk)
        digest = sha.hexdigest()
        # the manifest's keys are the JAX package's, its process count
        # included, so either package reads the other's checkpoints
        manifest = {"step": int(step), "sha256": digest,
                    "keys": sorted(arrays.keys()),
                    "jax_process_count": _process_count()}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
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


def _restore_step(ckpt_dir: str, step: int, target_tree, device,
                  blocks=None):
    """Restore exactly ``step_<step>``; IOError on any corruption
    (unreadable or tampered manifest, truncated or checksum-failing npz).
    ``blocks``: ``{key: slices}``, leaves of which only a block is kept
    (the target holds the stored, global shape)."""
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
        if blocks and key in blocks:
            arr = arr[blocks[key]]
        values[key] = from_host(arr).to(device)
    return _rebuild(target_tree, values)


def restore_checkpoint(ckpt_dir: str, step: int, target_tree,
                       device="cpu", *, mesh=None, specs=None):
    """Restore into the structure of ``target_tree`` (shapes must match),
    as tensors on ``device``.

    Corruption-tolerant: when ``step_<step>`` fails its checksum (or is
    truncated or unreadable), the restore falls back to the previous
    complete step instead of raising.  Raises IOError only when no step
    at or below ``step`` restores cleanly.

    With ``mesh``, ``target_tree`` holds this rank's block shapes and
    ``specs`` their specs: each stored (whole) leaf must have the global
    shape they imply, and only this rank's block of it is kept.
    """
    blocks = None
    if mesh is not None:
        spec = _specs(specs)
        shapes = {key: shd.global_shape(mesh, spec[key], tuple(
            leaf.shape if hasattr(leaf, "shape") else leaf[0]))
            for key, leaf in _leaves(target_tree)}
        blocks = {key: shd.block_slices(mesh, spec[key], shape)
                  for key, shape in shapes.items()}
        target_tree = _rebuild(target_tree, {
            key: (shape, None) for key, shape in shapes.items()})
    candidates = [s for s in valid_steps(ckpt_dir) if s <= int(step)]
    last_err: IOError | None = None
    for s in sorted(candidates, reverse=True):
        try:
            return _restore_step(ckpt_dir, s, target_tree, device, blocks)
        except IOError as e:
            last_err = e
            _warn(f"{e}; falling back to the previous complete step")
    if last_err is not None:
        raise last_err
    raise IOError(f"no complete checkpoint at or below step {int(step)} "
                  f"in {ckpt_dir}")


def restore_latest(ckpt_dir: str, target_tree, device="cpu", *,
                   blocks=None):
    """``(step, tree)`` from the newest checkpoint that restores cleanly.

    Walks complete steps newest first, skipping any that fail checksum
    verification (with a warning).  Raises FileNotFoundError when the
    directory holds no complete checkpoint at all, IOError when every
    complete checkpoint is corrupt.  ``blocks`` (``{key: slices}``, e.g.
    a mesh rank's :func:`repro_torch.core.distributed.block_slices` of
    the stored x) keeps only that block of those leaves; the stored
    format is the same either way.
    """
    steps = valid_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    last_err: IOError | None = None
    for s in reversed(steps):
        try:
            return s, _restore_step(ckpt_dir, s, target_tree, device, blocks)
        except IOError as e:
            last_err = e
            _warn(f"{e}; falling back to the previous complete step")
    raise last_err
