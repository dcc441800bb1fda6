"""Sharding rules: map parameter and batch names onto a mesh (the port of
the JAX package's ``parallel/sharding.py``), and the blocks they place.

The JAX package's strategy: Megatron tensor parallelism over ``model``,
FSDP-style parameter and optimizer sharding over ``data``, batch data
parallelism over (``pod``, ``data``).  The rules are name-based, so every
family's parameter tree gets consistent specs without per-arch tables.

A spec is a plain tuple with one entry per dim, as JAX's
``PartitionSpec`` holds them: ``None`` (the dim whole), an axis name, or
a tuple of axis names (the dim split over their product, row-major in
that order); ``()`` is replicated.  Specs read a mesh only through its
``axis_names`` and ``shape`` (a ``core.distributed.Mesh`` or a
``launch.mesh.MeshShape``).

:func:`shard_leaf` gives this rank's block: the one ``jax.NamedSharding``
places on the device at this rank's coordinates of a mesh built from
devices 0..n-1 in row-major order (``Mesh.coords``).  A dim that its
axes' sizes do not divide raises ``ValueError``, as JAX's ``device_put``
and ``jit`` do for such a sharding.  :func:`unshard_leaf` gathers the
blocks back into the whole tensor on every rank.

The compute these specs imply (Megatron tensor parallelism over
``model``, ``constrain_heads``' three attention cases, parameters gathered
over ``data`` a layer at a time) is ``parallel/tp.py``.  Not ported yet
(ROADMAP item 18 part 2): the sequence sharding of
``set_mesh(seq_shard=True)`` (``constrain_batch``) and of the KV caches
(``kv_seq_shard``), the expert parallelism of
``moe.py::constrain_experts``, and tensor parallelism inside the RWKV and
RG-LRU mixers and the cross-attention.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

TP = "model"    # tensor-parallel axis
FSDP = "data"   # fully-sharded-parameter axis (also the batch axis)

# spec for the TRAILING dims of each named leaf; leading (stacking) dims
# are padded with None.  3D entries are MoE expert tensors.
_NAME_RULES: dict[str, tuple] = {
    # attention / generic projections
    "wq": (FSDP, TP), "wk": (FSDP, TP), "wv": (FSDP, TP), "wo": (TP, FSDP),
    # MLPs
    "wu": (FSDP, TP), "wg": (FSDP, TP), "wd": (TP, FSDP),
    # embeddings (vocab over TP for parallel logits, d over FSDP)
    "tok": (TP, FSDP), "out": (TP, FSDP),
    # MoE router + experts (experts over TP = expert parallelism)
    "router": (None, TP),
    "moe/wg": (TP, FSDP, None), "moe/wu": (TP, FSDP, None),
    "moe/wd": (TP, None, FSDP),
    # rwkv
    "wr": (FSDP, TP), "ck": (FSDP, TP), "cv": (TP, FSDP), "cr": (FSDP, TP),
    # rg-lru
    "wx": (FSDP, TP), "conv": (None, TP),
}

# The data-parallel split of the step in flight: its mesh and the axes
# its batch rows are split over.  Process-wide, as JAX's ``_CTX``: the
# MoE layer reads it in the forward and again where remat recomputes
# that forward, inside autograd's own threads.
_CTX = {"mesh": None, "dp": None}


@contextlib.contextmanager
def set_mesh(mesh, *, dp_axes=None):
    """Activate a mesh for the step in flight (no-op when None);
    ``dp_axes``: the axes its batch rows are split over (``dp_axes_for``
    of the global batch), whose ranks hold different rows."""
    prev = (_CTX["mesh"], _CTX["dp"])
    _CTX["mesh"], _CTX["dp"] = mesh, (dp_axes if mesh is not None else None)
    try:
        yield
    finally:
        _CTX["mesh"], _CTX["dp"] = prev


def data_parallel():
    """``(mesh, dp_axes)`` of the step in flight; ``(None, None)`` off-mesh
    or when its batch is not split."""
    if _CTX["dp"] is None:
        return None, None
    return _CTX["mesh"], _CTX["dp"]


def batch_axes(mesh, batch: int | None = None):
    """Data-parallel axes; drops axes the batch size cannot divide."""
    if mesh is None:
        return None
    axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if batch is None:
        return axes
    total = 1
    for ax in axes:
        total *= mesh.shape[ax]
    if batch % total == 0:
        return axes
    if batch % mesh.shape["data"] == 0:
        return ("data",)
    return None


def tp_axis_for(dim_size: int, mesh) -> str | None:
    """``model`` when the dimension divides the TP axis, else replicated."""
    if mesh is None or TP not in mesh.axis_names:
        return None
    return TP if dim_size % mesh.shape[TP] == 0 else None


def tp_size(mesh) -> int:
    """Size of the TP axis of the mesh (0 when off-mesh)."""
    if mesh is None or TP not in mesh.axis_names:
        return 0
    return int(mesh.shape[TP])


def spec_for(path: tuple[str, ...], ndim: int) -> tuple:
    """The spec of a parameter leaf from its JAX tree path (strings) at
    its ndim in JAX's tree (layers stacked)."""
    name = path[-1]
    in_moe = any("moe" in p for p in path[:-1]) and "shared" not in path
    key = f"moe/{name}" if in_moe and f"moe/{name}" in _NAME_RULES else name
    base = _NAME_RULES.get(key)
    if base is None or ndim < len(base):
        return ()  # replicated (norm scales, gates, small vectors)
    return (None,) * (ndim - len(base)) + base


def param_specs(tree):
    """Specs matching a JAX-shaped parameter tree (dicts and lists over
    leaves with a ``shape``)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (str(i),)) for i, v in enumerate(node)]
        return spec_for(path, len(node.shape))
    return walk(tree, ())


def entry(axes) -> str | tuple | None:
    """A spec entry for a dim split over ``axes`` (a tuple or None), in
    JAX's normal form: one axis as its name."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _dim_axes(e) -> tuple:
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def spec_axes(mesh, spec: tuple) -> tuple:
    """The mesh axes ``spec`` names, in the mesh's order."""
    named = {a for e in spec for a in _dim_axes(e)}
    return tuple(a for a in mesh.axis_names if a in named)


def _splits(mesh, spec: tuple, shape) -> list[int]:
    """How many blocks each dim is split into; raises as JAX does when a
    dim's axes do not divide it."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the shape "
                         f"{tuple(shape)} has dims")
    out = []
    for d, size in enumerate(shape):
        n = math.prod(mesh.shape[a] for a in
                      _dim_axes(spec[d] if d < len(spec) else None))
        if size % n:
            raise ValueError(
                f"the sharding {spec} on the mesh {dict(mesh.shape)} implies "
                f"that the global size of its dimension {d} should be "
                f"divisible by {n}, but it is equal to {size} (full shape: "
                f"{tuple(shape)})")
        out.append(n)
    return out


def block_shape(mesh, spec: tuple, shape) -> tuple:
    """The shape of one block of a leaf of global ``shape``."""
    return tuple(s // n for s, n in zip(shape, _splits(mesh, spec, shape)))


def global_shape(mesh, spec: tuple, shape) -> tuple:
    """The global shape of a leaf whose blocks have ``shape``."""
    ns = [math.prod(mesh.shape[a] for a in
                    _dim_axes(spec[d] if d < len(spec) else None))
          for d in range(len(shape))]
    return tuple(s * n for s, n in zip(shape, ns))


def block_slices(mesh, spec: tuple, shape, coords=None) -> tuple:
    """The slices of the block at ``coords`` (default: this rank's,
    ``mesh.coords``) of a leaf of global ``shape``: along a dim split over
    axes (a, b), block index ``coords[a] * size(b) + coords[b]``."""
    coords = mesh.coords if coords is None else coords
    out = []
    for d, n in enumerate(_splits(mesh, spec, shape)):
        axes = _dim_axes(spec[d] if d < len(spec) else None)
        i = int(np.ravel_multi_index(
            tuple(coords[a] for a in axes),
            tuple(mesh.shape[a] for a in axes))) if axes else 0
        size = shape[d] // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_leaf(mesh, t: torch.Tensor, spec: tuple) -> torch.Tensor:
    """This rank's block of ``t`` (a tensor of its own storage)."""
    return t[block_slices(mesh, spec, t.shape)].clone(
        memory_format=torch.contiguous_format)


def unshard_leaf(mesh, block: torch.Tensor, spec: tuple, *,
                 kind: str = "leaf_gather") -> torch.Tensor:
    """The whole tensor whose block at this rank is ``block``, on every
    rank: one all-gather over the axes ``spec`` names (``Mesh.all_gather``
    counted as ``kind``), each block put at its coordinates.  A replicated
    leaf is returned as it is."""
    axes = spec_axes(mesh, spec)
    if not axes:
        return block
    parts = mesh.all_gather(block, axes=axes, kind=kind)
    shape = global_shape(mesh, spec, block.shape)
    out = torch.empty(shape, dtype=block.dtype, device=block.device)
    for r, part in zip(mesh.axes_ranks(axes), parts):
        out[block_slices(mesh, spec, shape, mesh.coords_of(r))] = part
    return out
