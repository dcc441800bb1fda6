"""Weights carried across from the JAX package.

:func:`params_from_jax` takes a JAX parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``: nested dicts and lists) and returns
the port's model holding the same weights.  JAX stacks each segment's (or
the encoder's and decoder's) layers over a leading depth axis; the port
keeps one module per layer, so each such leaf is unstacked here.  Nothing
of JAX is imported: the tree is plain numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lattice import resolve_device
from repro_torch.models import steps as S
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


def _tensor(a) -> torch.Tensor:
    """numpy -> torch, bfloat16 (ml_dtypes, which numpy lacks) included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def jax_path(cfg: ModelConfig, name: str) -> tuple[tuple, int | None]:
    """The JAX tree path of the port's parameter ``name`` (as
    ``named_parameters`` gives it) and the index on its stacked depth axis
    (None for an unstacked leaf)."""
    parts = name.split(".")
    if parts[0] == "layers":                         # decoder-only
        _, si, c, j = TF.layer_slots(cfg)[int(parts[1])]
        return ("segments", si, f"b{j}", *parts[2:]), c
    if parts[0] in ("encoder", "decoder"):           # encoder-decoder
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def params_from_jax(cfg: ModelConfig, tree, *, device="cuda"):
    """The port's model (``steps.model_module(cfg)``'s form) holding the
    weights of JAX parameter tree ``tree`` (numpy leaves), on ``device``.
    Each parameter takes its leaf's dtype (JAX's ``init_params`` with
    16-bit weights leaves its output projections in f32).  Raises if a
    shape differs or a JAX leaf is left over."""
    device = resolve_device(device)
    dtype = _tensor(tree["embed"]["tok"][:1]).dtype
    model = S.model_module(cfg).init_params(cfg, None, dtype=dtype,
                                            device=device)
    used = set()
    for name, p in model.named_parameters():
        path, idx = jax_path(cfg, name)
        node = tree
        for key in path:
            node = node[key]
        used.add(path)
        t = _tensor(node if idx is None else np.asarray(node)[idx])
        if t.shape != p.shape:
            raise ValueError(f"{name} <- {'/'.join(map(str, path))}: JAX "
                             f"{tuple(t.shape)}, port {tuple(p.shape)}")
        p.data = t.to(device)
    leaves = set(_paths(tree))
    if leaves != used:
        raise ValueError(f"JAX leaves without a port parameter: "
                         f"{sorted(leaves - used)}")
    return model


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix
