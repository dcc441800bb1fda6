"""Weights and train states carried across from and to the JAX package.

:func:`params_from_jax` takes a JAX parameter pytree as numpy arrays
(``jax.tree.map(np.asarray, params)``: nested dicts and lists) and returns
the port's model holding the same weights; :func:`params_to_jax` is its
inverse.  JAX stacks each segment's (or the encoder's and decoder's)
layers over a leading depth axis; the port keeps one module per layer, so
each such leaf is unstacked on the way in and stacked on the way out.
:func:`train_state_from_jax` / :func:`train_state_to_jax` do the same for
a train state, ``{"params", "opt": {"step", "m", "v"}}``, whose moments
mirror the parameters.  Nothing of JAX is imported: the trees are plain
numpy (a bf16 leaf as ml_dtypes bfloat16 or as the 2-byte void entries a
checkpoint stores).

On a mesh a train state holds this rank's block of every leaf
(``steps.init_train_state(..., mesh=)``): :func:`param_spec` gives a
parameter's spec at the port's (unstacked) ndim, :func:`train_state_tree`
and :func:`train_state_specs_to_jax` the blocks and their specs in JAX's
tree (what ``checkpoint.save_checkpoint(..., mesh=)`` unshards), and
:func:`train_state_from_jax` with ``mesh=`` takes a tree of blocks (what
``checkpoint.restore_checkpoint(..., mesh=)`` returns).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import from_host, host_array
from repro_torch.core.lattice import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import sharding as shd


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


def param_spec(cfg: ModelConfig, name: str, ndim: int) -> tuple:
    """The spec of the port's parameter ``name`` (of ``ndim`` dims, one
    layer's): JAX's ``spec_for`` at its JAX path and stacked ndim, less
    the stacked depth dim (which JAX's rules never shard)."""
    path, idx = jax_path(cfg, name)
    spec = shd.spec_for(tuple(map(str, path)), ndim + (idx is not None))
    if idx is not None and spec:
        if spec[0] is not None:
            raise ValueError(f"{name}: JAX's rule {spec} shards the depth "
                             "dim, which the port does not stack")
        return spec[1:]
    return spec


def _leaf(tree, cfg: ModelConfig, name: str) -> torch.Tensor:
    """The port tensor of parameter ``name`` in JAX tree ``tree`` (numpy
    or tensor leaves), on the CPU."""
    path, idx = jax_path(cfg, name)
    node = tree
    for key in path:
        node = node[key]
    if isinstance(node, torch.Tensor):
        return node if idx is None else node[idx]
    return from_host(node if idx is None else np.asarray(node)[idx])


def params_from_jax(cfg: ModelConfig, tree, *, device="cuda", mesh=None):
    """The port's model (``steps.model_module(cfg)``'s form) holding the
    weights of JAX parameter tree ``tree`` (numpy or tensor leaves), on
    ``device``.  Each parameter takes its leaf's dtype (JAX's
    ``init_params`` with 16-bit weights leaves its output projections in
    f32).  With ``mesh``, ``tree`` holds this rank's blocks and so does
    the model.  Raises if a shape differs or a JAX leaf is left over."""
    device = resolve_device(device)
    dtype = _leaf(tree, cfg, "embed.tok").dtype
    module = ED if cfg.is_encdec else TF
    model = module.init_params(cfg, None, dtype=dtype, device=device)
    used = set()
    for name, p in model.named_parameters():
        t = _leaf(tree, cfg, name)
        used.add(jax_path(cfg, name)[0])
        want = p.shape if mesh is None else torch.Size(shd.block_shape(
            mesh, param_spec(cfg, name, p.ndim), p.shape))
        if t.shape != want:
            path = "/".join(map(str, jax_path(cfg, name)[0]))
            raise ValueError(f"{name} <- {path}: JAX {tuple(t.shape)}, port "
                             f"{tuple(want)}")
        p.data = t.to(device)
    leaves = set(_paths(tree))
    if leaves != used:
        raise ValueError(f"JAX leaves without a port parameter: "
                         f"{sorted(leaves - used)}")
    return model


def _jax_tree(cfg: ModelConfig, named, leaf):
    """JAX's tree over the port's ``(name, tensor)`` pairs: each JAX leaf
    is ``leaf(tensors, stacked)``, ``tensors`` the port tensors JAX stacks
    there in depth order (``stacked``), or the one tensor of an unstacked
    leaf in a list.  Segments are a list, as in JAX."""
    parts: dict = {}
    for name, t in named:
        path, idx = jax_path(cfg, name)
        parts.setdefault(path, {})[idx] = t
    tree: dict = {}
    for path, byidx in parts.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        stacked = None not in byidx
        node[path[-1]] = leaf([byidx[i] for i in sorted(byidx)]
                              if stacked else [byidx[None]], stacked)
    return _lists(tree)


def _lists(node):
    """Dicts keyed 0..n-1 (the segment indices) as lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def _host_leaf(ts, stacked):
    arrs = [host_array(t) for t in ts]
    return np.stack(arrs) if stacked else arrs[0]


def _tensor_leaf(ts, stacked):
    return torch.stack(ts) if stacked else ts[0]


def _spec_leaf(specs, stacked):
    spec = specs[0]
    return (None, *spec) if stacked and spec else spec


def _shape_leaf(ts, stacked):
    shape = tuple(ts[0].shape)
    return ((len(ts), *shape) if stacked else shape, ts[0].dtype)


def params_to_jax(cfg: ModelConfig, named) -> dict:
    """JAX's parameter tree (numpy leaves; bf16 as 2-byte void entries)
    from the port's ``(name, tensor)`` pairs: ``model.named_parameters()``,
    or a gradient or moment dict's items."""
    return _jax_tree(cfg, named, _host_leaf)


def param_shapes(cfg: ModelConfig, named) -> dict:
    """JAX's parameter tree with ``(shape, dtype)`` leaves (a stacked
    leaf's shape with its depth dim) from the port's ``(name, tensor)``
    pairs."""
    return _jax_tree(cfg, named, _shape_leaf)


def _train_state_tree(cfg: ModelConfig, state: dict, leaf) -> dict:
    opt = state["opt"]
    return {"params": _jax_tree(cfg, state["params"].named_parameters(),
                                leaf),
            "opt": {"step": leaf([opt["step"]], False),
                    "m": _jax_tree(cfg, opt["m"].items(), leaf),
                    "v": _jax_tree(cfg, opt["v"].items(), leaf)}}


def train_state_to_jax(cfg: ModelConfig, state: dict) -> dict:
    """The port's train state (``steps.init_train_state``'s form) as JAX's
    ``{"params", "opt": {"step", "m", "v"}}`` with numpy leaves: what
    ``checkpoint.save_checkpoint`` writes in the JAX package's keys."""
    return _train_state_tree(cfg, state, _host_leaf)


def train_state_tree(cfg: ModelConfig, state: dict) -> dict:
    """:func:`train_state_to_jax`'s tree with the state's tensors as
    leaves, on their device (a stacked leaf: the layers' tensors stacked):
    on a mesh, this rank's blocks."""
    return _train_state_tree(cfg, state, _tensor_leaf)


def train_state_specs_to_jax(cfg: ModelConfig, specs: dict) -> dict:
    """``steps.state_specs``'s specs (keyed by the port's parameter
    names) in JAX's tree, a stacked leaf's with its depth dim: JAX's
    ``state_specs`` of the same state."""
    return {"params": _jax_tree(cfg, specs["params"].items(), _spec_leaf),
            "opt": {"step": specs["opt"]["step"],
                    "m": _jax_tree(cfg, specs["opt"]["m"].items(),
                                   _spec_leaf),
                    "v": _jax_tree(cfg, specs["opt"]["v"].items(),
                                   _spec_leaf)}}


def train_state_shapes(cfg: ModelConfig, state: dict) -> dict:
    """:func:`train_state_to_jax`'s tree with ``(shape, dtype)`` leaves:
    the target ``checkpoint.restore_checkpoint`` takes."""
    return _train_state_tree(cfg, state, _shape_leaf)


def train_state_from_jax(cfg: ModelConfig, tree: dict, *,
                         device="cuda", mesh=None) -> dict:
    """The port's train state from JAX's (numpy or tensor leaves, as JAX's
    ``init_train_state`` or a restored checkpoint gives it), on
    ``device``; with ``mesh``, from a tree of this rank's blocks."""
    device = resolve_device(device)
    model = params_from_jax(cfg, tree["params"], device=device, mesh=mesh)
    opt = tree["opt"]
    step = opt["step"]
    step = (step if isinstance(step, torch.Tensor)
            else from_host(step)).to(device=device, dtype=torch.int32)
    names = [name for name, _ in model.named_parameters()]
    return {"params": model,
            "opt": {"step": step,
                    "m": {n: _leaf(opt["m"], cfg, n).to(device)
                          for n in names},
                    "v": {n: _leaf(opt["v"], cfg, n).to(device)
                          for n in names}}}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix
