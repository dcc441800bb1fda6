"""Megatron tensor parallelism over ``model`` and parameters gathered over
``data`` one layer at a time: the compute half of the JAX package's
strategy (``parallel/sharding.py``), which XLA's partitioner derives there
from ``constrain_heads``, ``tp_axis_for`` and the parameter specs.

Every function here reads the mesh of the step in flight
(``sharding.set_mesh``) and is the identity off-mesh, so a one-device
program runs exactly as before.  On a mesh a model's leaves are this
rank's blocks (``sharding.shard_leaf`` under ``convert.param_spec``), and
a layer takes them through :func:`use` just before its product:

* over ``data`` every block is gathered (:class:`_Gather`: an all-gather
  forward; backward a reduce-scatter when the ranks of ``data`` hold
  different batch rows, else this rank's part);
* along ``model`` a block stays split where the layer computes in
  parallel (``model="local"``): column-parallel ``wq``/``wk``/``wv``/
  ``wu``/``wg`` after :func:`copy_to` (identity forward, all-reduce
  backward), row-parallel ``wo``/``wd`` before :func:`reduce_from`
  (all-reduce forward, identity backward), the vocabulary rows of the
  embedding and of the logits; where the layer needs the whole leaf it
  is gathered along ``model`` too, its backward a reduce-scatter when
  each rank's product adds only a part of the gradient (``"sum"``: K/V
  computed whole for this rank's query heads) or this rank's part when
  every rank computes the same (``"replicated"``: the mixers this slice
  leaves replicated, :class:`Whole`).

The attention's split follows JAX's three cases exactly
(:func:`head_split`).  Collectives are counted on the mesh under
``tp_all_reduce`` (every all-reduce over ``model``: the attention's and
MLP's activations, the embedding's, the loss's), ``param_gather``,
``grad_reduce_scatter`` and ``logits_gather``.
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.parallel import sharding as shd

TP, FSDP = shd.TP, shd.FSDP

# the attention cases run in this process, by name (the tests read it)
CASES: collections.Counter = collections.Counter()
# called with every gathered parameter (the dry-run's Trace labels them)
gathered_hook = None


def active():
    """The mesh of the step in flight (None off-mesh)."""
    return shd._CTX["mesh"]


def size(axis: str = TP, mesh=None) -> int:
    """The size of ``axis`` on the active mesh (1 off-mesh or without
    it)."""
    mesh = mesh if mesh is not None else active()
    if mesh is None or axis not in mesh.axis_names:
        return 1
    return int(mesh.shape[axis])


def index(axis: str = TP) -> int:
    """This rank's coordinate on ``axis`` (0 off-mesh)."""
    mesh = active()
    return mesh.coords[axis] if size(axis) > 1 else 0


# ---------------------------------------------------------------------------
# The collectives as autograd functions over one axis
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g, axes=(TP,), kind="tp_all_reduce"), None


class _ReduceFrom(torch.autograd.Function):
    """The sum over ``model`` forward; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.psum(x, axes=(TP,), kind="tp_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """The blocks of ``axis`` concatenated along ``dim`` forward;
    backward the gradient's part of this rank, summed over ``axis``
    (one reduce-scatter) when ``summed``."""

    @staticmethod
    def forward(ctx, t, mesh, axis, dim, summed):
        ctx.args = (mesh, axis, dim, summed)
        parts = mesh.all_gather(t, axes=(axis,), kind="param_gather")
        out = torch.cat(parts, dim=dim)
        if gathered_hook is not None:
            gathered_hook(out)
        return out

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, summed = ctx.args
        if summed:
            part = mesh.reduce_scatter(g, axes=(axis,), dim=dim,
                                       kind="grad_reduce_scatter")
        else:
            part = torch.chunk(g, size(axis, mesh), dim=dim)[
                mesh.coords[axis]]
        return part, None, None, None, None


def copy_to(x: torch.Tensor) -> torch.Tensor:
    """``x`` entering a region computed in parallel over ``model``."""
    if size(TP) == 1:
        return x
    return _CopyTo.apply(x, active())


def reduce_from(x: torch.Tensor) -> torch.Tensor:
    """The sum over ``model`` of the ranks' partial ``x``."""
    if size(TP) == 1:
        return x
    return _ReduceFrom.apply(x, active())


def gather_block(t: torch.Tensor, axis: str, dim: int, *,
                 summed: bool) -> torch.Tensor:
    """The blocks of ``t`` over ``axis`` joined along ``dim``; backward a
    reduce-scatter (``summed``) or this rank's part."""
    if size(axis) == 1:
        return t
    return _Gather.apply(t, active(), axis, dim, summed)


def rows_differ(axis: str) -> bool:
    """Whether the ranks of ``axis`` hold different batch rows in the
    step in flight (its gradients then sum over ``axis``)."""
    dp = shd._CTX["dp"]
    return dp is not None and axis in dp


def use(t: torch.Tensor, path: tuple, *, model: str = "local"):
    """The tensor a layer multiplies for its leaf whose block is ``t``
    (``path``: the leaf's names in JAX's tree, from the layer's own dict
    down, which pick its rule): gathered over ``data``, and along
    ``model`` unless ``model`` is ``"local"`` (``"sum"``: backward a
    reduce-scatter; ``"replicated"``: backward this rank's part).
    Off-mesh ``t`` itself."""
    if active() is None:
        return t
    spec = shd.spec_for(tuple(path), t.ndim)
    for dim, entry in enumerate(spec):
        if entry == FSDP:
            t = gather_block(t, FSDP, dim, summed=rows_differ(FSDP))
    if model != "local":
        for dim, entry in enumerate(spec):
            if entry == TP:
                t = gather_block(t, TP, dim, summed=model == "sum")
    return t


class Whole:
    """A layer's parameter container whose leaves are read whole: each
    leaf :func:`use`'d along both axes (``"replicated"``) at its first
    read, sub-containers and other attributes as they are.  The mixers
    this slice leaves replicated along ``model`` (MoE experts and router,
    RG-LRU, RWKV, cross-attention) read their parameters through it."""

    def __init__(self, p, path: tuple = ()):
        self._p, self._path, self._got = p, tuple(path), {}

    def __getattr__(self, name):
        p = self.__dict__["_p"]
        if name in p._parameters:
            got = self.__dict__["_got"]
            if name not in got:
                got[name] = use(p._parameters[name], self._path + (name,),
                                model="replicated")
            return got[name]
        return getattr(p, name)


def whole(p, path: tuple = ()):
    """``p`` read whole (:class:`Whole`) on a mesh; ``p`` off-mesh."""
    return p if active() is None else Whole(p, path)


# ---------------------------------------------------------------------------
# Attention heads
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """How one attention's heads lie on the ``model`` axis of size
    ``tp``, JAX's ``layers.attention`` decision:

    * ``"kv"``: the KV heads over ``model`` (``hkv % tp == 0``); each
      rank computes its query and KV heads;
    * ``"rep"``: each KV head replicated ``rep = tp // hkv`` times (JAX's
      condition, prefill and training only: ``sq > 1``), one virtual KV
      head a rank, with its ``g // rep`` query heads;
    * ``"group"``: the GQA group axis over ``model`` (``g % tp == 0``);
      K and V whole on every rank, the query heads split;
    * ``"whole"``: neither divides: every rank computes every head, and
      keeps its columns of the output for the row-parallel ``wo``.

    ``q_heads``/``kv_heads``: the heads this rank computes, from
    ``q0``/``kv0``."""

    case: str
    tp: int
    rep: int
    q0: int
    q_heads: int
    kv0: int
    kv_heads: int


def head_split(hq: int, hkv: int, sq: int) -> HeadSplit:
    """The split of ``hq`` query and ``hkv`` KV heads for a query of
    ``sq`` positions on the active mesh (off-mesh: one rank, ``"kv"``)."""
    t, r = size(TP), index(TP)
    g = hq // hkv
    if hkv % t == 0:
        return HeadSplit("kv", t, 1, r * hq // t, hq // t, r * hkv // t,
                         hkv // t)
    if (sq > 1 and g % t and t % hkv == 0 and g % (t // hkv) == 0
            and t // hkv > 1):
        rep = t // hkv
        return HeadSplit("rep", t, rep, r * hq // t, hq // t, 0, hkv)
    if g % t == 0:
        return HeadSplit("group", t, 1, r * hq // t, hq // t, 0, hkv)
    return HeadSplit("whole", t, 1, 0, hq, 0, hkv)


def cache_kv_heads(hkv: int) -> int:
    """KV heads a rank's self-attention cache holds: its own where they
    divide ``model`` (``cache_specs``' head rule), else all."""
    t = size(TP)
    return hkv // t if hkv % t == 0 else hkv


# ---------------------------------------------------------------------------
# Vocabulary
# ---------------------------------------------------------------------------

def vocab_start(rows: int) -> int:
    """The first vocabulary row of this rank's ``rows`` of the
    embedding."""
    return index(TP) * rows


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Every rank's vocabulary columns of ``logits`` joined (serving; no
    gradient), counted ``logits_gather``."""
    if size(TP) == 1:
        return logits
    parts = active().all_gather(logits, axes=(TP,), kind="logits_gather")
    return torch.cat(parts, dim=-1)
