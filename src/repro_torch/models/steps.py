"""Train / prefill / decode step factories and sharding-spec builders:
the JAX package's ``models/steps.py``.

Precision follows the JAX package's two-type discipline: f32 master
weights, a compute copy of the matmul weights in ``compute_dtype`` whose
gradients are taken (bf16 gradients with bf16 compute), f32 loss and
optimizer math, the m/v moment dtype per config.  ``compute_dtype``
defaults to bf16 as in JAX's factories; the serving CLI passes f32.

With a mesh (``make_train_step(..., mesh=)``) the train state and the
batch are laid out as JAX's ``state_specs`` and ``batch_specs`` say: every
f32 master, m and v leaf is split over ``data`` (FSDP) and ``model``, the
batch rows over (``pod``, ``data``).  A step casts the master blocks to
the compute dtype (each leaf stays this rank's block) and runs forward and
backward on this rank's rows as JAX's partitioned program does
(``parallel/tp.py``): Megatron tensor parallelism over ``model`` for the
attention, the dense MLP, the vocabulary-parallel embedding, logits and
cross-entropy, each layer's blocks gathered over ``data`` just before use
(inside the remat unit, so the recompute gathers them again).  A
gradient leaves the backward as this rank's block, reduce-scattered over
``data`` in its own dtype (bf16 with bf16 compute: JAX's compressed
gradient reduction); what no gather summed is summed over the batch axes
after it; AdamW runs on the blocks with the global clip.  The MoE experts
and router, the RG-LRU and RWKV mixers and the cross-attention are read
whole on every rank of a ``model`` line and computed there as on one
device, and no sequence is sharded (``seq_shard``): ROADMAP item 18 part
2.

:func:`make_prefill_step` and :func:`make_decode_step` take the same
mesh: parameters as this rank's blocks, the batch rows over the batch
axes, caches laid out by :func:`cache_specs`' head rule
(:func:`held_cache_specs`; a sequence-sharded cache is held whole along
``model`` until part 2), logits gathered over ``model``.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch
from torch import nn

from repro_torch.models import convert
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tp

F32 = torch.float32


def model_module(cfg: ModelConfig):
    return ED if cfg.is_encdec else TF


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token cross-entropy, f32, mean over all positions.  On a mesh
    ``logits`` are this rank's vocabulary columns (``layers.logits_out``):
    the largest logit by an all-reduce (max) over ``model``, the sum of
    exponentials and the gold logit, which one rank owns, by sums over
    ``model``."""
    mesh = tp.active()
    if tp.size() == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return torch.mean(logz - gold)
    with torch.no_grad():
        top = mesh.psum(logits.amax(dim=-1), axes=(shd.TP,), op="max",
                        kind="tp_all_reduce")
    sumexp = tp.reduce_from(torch.exp(logits - top[..., None]).sum(dim=-1))
    local = targets - tp.vocab_start(logits.shape[-1])
    mine = (local >= 0) & (local < logits.shape[-1])
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None])
    gold = tp.reduce_from(torch.where(mine, gold[..., 0], 0.0))
    return torch.mean(top + torch.log(sumexp) - gold)


def loss_fn(cfg: ModelConfig, model, batch, compute_dtype, *,
            shards: int = 1) -> tuple:
    """(next-token cross-entropy + 0.01 x the MoE load-balance loss, aux);
    a vlm's prefix positions are cut from the logits first.  With
    ``shards`` > 1, ``batch`` is one of that many equal row shards of the
    global batch and the loss this rank's share of the global one: the
    cross-entropy's mean over its rows divided by ``shards`` (its sum over
    the global count) plus the MoE's share (``moe.moe_apply``)."""
    tokens = batch["tokens"]
    if cfg.is_encdec:
        logits, aux = ED.forward(cfg, model, tokens, frames=batch["frames"],
                                 compute_dtype=compute_dtype)
    else:
        logits, aux = TF.forward(cfg, model, tokens,
                                 prefix_embeds=batch.get("prefix_embeds"),
                                 compute_dtype=compute_dtype)
        if cfg.num_prefix_embeds:   # loss only over the text region
            logits = logits[:, cfg.num_prefix_embeds:]
    loss = _xent(logits[:, :-1], tokens[:, 1:])
    if shards != 1:
        loss = loss / shards
    loss = loss + 0.01 * aux["load_balance_loss"]
    return loss, aux


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def is_matmul_weight(path: tuple, ndim: int) -> bool:
    """Whether JAX's ``shd.spec_for(path, ndim) != P()``: the leaf at JAX
    tree path ``path`` (strings), of ``ndim`` dims as JAX stacks it, is
    one its sharding rules recognise (``parallel/sharding.py``, the table
    that also lays the leaf out on a mesh)."""
    return shd.spec_for(path, ndim) != ()


def cast_compute(cfg: ModelConfig, model, compute_dtype):
    """The model one step differentiates: a copy of ``model`` whose matmul
    weights (:func:`is_matmul_weight` at the leaf's JAX path and stacked
    ndim, f32 leaves only) are cast to ``compute_dtype`` and whose other
    leaves (norm scales, gates, decays) share the master's f32 storage.
    Every parameter of the copy is a new leaf that takes gradients, so a
    bf16 weight's gradient is bf16 and a norm scale's f32, as in JAX.
    On a mesh ``model`` holds this rank's blocks and so does the copy
    (the layers gather them, ``parallel/tp.py``)."""
    memo = {}
    for name, p in model.named_parameters():
        path, idx = convert.jax_path(cfg, name)
        t = p.detach()
        if p.dtype == F32 and is_matmul_weight(
                tuple(map(str, path)), p.ndim + (idx is not None)):
            t = t.to(compute_dtype)
        memo[id(p)] = nn.Parameter(t)
    # deepcopy takes each memo entry in place of the parameter it names,
    # and copies the containers (and each block's ``kind``) around them
    return copy.deepcopy(model, memo)


def mesh_grads(cfg: ModelConfig, model, batch, compute_dtype, mesh,
               specs: dict) -> tuple:
    """``(loss, load_balance_loss, {name: gradient block})`` of the global
    ``batch`` (every rank passes the same one) on ``mesh``: the loss and
    load-balance loss the global values, each gradient this rank's block
    of the whole batch's.  ``model`` holds this rank's blocks (``specs``).

    The rows are split as :func:`batch_specs` says; each rank runs
    :func:`loss_fn` for its share on :func:`cast_compute`'s blocks
    (tensor-parallel over ``model``, gathered over ``data`` a layer at a
    time).  A leaf whose spec names ``data`` leaves the backward summed
    over ``data`` (its gather's reduce-scatter, ``grad_reduce_scatter``);
    the batch axes its spec does not name are summed after it
    (``Mesh.psum``, ``grad_all_reduce``: ``pod``, and ``data`` for the
    leaves it does not split), each in the gradient's dtype.  A batch
    that the batch axes do not divide is not split: every rank computes
    the whole batch and nothing is summed over them."""
    dp = dp_axes_for(mesh, batch["tokens"].shape[0])
    shards = math.prod(mesh.shape[a] for a in dp) if dp else 1
    if shards == 1:
        dp = None
    local = local_batch(cfg, batch, mesh)
    cmodel = cast_compute(cfg, model, compute_dtype)
    with shd.set_mesh(mesh, dp_axes=dp):
        loss, aux = loss_fn(cfg, cmodel, local, compute_dtype, shards=shards)
        names, leaves = zip(*cmodel.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    del cmodel, leaves
    grads = dict(zip(names, grads))
    sums = torch.stack([loss.detach(), aux["load_balance_loss"].detach()])
    if dp is not None:
        for name in names:
            rest = tuple(a for a in dp
                         if a not in shd.spec_axes(mesh, specs[name]))
            if rest:
                grads[name] = mesh.psum(grads[name], axes=rest,
                                        kind="grad_all_reduce")
        sums = mesh.psum(sums, axes=dp, kind="metric_all_reduce")
    return sums[0], sums[1], grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, mesh=None,
                    compute_dtype=torch.bfloat16, lr_schedule=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: gradients
    of :func:`loss_fn` with respect to :func:`cast_compute`'s copy, then
    one AdamW update of the f32 master (``lr_schedule(step)`` scales the
    rate; 1 when None).  The state is updated in place and returned;
    the metrics are 0-d tensors (``loss``, ``grad_norm``,
    ``load_balance_loss``, ``step``), read without a host sync.

    With ``mesh`` the state is :func:`init_train_state`'s on that mesh
    (this rank's blocks), every rank passes the same global batch, the
    gradients are :func:`mesh_grads`' and each rank updates its blocks;
    the metrics are the global values, the same on every rank."""
    schedule = lr_schedule or (lambda s: 1.0)

    def mesh_step(state, batch):
        model = state["params"]
        specs = state_specs(cfg, state)["params"]
        loss, lb, grads = mesh_grads(cfg, model, batch, compute_dtype, mesh,
                                     specs)
        _, opt, gnorm = adamw_update(
            dict(model.named_parameters()), grads, state["opt"], opt_cfg,
            lr_scale=schedule(state["opt"]["step"]), mesh=mesh, specs=specs)
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "load_balance_loss": lb, "step": opt["step"]}
        return {"params": model, "opt": opt}, metrics

    def train_step(state, batch):
        model = state["params"]
        cmodel = cast_compute(cfg, model, compute_dtype)
        loss, aux = loss_fn(cfg, cmodel, batch, compute_dtype)
        names, leaves = zip(*cmodel.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        del cmodel, leaves
        _, opt, gnorm = adamw_update(
            dict(model.named_parameters()), dict(zip(names, grads)),
            state["opt"], opt_cfg, lr_scale=schedule(state["opt"]["step"]))
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "load_balance_loss": aux["load_balance_loss"].detach(),
                   "step": opt["step"]}
        return {"params": model, "opt": opt}, metrics

    return train_step if mesh is None else mesh_step


def init_train_state(cfg: ModelConfig, gen: torch.Generator | None,
                     opt_cfg: AdamWConfig, param_dtype=F32,
                     device="cuda", mesh=None) -> dict:
    """``{"params": model, "opt": {"step", "m", "v"}}``: the model drawn
    from ``gen`` on ``device`` (f32 master weights), the moments in
    ``cfg.opt_state_dtype``, keyed by parameter name.  With ``mesh``
    every rank draws the whole model from the same ``gen`` (the weights
    of the one-device run) and keeps its block of each parameter
    (:func:`state_specs`); its moments are blocks too."""
    params = model_module(cfg).init_params(cfg, gen, dtype=param_dtype,
                                           device=device)
    if mesh is not None:
        shard_model(cfg, params, mesh)
    opt_cfg = dataclasses.replace(opt_cfg, moment_dtype=cfg.opt_state_dtype)
    return {"params": params,
            "opt": adamw_init(dict(params.named_parameters()), opt_cfg)}


def shard_model(cfg: ModelConfig, model, mesh):
    """``model`` with each parameter replaced by this rank's block
    (``convert.param_spec``), in place; returned."""
    for name, p in model.named_parameters():
        p.data = shd.shard_leaf(mesh, p.data,
                                convert.param_spec(cfg, name, p.ndim))
    return model


# ---------------------------------------------------------------------------
# Sharding specs (tuples: ``parallel/sharding.py``)
# ---------------------------------------------------------------------------

def state_specs(cfg: ModelConfig, state) -> dict:
    """Specs of a train state's leaves, keyed by the port's parameter
    names (``convert.param_spec``: JAX's rule at the leaf's JAX path and
    stacked ndim); m and v mirror the parameters, the step is replicated.
    ``convert.train_state_specs_to_jax`` gives them in JAX's tree, where
    they equal JAX's ``state_specs``."""
    params = {name: convert.param_spec(cfg, name, p.ndim)
              for name, p in state["params"].named_parameters()}
    return {"params": params,
            "opt": {"step": (), "m": dict(params), "v": dict(params)}}


def dp_axes_for(mesh, batch: int):
    """(pod, data) when the batch divides them, else the largest prefix."""
    dp = shd.batch_axes(mesh)
    if dp is None:
        return None
    total = 1
    for ax in dp:
        total *= mesh.shape[ax]
    if batch % total == 0:
        return dp
    # try data alone (e.g. multi-pod with batch < pods*data)
    if batch % mesh.shape["data"] == 0:
        return ("data",)
    return None


def batch_specs(cfg: ModelConfig, batch: dict, mesh) -> dict:
    """Each batch leaf's spec: its rows over :func:`dp_axes_for`."""
    return {k: (shd.entry(dp_axes_for(mesh, v.shape[0])),
                *([None] * (v.dim() - 1)))
            for k, v in batch.items()}


def local_batch(cfg: ModelConfig, batch: dict, mesh) -> dict:
    """This rank's rows of a global ``batch`` (:func:`batch_specs`)."""
    specs = batch_specs(cfg, batch, mesh)
    return {k: shd.shard_leaf(mesh, v, specs[k]) for k, v in batch.items()}


def _cache_spec(cfg: ModelConfig, mesh, name: str, shape) -> tuple:
    """JAX's ``cache_specs`` rule for the cache leaf ``name`` of stacked
    ``shape`` (L, B, ...)."""
    tp_size = mesh.shape[shd.TP]
    nd = len(shape)
    if nd < 2:
        return (None,) * nd
    dp = shd.entry(dp_axes_for(mesh, shape[1]))      # (L, B, ...) layout
    if name in ("k", "v") and nd == 5:               # (L, B, S, Hkv, hd)
        heads, seq = shape[3], shape[2]
        if heads % tp_size == 0:
            return (None, dp, None, shd.TP, None)
        if cfg.kv_seq_shard and seq % tp_size == 0:
            return (None, dp, shd.TP, None, None)    # sequence-sharded
        return (None, dp, None, None, None)
    if name == "S" and nd == 5:                      # (L, B, nh, dk, dv)
        tp = shd.TP if shape[2] % tp_size == 0 else None
        return (None, dp, tp, None, None)
    if name == "pos":
        return (None,) * nd
    return (None, dp, *([None] * (nd - 2)))          # tm_x/cm_x/h/conv


def cache_specs(cfg: ModelConfig, caches, mesh):
    """Specs of the decode caches (``init_caches``' form: a list of
    per-layer dicts, or an encoder-decoder's ``(self_kv, cross_kv)`` pair
    of such lists), keyed like them: JAX's ``cache_specs`` rule (batch
    over the batch axes, KV heads over ``model`` when they divide it, else
    the sequence when ``cfg.kv_seq_shard``; RWKV state heads over
    ``model``) at the leaf's stacked ndim (L, B, ...), less the depth dim,
    as ``convert.param_spec`` takes a parameter's."""
    def per_layer(layers):
        n = len(layers)
        return [{k: _cache_spec(cfg, mesh, k, (n, *v.shape))[1:]
                 for k, v in c.items()} for c in layers]

    if cfg.is_encdec:
        return tuple(per_layer(part) for part in caches)
    return per_layer(caches)


def held_cache_specs(cfg: ModelConfig, caches, mesh):
    """The specs of the caches the mesh serving steps hold (``caches`` at
    their global shapes), keyed as :func:`cache_specs`: its rules, less the sequence sharding of
    ``kv_seq_shard``, the RWKV state's heads and an encoder-decoder's
    cross-attention heads, which stay whole along ``model`` (ROADMAP
    item 18 part 2)."""
    tp_size = mesh.shape[shd.TP]

    def held(name, spec, shape):
        if name in ("k", "v") and len(spec) == 4:
            return (spec[0], None,
                    shd.TP if shape[2] % tp_size == 0 else None, None)
        if name == "S":
            return (spec[0], None, None, None)
        return spec

    def per_layer(layers, specs):
        return [{k: held(k, sp[k], c[k].shape) for k in c}
                for c, sp in zip(layers, specs)]

    specs = cache_specs(cfg, caches, mesh)
    if cfg.is_encdec:
        self_kv = per_layer(caches[0], specs[0])
        cross = [{k: (sp[k][0], *([None] * (len(sp[k]) - 1))) for k in sp}
                 for sp in specs[1]]
        return self_kv, cross
    return per_layer(caches, specs)


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, *, cache_len: int, mesh=None,
                      compute_dtype=torch.bfloat16):
    """Returns prefill_step(model, batch) -> (last-position logits, caches);
    ``batch`` holds ``tokens`` and, by family, ``frames`` or
    ``prefix_embeds``.

    With ``mesh``, ``model`` holds this rank's blocks (:func:`shard_model`)
    and ``batch`` this rank's rows (:func:`local_batch`); the prompt runs
    tensor-parallel over ``model``, each layer gathered over ``data``
    before use; the caches are this rank's rows and, where the KV heads
    divide ``model``, its heads (:func:`held_cache_specs`; a cache
    ``cache_specs`` shards along the sequence is held whole along
    ``model``, ROADMAP item 18 part 2); the logits are gathered over
    ``model`` (every vocabulary column)."""
    def prefill_step(model, batch):
        with shd.set_mesh(mesh):
            if cfg.is_encdec:
                logits, caches = ED.prefill(
                    cfg, model, batch["tokens"], frames=batch["frames"],
                    cache_len=cache_len, compute_dtype=compute_dtype)
            else:
                logits, caches = TF.prefill(
                    cfg, model, batch["tokens"], cache_len=cache_len,
                    prefix_embeds=batch.get("prefix_embeds"),
                    compute_dtype=compute_dtype)
            return tp.gather_vocab(logits), caches

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, mesh=None,
                     compute_dtype=torch.bfloat16):
    """Returns decode_step(model, caches, tokens, pos) -> (next tokens
    (B, 1), logits, caches): one greedy (argmax) step.  With ``mesh`` as
    :func:`make_prefill_step`: this rank's blocks, rows and caches; the
    logits gathered over ``model`` and the tokens their argmax."""
    def decode_step(model, caches, tokens, pos):
        with shd.set_mesh(mesh):
            logits, caches = model_module(cfg).decode_step(
                cfg, model, tokens, pos, caches, compute_dtype=compute_dtype)
            logits = tp.gather_vocab(logits)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], logits, caches

    return decode_step
