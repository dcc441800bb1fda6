"""Train / prefill / decode step factories: the JAX package's
``models/steps.py`` on one device.

Precision follows the JAX package's two-type discipline: f32 master
weights, a compute copy of the matmul weights in ``compute_dtype`` whose
gradients are taken (bf16 gradients with bf16 compute), f32 loss and
optimizer math, the m/v moment dtype per config.  On one device there is
no mesh: the steps call the model's functions directly, and the sharding
specs and data-parallel gradient reduction of JAX's factories are not
ported (ROADMAP item 17).  ``compute_dtype`` defaults to bf16 as in JAX's
factories; the serving CLI passes f32.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from repro_torch.models import convert
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

F32 = torch.float32


def model_module(cfg: ModelConfig):
    return ED if cfg.is_encdec else TF


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Token cross-entropy, f32, mean over all positions."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(cfg: ModelConfig, model, batch, compute_dtype) -> tuple:
    """(next-token cross-entropy + 0.01 x the MoE load-balance loss, aux);
    a vlm's prefix positions are cut from the logits first."""
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
    loss = loss + 0.01 * aux["load_balance_loss"]
    return loss, aux


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

# The JAX package's sharding rules (``parallel/sharding.py::_NAME_RULES``),
# which decide there which leaves are matmul weights: the leaf names the
# rules know, with the number of trailing dims each rule spans; a leaf
# with fewer dims than its rule is replicated, so not a weight.  MoE
# expert tensors have rules of their own (``moe/<name>``).
_WEIGHT_RULE_DIMS = {
    "wq": 2, "wk": 2, "wv": 2, "wo": 2, "wu": 2, "wg": 2, "wd": 2,
    "tok": 2, "out": 2, "router": 2, "moe/wg": 3, "moe/wu": 3, "moe/wd": 3,
    "wr": 2, "ck": 2, "cv": 2, "cr": 2, "wx": 2, "conv": 2}


def is_matmul_weight(path: tuple, ndim: int) -> bool:
    """Whether JAX's ``shd.spec_for(path, ndim) != P()``: the leaf at JAX
    tree path ``path`` (strings), of ``ndim`` dims as JAX stacks it, is
    one its sharding rules recognise."""
    name = path[-1]
    in_moe = any("moe" in p for p in path[:-1]) and "shared" not in path
    key = f"moe/{name}" if in_moe and f"moe/{name}" in _WEIGHT_RULE_DIMS \
        else name
    dims = _WEIGHT_RULE_DIMS.get(key)
    return dims is not None and ndim >= dims


def cast_compute(cfg: ModelConfig, model, compute_dtype):
    """The model one step differentiates: a copy of ``model`` whose matmul
    weights (:func:`is_matmul_weight` at the leaf's JAX path and stacked
    ndim, f32 leaves only) are cast to ``compute_dtype`` and whose other
    leaves (norm scales, gates, decays) share the master's f32 storage.
    Every parameter of the copy is a new leaf that takes gradients, so a
    bf16 weight's gradient is bf16 and a norm scale's f32, as in JAX."""
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


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *,
                    compute_dtype=torch.bfloat16, lr_schedule=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: gradients
    of :func:`loss_fn` with respect to :func:`cast_compute`'s copy, then
    one AdamW update of the f32 master (``lr_schedule(step)`` scales the
    rate; 1 when None).  The state is updated in place and returned;
    the metrics are 0-d tensors (``loss``, ``grad_norm``,
    ``load_balance_loss``, ``step``), read without a host sync."""
    schedule = lr_schedule or (lambda s: 1.0)

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

    return train_step


def init_train_state(cfg: ModelConfig, gen: torch.Generator | None,
                     opt_cfg: AdamWConfig, param_dtype=F32,
                     device="cuda") -> dict:
    """``{"params": model, "opt": {"step", "m", "v"}}``: the model drawn
    from ``gen`` on ``device`` (f32 master weights), the moments in
    ``cfg.opt_state_dtype``, keyed by parameter name."""
    params = model_module(cfg).init_params(cfg, gen, dtype=param_dtype,
                                           device=device)
    opt_cfg = dataclasses.replace(opt_cfg, moment_dtype=cfg.opt_state_dtype)
    return {"params": params,
            "opt": adamw_init(dict(params.named_parameters()), opt_cfg)}


# ---------------------------------------------------------------------------
# Serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, *, cache_len: int,
                      compute_dtype=torch.bfloat16):
    """Returns prefill_step(model, batch) -> (last-position logits, caches);
    ``batch`` holds ``tokens`` and, by family, ``frames`` or
    ``prefix_embeds``."""
    def prefill_step(model, batch):
        if cfg.is_encdec:
            return ED.prefill(cfg, model, batch["tokens"],
                              frames=batch["frames"], cache_len=cache_len,
                              compute_dtype=compute_dtype)
        return TF.prefill(cfg, model, batch["tokens"], cache_len=cache_len,
                          prefix_embeds=batch.get("prefix_embeds"),
                          compute_dtype=compute_dtype)

    return prefill_step


def make_decode_step(cfg: ModelConfig, *, compute_dtype=torch.bfloat16):
    """Returns decode_step(model, caches, tokens, pos) -> (next tokens
    (B, 1), logits, caches): one greedy (argmax) step."""
    def decode_step(model, caches, tokens, pos):
        logits, caches = model_module(cfg).decode_step(
            cfg, model, tokens, pos, caches, compute_dtype=compute_dtype)
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        return next_tok[:, None], logits, caches

    return decode_step
