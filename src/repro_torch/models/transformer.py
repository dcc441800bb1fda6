"""Unified decoder-only model covering the dense / moe / hybrid / ssm / vlm
families (PyTorch).  Encoder-decoder (audio) lives in
:mod:`repro_torch.models.encdec`.

Depth is organized into the JAX package's **segments** (:func:`stack_plan`:
maximal runs of a repeating block pattern, plus a tail).  JAX stacks each
segment's parameters over depth and runs it as one ``lax.scan``
(``scan_ctl.py::maybe_scan``); the port keeps one module per layer, in
the same order (segment by segment, pattern position fastest), and runs a
Python loop over them.  ``scan_ctl.py`` has no counterpart here.  Where
JAX remats a training segment's body (``cfg.remat``, no caches), the
port checkpoints each pattern period, one scan step's layers
(:func:`layers.remat`).

API (plain functions; a model is the ``nn.Module`` that holds the
parameters, where JAX passes a pytree):
  init_params(cfg, gen, dtype, device)          -> model
  forward(cfg, model, tokens, ...)              -> (logits, aux)
  prefill(cfg, model, tokens, ...)              -> (logits, caches)
  decode_step(cfg, model, tokens, pos, caches)  -> (logits, caches)
  init_caches(cfg, batch, length, dtype)        -> caches (one per layer)
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import recurrent as R
from repro_torch.core.lattice import resolve_device
from repro_torch.models.config import ModelConfig

F32 = torch.float32


# ---------------------------------------------------------------------------
# Depth plan
# ---------------------------------------------------------------------------

def stack_plan(cfg: ModelConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(block-pattern, repeat count)] covering cfg.num_layers layers."""
    kinds = cfg._layer_kinds()
    pat = {"dense": ("attn",), "moe": ("moe",), "ssm": ("rwkv",),
           "vlm": ("attn",), "audio": ("attn",),
           "hybrid": cfg.block_pattern}[cfg.family]
    plen = len(pat)
    full, tail = divmod(len(kinds), plen)
    plan = []
    if full:
        plan.append((tuple(pat), full))
    if tail:
        plan.append((tuple(pat[:tail]), 1))
    return plan


def layer_slots(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    """Per layer, in execution order: (kind, segment, repeat, position in
    the pattern) — where JAX keeps that layer's parameters:
    ``params["segments"][segment][f"b{position}"][...][repeat]``."""
    slots = []
    for si, (pat, count) in enumerate(stack_plan(cfg)):
        for c in range(count):
            for j, kind in enumerate(pat):
                slots.append((kind, si, c, j))
    return slots


# ---------------------------------------------------------------------------
# Per-block modules and apply
# ---------------------------------------------------------------------------

def _block_init(gen, cfg: ModelConfig, kind: str, dtype, device) -> L.Params:
    d = cfg.d_model
    p = L.Params(ln1=L.full((d,), 0.0, device), ln2=L.full((d,), 0.0, device))
    p.kind = kind      # a plain attribute: the block's kind, not a weight
    if kind == "attn":
        p.attn = B.attn_init(gen, cfg, dtype, device)
        p.mlp = L.mlp_init(gen, d, cfg.d_ff, cfg.mlp, dtype, device)
    elif kind == "moe":
        p.attn = B.attn_init(gen, cfg, dtype, device)
        p.moe = M.moe_init(gen, cfg, dtype, device)
    elif kind == "rec":
        p.rec = R.rglru_init(gen, cfg, dtype, device)
        p.mlp = L.mlp_init(gen, d, cfg.d_ff, cfg.mlp, dtype, device)
    elif kind == "rwkv":
        p.tm = R.rwkv_init(gen, cfg, dtype, device)
    else:
        raise ValueError(kind)
    return p


def _block_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                 dtype, device) -> dict:
    if kind in ("attn", "moe"):
        ring = cfg.family == "hybrid" and cfg.window > 0
        return B.make_kv_cache(cfg, batch, length, dtype, ring=ring,
                               device=device)
    if kind == "rec":
        return R.make_rglru_state(cfg, batch, dtype, device)
    if kind == "rwkv":
        return R.make_rwkv_state(cfg, batch, dtype, device)
    raise ValueError(kind)


def _block_apply(bp: L.Params, h: torch.Tensor, cfg: ModelConfig, *, pos0,
                 cache, update_cache: bool):
    kind = bp.kind
    aux = torch.zeros((), dtype=F32, device=h.device)
    new_cache = None
    if kind in ("attn", "moe"):
        a, nc = B.attn_apply(bp.attn, L.rms_norm(h, bp.ln1), cfg,
                             pos0=pos0, window=cfg.window, cache=cache,
                             update_cache=update_cache)
        h = h + a
        if kind == "attn":
            m = L.mlp_apply(bp.mlp, L.rms_norm(h, bp.ln2), cfg.mlp)
        else:
            m, ad = M.moe_apply(bp.moe, L.rms_norm(h, bp.ln2), cfg)
            aux = ad["load_balance_loss"]
        h = h + m
        new_cache = nc
    elif kind == "rec":
        a, ns = R.rglru_apply(bp.rec, L.rms_norm(h, bp.ln1), cfg,
                              state=cache, update_state=update_cache)
        h = h + a
        h = h + L.mlp_apply(bp.mlp, L.rms_norm(h, bp.ln2), cfg.mlp)
        new_cache = ns
    elif kind == "rwkv":
        a, ts = R.rwkv_time_mix(bp.tm, L.rms_norm(h, bp.ln1), cfg,
                                state=cache)
        h = h + a
        c, cs = R.rwkv_channel_mix(bp.tm, L.rms_norm(h, bp.ln2),
                                   state=cache)
        h = h + c
        if update_cache:
            new_cache = {**ts, **cs}
    return h, new_cache, aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, gen: torch.Generator | None,
                dtype=torch.float32, device="cuda") -> L.Params:
    """A model with JAX's init distributions drawn from ``gen`` (normals of
    std 0.02, 0.02/sqrt(2) for output projections, zero norms) on
    ``device``; ``gen=None`` leaves the weights uninitialised.  The model
    holds ``embed``, ``final_norm`` and ``layers`` (one block per layer,
    :func:`layer_slots` order)."""
    device = resolve_device(device)
    return L.Params(
        embed=L.embed_init(gen, cfg.vocab_size, cfg.d_model, dtype,
                           cfg.tie_embeddings,
                           padded_vocab=cfg.padded_vocab, device=device),
        final_norm=L.full((cfg.d_model,), 0.0, device),
        layers=nn.ModuleList(_block_init(gen, cfg, kind, dtype, device)
                             for kind, *_ in layer_slots(cfg)))


def init_caches(cfg: ModelConfig, batch: int, length: int,
                dtype=torch.float32, device="cuda") -> list:
    return [_block_cache(cfg, kind, batch, length, dtype, device)
            for kind, *_ in layer_slots(cfg)]


def _periods(cfg: ModelConfig, model: L.Params) -> list[list[L.Params]]:
    """The layers grouped as JAX's scan steps: one repeat of a segment's
    pattern (one layer of a uniform stack, ``len(cfg.block_pattern)`` of
    the hybrid's, fewer in its tail segment)."""
    groups: dict = {}
    for (_, si, c, _), bp in zip(layer_slots(cfg), model.layers):
        groups.setdefault((si, c), []).append(bp)
    return list(groups.values())


def _period(cfg: ModelConfig, blocks: list, h, aux):
    """One scan step of the cache-free forward (positions from 0): the
    blocks of one pattern period, their load-balance losses added to
    ``aux``."""
    for bp in blocks:
        h, _, a = _block_apply(bp, h, cfg, pos0=0, cache=None,
                               update_cache=False)
        aux = aux + a
    return h, aux


def _run_layers(cfg: ModelConfig, model: L.Params, h, *, pos0, caches,
                update_cache: bool):
    aux_total = torch.zeros((), dtype=F32, device=h.device)
    if caches is None:  # the cache-free forward: a period is the remat unit
        body = L.remat(cfg, model, _period)
        for blocks in _periods(cfg, model):
            h, aux_total = body(cfg, blocks, h, aux_total)
        return h, None, aux_total
    new_caches = []
    for i, bp in enumerate(model.layers):
        h, nc, a = _block_apply(bp, h, cfg, pos0=pos0, cache=caches[i],
                                update_cache=update_cache)
        new_caches.append(nc)
        aux_total = aux_total + a
    return h, (new_caches if update_cache else None), aux_total


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def _embed_inputs(model, tokens, prefix_embeds, dtype):
    h = L.embed_lookup(model.embed, tokens, dtype)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(dtype), h], dim=1)
    return h


def forward(cfg: ModelConfig, model: L.Params, tokens, *,
            prefix_embeds=None, compute_dtype=torch.float32):
    """Full-sequence logits (f32) + aux losses."""
    h = _embed_inputs(model, tokens, prefix_embeds, compute_dtype)
    h, _, aux = _run_layers(cfg, model, h, pos0=0, caches=None,
                            update_cache=False)
    h = L.rms_norm(h, model.final_norm)
    logits = L.logits_out(model.embed, h, cfg.vocab_size)
    return logits, {"load_balance_loss": aux}


def prefill(cfg: ModelConfig, model: L.Params, tokens, *, cache_len: int,
            prefix_embeds=None, compute_dtype=torch.float32):
    """Run the prompt, returning last-position logits + caches of
    ``cache_len`` slots (prompt K/V written at positions 0..S-1)."""
    b, s = tokens.shape
    caches = init_caches(cfg, b, cache_len, compute_dtype, tokens.device)
    h = _embed_inputs(model, tokens, prefix_embeds, compute_dtype)
    h, caches, _ = _run_layers(cfg, model, h, pos0=0, caches=caches,
                               update_cache=True)
    h = L.rms_norm(h[:, -1:], model.final_norm)
    logits = L.logits_out(model.embed, h, cfg.vocab_size)
    return logits, caches


def decode_step(cfg: ModelConfig, model: L.Params, tokens, pos: int,
                caches, *, compute_dtype=torch.float32):
    """One decode step: tokens (B,1) at absolute position ``pos``."""
    h = L.embed_lookup(model.embed, tokens, compute_dtype)
    h, caches, _ = _run_layers(cfg, model, h, pos0=int(pos), caches=caches,
                               update_cache=True)
    h = L.rms_norm(h, model.final_norm)
    logits = L.logits_out(model.embed, h, cfg.vocab_size)
    return logits, caches
