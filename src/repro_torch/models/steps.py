"""Prefill / decode step factories: the serving half of the JAX package's
``models/steps.py`` (the train step, loss and sharding specs come with the
training slice).

On one device there is no mesh: the steps call the model's functions
directly.  ``compute_dtype`` defaults to bf16 as in JAX's factories; the
serving CLI passes f32.
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


def model_module(cfg: ModelConfig):
    return ED if cfg.is_encdec else TF


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
