"""Learning-rate schedules (scale factors multiplying AdamWConfig.lr)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup to 1 over ``warmup`` steps, then a cosine down to
    ``min_frac`` at ``total``; an f32 scalar, as the JAX schedule computes
    it (``step`` an int or an integer tensor)."""
    t = torch.as_tensor(step).to(torch.float32)
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(t < warmup, warm, cos)
