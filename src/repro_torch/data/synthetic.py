"""Deterministic synthetic data.

* ``SyntheticLM`` — reproducible token/frame/patch batches for the LM
  substrate.  Batch ``i`` is a pure function of (seed, i), so a restarted
  job regenerates the exact stream.  torch cannot replay ``jax.random``:
  the streams differ from the JAX package's in value, not in law.
* ``lattice_problem`` — the paper's workload: a gauge field and a source.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import lattice as lat
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    batch: int
    seq_len: int
    seed: int = 0
    # "zipf": skewed unigram distribution (learnable signal for the loss
    # curve); "uniform": max-entropy tokens (throughput benchmarking).
    mode: str = "zipf"
    device: str = "cuda"

    def _generator(self, step: int) -> torch.Generator:
        """A generator seeded from (seed, step) alone."""
        dev = lat.resolve_device(self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence(
            [self.seed, step]).generate_state(1, np.uint64)[0] >> 1))
        return gen

    def _tokens(self, gen, shape):
        v = self.cfg.vocab_size
        if self.mode == "uniform":
            return torch.randint(0, v, shape, generator=gen,
                                 device=gen.device)
        logits = -1.2 * torch.log1p(torch.arange(v, dtype=torch.float32,
                                                 device=gen.device))
        probs = torch.softmax(logits, dim=0)
        n = int(np.prod(shape))
        return torch.multinomial(probs, n, replacement=True,
                                 generator=gen).reshape(shape)

    def batch_at(self, step: int, dtype=torch.float32) -> dict:
        """Batch for a given step index: tokens first, then the family's
        frames (audio) or prefix embeddings (vlm), from one generator."""
        cfg = self.cfg
        gen = self._generator(step)
        dev = gen.device

        def normal(shape):
            return 0.02 * torch.randn(shape, generator=gen, dtype=dtype,
                                      device=dev)

        out: dict = {}
        if cfg.is_encdec:
            out["tokens"] = self._tokens(gen, (self.batch, self.seq_len))
            out["frames"] = normal((self.batch, self.seq_len, cfg.d_model))
        elif cfg.num_prefix_embeds:
            s_txt = self.seq_len - cfg.num_prefix_embeds
            out["tokens"] = self._tokens(gen, (self.batch, s_txt))
            out["prefix_embeds"] = normal(
                (self.batch, cfg.num_prefix_embeds, cfg.d_model))
        else:
            out["tokens"] = self._tokens(gen, (self.batch, self.seq_len))
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def lattice_problem(shape: lat.LatticeShape, *, mass: float = 0.1,
                    seed: int = 0, packed: bool = True, device="cuda"):
    """(gauge, source) for D x = b, drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed`` (gauge first, then source).

    ``mass`` is unused, as in the JAX package's generator: the problem
    does not depend on it.  ``packed`` returns the packed real layouts.
    """
    gen = torch.Generator(device=lat.resolve_device(device))
    gen.manual_seed(seed)
    u = lat.random_gauge(gen, shape)
    b = lat.random_spinor(gen, shape)
    if packed:
        return lat.pack_gauge(u), lat.pack_spinor(b)
    return u, b
