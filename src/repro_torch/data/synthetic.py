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
        """Token ids of ``shape``.  zipf: the inverse CDF of the unigram
        law (p_i proportional to (1 + i)^-1.2, its CDF in float64 on the
        host) at the generator's uniforms.  ``torch.multinomial`` is not
        used: on a CUDA device it drew other tokens on every call with the
        same seed (36-57 of 4 x 2112 at a 256000-token vocabulary on an
        H100; scripts/token_draws.py), so a served prompt was not the
        prompt a check drew again."""
        v = self.cfg.vocab_size
        if self.mode == "uniform":
            return torch.randint(0, v, shape, generator=gen,
                                 device=gen.device)
        logits = -1.2 * np.log1p(np.arange(v, dtype=np.float64))
        probs = np.exp(logits - logits.max())
        cdf = torch.from_numpy(np.cumsum(probs / probs.sum())).to(gen.device)
        u = torch.rand(shape, generator=gen, dtype=torch.float64,
                       device=gen.device)
        return torch.searchsorted(cdf, u, right=True).clamp_(max=v - 1)

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
