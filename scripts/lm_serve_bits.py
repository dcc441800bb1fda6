#!/usr/bin/env python3
"""A fingerprint of the LM serving path's numbers, to compare two trees.

    PYTHONPATH=<tree>/src python3 scripts/lm_serve_bits.py

For each architecture's smoke config (weights from seed 0, the prompt
``SyntheticLM`` batch 0 of seed 1, on the CPU): the sha256 of the f32
bytes of the prefill logits, 4 greedy decode steps' logits and the full
forward's logits, in f32 and in bf16 compute.  Equal lines from two trees
mean their prefill, decode and forward are bitwise equal.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import steps  # noqa: E402


def fingerprint(arch: str) -> str:
    cfg = configs.get_smoke(arch)
    gen = torch.Generator().manual_seed(0)
    model = steps.model_module(cfg).init_params(cfg, gen, device="cpu")
    pre = cfg.num_prefix_embeds
    batch = SyntheticLM(cfg, batch=2, seq_len=pre + 20, seed=1,
                        device="cpu").batch_at(0)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    h = hashlib.sha256()
    for dt in (torch.float32, torch.bfloat16):
        prefill = steps.make_prefill_step(cfg, cache_len=pre + 25,
                                          compute_dtype=dt)
        decode = steps.make_decode_step(cfg, compute_dtype=dt)
        logits, caches = prefill(model, batch)
        h.update(logits.float().numpy().tobytes())
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(4):
            tok, logits, caches = decode(model, caches, tok, pre + 20 + i)
            h.update(logits.float().numpy().tobytes())
        full, _ = steps.model_module(cfg).forward(
            cfg, model, batch["tokens"], compute_dtype=dt, **extra)
        h.update(full.float().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    print(json.dumps({arch: fingerprint(arch)
                      for arch in configs.all_arch_names()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
