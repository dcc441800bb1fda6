#!/usr/bin/env python3
"""Loss of a few training steps against the learning rate, on the card.

    python3 scripts/lm_train_lr.py --lrs 1e-4,3e-5,1e-5 --dtypes bfloat16

``chip_smoke.py``'s phase 12(a) configuration (glm4-9b at full width,
``--layers`` of its 40 layers, batch 2 x 1024 tokens, one repeated batch,
``make_train_step``'s constant schedule, AdamW's other defaults), run
once for each learning rate and compute dtype from the same seed: prints
each step's loss and grad norm, so one can see at which rates the loss
falls over the first steps.  Needs the card (``--device cpu`` runs the
smoke config instead).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import steps  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lrs", default="1e-4,3e-5,1e-5")
    p.add_argument("--dtypes", default="bfloat16")
    p.add_argument("--layers", type=int, default=8)
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    get = configs.get if dev.type == "cuda" else configs.get_smoke
    cfg = dataclasses.replace(get("glm4-9b"), num_layers=args.layers)
    batch = SyntheticLM(cfg, batch=2, seq_len=1024, seed=0,
                        device=str(dev)).batch_at(0)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    for dtype in args.dtypes.split(","):
        for lr in map(float, args.lrs.split(",")):
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            opt = AdamWConfig(lr=lr)
            state = steps.init_train_state(cfg, gen, opt, device=dev)
            step = steps.make_train_step(cfg, opt,
                                         compute_dtype=getattr(torch, dtype))
            losses, norms = [], []
            t0 = time.perf_counter()
            for _ in range(args.steps):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
            print(f"{cfg.name} {args.layers} layers, {dtype} compute, lr "
                  f"{lr:g}: losses {[round(x, 4) for x in losses]}, grad "
                  f"norms {[round(x, 3) for x in norms]} "
                  f"({time.perf_counter() - t0:.1f} s; {card})", flush=True)
            del state, step
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
