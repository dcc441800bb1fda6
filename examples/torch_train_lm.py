"""End-to-end driver: train a ~100M-parameter GLM4-family model (the
PyTorch port's twin of examples/train_lm.py).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300

Defaults train ~300 steps of a 98M-param decoder on the synthetic zipf
stream with the full production substrate: mixed-precision AdamW,
warmup-cosine schedule, atomic checkpoints every 50 steps, auto-resume.
Runs on the card unless ``--device cpu``; on a mesh of ranks use
``torchrun ... -m repro_torch.launch.train --mesh``.
"""

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.core import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.models import convert
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig, warmup_cosine


def model_100m():
    base = configs.get_smoke("glm4-9b")
    return dataclasses.replace(
        base, name="glm4-100m", num_layers=12, d_model=512, num_heads=8,
        num_kv_heads=2, head_dim=64, d_ff=2048, vocab_size=32_768)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_train_lm")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_100m()
    n = cfg.param_count()
    print(f"[example] {cfg.name}: {n/1e6:.0f}M params")

    opt = AdamWConfig(lr=3e-4, weight_decay=0.1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = S.init_train_state(cfg, gen, opt, device=dev)
    sched = lambda s: warmup_cosine(s, warmup=30, total=args.steps)
    step_fn = S.make_train_step(cfg, opt, compute_dtype=torch.float32,
                                lr_schedule=sched)
    data = SyntheticLM(cfg, batch=args.batch, seq_len=args.seq_len,
                       device=str(dev))

    start = latest_step(args.ckpt_dir) or 0
    if start:
        print(f"[example] resuming from step {start}")
        tree = restore_checkpoint(args.ckpt_dir, start,
                                  convert.train_state_shapes(cfg, state),
                                  device=dev)
        state = convert.train_state_from_jax(cfg, tree, device=dev)

    t0 = time.time()
    for step in range(start, args.steps):
        state, m = step_fn(state, data.batch_at(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq_len * (step - start + 1) / \
                (time.time() - t0)
            print(f"[example] step={step:4d} loss={float(m['loss']):.4f} "
                  f"gnorm={float(m['grad_norm']):.2f} ({tok_s:.0f} tok/s)")
        if (step + 1) % 50 == 0 or step == args.steps - 1:
            save_checkpoint(args.ckpt_dir, step + 1,
                            convert.train_state_to_jax(cfg, state))
    print(f"[example] done in {time.time()-t0:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
