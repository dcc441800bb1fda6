"""Training launcher: ``python -m repro_torch.launch.train --arch glm4-9b``

The JAX launcher's flags and printout, on one device, with ``--device``
(default ``cuda``):

* checkpoints every ``--ckpt-every`` steps and at the last (atomic,
  checksummed, in the JAX package's format and keys: the JAX launcher
  restores them, and they restore here);
* ``--resume auto`` restores the newest complete checkpoint and the data
  stream skips to the restored step (``SyntheticLM.batch_at(step)``: the
  same batches as an uninterrupted run);
* on SIGTERM (preemption) the step in flight finishes, a checkpoint is
  written and the process exits 0;
* a straggler watchdog warns on stderr when a step takes longer than
  ``--max-step-seconds``.

``--mesh`` other than ``none`` (the JAX launcher's data-parallel meshes)
is not ported yet (ROADMAP item 17) and raises.  Weights are random,
drawn from ``--seed`` on the device; the learning rate warms up
linearly over ``--warmup`` steps and decays on a cosine to ``--steps``.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.core.lattice import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.models import convert
from repro_torch.models import steps as S
from repro_torch.optim import AdamWConfig, warmup_cosine


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True, choices=configs.all_arch_names())
    p.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--warmup", type=int, default=20)
    p.add_argument("--mesh", default="none",
                   choices=["none", "debug", "pod", "multipod"])
    p.add_argument("--compute-dtype", default="float32")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--resume", default="none", choices=["none", "auto"])
    p.add_argument("--max-step-seconds", type=float, default=120.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cpu)")
    return p.parse_args(argv)


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: data-parallel training is not ported yet "
            "(ROADMAP item 17); the port trains on one device (--mesh none)")
    dev = resolve_device(args.device)
    cfg = (configs.get if args.scale == "full" else configs.get_smoke)(
        args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, moment_dtype=cfg.opt_state_dtype)
    compute_dtype = getattr(torch, args.compute_dtype)

    seq = args.seq_len + (cfg.num_prefix_embeds or 0)
    data = SyntheticLM(cfg, batch=args.batch, seq_len=seq, seed=args.seed,
                       device=str(dev))

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    state = S.init_train_state(cfg, gen, opt_cfg, device=dev)

    def schedule(s):
        return warmup_cosine(s, warmup=args.warmup, total=args.steps)
    step_fn = S.make_train_step(cfg, opt_cfg, compute_dtype=compute_dtype,
                                lr_schedule=schedule)

    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"[train] resuming from step {last}")
            tree = restore_checkpoint(
                args.ckpt_dir, last, convert.train_state_shapes(cfg, state),
                device=dev)
            state = convert.train_state_from_jax(cfg, tree, device=dev)
            start = last

    stop = {"now": False}

    def _sigterm(signum, frame):  # preemption: checkpoint then exit
        stop["now"] = True
    previous = signal.signal(signal.SIGTERM, _sigterm)
    try:
        t_all = time.time()
        for step in range(start, args.steps):
            t0 = time.time()
            state, metrics = step_fn(state, data.batch_at(step))
            _sync(dev)
            if step % args.log_every == 0 or step == args.steps - 1:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                print(f"[train] step={step} loss={loss:.4f} "
                      f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s",
                      flush=True)
            if time.time() - t0 > args.max_step_seconds:
                print(f"[train] WARNING straggler: step {step} took "
                      f"{time.time()-t0:.1f}s > {args.max_step_seconds}s",
                      file=sys.stderr)
            if args.ckpt_dir and (
                    (step + 1) % args.ckpt_every == 0 or stop["now"]
                    or step == args.steps - 1):
                path = save_checkpoint(args.ckpt_dir, step + 1,
                                       convert.train_state_to_jax(cfg, state))
                print(f"[train] checkpoint -> {path}", flush=True)
            if stop["now"]:
                print("[train] SIGTERM received; checkpointed and exiting",
                      flush=True)
                return 0
        print(f"[train] done: {args.steps - start} steps in "
              f"{time.time()-t_all:.1f}s")
        return 0
    finally:  # a caller of main() keeps its own handler
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    sys.exit(main())
