"""Training launcher: ``python -m repro_torch.launch.train --arch glm4-9b``

The JAX launcher's flags and printout, with ``--device`` (default
``cuda``), on one device or, with ``--mesh``, on a mesh over the ranks of
a ``torchrun`` job:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh debug

``debug`` is the 2 x 2 (``data``, ``model``) mesh, ``pod`` and
``multipod`` the JAX package's 16 x 16 and 2 x 16 x 16 meshes, which run
when the job has 256 or 512 ranks and raise naming that size otherwise.
On a mesh the state and the batch are sharded as the JAX launcher shards
them (``models/steps.py``); every rank draws the same weights and the
same batches, rank 0 alone prints, and a checkpoint holds whole arrays,
so ``--resume auto`` restores onto any mesh or onto one device:

* checkpoints every ``--ckpt-every`` steps and at the last (atomic,
  checksummed, in the JAX package's format and keys: the JAX launcher
  restores them, and they restore here);
* ``--resume auto`` restores the newest complete checkpoint and the data
  stream skips to the restored step (``SyntheticLM.batch_at(step)``: the
  same batches as an uninterrupted run);
* on SIGTERM (preemption) the step in flight finishes, a checkpoint is
  written and the process exits 0 (on a mesh every rank stops after the
  same step: the ranks agree on it through one all-reduce a step);
* a straggler watchdog warns on stderr when a step takes longer than
  ``--max-step-seconds``.

Weights are random, drawn from ``--seed`` on the device; the learning
rate warms up linearly over ``--warmup`` steps and decays on a cosine to
``--steps``.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.core.lattice import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
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


def build_mesh(kind: str, device):
    """None for ``none``; else the mesh over this ``torchrun`` job's ranks
    (``pod``/``multipod``: a job of exactly their size)."""
    if kind == "none":
        return None
    if kind == "debug":
        return make_debug_mesh(device=device)
    shape = make_production_mesh(multi_pod=kind == "multipod")
    world = os.environ.get("WORLD_SIZE")
    if world is None or int(world) != shape.size:
        raise ValueError(
            f"--mesh {kind} is {' x '.join(map(str, shape.shape.values()))} "
            f"over {shape.axis_names}: it needs a torchrun job of "
            f"{shape.size} ranks, this one has {world or 'none'}")
    return make_debug_mesh(tuple(shape.shape.values()), shape.axis_names,
                           device=device)


def _checkpoint(cfg, state, mesh, ckpt_dir: str, step: int) -> str:
    if mesh is None:
        return save_checkpoint(ckpt_dir, step,
                               convert.train_state_to_jax(cfg, state))
    return save_checkpoint(
        ckpt_dir, step, convert.train_state_tree(cfg, state), mesh=mesh,
        specs=convert.train_state_specs_to_jax(cfg, S.state_specs(cfg,
                                                                  state)))


def _restore(cfg, state, mesh, ckpt_dir: str, step: int, dev) -> dict:
    specs = None if mesh is None else convert.train_state_specs_to_jax(
        cfg, S.state_specs(cfg, state))
    tree = restore_checkpoint(ckpt_dir, step,
                              convert.train_state_shapes(cfg, state),
                              device=dev, mesh=mesh, specs=specs)
    return convert.train_state_from_jax(cfg, tree, device=dev, mesh=mesh)


def _stop_agreed(flag: bool, mesh, dev) -> bool:
    """Whether any rank was asked to stop (every rank gets the same
    answer, so every rank checkpoints after the same step)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    return bool(mesh.psum(t, kind="stop_flag").item())


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mesh = build_mesh(args.mesh, dev)
    if mesh is not None:
        dev = mesh.device
    lead = mesh is None or mesh.rank == 0

    def say(msg: str):
        if lead:
            print(msg, flush=True)

    cfg = (configs.get if args.scale == "full" else configs.get_smoke)(
        args.arch)
    opt_cfg = AdamWConfig(lr=args.lr, moment_dtype=cfg.opt_state_dtype)
    compute_dtype = getattr(torch, args.compute_dtype)

    seq = args.seq_len + (cfg.num_prefix_embeds or 0)
    data = SyntheticLM(cfg, batch=args.batch, seq_len=seq, seed=args.seed,
                       device=str(dev))

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    state = S.init_train_state(cfg, gen, opt_cfg, device=dev, mesh=mesh)

    def schedule(s):
        return warmup_cosine(s, warmup=args.warmup, total=args.steps)
    step_fn = S.make_train_step(cfg, opt_cfg, mesh=mesh,
                                compute_dtype=compute_dtype,
                                lr_schedule=schedule)

    start = 0
    if args.resume == "auto" and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            say(f"[train] resuming from step {last}")
            state = _restore(cfg, state, mesh, args.ckpt_dir, last, dev)
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
                say(f"[train] step={step} loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s")
            if time.time() - t0 > args.max_step_seconds:
                print(f"[train] WARNING straggler: step {step} took "
                      f"{time.time()-t0:.1f}s > {args.max_step_seconds}s",
                      file=sys.stderr)
            stopping = _stop_agreed(stop["now"], mesh, dev)
            if args.ckpt_dir and (
                    (step + 1) % args.ckpt_every == 0 or stopping
                    or step == args.steps - 1):
                path = _checkpoint(cfg, state, mesh, args.ckpt_dir, step + 1)
                say(f"[train] checkpoint -> {path}")
            if stopping:
                say("[train] SIGTERM received; checkpointed and exiting")
                return 0
        say(f"[train] done: {args.steps - start} steps in "
            f"{time.time()-t_all:.1f}s")
        return 0
    finally:  # a caller of main() keeps its own handler
        signal.signal(signal.SIGTERM, previous)


if __name__ == "__main__":
    sys.exit(main())
