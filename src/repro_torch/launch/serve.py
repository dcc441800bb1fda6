"""Serving launcher: batched prefill + greedy decode loop.

``python -m repro_torch.launch.serve --arch glm4-9b --requests 4 --gen 16``
``python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu``

The JAX launcher's flags and printout, with ``--device`` (default
``cuda``): one batched prefill builds the KV caches (and recurrent
states), then a decode loop emits one token per step for the whole
batch.  Weights are random, drawn from ``--seed`` on the device; the
prompt is ``SyntheticLM``'s batch 0.  Both steps are timed on the host
clock, synchronized with the card.  :func:`main` returns what it measured
so another program can drive it (``cfg=`` replaces the architecture's
configuration, e.g. a depth cut).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.core.lattice import resolve_device
from repro_torch.data import SyntheticLM
from repro_torch.models import steps as S


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, *, cfg=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default="glm4-9b",
                   choices=configs.all_arch_names())
    p.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cpu)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = (configs.get if args.scale == "full" else configs.get_smoke)(
            args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = S.model_module(cfg).init_params(cfg, gen, device=dev)

    prefix = cfg.num_prefix_embeds or 0
    cache_len = prefix + args.prompt_len + args.gen
    data = SyntheticLM(cfg, batch=args.requests,
                       seq_len=args.prompt_len + prefix, seed=args.seed,
                       device=str(dev))
    batch = data.batch_at(0)

    prefill = S.make_prefill_step(cfg, cache_len=cache_len,
                                  compute_dtype=torch.float32)
    decode = S.make_decode_step(cfg, compute_dtype=torch.float32)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(model, batch)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        pos = prefix + args.prompt_len + i
        tok, logits, caches = decode(model, caches, tok, pos)
        out_tokens.append(tok)
    toks = torch.cat(out_tokens, dim=1)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    print(f"[serve] arch={cfg.name} requests={args.requests} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"[serve] prefill {t_prefill*1e3:.1f} ms, decode "
          f"{t_decode/max(args.gen-1,1)*1e3:.2f} ms/token")
    print(f"[serve] sample continuations: {toks[:, :8].tolist()}")
    return {
        "tokens": toks.cpu(), "last_logits": logits[:, -1].cpu(),
        "prefill_ms": t_prefill * 1e3,
        "decode_ms_per_token": t_decode / max(args.gen - 1, 1) * 1e3,
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in model.parameters()),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None)}


if __name__ == "__main__":
    main()
