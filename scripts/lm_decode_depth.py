#!/usr/bin/env python3
"""How far prefill(S) + decode(1) sits from forward(S + 1), by depth and
precision, for one LM family.  On the card:

    python3 scripts/lm_decode_depth.py [--arch rwkv6-1.6b] [--depths 1,2,4,8,16,24]

``chip_smoke.py`` phase 11 holds the served models' cache path (prefill,
then one decode step) against a forward pass over the prompt and the
served token, at the last position, within the CPU tests' bar scaled by
the square root of depth over the smoke config's.  This script takes the
same inputs (random weights from seed 0, ``SyntheticLM``'s batch 0,
4 requests, prompt 32) at full width and the depths given, and prints for
each: that error over the largest |logit| in float32; the logits' move
under a 1e-7 scaling of the embeddings (the model's own amplification of
a rounding, as phase 11 measures it); and the same error with every
tensor in float64 (the model's weights widened and its float32 casts and
constants made float64 in this process only).  An error that grows with
the amplification in float32 and sits at float64 rounding in float64 is
rounding carried through the layers; a cache-path fault shows in
float64 as an error far above it.  Then the card's name and power limit.
"""

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)
from repro_torch import configs  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import steps  # noqa: E402

REQUESTS, PROMPT = 4, 32


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="rwkv6-1.6b")
    p.add_argument("--depths", default="1,2,4,8,16,24")
    p.add_argument("--scale", choices=["full", "smoke"], default="full",
                   help="smoke: the smoke config's widths (a CPU rehearsal)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("lm_decode_depth: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    get = configs.get if args.scale == "full" else configs.get_smoke
    for depth in (int(v) for v in args.depths.split(",")):
        cfg = dataclasses.replace(get(args.arch), num_layers=depth)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = steps.model_module(cfg).init_params(cfg, gen, device=dev)
        batch = SyntheticLM(cfg, batch=REQUESTS,
                            seq_len=PROMPT + cfg.num_prefix_embeds, seed=0,
                            device=str(dev)).batch_at(0)
        logits, _ = steps.make_prefill_step(
            cfg, cache_len=cfg.num_prefix_embeds + PROMPT + 1,
            compute_dtype=torch.float32)(model, batch)
        nxt = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]
        err32, big32 = cs.lm_decode_vs_forward(cfg, model, batch, nxt, dev)
        sens = cs.lm_sensitivity(cfg, model, batch)
        print(f"{args.arch} depth {depth}: float32 error {err32 / big32:.3e}"
              f" of the largest |logit| {big32:.4f}, amplification of a "
              f"1e-7 input scaling {sens:.3e}", flush=True)
        del model
        torch.cuda.empty_cache()
    for depth in (int(v) for v in args.depths.split(",")):
        cfg = dataclasses.replace(get(args.arch), num_layers=depth)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = steps.model_module(cfg).init_params(cfg, gen, device=dev)
        model.double()
        batch = SyntheticLM(cfg, batch=REQUESTS,
                            seq_len=PROMPT + cfg.num_prefix_embeds, seed=0,
                            device=str(dev)).batch_at(0)
        with cs.float64_models():
            logits, _ = steps.make_prefill_step(
                cfg, cache_len=cfg.num_prefix_embeds + PROMPT + 1,
                compute_dtype=torch.float64)(model, batch)
            nxt = torch.argmax(logits[:, -1, :cfg.vocab_size],
                               dim=-1)[:, None]
            err64, big64 = cs.lm_decode_vs_forward(cfg, model, batch, nxt,
                                                   dev, torch.float64)
        print(f"{args.arch} depth {depth}: float64 error {err64 / big64:.3e}"
              f" of the largest |logit| {big64:.4f}", flush=True)
        del model
        torch.cuda.empty_cache()
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
