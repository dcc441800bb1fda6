#!/usr/bin/env python3
"""Are the served prompts the same on every draw?  On the card:

    python3 scripts/token_draws.py

Draws ``SyntheticLM``'s batch 0 eight times (seed 0, 4 requests) for
recurrentgemma-9b (a 2112-token prompt), seamless-m4t-large-v2 and
glm4-9b (32 tokens) at their full vocabularies, and eight times
``torch.multinomial`` of the zipf law they serve from one seeded
generator, and prints how many tokens of each draw differ from the
first; then the card's name and power limit.  ``torch.multinomial``
with replacement on a CUDA device drew other tokens on every call with
the same seed; ``SyntheticLM`` draws by inverse CDF and must differ in
none.
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402

DRAWS = 8


def main() -> int:
    if not torch.cuda.is_available():
        print("token_draws: no CUDA device", file=sys.stderr)
        return 2
    for arch, seq in (("recurrentgemma-9b", 2112),
                      ("seamless-m4t-large-v2", 32), ("glm4-9b", 32)):
        cfg = configs.get(arch)
        draws = [SyntheticLM(cfg, batch=4, seq_len=seq, seed=0,
                             device="cuda").batch_at(0)["tokens"].cpu()
                 for _ in range(DRAWS)]
        logits = -1.2 * torch.log1p(torch.arange(
            cfg.vocab_size, dtype=torch.float32, device="cuda"))
        probs = torch.softmax(logits, dim=0)
        multi = []
        for _ in range(DRAWS):
            gen = torch.Generator(device="cuda")
            gen.manual_seed(1234)
            multi.append(torch.multinomial(probs, 4 * seq, replacement=True,
                                           generator=gen).cpu())
        print(f"{arch} (4 x {seq} tokens): SyntheticLM draws differing from "
              f"the first in {[int((d != draws[0]).sum()) for d in draws[1:]]}"
              f" tokens; torch.multinomial in "
              f"{[int((m != multi[0]).sum()) for m in multi[1:]]}",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
