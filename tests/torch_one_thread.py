"""Imported by the port's CPU test files for its one effect: torch runs
one intra-op thread.  The suite runs six pytest workers (``-n 6``) on a
few cores, where each worker's spinning thread pool costs the others many
times over (one port file alone: 17 s; six copies at once: 499 s with
torch's default threads, 15 s with one)."""

import torch

torch.set_num_threads(1)
