"""Shape-ladder padding and the batch-formation policy for the solver server.

The serving layer coalesces requests that share a gauge field into the
multi-RHS batched Schur solve.  Every dispatched batch is padded up to a
small ladder of batch shapes (default N in {1, 4, 8, 16}), so the kernels
and the loop see a handful of shapes whatever the queue depth.

Padding is bitwise-safe by construction: a pad slot is an all-zero RHS,
whose convergence limit ``tol^2 ||b||^2`` is exactly 0, so the per-RHS
convergence mask (``repro_torch.core.solvers.cg``, ``batched=True``)
deactivates it at iteration 0: its masked ``alpha`` is 0 forever, it adds
nothing to any other system's ``alpha``/``beta`` (those are per RHS), and
the loop's trip count is decided by the real systems only.  A batch of k
padded to rung N returns the first k solutions bitwise equal to the
unpadded k-RHS solve (``tests/test_torch_serve.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

DEFAULT_LADDER = (1, 4, 8, 16)


def validate_ladder(ladder: Sequence[int]) -> tuple[int, ...]:
    """Normalize a batch-shape ladder: sorted, unique, positive rungs."""
    rungs = tuple(sorted({int(n) for n in ladder}))
    if not rungs or rungs[0] < 1:
        raise ValueError(f"batch ladder needs positive rungs, got {ladder!r}")
    return rungs


def rung_for(n: int, ladder: Sequence[int]) -> int:
    """The smallest ladder rung that fits an n-request batch."""
    for rung in ladder:
        if n <= rung:
            return rung
    raise ValueError(
        f"batch of {n} exceeds the top ladder rung {ladder[-1]}; the "
        "dispatcher must cap batches at the top rung (BatchPolicy."
        "resolved_max_batch)")


def pad_batch(rhs_list: Sequence, rung: int, device=None) -> torch.Tensor:
    """Stack k right-hand sides (on ``device``) and zero-pad the batch
    axis up to ``rung``; the zero slots freeze at iteration 0 (see the
    module docstring)."""
    b = torch.stack([torch.as_tensor(r, device=device) for r in rhs_list])
    k = b.shape[0]
    if k > rung:
        raise ValueError(f"batch of {k} does not fit rung {rung}")
    if k == rung:
        return b
    pad = torch.zeros((rung - k,) + tuple(b.shape[1:]), dtype=b.dtype,
                      device=b.device)
    return torch.cat([b, pad])


def pad_tols(tols: Sequence[float], rung: int, device=None) -> torch.Tensor:
    """Per-RHS float32 tolerance vector for a padded batch.  Pad slots get
    tol = 1.0: any value works (their limit is 0, the RHS being zero)."""
    if len(tols) > rung:
        raise ValueError(f"{len(tols)} tolerances do not fit rung {rung}")
    vals = [float(t) for t in tols] + [1.0] * (rung - len(tols))
    return torch.tensor(vals, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """When a per-gauge-field queue dispatches a batch.

    ``max_wait``: seconds from the first queued request to a forced
    dispatch; a lone request is solved at most ``max_wait`` after arrival
    even if the batch never fills.  ``max_batch``: dispatch at once when
    this many requests are queued; ``None`` means the top ladder rung.
    """

    max_wait: float = 0.05
    max_batch: int | None = None

    def __post_init__(self):
        if self.max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {self.max_wait}")
        if self.max_batch is not None and self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")

    def resolved_max_batch(self, ladder: Sequence[int]) -> int:
        """The dispatch cap: never exceed the top ladder rung."""
        top = ladder[-1]
        if self.max_batch is None:
            return top
        return min(self.max_batch, top)
