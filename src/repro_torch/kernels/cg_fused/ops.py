"""The fused CG vector engine on arbitrary field shapes.

``cg_update``/``cg_xpay`` take unbatched fields (run as an N = 1 batch of
the kernels), the ``_batched`` forms (N, ...) fields with per-RHS (N,)
scalars.  :func:`fused_engine` and :func:`fused_engine_batched` return
the (update, xpay) pairs that :func:`repro_torch.core.solvers.cg` takes.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cg_fused import kernel


def _per_rhs(s, like: torch.Tensor, n: int) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=torch.float32, device=like.device)
    return s.reshape(n).contiguous() if s.dim() else s.expand(n).contiguous()


def cg_update(alpha, x, r, p, ap):
    """Fused (x + alpha p, r - alpha Ap, ||r_new||^2) for any field shape."""
    xo, ro, rs = kernel.cg_update(_per_rhs(alpha, x, 1), x[None], r[None],
                                  p[None], ap[None])
    return xo[0], ro[0], rs[0]


def cg_xpay(beta, r, p):
    """p <- r + beta p for any field shape."""
    return kernel.cg_xpay(_per_rhs(beta, p, 1), r[None], p[None])[0]


def cg_update_batched(alpha, x, r, p, ap):
    """Per-RHS fused triad for (N, ...) fields; ``alpha`` is (N,).  A frozen
    RHS (alpha_n = 0) keeps its x/r slices bitwise unchanged."""
    return kernel.cg_update(_per_rhs(alpha, x, x.shape[0]), x, r, p, ap)


def cg_xpay_batched(beta, r, p, gate):
    """Gated per-RHS direction update: r_n + beta_n p_n where ``gate`` is
    set, p_n unchanged where it is not."""
    n = p.shape[0]
    gate = torch.as_tensor(gate, device=p.device).reshape(n)
    return kernel.cg_xpay(_per_rhs(beta, p, n), r, p, gate)


def fused_engine():
    """(update, xpay) for an unbatched :func:`repro_torch.core.solvers.cg`."""
    return cg_update, cg_xpay


def fused_engine_batched():
    """(update, xpay) for ``cg(..., batched=True)``: ``update`` takes the
    masked per-RHS alpha and returns per-RHS norms, ``xpay`` the gate."""
    return cg_update_batched, cg_xpay_batched
