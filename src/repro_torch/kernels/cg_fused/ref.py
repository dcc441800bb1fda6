"""Plain PyTorch versions of the fused CG vector kernels.

Fields are (N, ...) batches with per-RHS (N,) scalars.  Each RHS is
reduced on its own, so a batched call equals N single calls bit for bit.
A frozen RHS (alpha_n == 0) and a closed gate pass their fields through
unchanged, exactly as the kernels do.
"""

from __future__ import annotations

import torch


def _bcast(s: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    return s.reshape(s.shape + (1,) * (field.dim() - 1))


def cg_update_ref(alpha, x, r, p, ap):
    """Per-RHS (x + a_n p, r - a_n Ap, ||r'_n||^2) for (N, ...) fields."""
    a = _bcast(alpha.to(torch.float32), x)
    frozen = a == 0
    xo = torch.where(frozen, x, x + a * p)
    ro = torch.where(frozen, r, r - a * ap)
    rs = torch.stack([(ro[n] * ro[n]).sum() for n in range(ro.shape[0])])
    return xo, ro, rs


def cg_xpay_ref(beta, r, p, gate=None):
    """Per-RHS p' = r + b_n p where gate_n (always when gate is None)."""
    po = r + _bcast(beta.to(torch.float32), p) * p
    if gate is None:
        return po
    return torch.where(_bcast(gate.to(torch.bool), p), po, p)
