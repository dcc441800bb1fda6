"""Plain PyTorch versions of the fused CG vector kernels.

Fields are (N, ...) batches with per-RHS (N,) scalars, in float32, bf16
or float16 storage: each field is widened to f32, the update is computed in
f32 and rounded once to the field's dtype, and ``||r'||^2`` is reduced
from the f32 value before that rounding (as the JAX kernels do).  Each
RHS is reduced on its own, so a batched call equals N single calls bit
for bit.  A frozen RHS (alpha_n == 0) and a closed gate pass their
fields through unchanged, exactly as the kernels do.
"""

from __future__ import annotations

import torch


def _bcast(s: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    return s.reshape(s.shape + (1,) * (field.dim() - 1))


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32)


def cg_update_ref(alpha, x, r, p, ap):
    """Per-RHS (x + a_n p, r - a_n Ap, ||r'_n||^2) for (N, ...) fields."""
    a = _bcast(alpha.to(torch.float32), x)
    frozen = a == 0
    x32 = _f32(x) + a * _f32(p)
    r32 = _f32(r) - a * _f32(ap)
    xo = torch.where(frozen, x, x32.to(x.dtype))
    ro = torch.where(frozen, r, r32.to(r.dtype))
    r32 = torch.where(frozen, _f32(r), r32)
    rs = torch.stack([(r32[n] * r32[n]).sum() for n in range(r.shape[0])])
    return xo, ro, rs


def cg_xpay_ref(beta, r, p, gate=None):
    """Per-RHS p' = r + b_n p where gate_n (always when gate is None)."""
    po = (_f32(r) + _bcast(beta.to(torch.float32), p) * _f32(p)).to(p.dtype)
    if gate is None:
        return po
    return torch.where(_bcast(gate.to(torch.bool), p), po, p)
