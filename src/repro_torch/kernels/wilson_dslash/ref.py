"""Plain PyTorch versions of the parity hop kernel (K1) and the
full-lattice kernel (K4).

The hop versions round-trip through the natural-layout complex operators
of :mod:`repro_torch.core.wilson`; the full-lattice version runs the
packed einsum operator ``dslash_packed``.  Both are slow, but independent
of the kernels' tables and index arithmetic, which is what an oracle
should be.  On CPU tensors the kernel wrappers (:mod:`repro_torch.kernels.
wilson_dslash.kernel`) run these; ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.lattice import (eo_row_offset, pack_spinor,
                                      unpack_gauge, unpack_spinor)
from repro_torch.core.operators import (apply_igamma5_packed,
                                        schur_dagger_g, schur_normal_op_g,
                                        schur_op_g)
from repro_torch.core.wilson import (_hop_half, apply_gamma5,
                                     apply_gamma5_packed, dslash_packed)


def _per_rhs(fn, v: torch.Tensor, batched: bool) -> torch.Tensor:
    """Apply a single-RHS natural-layout op to each slice of a batch."""
    if not batched:
        return fn(v)
    return torch.stack([fn(v[n]) for n in range(v.shape[0])])


def wilson_hop_ref(u_out: torch.Tensor, u_nbr: torch.Tensor,
                   psi: torch.Tensor, *, parity: int,
                   gamma5_in: bool = False, gamma5_out: bool = False,
                   psi_acc: torch.Tensor | None = None,
                   acc_coeff: float = 0.0, hop_coeff: float = 1.0,
                   acc_twist: float = 0.0,
                   hop_twist: float = 0.0) -> torch.Tensor:
    """The hop kernel's function on packed half fields (rank 5, or rank 6
    with a leading RHS axis), computed in f32 from the widened operands
    and rounded once to ``psi``'s dtype:

        out = (acc_coeff + acc_twist i g5) psi_acc
            + (hop_coeff + hop_twist i g5) g5out Hop(g5in psi)

    ``parity`` is the output parity (0: D_eo, 1: D_oe); ``u_out`` holds
    the links at the output parity's sites, ``u_nbr`` the others.
    """
    t, z, y = psi.shape[-5:-2]
    s_out = eo_row_offset(t, z, y) ^ (int(parity) & 1)
    uo = unpack_gauge(u_out.to(torch.float32))
    un = unpack_gauge(u_nbr.to(torch.float32))

    def one(v):
        if gamma5_in:
            v = apply_gamma5(v)
        h = _hop_half(uo, un, v, s_out, 1.0)
        return apply_gamma5(h) if gamma5_out else h

    v = unpack_spinor(psi.to(torch.float32))
    hop = pack_spinor(_per_rhs(one, v, psi.dim() == 6))
    out = hop if hop_coeff == 1.0 else hop_coeff * hop
    if hop_twist != 0.0:
        out = out + hop_twist * apply_igamma5_packed(hop)
    if psi_acc is not None:
        acc32 = psi_acc.to(torch.float32)
        acc = acc_coeff * acc32
        if acc_twist != 0.0:
            acc = acc + acc_twist * apply_igamma5_packed(acc32)
        out = acc + out
    return out.to(psi.dtype)


def wilson_full_ref(up: torch.Tensor, pp: torch.Tensor, mass, *,
                    twist: float = 0.0, gamma5_in: bool = False,
                    gamma5_out: bool = False) -> torch.Tensor:
    """The full-lattice kernel's function on packed fields (rank 5, or
    rank 6 with a leading RHS axis)::

        out = g5out (D_wilson + i twist g5) (g5in psi)

    Computed in f32 (f64 for f64 fields) from the widened operands and
    rounded once to ``pp``'s dtype, as the kernel does.  A batch goes through one RHS at a
    time, so batched equals looped bitwise.
    """
    def one(q):
        if gamma5_in:
            q = apply_gamma5_packed(q)
        out = dslash_packed(up_w, q, mass, hop_dtype=hop)
        if twist != 0.0:
            out = out + twist * apply_igamma5_packed(q)
        out = apply_gamma5_packed(out) if gamma5_out else out
        return out.to(pp.dtype)

    wide = torch.float64 if pp.dtype == torch.float64 else torch.float32
    # f32 fields: each hop term in f64, rounded once (see dslash_packed);
    # narrow storage keeps f32 throughout
    hop = (torch.float64 if pp.dtype in (torch.float32, torch.float64)
           else torch.float32)
    up_w = up.to(wide)
    return _per_rhs(one, pp.to(wide), pp.dim() == 6)


def _via_natural(fn, u_e_p, u_o_p, pp):
    u_e = unpack_gauge(u_e_p.to(torch.float32))
    u_o = unpack_gauge(u_o_p.to(torch.float32))
    v = unpack_spinor(pp.to(torch.float32))
    out = _per_rhs(lambda w: fn(u_e, u_o, w), v, pp.dim() == 6)
    return pack_spinor(out, dtype=pp.dtype)


def schur_op_ref(u_e_p, u_o_p, pp_e, mass, *, twist: float = 0.0,
                 dagger: bool = False) -> torch.Tensor:
    """Schur complement D_hat (or D_hat^dag) on packed even half fields."""
    fn = schur_dagger_g if dagger else schur_op_g
    return _via_natural(lambda ue, uo, v: fn(ue, uo, v, mass, twist=twist),
                        u_e_p, u_o_p, pp_e)


def schur_normal_op_ref(u_e_p, u_o_p, pp_e, mass, *,
                        twist: float = 0.0) -> torch.Tensor:
    """A_hat = D_hat^dag D_hat on packed even half fields."""
    return _via_natural(
        lambda ue, uo, v: schur_normal_op_g(ue, uo, v, mass, twist=twist),
        u_e_p, u_o_p, pp_e)
