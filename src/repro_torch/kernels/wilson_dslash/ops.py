"""Public entry points over the parity hop kernel (K1).

Even-odd half lattice (parity-compressed X axis, see
:mod:`repro_torch.core.lattice`):

``dslash_eo``/``dslash_oe`` — the parity-changing hopping blocks
``hop_block``               — one block with the whole fused epilogue
``schur_op``                — D_hat = S - D_eo S^-1 D_oe, two launches with
                              the site term and the axpy in the epilogues
``schur_dagger``            — D_hat^dag via the folded gamma5 flags
``schur_normal_op``         — D_hat^dag D_hat, four launches in all

Every entry point takes a spinor with or without a leading RHS axis
(N, T, Z, Y, 24, Xh); a batch rides the same launches, so
``schur_normal_op`` is four launches whatever N is.  Tensors on the CPU go
through the kernel's plain version, CUDA tensors through the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.operators import schur_launch_coeffs
from repro_torch.kernels.wilson_dslash.kernel import wilson_hop

_FULL_LATTICE = (
    "the full-lattice dslash needs the port of kernel B6 "
    "(repro/kernels/wilson_dslash/kernel.py::_dslash_kernel); it is "
    "ROADMAP Queue A item 7, the next slice")


def dslash(up, pp, mass, **_):
    """Full-lattice D psi: not ported yet (ROADMAP A7 / B6)."""
    raise NotImplementedError(_FULL_LATTICE)


def normal_op(up, pp, mass, **_):
    """Full-lattice D^dag D psi: not ported yet (ROADMAP A7 / B6)."""
    raise NotImplementedError(_FULL_LATTICE)


def dslash_eo(u_e, u_o, pp_o, *, gamma5_in: bool = False,
              gamma5_out: bool = False) -> torch.Tensor:
    """D_eo: ODD half field in, EVEN half field out (hopping term only)."""
    return wilson_hop(u_e, u_o, pp_o, parity=0, gamma5_in=gamma5_in,
                      gamma5_out=gamma5_out)


def dslash_oe(u_e, u_o, pp_e, *, gamma5_in: bool = False,
              gamma5_out: bool = False) -> torch.Tensor:
    """D_oe: EVEN half field in, ODD half field out (hopping term only)."""
    return wilson_hop(u_o, u_e, pp_e, parity=1, gamma5_in=gamma5_in,
                      gamma5_out=gamma5_out)


def hop_block(u_e, u_o, pp, *, which: str, gamma5_in: bool = False,
              gamma5_out: bool = False, psi_acc=None, acc_coeff: float = 0.0,
              hop_coeff: float = 1.0, acc_twist: float = 0.0,
              hop_twist: float = 0.0) -> torch.Tensor:
    """One parity hop block with the fused epilogue::

        out = (acc_coeff + acc_twist i g5) psi_acc
            + (hop_coeff + hop_twist i g5) g5out Hop_which(g5in psi)

    ``which`` is ``"eo"`` (odd in, even out) or ``"oe"`` (even in, odd out).
    """
    if which not in ("eo", "oe"):
        raise ValueError(f"hop_block: which must be 'eo' or 'oe', "
                         f"got {which!r}")
    u_out, u_nbr = (u_e, u_o) if which == "eo" else (u_o, u_e)
    return wilson_hop(u_out, u_nbr, pp, parity=0 if which == "eo" else 1,
                      gamma5_in=gamma5_in, gamma5_out=gamma5_out,
                      psi_acc=psi_acc, acc_coeff=acc_coeff,
                      hop_coeff=hop_coeff, acc_twist=acc_twist,
                      hop_twist=hop_twist)


def schur_op(u_e, u_o, pp_e, mass: float, *, twist: float = 0.0,
             dagger: bool = False) -> torch.Tensor:
    """D_hat psi = S psi - D_eo S^-1 D_oe psi with S = (mass+4) + i twist g5.

    Two launches for every operator family: D_oe with S^-1 in its
    epilogue (for Wilson the scalar rides the second launch's hop
    coefficient), then D_eo computing ``S psi - hop`` in its epilogue.
    ``dagger`` gives D_hat(twist)^dag = g5 D_hat(-twist) g5 by folding g5
    into the first launch's input and the second launch's hop.
    """
    m = float(mass) + 4.0
    if twist == 0.0:
        tmp_o = hop_block(u_e, u_o, pp_e, which="oe", gamma5_in=dagger)
        return hop_block(u_e, u_o, tmp_o, which="eo", gamma5_out=dagger,
                         psi_acc=pp_e, acc_coeff=m, hop_coeff=-1.0 / m)
    h1c, h1t, acc, acct = schur_launch_coeffs(m, twist, dagger)
    tmp_o = hop_block(u_e, u_o, pp_e, which="oe", gamma5_in=dagger,
                      hop_coeff=h1c, hop_twist=h1t)
    return hop_block(u_e, u_o, tmp_o, which="eo", gamma5_out=dagger,
                     psi_acc=pp_e, acc_coeff=acc, acc_twist=acct,
                     hop_coeff=-1.0)


def schur_dagger(u_e, u_o, pp_e, mass: float, *,
                 twist: float = 0.0) -> torch.Tensor:
    """D_hat^dag = gamma5 D_hat(-twist) gamma5, folded into the launches."""
    return schur_op(u_e, u_o, pp_e, mass, twist=twist, dagger=True)


def schur_normal_op(u_e, u_o, pp_e, mass: float, *,
                    twist: float = 0.0) -> torch.Tensor:
    """A_hat = D_hat^dag D_hat: four hop launches for every N and family."""
    w = schur_op(u_e, u_o, pp_e, mass, twist=twist)
    return schur_op(u_e, u_o, w, mass, twist=twist, dagger=True)
