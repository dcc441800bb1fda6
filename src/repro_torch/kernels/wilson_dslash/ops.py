"""Public entry points over the Wilson kernels (K4 full lattice, K1 parity
hop).

Full lattice (packed (T, Z, Y, 24, X) fields, through K4):

``dslash``          — D psi, with optional gamma5 folding on either side
``dslash_dagger``   — D^dag psi = gamma5 D(-twist) gamma5, the flags folded
``normal_op``       — D^dag D psi: two launches, no standalone gamma5 pass

``use_kernels=False`` runs K4's plain version directly (the plan's
reference backend), without touching the wrapper's counts.

Even-odd half lattice (parity-compressed X axis, see
:mod:`repro_torch.core.lattice`):

``dslash_eo``/``dslash_oe`` — the parity-changing hopping blocks
``hop_block``               — one block with the whole fused epilogue
``schur_op``                — D_hat = S - D_eo S^-1 D_oe, two launches with
                              the site term and the axpy in the epilogues
``schur_dagger``            — D_hat^dag via the folded gamma5 flags
``schur_normal_op``         — D_hat^dag D_hat, four launches in all

Every entry point takes a spinor with or without a leading RHS axis
(N, T, Z, Y, 24, X[h]); a batch rides the same launches, so
``schur_normal_op`` is four launches and ``normal_op`` two whatever N
is.  Tensors on the CPU go through the kernel's plain version, CUDA
tensors through the kernel.  Fields and links are float32, or bf16 or
float16 for the mixed-precision solve's low operator: every launch's
output, and so every entry point's, is in the input's storage dtype, as
in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.core.operators import schur_launch_coeffs
from repro_torch.kernels.wilson_dslash.kernel import wilson_full, wilson_hop
from repro_torch.kernels.wilson_dslash.ref import (wilson_full_ref,
                                                   wilson_hop_ref)


def dslash(up, pp, mass, *, twist: float = 0.0, gamma5_in: bool = False,
           gamma5_out: bool = False, use_kernels: bool = True,
           halo=None) -> torch.Tensor:
    """``g5out (D + i twist g5) (g5in psi)`` on packed full-lattice fields;
    ``twist`` is the operator family's site-term twist (0 for Wilson).
    ``halo``: a mesh block's ghost planes (:func:`..kernel.wilson_full`),
    read in the same launch."""
    fn = wilson_full if use_kernels else wilson_full_ref
    return fn(up, pp, mass, twist=twist, gamma5_in=gamma5_in,
              gamma5_out=gamma5_out, halo=halo)


def dslash_dagger(up, pp, mass, *, twist: float = 0.0,
                  use_kernels: bool = True) -> torch.Tensor:
    """D(twist)^dag = gamma5 D(-twist) gamma5, folded into one launch."""
    return dslash(up, pp, mass, twist=-twist, gamma5_in=True,
                  gamma5_out=True, use_kernels=use_kernels)


def normal_op(up, pp, mass, *, twist: float = 0.0,
              use_kernels: bool = True) -> torch.Tensor:
    """A = D^dag D: two launches for every N and operator family."""
    dv = dslash(up, pp, mass, twist=twist, use_kernels=use_kernels)
    return dslash_dagger(up, dv, mass, twist=twist, use_kernels=use_kernels)


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
              hop_twist: float = 0.0, use_kernels: bool = True
              ) -> torch.Tensor:
    """One parity hop block with the fused epilogue::

        out = (acc_coeff + acc_twist i g5) psi_acc
            + (hop_coeff + hop_twist i g5) g5out Hop_which(g5in psi)

    ``which`` is ``"eo"`` (odd in, even out) or ``"oe"`` (even in, odd out).
    ``use_kernels=False`` runs K1's plain version directly.
    """
    if which not in ("eo", "oe"):
        raise ValueError(f"hop_block: which must be 'eo' or 'oe', "
                         f"got {which!r}")
    u_out, u_nbr = (u_e, u_o) if which == "eo" else (u_o, u_e)
    fn = wilson_hop if use_kernels else wilson_hop_ref
    return fn(u_out, u_nbr, pp, parity=0 if which == "eo" else 1,
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
