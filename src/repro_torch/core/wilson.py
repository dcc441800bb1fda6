"""The Dirac-Wilson operator, natural layout (PyTorch reference).

Operator convention (r = Wilson parameter, m = bare mass)::

    D psi(x) = (m + 4r) psi(x)
             - 1/2 sum_mu [ (r - gamma_mu) U_mu(x)       psi(x+mu)
                          + (r + gamma_mu) U_mu(x-mu)^dag psi(x-mu) ]

Directions are ordered (t, z, y, x) like the tensor axes; the gamma
matrices are in the DeGrand-Rossi basis.  Even-odd blocks and the Schur
complement follow the JAX package::

    D_hat = M_ee - D_eo M_oo^{-1} D_oe,   D_hat^dag = gamma5 D_hat gamma5

These complex einsum forms are the port's correctness oracles: the plain
versions of the hop kernel run through them, and the solve's verification
matvec is the full-lattice ``dslash`` below.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lattice import NCOL, NDIRS, SPINOR_S, eo_row_offset

# ---------------------------------------------------------------------------
# Gamma matrices, DeGrand-Rossi basis, order (t, z, y, x) = axes (0,1,2,3)
# ---------------------------------------------------------------------------

_i = 1j
GAMMA_T = np.array([[0, 0, 1, 0],
                    [0, 0, 0, 1],
                    [1, 0, 0, 0],
                    [0, 1, 0, 0]], dtype=np.complex64)
GAMMA_X = np.array([[0, 0, 0, _i],
                    [0, 0, _i, 0],
                    [0, -_i, 0, 0],
                    [-_i, 0, 0, 0]], dtype=np.complex64)
GAMMA_Y = np.array([[0, 0, 0, -1],
                    [0, 0, 1, 0],
                    [0, 1, 0, 0],
                    [-1, 0, 0, 0]], dtype=np.complex64)
GAMMA_Z = np.array([[0, 0, _i, 0],
                    [0, 0, 0, -_i],
                    [-_i, 0, 0, 0],
                    [0, _i, 0, 0]], dtype=np.complex64)

# axis order (T, Z, Y, X)
GAMMAS = np.stack([GAMMA_T, GAMMA_Z, GAMMA_Y, GAMMA_X])
GAMMA5 = np.diag([1, 1, -1, -1]).astype(np.complex64)  # g5 = gt gx gy gz

EYE4 = np.eye(4, dtype=np.complex64)


def _projectors(r: float):
    """P-[mu] = r - gamma_mu (forward hop), P+[mu] = r + gamma_mu (backward)."""
    pm = np.stack([r * EYE4 - GAMMAS[mu] for mu in range(NDIRS)])
    pp = np.stack([r * EYE4 + GAMMAS[mu] for mu in range(NDIRS)])
    return pm, pp


def _spin_mats(r: float, like: torch.Tensor):
    pm, pp = _projectors(r)
    return (torch.from_numpy(pm).to(like.device, like.dtype),
            torch.from_numpy(pp).to(like.device, like.dtype))


# ---------------------------------------------------------------------------
# Natural-layout reference operator (complex)
# ---------------------------------------------------------------------------

def dslash(u: torch.Tensor, psi: torch.Tensor, mass,
           r: float = 1.0) -> torch.Tensor:
    """Dirac-Wilson operator: u (4,T,Z,Y,X,3,3), psi (T,Z,Y,X,4,3) complex."""
    pm, pp = _spin_mats(r, psi)
    out = (mass + 4.0 * r) * psi
    for mu in range(NDIRS):
        umu = u[mu]
        fwd = torch.roll(psi, -1, dims=mu)
        hf = torch.einsum("tzyxab,tzyxsb->tzyxsa", umu, fwd)
        hf = torch.einsum("sp,tzyxpa->tzyxsa", pm[mu], hf)
        bwd = torch.roll(psi, 1, dims=mu)
        ubw = torch.roll(umu, 1, dims=mu)
        hb = torch.einsum("tzyxba,tzyxsb->tzyxsa", ubw.conj(), bwd)
        hb = torch.einsum("sp,tzyxpa->tzyxsa", pp[mu], hb)
        out = out - 0.5 * (hf + hb)
    return out


def apply_gamma5(psi: torch.Tensor) -> torch.Tensor:
    """gamma5 = diag(+,+,-,-) on the spin axis (-2) of a natural field."""
    sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=psi.dtype,
                        device=psi.device)
    return psi * sign[:, None]


# ---------------------------------------------------------------------------
# Even-odd hopping operators and the Schur complement (natural layout)
# ---------------------------------------------------------------------------

def _hop_half(u_out: torch.Tensor, u_nbr: torch.Tensor, psi: torch.Tensor,
              s_out: np.ndarray, r: float) -> torch.Tensor:
    """Hopping term of D restricted to one parity's output sites.

    ``u_out`` holds the links at the OUTPUT-parity sites (forward hops),
    ``u_nbr`` those at the neighbour parity (backward hops take
    U_mu(x-mu)^dag there); ``psi`` is the opposite-parity half field
    (T, Z, Y, Xh, 4, 3) and ``s_out`` the (T, Z, Y) row offsets of the
    output sites.  For mu = x the neighbour of compressed index j is
    j + s_out (forward) / j - (1 - s_out) (backward).
    """
    t, z, y = psi.shape[:3]
    if t % 2 or z % 2 or y % 2:
        raise ValueError("even-odd operators need even T/Z/Y extents: an "
                         "odd periodic extent breaks bipartiteness, got "
                         f"{(t, z, y)}")
    pm, pp = _spin_mats(r, psi)
    sel = torch.from_numpy(s_out == 1).to(psi.device).reshape(
        s_out.shape + (1, 1, 1))

    out = torch.zeros_like(psi)
    for mu in range(NDIRS):
        if mu < 3:
            fwd = torch.roll(psi, -1, dims=mu)
            u_fwd = u_out[mu]
            bwd = torch.roll(psi, 1, dims=mu)
            u_bwd = torch.roll(u_nbr[mu], 1, dims=mu)
        else:
            fwd = torch.where(sel, torch.roll(psi, -1, dims=3), psi)
            u_fwd = u_out[3]
            bwd = torch.where(sel, psi, torch.roll(psi, 1, dims=3))
            u_bwd = torch.where(sel, u_nbr[3], torch.roll(u_nbr[3], 1, dims=3))
        hf = torch.einsum("tzyjab,tzyjsb->tzyjsa", u_fwd, fwd)
        hf = torch.einsum("sp,tzyjpa->tzyjsa", pm[mu], hf)
        hb = torch.einsum("tzyjba,tzyjsb->tzyjsa", u_bwd.conj(), bwd)
        hb = torch.einsum("sp,tzyjpa->tzyjsa", pp[mu], hb)
        out = out - 0.5 * (hf + hb)
    return out


def dslash_eo(u_e, u_o, psi_o, r: float = 1.0) -> torch.Tensor:
    """D_eo: hopping term from an ODD half field onto EVEN output sites."""
    t, z, y = psi_o.shape[:3]
    return _hop_half(u_e, u_o, psi_o, eo_row_offset(t, z, y), r)


def dslash_oe(u_e, u_o, psi_e, r: float = 1.0) -> torch.Tensor:
    """D_oe: hopping term from an EVEN half field onto ODD output sites."""
    t, z, y = psi_e.shape[:3]
    return _hop_half(u_o, u_e, psi_e, 1 - eo_row_offset(t, z, y), r)


def schur_op(u_e, u_o, psi_e, mass, r: float = 1.0) -> torch.Tensor:
    """D_hat psi_e = (m+4r) psi_e - D_eo D_oe psi_e / (m+4r)."""
    m = mass + 4.0 * r
    return m * psi_e - dslash_eo(u_e, u_o, dslash_oe(u_e, u_o, psi_e, r=r),
                                 r=r) / m


def schur_dagger(u_e, u_o, psi_e, mass, r: float = 1.0) -> torch.Tensor:
    """D_hat^dag = gamma5 D_hat gamma5."""
    return apply_gamma5(schur_op(u_e, u_o, apply_gamma5(psi_e), mass, r=r))


def schur_normal_op(u_e, u_o, psi_e, mass, r: float = 1.0) -> torch.Tensor:
    """A_hat = D_hat^dag D_hat — HPD on the even sublattice."""
    return schur_dagger(u_e, u_o, schur_op(u_e, u_o, psi_e, mass, r=r),
                        mass, r=r)


# ---------------------------------------------------------------------------
# Packed layout
# ---------------------------------------------------------------------------

def apply_gamma5_packed(p: torch.Tensor) -> torch.Tensor:
    """gamma5 on a packed field's S axis (-2); leading axes pass through."""
    if p.shape[-2] != SPINOR_S:
        raise ValueError(f"packed spinor needs S={SPINOR_S}, got "
                         f"{p.shape[-2]}")
    sign = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=p.dtype,
                        device=p.device).repeat_interleave(NCOL * 2)
    return p * sign[:, None]

