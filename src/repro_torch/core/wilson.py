"""The Dirac-Wilson operator in the natural and packed layouts (PyTorch
reference).

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
matvec is the full-lattice ``dslash`` below.  The packed real forms
(``dslash_packed`` and its dagger and normal operator) are the plain
version of the full-lattice kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.lattice import (NCOL, NDIRS, NSPIN, SPINOR_S,
                                      eo_row_offset)

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


@functools.lru_cache(maxsize=None)
def device_const(values: tuple, shape: tuple, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """A small constant tensor (spin matrices, gamma5 signs) on ``device``,
    copied there once and reused: a host-to-device copy on every call
    would make the host wait for the card's queue each time."""
    return torch.tensor(values, dtype=dtype).reshape(shape).to(device)


_G5_SIGNS = (1.0, 1.0, -1.0, -1.0)


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
    sign = device_const(_G5_SIGNS, (NSPIN, 1), psi.device, psi.dtype)
    return psi * sign


def dslash_dagger(u: torch.Tensor, psi: torch.Tensor, mass,
                  r: float = 1.0) -> torch.Tensor:
    """D^dag psi = gamma5 D gamma5 psi."""
    return apply_gamma5(dslash(u, apply_gamma5(psi), mass, r=r))


def normal_op(u: torch.Tensor, psi: torch.Tensor, mass,
              r: float = 1.0) -> torch.Tensor:
    """A = D^dag D, Hermitian positive definite: the CGNR operator."""
    return dslash_dagger(u, dslash(u, psi, mass, r=r), mass, r=r)


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
# Packed layout (real arithmetic, the kernels' wire format)
# ---------------------------------------------------------------------------

def _split_packed_spinor(p: torch.Tensor):
    """(T,Z,Y,24,X) -> re, im each (T,Z,Y,4,3,X)."""
    t, z, y, s, x = p.shape
    q = p.reshape(t, z, y, NSPIN, NCOL, 2, x)
    return q[..., 0, :], q[..., 1, :]


def _merge_packed_spinor(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_split_packed_spinor`."""
    t, z, y, s, c, x = re.shape
    return torch.stack([re, im], dim=5).reshape(t, z, y, s * c * 2, x)


def _split_packed_gauge(up: torch.Tensor):
    """(4,T,Z,Y,18,X) -> re, im each (4,T,Z,Y,3,3,X)."""
    d, t, z, y, g, x = up.shape
    q = up.reshape(d, t, z, y, NCOL, NCOL, 2, x)
    return q[..., 0, :], q[..., 1, :]


# spinor re/im arrays are (T,Z,Y,spin,color,X) and per-mu gauge ones
# (T,Z,Y,row,col,X): the axis each direction rolls along
_ROLL_AXIS = {0: 0, 1: 1, 2: 2, 3: 5}


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Narrow storage, f32 sums; f64 stays f64."""
    return (torch.float32 if dtype in (torch.bfloat16, torch.float16,
                                       torch.float32) else dtype)


def _link_times(ur, ui, pr, pi, dag: bool):
    """(U or U^dag) psi over colour, complex numbers as (re, im) pairs:
    links (T,Z,Y,3,3,X), spinors (T,Z,Y,4,3,X)."""
    sub = "tzybax,tzysbx->tzysax" if dag else "tzyabx,tzysbx->tzysax"

    def e(a, b):
        return torch.einsum(sub, a, b)

    if dag:
        return e(ur, pr) + e(ui, pi), e(ur, pi) - e(ui, pr)
    return e(ur, pr) - e(ui, pi), e(ur, pi) + e(ui, pr)


def _spin_times(mat: np.ndarray, hr, hi):
    """A constant complex 4x4 on the spin axis (3) of (re, im) pairs."""
    mr, mi = (device_const(tuple(part(mat).ravel().tolist()), mat.shape,
                           hr.device, hr.dtype) for part in (np.real, np.imag))

    def e(m, h):
        return torch.einsum("sp,tzypcx->tzyscx", m, h)

    return e(mr, hr) - e(mi, hi), e(mr, hi) + e(mi, hr)


def hop_term_packed(u_mu: torch.Tensor, psi_nbr: torch.Tensor, mu: int,
                    forward: bool, r: float = 1.0, *,
                    hop_dtype=None) -> torch.Tensor:
    """One hop's contribution ``-1/2 (r -+ gamma_mu) U psi`` on pre-aligned
    packed fields (no shifts here: the caller aligns the neighbours).

    ``u_mu`` (T,Z,Y,18,X) is U_mu at the output site (forward hop) or at
    the neighbour site (backward hop, daggered here); ``psi_nbr``
    (T,Z,Y,24,X) is psi at the neighbour site.  Sums in f32 for narrow
    storage, or in ``hop_dtype`` when given; the result has ``psi_nbr``'s
    dtype.
    """
    acc = _acc_dtype(psi_nbr.dtype) if hop_dtype is None else hop_dtype
    pm, pp = _projectors(r)
    t, z, y, s, x = psi_nbr.shape
    q = psi_nbr.reshape(t, z, y, NSPIN, NCOL, 2, x).to(acc)
    g = u_mu.reshape(t, z, y, NCOL, NCOL, 2, x).to(acc)
    hr, hi = _link_times(g[..., 0, :], g[..., 1, :], q[..., 0, :],
                         q[..., 1, :], dag=not forward)
    outr, outi = _spin_times(pm[mu] if forward else pp[mu], hr, hi)
    out = torch.stack([outr, outi], dim=5).reshape(t, z, y, s, x)
    return (-0.5 * out).to(psi_nbr.dtype)


def dslash_packed(up: torch.Tensor, pp: torch.Tensor, mass,
                  r: float = 1.0, *, hop_dtype=None) -> torch.Tensor:
    """The Dirac-Wilson operator on the packed real layout.

    ``up`` (4,T,Z,Y,18,X), ``pp`` (T,Z,Y,24,X); returns packed D psi with
    ``pp``'s shape and dtype.  The mass term and the eight hop terms are
    summed in f32 (f64 for f64 fields) whatever the storage dtype.

    ``hop_dtype`` is the dtype each of the eight hop terms (colour
    product and spin projection) is evaluated in before it is rounded to
    the accumulation dtype and summed into the result.  It defaults to
    float64 for float32 fields: one rounding a hop term, which matches
    the rounding error of the JAX package's XLA-compiled operator (a
    pipelined CG's count on the 4^4 fixture depends on it).  The bf16
    plain versions pass float32.
    """
    acc = _acc_dtype(pp.dtype)
    if hop_dtype is None:
        hop_dtype = torch.float64 if pp.dtype == torch.float32 else acc
    pm, pp_c = _projectors(r)
    pr, pi = (a.to(hop_dtype) for a in _split_packed_spinor(pp))
    ur, ui = (a.to(hop_dtype) for a in _split_packed_gauge(up))
    m = mass + 4.0 * r
    outr, outi = m * pr.to(acc), m * pi.to(acc)
    for mu in range(NDIRS):
        ax = _ROLL_AXIS[mu]
        hr, hi = _link_times(ur[mu], ui[mu], torch.roll(pr, -1, ax),
                             torch.roll(pi, -1, ax), dag=False)
        hr, hi = _spin_times(pm[mu], hr, hi)
        outr, outi = outr - 0.5 * hr.to(acc), outi - 0.5 * hi.to(acc)
        hr, hi = _link_times(torch.roll(ur[mu], 1, ax),
                             torch.roll(ui[mu], 1, ax),
                             torch.roll(pr, 1, ax), torch.roll(pi, 1, ax),
                             dag=True)
        hr, hi = _spin_times(pp_c[mu], hr, hi)
        outr, outi = outr - 0.5 * hr.to(acc), outi - 0.5 * hi.to(acc)
    return _merge_packed_spinor(outr.to(pp.dtype), outi.to(pp.dtype))


def apply_gamma5_packed(p: torch.Tensor) -> torch.Tensor:
    """gamma5 on a packed field's S axis (-2); leading axes pass through."""
    if p.shape[-2] != SPINOR_S:
        raise ValueError(f"packed spinor needs S={SPINOR_S}, got "
                         f"{p.shape[-2]}")
    sign = device_const(tuple(np.repeat(_G5_SIGNS, NCOL * 2).tolist()),
                        (SPINOR_S, 1), p.device, p.dtype)
    return p * sign


def dslash_dagger_packed(up: torch.Tensor, pp: torch.Tensor, mass,
                         r: float = 1.0) -> torch.Tensor:
    """D^dag = gamma5 D gamma5 on the packed layout."""
    return apply_gamma5_packed(
        dslash_packed(up, apply_gamma5_packed(pp), mass, r=r))


def normal_op_packed(up: torch.Tensor, pp: torch.Tensor, mass,
                     r: float = 1.0) -> torch.Tensor:
    """A = D^dag D on the packed layout."""
    return dslash_dagger_packed(up, dslash_packed(up, pp, mass, r=r), mass,
                                r=r)


# Flops per lattice site of one dslash: the standard count for the r = 1
# Wilson dslash with spin projection (the paper's GFLOP/s convention).
DSLASH_FLOPS_PER_SITE = 1320


def dslash_flops(volume: int) -> int:
    return DSLASH_FLOPS_PER_SITE * volume
