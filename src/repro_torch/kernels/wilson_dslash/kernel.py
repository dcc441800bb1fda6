"""K1 ``wilson_hop`` and K4 ``wilson_full``: the Wilson kernels' wrappers
and their host tables.

The CUDA sources are ``repro_torch/csrc/wilson_hop.cu`` (K1, the parity
hop) and ``repro_torch/csrc/wilson_full.cu`` (K4, the full-lattice
operator); their header notes say what bounds each kernel and how it is
laid out.  They replace the Pallas kernels ``repro/kernels/wilson_dslash/
kernel.py::_dslash_parity_kernel`` and ``::_dslash_kernel``, and share the
spin-projection tables of :func:`hop_tables`.

Each wrapper runs its plain version (:mod:`..ref`) for tensors on the
CPU, and only then; for CUDA tensors it launches the kernel or raises.
``<wrapper>.launches`` counts kernel launches and ``<wrapper>.plain_calls``
plain-version calls, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.lattice import GAUGE_G, NDIRS, NSPIN, SPINOR_S
from repro_torch.core.wilson import _projectors
from repro_torch.kernels import build
from repro_torch.kernels.wilson_dslash.ref import (wilson_full_ref,
                                                   wilson_hop_ref)


def _halfspinor_tables():
    """Per (mu, sign): the rows 0,1 of the rank-2 projector (1 -+ g_mu) as
    the half-spinor projection, and rows 2,3 as (source row, phase).

    For r = 1 each projector has rank 2: rows 2 and 3 are a phase times
    row 0 or 1, which is what lets a hop multiply only two half spinors
    by its link.
    """
    pm, pp = _projectors(1.0)
    tables = {}
    for mu in range(NDIRS):
        for sign, proj in (("fwd", pm[mu]), ("bwd", pp[mu])):
            recon = []
            for a in (2, 3):
                row = proj[a]
                hit = None
                for src in range(2):
                    ref = proj[src]
                    nz = np.nonzero(np.abs(ref) > 1e-12)[0]
                    if np.all((np.abs(row) > 1e-12) == (np.abs(ref) > 1e-12)):
                        phase = row[nz[0]] / ref[nz[0]]
                        if np.allclose(row, phase * ref, atol=1e-12):
                            hit = (src, complex(phase))
                            break
                if hit is None:
                    raise ValueError("projector is not rank-2; need r=1")
                recon.append(hit)
            tables[(mu, sign)] = (proj[:2], recon)
    return tables


@functools.lru_cache(maxsize=4)
def hop_tables(gamma5_in: bool, gamma5_out: bool) -> np.ndarray:
    """The kernel's 192-float table: ``proj[8][2][4][re,im]`` then
    ``recon[8][2][2][re,im]``, hop h = 2*mu + (0 fwd, 1 bwd).

    gamma5 = diag(+,+,-,-) folds in as signs: ``gamma5_in`` negates the
    projection coefficients of source spins 2,3 (P -> P g5),
    ``gamma5_out`` the reconstruction phases of output spins 2,3
    (P -> g5 P).
    """
    proj = np.zeros((8, 2, NSPIN, 2), np.float32)
    recon = np.zeros((8, 2, 2, 2), np.float32)
    for (mu, sign), (rows, rec) in _halfspinor_tables().items():
        h = 2 * mu + (sign == "bwd")
        for a in range(2):
            for b in range(NSPIN):
                c = complex(rows[a, b]) * (-1 if gamma5_in and b >= 2 else 1)
                proj[h, a, b] = (c.real, c.imag)
        for i, (src, phase) in enumerate(rec):
            phase = -phase if gamma5_out else phase
            recon[h, i, src] = (phase.real, phase.imag)
    out = np.concatenate([proj.ravel(), recon.ravel()])
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("wilson_hop")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wilson_hop.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p,
                               f, f, f, f, p]
    lib.wilson_hop.restype = ctypes.c_int
    return lib


def _check_operands(u_out, u_nbr, psi, psi_acc):
    if psi.dim() not in (5, 6):
        raise ValueError(f"spinor rank must be 5 or 6, got {psi.dim()}")
    nd, t, z, y, g, xh = u_out.shape
    if nd != NDIRS or g != GAUGE_G or u_nbr.shape != u_out.shape:
        raise ValueError(f"gauge halves must be (4,T,Z,Y,18,Xh), got "
                         f"{tuple(u_out.shape)} and {tuple(u_nbr.shape)}")
    if tuple(psi.shape[-5:]) != (t, z, y, SPINOR_S, xh):
        raise ValueError(f"spinor {tuple(psi.shape)} does not match gauge "
                         f"{tuple(u_out.shape)}")
    if t % 2 or z % 2 or y % 2:
        raise ValueError("even-odd kernels need even T/Z/Y extents: an odd "
                         f"periodic extent breaks bipartiteness, got "
                         f"{(t, z, y)}")
    if psi_acc is not None and psi_acc.shape != psi.shape:
        raise ValueError(f"psi_acc {tuple(psi_acc.shape)} must match psi "
                         f"{tuple(psi.shape)}")


def wilson_hop(u_out: torch.Tensor, u_nbr: torch.Tensor, psi: torch.Tensor,
               *, parity: int, gamma5_in: bool = False,
               gamma5_out: bool = False, psi_acc: torch.Tensor | None = None,
               acc_coeff: float = 0.0, hop_coeff: float = 1.0,
               acc_twist: float = 0.0,
               hop_twist: float = 0.0) -> torch.Tensor:
    """One parity hop block with the fused epilogue (see
    :func:`..ref.wilson_hop_ref` for the function).  ``psi`` is a packed
    half field (T,Z,Y,24,Xh) or an (N,T,Z,Y,24,Xh) batch."""
    _check_operands(u_out, u_nbr, psi, psi_acc)
    kw = dict(parity=parity, gamma5_in=gamma5_in, gamma5_out=gamma5_out,
              psi_acc=psi_acc, acc_coeff=acc_coeff, hop_coeff=hop_coeff,
              acc_twist=acc_twist, hop_twist=hop_twist)
    if psi.device.type == "cpu":
        wilson_hop.plain_calls += 1
        return wilson_hop_ref(u_out, u_nbr, psi, **kw)
    operands = [u_out, u_nbr, psi] + ([psi_acc] if psi_acc is not None
                                      else [])
    for name, v in zip(("u_out", "u_nbr", "psi", "psi_acc"), operands):
        if (v.device != psi.device or v.dtype != torch.float32
                or not v.is_contiguous()):
            raise ValueError(f"wilson_hop: {name} must be a contiguous "
                             f"float32 tensor on {psi.device}, got "
                             f"{v.dtype} on {v.device}")
    _, t, z, y, _, xh = u_out.shape
    n = psi.shape[0] if psi.dim() == 6 else 1
    out = torch.empty_like(psi)
    tables = hop_tables(bool(gamma5_in), bool(gamma5_out))
    lib = _lib()
    rc = lib.wilson_hop(
        u_out.data_ptr(), u_nbr.data_ptr(), psi.data_ptr(),
        psi_acc.data_ptr() if psi_acc is not None else None,
        out.data_ptr(), t, z, y, xh, n, int(parity) & 1,
        tables.ctypes.data, float(hop_coeff), float(hop_twist),
        float(acc_coeff), float(acc_twist),
        torch.cuda.current_stream(psi.device).cuda_stream)
    build.check(lib, rc, "wilson_hop")
    wilson_hop.launches += 1
    return out


wilson_hop.launches = 0
wilson_hop.plain_calls = 0


# ---------------------------------------------------------------------------
# K4: the full-lattice operator
# ---------------------------------------------------------------------------


def site_coeffs(mass, twist: float, gamma5_in: bool,
                gamma5_out: bool) -> tuple[float, float, float, float]:
    """K4's site term ``g5out ((m+4) + i twist g5) g5in`` as per-spin-block
    coefficients ``(m_hi, m_lo, tw_hi, tw_lo)``: spins 0,1 take
    ``(m+4, twist)``; spins 2,3 take ``-(m+4)`` when exactly one flag is
    set (g5 once) and ``-twist`` when the flags agree (g5 once or three
    times).  The kernel adds ``m psi + tw (i psi)``.
    """
    m4 = float(mass) + 4.0
    one = bool(gamma5_in) != bool(gamma5_out)
    tw = float(twist)
    return m4, -m4 if one else m4, tw, tw if one else -tw


@functools.lru_cache(maxsize=None)
def _full_lib() -> ctypes.CDLL:
    lib = build.library("wilson_full")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wilson_full.argtypes = [p, p, p, i, i, i, i, i, p, f, f, f, f, p]
    lib.wilson_full.restype = ctypes.c_int
    return lib


def _check_full_operands(up, pp):
    if pp.dim() not in (5, 6):
        raise ValueError(f"spinor rank must be 5 or 6, got {pp.dim()}")
    nd, t, z, y, g, x = up.shape
    if nd != NDIRS or g != GAUGE_G:
        raise ValueError(f"gauge must be (4,T,Z,Y,18,X), got "
                         f"{tuple(up.shape)}")
    if tuple(pp.shape[-5:]) != (t, z, y, SPINOR_S, x):
        raise ValueError(f"spinor {tuple(pp.shape)} does not match gauge "
                         f"{tuple(up.shape)}")
    for name, v in (("up", up), ("pp", pp)):
        if v.dtype != torch.float32:
            raise NotImplementedError(
                f"wilson_full takes float32 fields, got {name} {v.dtype}; "
                "narrow (bf16) storage comes with mixed precision, ROADMAP "
                "Queue A item 8")


def wilson_full(up: torch.Tensor, pp: torch.Tensor, mass, *,
                twist: float = 0.0, gamma5_in: bool = False,
                gamma5_out: bool = False) -> torch.Tensor:
    """``g5out (D + i twist g5) (g5in psi)`` on the full lattice (see
    :func:`..ref.wilson_full_ref`).  ``pp`` is a packed field
    (T,Z,Y,24,X) or an (N,T,Z,Y,24,X) batch, ``up`` the packed gauge
    field (4,T,Z,Y,18,X), both float32."""
    _check_full_operands(up, pp)
    kw = dict(twist=twist, gamma5_in=gamma5_in, gamma5_out=gamma5_out)
    if pp.device.type == "cpu":
        wilson_full.plain_calls += 1
        return wilson_full_ref(up, pp, mass, **kw)
    for name, v in (("up", up), ("pp", pp)):
        if v.device != pp.device or not v.is_contiguous():
            raise ValueError(f"wilson_full: {name} must be a contiguous "
                             f"tensor on {pp.device}")
    _, t, z, y, _, x = up.shape
    n = pp.shape[0] if pp.dim() == 6 else 1
    out = torch.empty_like(pp)
    tables = hop_tables(bool(gamma5_in), bool(gamma5_out))
    lib = _full_lib()
    rc = lib.wilson_full(
        up.data_ptr(), pp.data_ptr(), out.data_ptr(), t, z, y, x, n,
        tables.ctypes.data, *site_coeffs(mass, twist, gamma5_in, gamma5_out),
        torch.cuda.current_stream(pp.device).cuda_stream)
    build.check(lib, rc, "wilson_full")
    wilson_full.launches += 1
    return out


wilson_full.launches = 0
wilson_full.plain_calls = 0
