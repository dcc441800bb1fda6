"""4D lattice geometry, SU(3) gauge fields and layout packing (PyTorch).

The two layouts are those of the JAX package, byte for byte:

* **natural** — complex tensors in the index order physicists write:
  ``psi[T, Z, Y, X, spin(4), color(3)]`` and
  ``U[mu(4), T, Z, Y, X, color(3), color(3)]``.  The layout of the
  reference operators and of every correctness oracle.

* **packed** — real tensors with X innermost:
  ``psi[..., T, Z, Y, S=24, X]`` with ``S = (spin*3 + color)*2 + reim`` and
  ``U[mu(4), T, Z, Y, G=18, X]`` with ``G = (row*3 + col)*2 + reim``.
  Each of the 24 (18) component planes is contiguous along X, so
  neighbouring GPU threads (neighbouring X sites) load neighbouring
  addresses.

Packing is an exact bijection; tests round-trip it against the JAX
package.  Random fields draw from an explicit ``torch.Generator``, so the
numbers differ from ``jax.random``'s: fields shared with the JAX package
cross over through numpy (:func:`fields_from_numpy`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

NDIRS = 4  # t, z, y, x
NSPIN = 4
NCOL = 3
SPINOR_S = NSPIN * NCOL * 2  # 24 packed real components per site
GAUGE_G = NCOL * NCOL * 2    # 18 packed real components per link


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there.

    Entry points default to ``"cuda"``; on a machine without a card they
    raise here instead of carrying on quietly on the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    return dev


@dataclasses.dataclass(frozen=True)
class LatticeShape:
    """Geometry of the 4D lattice. Axis order is (T, Z, Y, X)."""

    t: int
    z: int
    y: int
    x: int

    @property
    def dims(self) -> tuple[int, int, int, int]:
        return (self.t, self.z, self.y, self.x)

    @property
    def volume(self) -> int:
        return self.t * self.z * self.y * self.x

    def __str__(self) -> str:  # e.g. 8x8x8x16
        return f"{self.t}x{self.z}x{self.y}x{self.x}"


# ---------------------------------------------------------------------------
# Random fields
# ---------------------------------------------------------------------------

def random_spinor(gen: torch.Generator, lat: LatticeShape,
                  dtype=torch.complex64) -> torch.Tensor:
    """Gaussian random spinor field, natural layout (T,Z,Y,X,4,3), on the
    generator's device."""
    shape = lat.dims + (NSPIN, NCOL)
    re = torch.randn(shape, generator=gen, device=gen.device)
    im = torch.randn(shape, generator=gen, device=gen.device)
    return torch.complex(re, im).to(dtype)


def _det3(q: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices by cofactor expansion."""
    a, b, c = q[..., 0, 0], q[..., 0, 1], q[..., 0, 2]
    d, e, f = q[..., 1, 0], q[..., 1, 1], q[..., 1, 2]
    g, h, i = q[..., 2, 0], q[..., 2, 1], q[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _project_su3(m: torch.Tensor) -> torch.Tensor:
    """Project complex 3x3 matrices onto SU(3): unitary Q of the QR with a
    positive real diagonal of R, then divide by det(Q)^(1/3) (principal
    branch).

    The JAX package takes a LAPACK QR and fixes the phases of R's
    diagonal; the Q of a QR whose R has a positive diagonal is unique, and
    it is what modified Gram-Schmidt on the columns computes.  Batched
    elementwise work, so it runs at full width on a card where a batched
    ``torch.linalg.qr`` over millions of 3x3 matrices would not.
    """
    cols: list[torch.Tensor] = []
    for k in range(NCOL):
        v = m[..., :, k]
        for q in cols:
            v = v - (q.conj() * v).sum(-1, keepdim=True) * q
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        cols.append(v)
    q = torch.stack(cols, dim=-1)
    return q / (_det3(q) ** (1.0 / 3.0))[..., None, None]


def random_gauge(gen: torch.Generator, lat: LatticeShape,
                 dtype=torch.complex64) -> torch.Tensor:
    """Random SU(3) gauge field, natural layout (4,T,Z,Y,X,3,3)."""
    shape = (NDIRS,) + lat.dims + (NCOL, NCOL)
    re = torch.randn(shape, generator=gen, device=gen.device)
    im = torch.randn(shape, generator=gen, device=gen.device)
    return _project_su3(torch.complex(re, im).to(dtype))


def unit_gauge(lat: LatticeShape, dtype=torch.complex64,
               device=None) -> torch.Tensor:
    """Free-field (identity links) gauge configuration, natural layout
    (4,T,Z,Y,X,3,3)."""
    eye = torch.eye(NCOL, dtype=dtype, device=device)
    return eye.expand((NDIRS,) + lat.dims + (NCOL, NCOL)).contiguous()


# ---------------------------------------------------------------------------
# Layout packing (natural complex <-> packed real)
# ---------------------------------------------------------------------------

def _re_im(v: torch.Tensor, dtype) -> torch.Tensor:
    """complex (...) -> real (..., 2) in ``dtype``."""
    return torch.stack([v.real, v.imag], dim=-1).to(dtype)


def pack_spinor(psi: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., X, 4, 3) complex -> (..., 24, X) real (leading axes pass)."""
    p = _re_im(psi, dtype).reshape(psi.shape[:-2] + (SPINOR_S,))
    return p.movedim(-2, -1).contiguous()


def unpack_spinor(p: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """(..., 24, X) real -> (..., X, 4, 3) complex (leading axes pass)."""
    s, x = p.shape[-2:]
    if s != SPINOR_S:
        raise ValueError(f"packed spinor needs S={SPINOR_S}, got {s}")
    q = p.movedim(-1, -2).reshape(p.shape[:-2] + (x, NSPIN, NCOL, 2))
    return torch.complex(q[..., 0], q[..., 1]).to(dtype)


def pack_gauge(u: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(4,T,Z,Y,X,3,3) complex -> (4,T,Z,Y,18,X) real."""
    p = _re_im(u, dtype).reshape(u.shape[:5] + (GAUGE_G,))
    return p.movedim(4, 5).contiguous()


def unpack_gauge(p: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """(4,T,Z,Y,18,X) real -> (4,T,Z,Y,X,3,3) complex."""
    d, t, z, y, g, x = p.shape
    if g != GAUGE_G:
        raise ValueError(f"packed gauge needs G={GAUGE_G}, got {g}")
    q = p.movedim(5, 4).reshape(d, t, z, y, x, NCOL, NCOL, 2)
    return torch.complex(q[..., 0], q[..., 1]).to(dtype)


# ---------------------------------------------------------------------------
# Even-odd (red-black) parity geometry
# ---------------------------------------------------------------------------
#
# A site (t, z, y, x) has parity (t + z + y + x) mod 2.  Half-lattice fields
# compress X by 2: within row (t, z, y) the even sites sit at x = 2*j + s
# with s = (t + z + y) mod 2, the odd ones at x = 2*j + (1 - s).  The
# even-odd operators further need even T/Z/Y extents (an odd periodic
# extent breaks bipartiteness).


def eo_row_offset(t: int, z: int, y: int) -> np.ndarray:
    """x-offset of EVEN-parity sites in each (t, z, y) row, shape (T,Z,Y)."""
    tt, zz, yy = np.meshgrid(np.arange(t), np.arange(z), np.arange(y),
                             indexing="ij")
    return ((tt + zz + yy) % 2).astype(np.int32)


def parity_masks(lat: LatticeShape) -> tuple[np.ndarray, np.ndarray]:
    """(even_mask, odd_mask) boolean site masks of shape (T, Z, Y, X), as
    numpy arrays (host constants, as in the JAX package)."""
    tt, zz, yy, xx = np.meshgrid(np.arange(lat.t), np.arange(lat.z),
                                 np.arange(lat.y), np.arange(lat.x),
                                 indexing="ij")
    even = (tt + zz + yy + xx) % 2 == 0
    return even, ~even


def _eo_row_sel(t: int, z: int, y: int, n_rest: int,
                device) -> torch.Tensor:
    """Broadcastable bool: True where the even-site row offset is 0."""
    s = torch.from_numpy(eo_row_offset(t, z, y) == 0).to(device)
    return s.reshape((t, z, y, 1) + (1,) * n_rest)


def split_eo(field: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a natural-layout site field (T, Z, Y, X, *rest) with even X
    into (even, odd) half fields (T, Z, Y, X//2, *rest)."""
    t, z, y, x = field.shape[:4]
    if x % 2:
        raise ValueError(f"even-odd split needs even X extent, got {x}")
    rest = field.shape[4:]
    pair = field.reshape((t, z, y, x // 2, 2) + rest)
    lo, hi = pair[:, :, :, :, 0], pair[:, :, :, :, 1]  # x = 2j and 2j+1
    sel = _eo_row_sel(t, z, y, len(rest), field.device)
    return torch.where(sel, lo, hi), torch.where(sel, hi, lo)


def merge_eo(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_eo`."""
    t, z, y, xh = even.shape[:4]
    rest = even.shape[4:]
    sel = _eo_row_sel(t, z, y, len(rest), even.device)
    lo = torch.where(sel, even, odd)
    hi = torch.where(sel, odd, even)
    return torch.stack([lo, hi], dim=4).reshape((t, z, y, 2 * xh) + rest)


def split_eo_gauge(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(4, T, Z, Y, X, 3, 3) -> per-parity link fields (u_e, u_o), each
    (4, T, Z, Y, X//2, 3, 3): ``u_e[mu]`` holds U_mu(x) at EVEN sites x."""
    halves = [split_eo(u[mu]) for mu in range(u.shape[0])]
    return (torch.stack([h[0] for h in halves]),
            torch.stack([h[1] for h in halves]))


def merge_eo_gauge(u_e: torch.Tensor, u_o: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`split_eo_gauge`."""
    return torch.stack([merge_eo(u_e[mu], u_o[mu])
                        for mu in range(u_e.shape[0])])


# ---------------------------------------------------------------------------
# Complex <-> real-pair views (for low-precision storage of complex fields)
# ---------------------------------------------------------------------------

def complex_to_real_pair(v: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """(...) complex -> (..., 2) real in ``dtype`` (bf16 for narrow
    storage: complex bf16 does not exist)."""
    return _re_im(v, dtype)


def real_pair_to_complex(w: torch.Tensor,
                         dtype=torch.complex64) -> torch.Tensor:
    """Inverse of :func:`complex_to_real_pair`; widens before recombining."""
    wf = w.to(torch.float64 if dtype == torch.complex128 else torch.float32)
    return torch.complex(wf[..., 0], wf[..., 1]).to(dtype)


# ---------------------------------------------------------------------------
# Inner products on fields (any layout)
# ---------------------------------------------------------------------------

def field_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> with complex conjugation if complex; f32/f64 accumulation."""
    if a.is_complex():
        return (a.conj() * b).sum()
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    return (a.to(acc) * b.to(acc)).sum()


def field_norm2(a: torch.Tensor) -> torch.Tensor:
    """||a||^2 as a real scalar."""
    if a.is_complex():
        return (a.real ** 2 + a.imag ** 2).sum()
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    return (a.to(acc) ** 2).sum()


# Batched (multi-RHS) reductions: the leading axis is the RHS batch.  Each
# slice goes through the single-RHS reduction on its own, so a batched
# solve reduces every RHS in exactly the order an independent solve does
# (the batched-equals-single invariant is bitwise).

def field_dot_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-RHS <a_n, b_n>; returns shape (N,)."""
    return torch.stack([field_dot(a[n], b[n]) for n in range(a.shape[0])])


def field_norm2_batched(a: torch.Tensor) -> torch.Tensor:
    """Per-RHS ||a_n||^2; returns shape (N,)."""
    return torch.stack([field_norm2(a[n]) for n in range(a.shape[0])])


# ---------------------------------------------------------------------------
# Fields from the JAX package (or any numpy source)
# ---------------------------------------------------------------------------

def fields_from_numpy(u, b, device="cuda") -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Natural-layout (gauge, RHS) tensors from numpy arrays.

    Takes the JAX package's natural complex arrays
    (``(4,T,Z,Y,X,3,3)`` / ``(..., T,Z,Y,X,4,3)``) or its packed real ones
    (``(4,T,Z,Y,18,X)`` / ``(..., T,Z,Y,24,X)``) and returns complex64
    natural tensors on ``device`` — what :func:`repro_torch.core.plan.solve`
    takes.  The gauge field plays the part weights play in a model.
    """
    dev = resolve_device(device)
    ut = torch.tensor(np.asarray(u), device=dev)
    bt = torch.tensor(np.asarray(b), device=dev)
    if not ut.is_complex():
        ut = unpack_gauge(ut.to(torch.float32))
    if not bt.is_complex():
        bt = unpack_spinor(bt.to(torch.float32))
    return ut.to(torch.complex64), bt.to(torch.complex64)
