"""The operator registry: site-local physics decoupled from hop transport.

An operator contributes only its site-local diagonal block,

    S = scale * 1 + twist * (i gamma5),

with the analytic inverse ``S^-1 = (scale - i twist gamma5) / (scale^2 +
twist^2)`` and adjoint ``S^dag = S(-twist)``.  The hop transport (the
parity hop kernel and its plain versions) is shared by every family; the
site term is folded into the kernel epilogues, so the Schur normal
operator stays four hop launches for every registered operator.

Registered operators: ``wilson`` (S = m + 4r) and ``twisted-mass``
(S = m + 4r + i mu gamma5).  Every twist gate compares against 0.0, so a
Wilson solve runs exactly the Wilson expressions.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Callable

import torch

from repro_torch.core.lattice import NCOL, NSPIN
from repro_torch.core.wilson import (apply_gamma5, device_const, dslash,
                                     dslash_eo, dslash_oe, schur_dagger,
                                     schur_op)

Tensor = torch.Tensor


def unknown_name(kind: str, value, allowed) -> str:
    """Error text for an unknown registry/enum name, with a did-you-mean."""
    allowed = tuple(allowed)
    msg = (f"unknown {kind} {value!r}; registered names: "
           f"{', '.join(repr(a) for a in allowed)}")
    hits = difflib.get_close_matches(str(value), [str(a) for a in allowed],
                                     n=1, cutoff=0.4)
    if hits:
        msg += f" — did you mean {hits[0]!r}?"
    return msg


# ---------------------------------------------------------------------------
# The site-local term
# ---------------------------------------------------------------------------


def apply_igamma5_packed(p: Tensor) -> Tensor:
    """(i gamma5) on a packed field's S axis (-2); leading axes pass through.

    The S axis interleaves (spin, color, re/im): multiplying by i swaps
    the re/im planes (re' = -im, im' = re) and gamma5 signs spin blocks.
    """
    s, x = p.shape[-2:]
    if s != NSPIN * NCOL * 2:
        raise ValueError(f"packed spinor needs S={NSPIN * NCOL * 2}, got {s}")
    q = p.reshape(p.shape[:-2] + (NSPIN, NCOL, 2, x))
    re, im = q[..., 0, :], q[..., 1, :]
    sign = device_const((1.0, 1.0, -1.0, -1.0), (NSPIN, 1, 1), p.device,
                        p.dtype)
    return torch.stack([-sign * im, sign * re], dim=-2).reshape(p.shape)


@dataclasses.dataclass(frozen=True)
class SiteTerm:
    """The site-local diagonal block ``S = scale*1 + twist*(i gamma5)``.

    ``apply``/``solve`` dispatch on the layout: complex tensors are the
    natural layout (gamma5 on spin axis -2), real ones the packed
    (..., 24, X) layout.
    """

    scale: float
    twist: float = 0.0

    def apply(self, v: Tensor) -> Tensor:
        """S v on a natural (complex) or packed (real) field."""
        if self.twist == 0.0:
            return self.scale * v
        if v.is_complex():
            return self.scale * v + (1j * self.twist) * apply_gamma5(v)
        return self.scale * v + self.twist * apply_igamma5_packed(v)

    def solve(self, v: Tensor) -> Tensor:
        """S^-1 v (``v / scale`` when twist == 0)."""
        if self.twist == 0.0:
            return v / self.scale
        den = self.scale * self.scale + self.twist * self.twist
        if v.is_complex():
            return (self.scale * v
                    - (1j * self.twist) * apply_gamma5(v)) / den
        return (self.scale * v - self.twist * apply_igamma5_packed(v)) / den


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LatticeOperator:
    """What a lattice operator declares to ride the transport stack:
    its name, one line of description, the names of its extra site
    parameters (fields of ``SolverPlan``) and ``make_site_term(mass, r,
    **params) -> SiteTerm``."""

    name: str
    description: str
    params: tuple[str, ...]
    make_site_term: Callable[..., SiteTerm]

    def site_term(self, mass, r: float = 1.0, **params) -> SiteTerm:
        return self.make_site_term(mass, r, **params)


_REGISTRY: dict[str, LatticeOperator] = {}


def register_operator(spec: LatticeOperator) -> LatticeOperator:
    """Add ``spec`` to the registry (name collisions are an error)."""
    if spec.name in _REGISTRY:
        raise ValueError(f"operator family {spec.name!r} is already "
                         "registered")
    _REGISTRY[spec.name] = spec
    return spec


def operator_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_operator(name: str) -> LatticeOperator:
    """Look up a registered operator; unknown names get a did-you-mean."""
    spec = _REGISTRY.get(name)
    if spec is None:
        raise ValueError(unknown_name("operator family", name,
                                      operator_names()))
    return spec


WILSON = register_operator(LatticeOperator(
    name="wilson",
    description="Dirac-Wilson: site term (m + 4r)*1",
    params=(),
    make_site_term=lambda mass, r: SiteTerm(mass + 4.0 * r, 0.0)))

TWISTED_MASS = register_operator(LatticeOperator(
    name="twisted-mass",
    description="twisted-mass Wilson: site term (m + 4r) + i*mu*gamma5",
    params=("mu",),
    make_site_term=lambda mass, r, mu: SiteTerm(mass + 4.0 * r, float(mu))))


# ---------------------------------------------------------------------------
# Generic natural-layout operators (reference backend, verification)
# ---------------------------------------------------------------------------


def dslash_g(u: Tensor, psi: Tensor, mass, r: float = 1.0,
             twist: float = 0.0) -> Tensor:
    """D psi for the (mass, r, twist) operator family, natural layout."""
    out = dslash(u, psi, mass, r=r)
    if twist != 0.0:
        out = out + (1j * twist) * apply_gamma5(psi)
    return out


def dslash_dagger_g(u: Tensor, psi: Tensor, mass, r: float = 1.0,
                    twist: float = 0.0) -> Tensor:
    """D^dag = gamma5 D(-twist) gamma5 (for twist = 0: plain gamma5 D
    gamma5, the Wilson dagger)."""
    return apply_gamma5(dslash_g(u, apply_gamma5(psi), mass, r=r,
                                 twist=-twist))


def normal_op_g(u: Tensor, psi: Tensor, mass, r: float = 1.0,
                twist: float = 0.0) -> Tensor:
    """A = D^dag D, Hermitian positive definite for every family: the
    CGNR operator."""
    return dslash_dagger_g(u, dslash_g(u, psi, mass, r=r, twist=twist),
                           mass, r=r, twist=twist)


def schur_launch_coeffs(scale: float, twist: float, dagger: bool
                        ) -> tuple[float, float, float, float]:
    """Epilogue coefficients of the TWO-launch twisted Schur split.

    D_hat(tw) = S(tw) - D_eo S(tw)^-1 D_oe and D_hat(tw)^dag =
    gamma5 D_hat(-tw) gamma5, so with tw = -twist if dagger else twist and
    den = scale^2 + tw^2:

      launch 1 (D_oe, gamma5_in=dagger) folds S(tw)^-1 into its hop
        epilogue: (hop1_coeff, hop1_twist) = (scale, -tw) / den;
      launch 2 (D_eo, gamma5_out=dagger) accumulates S(tw) psi with
        hop_coeff = -1: (acc_coeff, acc_twist) = (scale, tw).

    Returns (hop1_coeff, hop1_twist, acc_coeff, acc_twist).
    """
    tw = -twist if dagger else twist
    den = scale * scale + tw * tw
    return scale / den, -tw / den, scale, tw


def schur_op_g(u_e: Tensor, u_o: Tensor, psi_e: Tensor, mass,
               r: float = 1.0, twist: float = 0.0) -> Tensor:
    """Schur complement D_hat = S - D_eo S^-1 D_oe on even half fields."""
    if twist == 0.0:
        return schur_op(u_e, u_o, psi_e, mass, r=r)
    site = SiteTerm(mass + 4.0 * r, twist)
    tmp_o = site.solve(dslash_oe(u_e, u_o, psi_e, r=r))
    return site.apply(psi_e) - dslash_eo(u_e, u_o, tmp_o, r=r)


def schur_dagger_g(u_e: Tensor, u_o: Tensor, psi_e: Tensor, mass,
                   r: float = 1.0, twist: float = 0.0) -> Tensor:
    """D_hat(twist)^dag = gamma5 D_hat(-twist) gamma5."""
    if twist == 0.0:
        return schur_dagger(u_e, u_o, psi_e, mass, r=r)
    return apply_gamma5(schur_op_g(u_e, u_o, apply_gamma5(psi_e), mass,
                                   r=r, twist=-twist))


def schur_normal_op_g(u_e: Tensor, u_o: Tensor, psi_e: Tensor, mass,
                      r: float = 1.0, twist: float = 0.0) -> Tensor:
    """A_hat = D_hat^dag D_hat — HPD on the even sublattice."""
    return schur_dagger_g(u_e, u_o,
                          schur_op_g(u_e, u_o, psi_e, mass, r=r,
                                     twist=twist),
                          mass, r=r, twist=twist)
