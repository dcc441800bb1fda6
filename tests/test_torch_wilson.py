"""Port vs JAX: the natural-layout Wilson operator, its even-odd blocks, the
Schur complement and the operator registry, on fields the JAX package
generated (4^4 and 4x4x4x8).

Tolerance: the two packages contract in different orders in f32, so
entries agree to rounding: max-abs error <= 1e-5 relative to the field's
largest entry (values reach ~70 for the Schur normal operator, where one
f32 ulp is ~8e-6).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import lattice as jl
from repro.core import operators as jo
from repro.core import wilson as jw
from repro_torch.core import lattice as tl
from repro_torch.core import operators as to
from repro_torch.core import wilson as tw

import torch_one_thread  # noqa: F401  (one intra-op thread)

SHAPES = [jl.LatticeShape(4, 4, 4, 4), jl.LatticeShape(4, 4, 4, 8)]
MASS = 0.1


def close(ours, ref, tol=1e-5):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    err = np.max(np.abs(ours - ref))
    assert err <= tol * max(1.0, np.max(np.abs(ref))), err


@pytest.fixture(scope="module", params=SHAPES, ids=str)
def fields(request):
    lat = request.param
    ku, kb = jax.random.split(jax.random.PRNGKey(21))
    u = np.asarray(jl.random_gauge(ku, lat))
    b = np.asarray(jl.random_spinor(kb, lat))
    ue, uo = (np.asarray(a) for a in jl.split_eo_gauge(u))
    be, bo = (np.asarray(a) for a in jl.split_eo(b))
    return dict(u=u, b=b, ue=ue, uo=uo, be=be, bo=bo)


def T(a):
    return torch.from_numpy(np.array(a))


def test_gamma_tables_equal():
    np.testing.assert_array_equal(tw.GAMMAS, jw.GAMMAS)
    for a, b in zip(tw._projectors(1.0), jw._projectors(1.0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("twist", [0.0, 0.25])
def test_dslash_g(fields, twist):
    close(to.dslash_g(T(fields["u"]), T(fields["b"]), MASS, twist=twist),
          jo.dslash_g(fields["u"], fields["b"], MASS, twist=twist))


def test_hop_blocks(fields):
    ue, uo = T(fields["ue"]), T(fields["uo"])
    close(tw.dslash_eo(ue, uo, T(fields["bo"])),
          jw.dslash_eo(fields["ue"], fields["uo"], fields["bo"]))
    close(tw.dslash_oe(ue, uo, T(fields["be"])),
          jw.dslash_oe(fields["ue"], fields["uo"], fields["be"]))


@pytest.mark.parametrize("twist", [0.0, 0.25])
@pytest.mark.parametrize("name", ["schur_op_g", "schur_dagger_g",
                                  "schur_normal_op_g"])
def test_schur_blocks(fields, name, twist):
    ours = getattr(to, name)(T(fields["ue"]), T(fields["uo"]),
                             T(fields["be"]), MASS, twist=twist)
    ref = getattr(jo, name)(fields["ue"], fields["uo"], fields["be"], MASS,
                            twist=twist)
    close(ours, ref)


def test_natural_schur_matches_wilson_module(fields):
    ue, uo, be = T(fields["ue"]), T(fields["uo"]), T(fields["be"])
    close(tw.schur_normal_op(ue, uo, be, MASS),
          jw.schur_normal_op(fields["ue"], fields["uo"], fields["be"], MASS))


def test_gamma5_maps(fields):
    pb = np.asarray(jl.pack_spinor(fields["b"]))
    np.testing.assert_array_equal(tw.apply_gamma5_packed(T(pb)).numpy(),
                                  np.asarray(jw.apply_gamma5_packed(pb)))
    np.testing.assert_array_equal(to.apply_igamma5_packed(T(pb)).numpy(),
                                  np.asarray(jo.apply_igamma5_packed(pb)))
    np.testing.assert_array_equal(tw.apply_gamma5(T(fields["b"])).numpy(),
                                  np.asarray(jw.apply_gamma5(fields["b"])))


@pytest.mark.parametrize("twist", [0.0, 0.3])
def test_site_term_apply_solve(fields, twist):
    pb = np.asarray(jl.pack_spinor(fields["b"]))
    ours, ref = to.SiteTerm(4.1, twist), jo.SiteTerm(4.1, twist)
    for v, tv in ((pb, T(pb)), (fields["b"], T(fields["b"]))):
        close(ours.apply(tv), ref.apply(v))
        close(ours.solve(tv), ref.solve(v))


def test_zero_twist_is_wilson_bitwise(fields):
    """A twisted-mass family at mu = 0 runs the Wilson expressions."""
    ue, uo, be = T(fields["ue"]), T(fields["uo"]), T(fields["be"])
    wil = to.get_operator("wilson").site_term(MASS)
    tm0 = to.get_operator("twisted-mass").site_term(MASS, mu=0.0)
    assert wil == tm0
    assert torch.equal(to.schur_normal_op_g(ue, uo, be, MASS, twist=0.0),
                       tw.schur_normal_op(ue, uo, be, MASS))


def test_registry():
    assert to.operator_names() == jo.operator_names()
    for dagger in (False, True):
        assert to.schur_launch_coeffs(4.1, 0.25, dagger) == \
            jo.schur_launch_coeffs(4.1, 0.25, dagger)
    with pytest.raises(ValueError, match="did you mean"):
        to.get_operator("twisted_mass")
    with pytest.raises(ValueError, match="already registered"):
        to.register_operator(to.WILSON)
