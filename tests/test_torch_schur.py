"""Port vs JAX: the Schur operators over the parity hop kernel.

``schur_normal_op`` (four hop launches) against the JAX package's four
Pallas launches in interpret mode, and ``schur_op``/``schur_dagger``/
``schur_normal_op`` for both operator families against its jnp
reference, batched and unbatched.  Tolerance: max-abs error <= 1e-5 times
the largest entry of the result — the Schur normal operator reaches ~70
here, where an f32 ulp is ~8e-6, and both packages sum in f32 in
different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as jl
from repro.kernels.wilson_dslash import ops as jops
from repro_torch.kernels.wilson_dslash import ops as tops

import torch_one_thread  # noqa: F401  (one intra-op thread)

MASS = 0.1


def close(ours, ref, tol=1e-5):
    ref = np.asarray(ref)
    err = np.max(np.abs(ours.numpy() - ref))
    assert err <= tol * max(1.0, np.max(np.abs(ref))), err


def _packed(lat, n):
    ku, kb = jax.random.split(jax.random.PRNGKey(41))
    ue, uo = jl.split_eo_gauge(jl.random_gauge(ku, lat))
    be = jnp.stack([jl.split_eo(jl.random_spinor(jax.random.fold_in(kb, i),
                                                 lat))[0] for i in range(n)])
    return tuple(np.asarray(a) for a in (jl.pack_gauge(ue),
                                         jl.pack_gauge(uo),
                                         jl.pack_spinor(be)))


def T(a):
    return torch.from_numpy(np.array(a))


def test_schur_normal_op_matches_pallas_interpret():
    upe, upo, pb = _packed(jl.LatticeShape(4, 4, 4, 4), 2)
    ours = tops.schur_normal_op(T(upe), T(upo), T(pb), MASS, twist=0.25)
    ref = jops.schur_normal_op(upe, upo, pb, MASS, twist=0.25,
                               interpret=True, bz=2)
    close(ours, ref)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("twist", [0.0, 0.25])
@pytest.mark.parametrize("name", ["schur_op", "schur_dagger",
                                  "schur_normal_op"])
def test_schur_ops_match_jax_reference(name, twist, batched):
    upe, upo, pb = _packed(jl.LatticeShape(4, 4, 4, 8), 3)
    pb = pb if batched else pb[1]
    ours = getattr(tops, name)(T(upe), T(upo), T(pb), MASS, twist=twist)
    ref = getattr(jops, name)(upe, upo, pb, MASS, twist=twist,
                              use_pallas=False)
    close(ours, ref)
