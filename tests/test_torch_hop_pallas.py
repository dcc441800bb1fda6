"""Port vs the JAX Pallas parity hop kernel in interpret mode.

The JAX kernel (``_dslash_parity_kernel``) runs interpreted on the CPU,
as the JAX package's own kernel tests run it, on four launches in which
every flag (parity, gamma5_in, gamma5_out, accumulator, twist), both
lattices and N in {1, 3} each appear on and off; the port's hop_block
(its plain version, on CPU tensors) must agree to <= 1e-5 max-abs, the
slack of f32 sums taken in another order.  Interpreting a Pallas kernel
costs seconds a launch here, which is why the set is small; every flag
combination is held against the JAX package's jnp oracle in
test_torch_hop.py.
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

SHAPES = {"4x4x4x4": jl.LatticeShape(4, 4, 4, 4),
          "4x4x4x8": jl.LatticeShape(4, 4, 4, 8)}


@pytest.fixture(scope="module")
def packed():
    out = {}
    for name, lat in SHAPES.items():
        ku, kb = jax.random.split(jax.random.PRNGKey(32))
        ue, uo = jl.split_eo_gauge(jl.random_gauge(ku, lat))
        bo = jnp.stack([jl.split_eo(jl.random_spinor(jax.random.fold_in(
            kb, i), lat))[1] for i in range(3)])
        out[name] = tuple(np.asarray(a) for a in (
            jl.pack_gauge(ue), jl.pack_gauge(uo), jl.pack_spinor(bo)))
    return out


def T(a):
    return torch.from_numpy(np.array(a))


# (shape, N, which, g5in, g5out, acc, twist): each flag, shape and N is
# taken on and off across the four launches
PALLAS_CASES = [
    ("4x4x4x4", 1, "oe", True, False, False, False),
    ("4x4x4x8", 3, "eo", False, True, True, False),
    ("4x4x4x4", 3, "oe", False, False, False, True),
    ("4x4x4x8", 1, "eo", True, True, True, True),
]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_hop_block_matches_pallas_interpret(packed, case):
    shape, n, which, g5in, g5out, acc, twist = case
    upe, upo, pb = packed[shape]
    pb = pb[0] if n == 1 else pb[:n]
    flags = dict(which=which, gamma5_in=g5in, gamma5_out=g5out,
                 hop_coeff=-0.3 if (acc or twist) else 1.0,
                 hop_twist=0.2 if twist else 0.0,
                 acc_coeff=1.7 if acc else 0.0,
                 acc_twist=-0.4 if (acc and twist) else 0.0)
    acc_field = -0.5 * pb if acc else None
    ours = tops.hop_block(T(upe), T(upo), T(pb),
                          psi_acc=None if acc_field is None
                          else T(acc_field), **flags)
    ref = jops.hop_block(upe, upo, pb, psi_acc=acc_field, interpret=True,
                         bz=2, **flags)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
