"""``ops.dslash`` (K4's entry point) against the JAX package's jnp oracle
for every (gamma5_in, gamma5_out, twist) at N = 1 and 3, and against the
JAX Pallas kernel interpreted in three launches that together set each
flag on and off and cover N = 3 (an interpreted launch costs seconds
here).  Split from ``tests/test_torch_full.py``, whose fixture and
helpers these tests share and whose docstring states the tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import lattice as jl
from repro.kernels.wilson_dslash import ops as jops
from repro_torch.kernels.wilson_dslash import ops as tops
from test_torch_full import FLAGS, MASS, SHAPES, T, close, fields  # noqa: F401

import torch_one_thread  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("n", [None, 3])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_dslash_matches_jax_oracle(fields, flags, n):
    g5in, g5out, twist = flags
    up, pp = fields["up"], fields["pp"]
    pp = pp[0] if n is None else pp
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    close(tops.dslash(T(up), T(pp), MASS, **kw),
          jops.dslash(up, pp, MASS, use_pallas=False, **kw))


# (lattice index, N, gamma5_in, gamma5_out, twist): each flag on and off
PALLAS_CASES = [(0, 1, True, False, 0.0), (0, 3, False, True, 0.25),
                (0, 1, True, True, -0.25)]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_dslash_matches_pallas_interpret(case):
    i, n, g5in, g5out, twist = case
    lat = SHAPES[i]
    ku, kb = jax.random.split(jax.random.PRNGKey(52))
    up = np.asarray(jl.pack_gauge(jl.random_gauge(ku, lat)))
    pp = np.asarray(jnp.stack([jl.pack_spinor(jl.random_spinor(
        jax.random.fold_in(kb, j), lat)) for j in range(n)]))
    pp = pp[0] if n == 1 else pp
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    # bz given explicitly: the tuning cache's choice for small lattices
    # is a streaming mode this jax cannot interpret
    ref = jops.dslash(up, pp, MASS, interpret=True, bz=2, **kw)
    close(tops.dslash(T(up), T(pp), MASS, **kw), ref)
