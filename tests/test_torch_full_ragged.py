"""K4's emulated algorithm where its plan is least regular (odd X, Y = 22
against an 8-row tile, odd T, Z and Y with a ragged last tile), against
its plain version for every flag combination, batched equal to single
RHS bitwise.  Split from ``tests/test_torch_full.py``, whose emulation
and helpers these tests share.
"""

import pytest
import torch

from repro_torch.core import lattice as tl
from repro_torch.core.lattice import pack_gauge, pack_spinor
from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
from test_torch_full import FLAGS, MASS, close, emulate_wilson_full

import torch_one_thread  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("dims", [(4, 4, 6, 5), (4, 4, 22, 16),
                                  (3, 5, 7, 32)],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_kernel_algorithm_at_odd_and_ragged_shapes(dims, flags):
    """The algorithm where the plan is least regular: odd X (plain-load
    staging on the card), Y = 22 against an 8-row tile, odd T, Z and Y with
    a ragged last tile; batched against single RHS bitwise."""
    g5in, g5out, twist = flags
    gen = torch.Generator().manual_seed(61)
    lat = tl.LatticeShape(*dims)
    up = pack_gauge(tl.random_gauge(gen, lat))
    pp = pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                  for _ in range(2)]))
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    out = emulate_wilson_full(up, pp, MASS, **kw)
    close(out, wilson_full_ref(up, pp, MASS, **kw))
    for i in range(2):
        assert torch.equal(out[i], emulate_wilson_full(up, pp[i], MASS, **kw))
