"""K4's algorithm, emulated on this machine (the kernel runs only on the
card), against its plain version for every flag combination at the
fixture's shapes and N = 1 and 3; its bf16 pair instance (two sites a
thread, X = 32) bitwise the one-site emulation and within 1 bf16 ulp of
the plain version; the float16 pair instance on batches of right-hand
sides bitwise the one-site emulation and its single launches and within
1 float16 ulp of the plain version.  Split from
``tests/test_torch_full.py``, whose emulation, fixture and helpers these
tests share.
"""

import pytest
import torch

from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
from test_torch_full import (FLAGS, MASS, T, _bf16_fields,  # noqa: F401
                             _full_pair_case, _within_one_ulp, close,
                             emulate_wilson_full, fields)

import torch_one_thread  # noqa: F401  (one intra-op thread)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_kernel_algorithm_matches_plain_version(fields, flags, n):
    g5in, g5out, twist = flags
    up, pp = T(fields["up"]), T(fields["pp"])
    pp = pp[0] if n == 1 else pp
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    close(emulate_wilson_full(up, pp, MASS, **kw),
          wilson_full_ref(up, pp, MASS, **kw))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(map(str, f)))
def test_pair_algorithm_equals_one_site(flags, n):
    """The pair instance on bf16 fields at 2x2x4x32 (every row's first and
    last pair read across the row's ends), Wilson and twisted mass, every
    gamma5 flag pair, N = 1 and 3."""
    up, pp = _bf16_fields((2, 2, 4, 32), 3, 63)
    _full_pair_case(up, pp[0] if n == 1 else pp, flags)


@pytest.mark.parametrize("dims", [(3, 5, 7, 32), (2, 2, 12, 32)],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", [(True, True, 0.25), (False, True, 0.0)],
                         ids=lambda f: "-".join(map(str, f)))
def test_pair_algorithm_other_shapes(dims, flags):
    """Odd T, Z, Y (one 7-row tile), Y = 12 against an 8-row tile (the
    last one ragged); batched equal to single RHS bitwise."""
    up, pp = _bf16_fields(dims, 2, 62)
    out, kw = _full_pair_case(up, pp, flags)
    for i in range(2):
        assert torch.equal(out[i], emulate_wilson_full(up, pp[i], MASS,
                                                       pair=True, **kw))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("dims", [(2, 2, 4, 32), (3, 5, 7, 32)],
                         ids=lambda d: "x".join(map(str, d)))
def test_f16_batch_algorithm_equals_pair(dims, n):
    """The float16 pair instance (each link word read once for both
    sites) on a batch of N = 1, 2, 3 and 5 right-hand sides at 2x2x4x32
    and at odd T, Z, Y (one 7-row tile), every gamma5 flag pair with and
    without twist: bitwise the one-site emulation, each RHS bitwise its
    single launch, and within 1 float16 ulp of the plain version."""
    up, pp = _bf16_fields(dims, n, 64, torch.float16)
    pp = pp[0] if n == 1 else pp
    for g5in, g5out, twist in FLAGS:
        kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
        out = emulate_wilson_full(up, pp, MASS, pair=True, **kw)
        assert torch.equal(out, emulate_wilson_full(up, pp, MASS, **kw))
        for i in range(n if n > 1 else 0):
            assert torch.equal(out[i], emulate_wilson_full(
                up, pp[i], MASS, pair=True, **kw))
        _within_one_ulp(out, wilson_full_ref(up, pp, MASS, **kw))
