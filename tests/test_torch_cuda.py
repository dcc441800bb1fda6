"""The port's CUDA kernels on the card against their plain versions.

Marked ``cuda``: these need an NVIDIA card and ``nvcc`` and skip
elsewhere.  On the machine with the card:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda -q

This file imports nothing of JAX, so it runs where only PyTorch is
installed.  Tolerances as in chip_smoke.py: hop and full-lattice
outputs max-abs <= 1e-5 times max(1, max |plain|); CG fields 1e-5
max-abs, norms 1e-5 relative.
"""

import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import lattice as tl
from repro_torch.core import plan as plan_mod

GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data"
          / "golden_4x4x4x4_seed7.npz")

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "False)")
    from repro_torch.kernels import build
    build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.parametrize("flags", list(itertools.product(
    (0, 1), (False, True), (False, True), (False, True), (False, True))))
def test_wilson_hop_matches_plain(dev, flags):
    from repro_torch.kernels.wilson_dslash.kernel import wilson_hop
    from repro_torch.kernels.wilson_dslash.ref import wilson_hop_ref
    parity, g5in, g5out, has_acc, twist = flags
    gen = torch.Generator(device=dev).manual_seed(3)
    lat = tl.LatticeShape(4, 6, 8, 16)
    ue, uo = tl.split_eo_gauge(tl.random_gauge(gen, lat))
    upe, upo = tl.pack_gauge(ue), tl.pack_gauge(uo)
    psi = tl.pack_spinor(torch.stack(
        [tl.split_eo(tl.random_spinor(gen, lat))[0] for _ in range(3)]))
    u_out, u_nbr = (upe, upo) if parity == 0 else (upo, upe)
    kw = dict(parity=parity, gamma5_in=g5in, gamma5_out=g5out,
              psi_acc=-psi if has_acc else None,
              acc_coeff=1.7 if has_acc else 0.0,
              hop_coeff=-0.3 if (has_acc or twist) else 1.0,
              hop_twist=0.2 if twist else 0.0,
              acc_twist=-0.4 if (has_acc and twist) else 0.0)
    out = wilson_hop(u_out, u_nbr, psi, **kw)
    ref = wilson_hop_ref(u_out, u_nbr, psi, **kw)
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max())), err
    for i in range(3):
        kw["psi_acc"] = -psi[i] if has_acc else None
        assert torch.equal(out[i], wilson_hop(u_out, u_nbr, psi[i], **kw))


def test_cg_kernels_match_plain(dev):
    from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    x, r, p, ap = (torch.randn(3, 54321, generator=gen, device=dev)
                   for _ in range(4))
    alpha = torch.tensor([0.4, 0.0, -0.9], device=dev)
    xo, ro, rs = cg_update(alpha, x, r, p, ap)
    xr, rr, rsr = cg_update_ref(alpha, x, r, p, ap)
    assert float((xo - xr).abs().max()) <= 1e-5
    assert float((ro - rr).abs().max()) <= 1e-5
    assert float(((rs - rsr).abs() / rsr).max()) <= 1e-5
    assert torch.equal(xo[1], x[1]) and torch.equal(ro[1], r[1])
    gate = torch.tensor([True, False, True], device=dev)
    po = cg_xpay(alpha, r, p, gate)
    assert float((po - cg_xpay_ref(alpha, r, p, gate)).abs().max()) <= 1e-5
    assert torch.equal(po[1], p[1])


@pytest.mark.parametrize("family,mu,nrhs,golden", [
    ("wilson", 0.0, None, [14]), ("twisted-mass", 0.25, None, [13]),
    ("wilson", 0.0, 4, [14] * 4)])
def test_golden_solves_through_the_kernels(dev, family, mu, nrhs, golden):
    with np.load(GOLDEN) as f:
        u, b = tl.fields_from_numpy(f["gauge"], f["b_batch"] if nrhs
                                    else f["b"], device=dev)
    plan = plan_mod.SolverPlan(operator_family=family, mu=mu, nrhs=nrhs)
    kernels.reset_counts()
    _, st = plan_mod.solve(plan, u, b, 0.1, tol=1e-6, device=dev)
    its = st.rhs_iterations.tolist() if nrhs else [st.iterations]
    assert its == golden
    assert bool(torch.atleast_1d(st.verified).all())
    c = kernels.counts()
    k = st.iterations
    assert c["wilson_hop"] == {"launches": 4 * k + 4, "plain_calls": 0}
    assert c["cg_update"] == {"launches": k, "plain_calls": 0}
    assert c["cg_xpay"] == {"launches": k, "plain_calls": 0}
    assert c["wilson_full"] == {"launches": 0, "plain_calls": 0}


@pytest.mark.parametrize("flags", list(itertools.product(
    (False, True), (False, True), (0.0, 0.25))))
def test_wilson_full_matches_plain(dev, flags):
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    g5in, g5out, twist = flags
    gen = torch.Generator(device=dev).manual_seed(6)
    lat = tl.LatticeShape(4, 6, 8, 16)
    up = tl.pack_gauge(tl.random_gauge(gen, lat))
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]))
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    out = wilson_full(up, pp, 0.1, **kw)
    ref = wilson_full_ref(up, pp, 0.1, **kw)
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max())), err
    for i in range(3):
        assert torch.equal(out[i], wilson_full(up, pp[i], 0.1, **kw))


@pytest.mark.parametrize("family,mu,nrhs", [
    ("wilson", 0.0, None), ("twisted-mass", 0.25, None),
    ("wilson", 0.0, 4)])
def test_full_golden_solves_through_the_kernel(dev, family, mu, nrhs):
    with np.load(GOLDEN) as f:
        u, b = tl.fields_from_numpy(f["gauge"], f["b_batch"] if nrhs
                                    else f["b"], device=dev)
    plan = plan_mod.SolverPlan(operator="full", operator_family=family,
                               mu=mu, nrhs=nrhs)
    kernels.reset_counts()
    _, st = plan_mod.solve(plan, u, b, 0.1, tol=1e-6, device=dev)
    its = st.rhs_iterations.tolist() if nrhs else [st.iterations]
    assert its == [27] * (nrhs or 1)
    assert bool(torch.atleast_1d(st.verified).all())
    c = kernels.counts()
    assert c["wilson_full"] == {"launches": 2 * st.iterations + 1,
                                "plain_calls": 0}
    assert all(c[k] == {"launches": 0, "plain_calls": 0}
               for k in ("wilson_hop", "cg_update", "cg_xpay"))


# odd Xh = 3 (links staged by plain loads), Y = 22 against an 8-row tile,
# and rows too wide for shared memory (read in place)
SHAPES = [(4, 4, 6, 6), (4, 4, 22, 8), (2, 2, 2, 348)]


@pytest.mark.parametrize("dims", SHAPES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", [(0, False, True, True, False),
                                   (1, True, False, False, True),
                                   (0, True, True, True, True)])
def test_wilson_hop_odd_and_ragged_shapes(dev, dims, flags):
    from repro_torch.kernels.wilson_dslash.kernel import wilson_hop
    from repro_torch.kernels.wilson_dslash.ref import wilson_hop_ref
    parity, g5in, g5out, has_acc, twist = flags
    gen = torch.Generator(device=dev).manual_seed(7)
    lat = tl.LatticeShape(*dims)
    ue, uo = tl.split_eo_gauge(tl.random_gauge(gen, lat))
    upe, upo = tl.pack_gauge(ue), tl.pack_gauge(uo)
    psi = tl.pack_spinor(torch.stack(
        [tl.split_eo(tl.random_spinor(gen, lat))[0] for _ in range(2)]))
    u_out, u_nbr = (upe, upo) if parity == 0 else (upo, upe)
    kw = dict(parity=parity, gamma5_in=g5in, gamma5_out=g5out,
              psi_acc=0.5 * psi if has_acc else None,
              acc_coeff=1.3 if has_acc else 0.0,
              hop_coeff=-0.7, hop_twist=0.3 if twist else 0.0,
              acc_twist=0.2 if (has_acc and twist) else 0.0)
    out = wilson_hop(u_out, u_nbr, psi, **kw)
    ref = wilson_hop_ref(u_out, u_nbr, psi, **kw)
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max())), err
    for i in range(2):
        kw["psi_acc"] = 0.5 * psi[i] if has_acc else None
        assert torch.equal(out[i], wilson_hop(u_out, u_nbr, psi[i], **kw))


# K4's link staging modes: bulk copies (4x4x6x6, 4x4x22x8, 8^4, and
# 4x4x22x16, Y = 22 against an 8-row tile), plain loads at odd X (4x4x6x5),
# one-row tiles looping over X (2x2x2x348), link rows too wide for shared
# memory read in place (2x2x2x464)
FULL_SHAPES = [(4, 4, 6, 6), (4, 4, 22, 8), (8, 8, 8, 8), (4, 4, 22, 16),
               (4, 4, 6, 5), (2, 2, 2, 348), (2, 2, 2, 464)]
FULL_FLAGS = list(itertools.product((False, True), (False, True),
                                    (0.0, 0.25)))


def _check_full(up, pp, flags):
    """Every RHS of a batched K4 launch against the plain version and,
    bitwise, against its own single launch."""
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    g5in, g5out, twist = flags
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    out = wilson_full(up, pp, 0.1, **kw)
    ref = wilson_full_ref(up, pp, 0.1, **kw)
    err = float((out - ref).abs().max())
    assert err <= 1e-5 * max(1.0, float(ref.abs().max())), err
    for i in range(pp.shape[0]):
        assert torch.equal(out[i], wilson_full(up, pp[i], 0.1, **kw))


@pytest.mark.parametrize("dims", FULL_SHAPES,
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", FULL_FLAGS)
def test_wilson_full_odd_and_ragged_shapes(dev, dims, flags):
    gen = torch.Generator(device=dev).manual_seed(8)
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat))
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]))
    _check_full(up, pp, flags)


def _off_by_one_float(v):
    """A contiguous copy of ``v`` whose data starts 4 bytes past a 16-byte
    boundary (a view into a larger buffer)."""
    buf = torch.empty(v.numel() + 4, dtype=v.dtype, device=v.device)
    out = buf[1:1 + v.numel()].view(v.shape)
    out.copy_(v)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("which", ["psi", "gauge"])
@pytest.mark.parametrize("flags", FULL_FLAGS)
def test_wilson_full_misaligned_base(dev, which, flags):
    """A base pointer off 16-byte alignment: the gauge field's links are
    staged by plain loads, the spinor is read through L1 as ever."""
    gen = torch.Generator(device=dev).manual_seed(10)
    lat = tl.LatticeShape(4, 4, 6, 8)
    up = tl.pack_gauge(tl.random_gauge(gen, lat))
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]))
    if which == "psi":
        pp = _off_by_one_float(pp)
    else:
        up = _off_by_one_float(up)
    _check_full(up, pp, flags)


@pytest.mark.parametrize("offsets", [(1, 1), (2, 2), (3, 3), (1, 3), (0, 2)])
@pytest.mark.parametrize("gated", [False, True])
def test_cg_xpay_misaligned_views(dev, offsets, gated):
    """Views 1-3 floats off 16-byte alignment (alike, and against each
    other): within 1e-5 of the plain version, a closed gate keeps p
    bitwise, and each single-RHS slice equals its row of the batch."""
    from repro_torch.kernels.cg_fused.kernel import cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_xpay_ref
    length = 12345
    gen = torch.Generator(device=dev).manual_seed(9)
    buf_r = torch.randn(2 * length + 8, generator=gen, device=dev)
    buf_p = torch.randn(2 * length + 8, generator=gen, device=dev)
    r = buf_r[offsets[0]:offsets[0] + 2 * length].view(2, length)
    p = buf_p[offsets[1]:offsets[1] + 2 * length].view(2, length)
    beta = torch.tensor([0.75, -1.5], device=dev)
    gate = torch.tensor([True, False], device=dev) if gated else None
    po = cg_xpay(beta, r, p, gate)
    assert float((po - cg_xpay_ref(beta, r, p, gate)).abs().max()) <= 1e-5
    if gated:
        assert torch.equal(po[1], p[1])
    for i in range(2):
        single = cg_xpay(beta[i:i + 1], r[i:i + 1], p[i:i + 1],
                         None if gate is None else gate[i:i + 1])
        assert torch.equal(single[0], po[i])
