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


# ---------------------------------------------------------------------------
# bf16 instances (mixed precision): each kernel against its plain version on
# the same bf16 inputs, at most 1 bf16 ulp per entry (an entry that cancels
# below 2^-16 of the field's largest entry, where f32 sums in another order
# differ by more than its own ulp, is held to the ulp at that floor);
# batched launches equal single launches bitwise
# ---------------------------------------------------------------------------

ULP_FLOOR = 2.0 ** -16


def _bf16_within_one_ulp(out, ref):
    assert out.dtype == ref.dtype == torch.bfloat16
    bits = [v.contiguous().view(torch.int16).int() for v in (out, ref)]
    ords = [torch.where(v < 0, -(v & 0x7FFF), v) for v in bits]
    a, b = out.double(), ref.double()
    _, e = torch.frexp(ULP_FLOOR * b.abs().max())
    floor = torch.ldexp(torch.ones((), dtype=torch.float64, device=b.device),
                        e - 8)
    ok = ((ords[0] - ords[1]).abs() <= 1) | ((a - b).abs() <= floor)
    assert bool(ok.all()), float((a - b).abs().max())


def _bf16_hop_case(dev, dims, flags, n=3, seed=11):
    from repro_torch.kernels.wilson_dslash.kernel import wilson_hop
    from repro_torch.kernels.wilson_dslash.ref import wilson_hop_ref
    parity, g5in, g5out, has_acc, twist = flags
    gen = torch.Generator(device=dev).manual_seed(seed)
    lat = tl.LatticeShape(*dims)
    ue, uo = tl.split_eo_gauge(tl.random_gauge(gen, lat))
    upe, upo = (tl.pack_gauge(v, dtype=torch.bfloat16) for v in (ue, uo))
    psi = tl.pack_spinor(torch.stack(
        [tl.split_eo(tl.random_spinor(gen, lat))[0] for _ in range(n)]),
        dtype=torch.bfloat16)
    acc = (-0.5 * psi).to(torch.bfloat16)
    u_out, u_nbr = (upe, upo) if parity == 0 else (upo, upe)
    kw = dict(parity=parity, gamma5_in=g5in, gamma5_out=g5out,
              psi_acc=acc if has_acc else None,
              acc_coeff=1.7 if has_acc else 0.0,
              hop_coeff=-0.3 if (has_acc or twist) else 1.0,
              hop_twist=0.2 if twist else 0.0,
              acc_twist=-0.4 if (has_acc and twist) else 0.0)
    kernels.reset_counts()
    out = wilson_hop(u_out, u_nbr, psi, **kw)
    assert kernels.counts()["wilson_hop_bf16"]["launches"] == 1
    _bf16_within_one_ulp(out, wilson_hop_ref(u_out, u_nbr, psi, **kw))
    for i in range(n):
        kw["psi_acc"] = acc[i] if has_acc else None
        assert torch.equal(out[i], wilson_hop(u_out, u_nbr, psi[i], **kw))


@pytest.mark.parametrize("flags", list(itertools.product(
    (0, 1), (False, True), (False, True), (False, True), (False, True))))
def test_wilson_hop_bf16_matches_plain(dev, flags):
    _bf16_hop_case(dev, (4, 6, 8, 16), flags)


# 4^4 (Xh = 2: 4-byte planes, staged by plain loads), odd Xh, Y = 22
# against the tile, 2x2x2x348 (staged in bf16, where f32 reads in place),
# 2x2x2x700 (read in place), 8x8x8x32 (TMA, padded strides)
BF16_HOP_SHAPES = [(4, 4, 4, 4), (4, 4, 6, 6), (4, 4, 22, 8), (2, 2, 2, 348),
                   (2, 2, 2, 700), (8, 8, 8, 32)]


@pytest.mark.parametrize("dims", BF16_HOP_SHAPES,
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", [(0, False, True, True, False),
                                   (1, True, False, False, True),
                                   (0, True, True, True, True)])
def test_wilson_hop_bf16_odd_and_ragged_shapes(dev, dims, flags):
    _bf16_hop_case(dev, dims, flags, n=2, seed=12)


def _bf16_full_case(up, pp, flags):
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    g5in, g5out, twist = flags
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    kernels.reset_counts()
    out = wilson_full(up, pp, 0.1, **kw)
    assert kernels.counts()["wilson_full_bf16"]["launches"] == 1
    _bf16_within_one_ulp(out, wilson_full_ref(up, pp, 0.1, **kw))
    for i in range(pp.shape[0]):
        assert torch.equal(out[i], wilson_full(up, pp[i], 0.1, **kw))


# K4's bf16 modes: TMA (8^4, 4x4x22x16, X = 32 instances at 4x4x8x32),
# plain loads (4x4x6x6: 216-byte rows; 4x4x6x5), one-row tiles over X
# (2x2x2x464, staged in bf16), links read in place (2x2x2x928)
BF16_FULL_SHAPES = [(8, 8, 8, 8), (4, 4, 22, 16), (4, 4, 8, 32),
                    (4, 4, 6, 6), (4, 4, 6, 5), (2, 2, 2, 464),
                    (2, 2, 2, 928)]


@pytest.mark.parametrize("dims", BF16_FULL_SHAPES,
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", FULL_FLAGS)
def test_wilson_full_bf16_shapes(dev, dims, flags):
    gen = torch.Generator(device=dev).manual_seed(13)
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), dtype=torch.bfloat16)
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]),
                        dtype=torch.bfloat16)
    _bf16_full_case(up, pp, flags)


def _off_by(v, elems):
    """A contiguous copy of ``v`` starting ``elems`` elements past a
    16-byte boundary."""
    buf = torch.empty(v.numel() + 16, dtype=v.dtype, device=v.device)
    out = buf[elems:elems + v.numel()].view(v.shape)
    out.copy_(v)
    assert out.data_ptr() % 16 == elems * v.element_size()
    return out


@pytest.mark.parametrize("which", ["psi", "gauge"])
@pytest.mark.parametrize("elems", [1, 2])
def test_wilson_full_bf16_misaligned_base(dev, which, elems):
    """Bases 2 and 4 bytes off 16-byte alignment: the links staged by
    plain loads, the spinor read through L1 as ever."""
    gen = torch.Generator(device=dev).manual_seed(14)
    lat = tl.LatticeShape(4, 4, 6, 8)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), dtype=torch.bfloat16)
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]),
                        dtype=torch.bfloat16)
    if which == "psi":
        pp = _off_by(pp, elems)
    else:
        up = _off_by(up, elems)
    for flags in FULL_FLAGS:
        _bf16_full_case(up, pp, flags)


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (3, 3), (7, 7), (1, 2),
                                     (0, 5)])
def test_cg_kernels_bf16_match_plain(dev, offsets):
    """K2 and K3 on bf16 views 0-7 elements off 16-byte alignment (alike,
    and against each other), a ragged length, a frozen lane and a closed
    gate: within 1 bf16 ulp of the plain version, the norms (f32, of the
    unrounded r') 1e-5 relative, frozen lanes and closed gates bitwise,
    each single-RHS slice equal to its row of the batch."""
    from repro_torch.kernels.cg_fused.kernel import cg_update, cg_xpay
    from repro_torch.kernels.cg_fused.ref import cg_update_ref, cg_xpay_ref
    length = 12345
    gen = torch.Generator(device=dev).manual_seed(15)
    bufs = [torch.randn(3 * length + 16, generator=gen,
                        device=dev).to(torch.bfloat16) for _ in range(4)]
    x, r, p, ap = (buf[o:o + 3 * length].view(3, length)
                   for buf, o in zip(bufs, offsets + offsets))
    alpha = torch.tensor([0.4, 0.0, -0.9], device=dev)
    kernels.reset_counts()
    xo, ro, rs = cg_update(alpha, x, r, p, ap)
    xr, rr, rsr = cg_update_ref(alpha, x, r, p, ap)
    _bf16_within_one_ulp(xo, xr)
    _bf16_within_one_ulp(ro, rr)
    assert rs.dtype == torch.float32
    assert float(((rs - rsr).abs() / rsr).max()) <= 1e-5
    assert torch.equal(xo[1], x[1]) and torch.equal(ro[1], r[1])
    beta = torch.tensor([0.5, 0.25, 2.0], device=dev)
    gate = torch.tensor([True, False, True], device=dev)
    for g in (None, gate):
        po = cg_xpay(beta, r, p, g)
        _bf16_within_one_ulp(po, cg_xpay_ref(beta, r, p, g))
        if g is not None:
            assert torch.equal(po[1], p[1])
        for i in range(3):
            single = cg_xpay(beta[i:i + 1], r[i:i + 1], p[i:i + 1],
                             None if g is None else g[i:i + 1])
            assert torch.equal(single[0], po[i])
    for i in range(3):
        sx, sr, srs = cg_update(alpha[i:i + 1], x[i:i + 1], r[i:i + 1],
                                p[i:i + 1], ap[i:i + 1])
        assert torch.equal(sx[0], xo[i]) and torch.equal(sr[0], ro[i])
        assert torch.equal(srs[0], rs[i])
    c = kernels.counts()
    assert c["cg_update_bf16"]["launches"] == 4
    assert c["cg_xpay_bf16"]["launches"] == 8
    assert c["cg_update"]["launches"] == c["cg_xpay"]["launches"] == 0


# the mixed goldens (4^4, seed 7, mass 0.1, tol 1e-6), inner counts
# within 2 of JAX's pallas-backend twin, outer counts equal
MIXED_GOLDENS = [
    ("eo-schur", "mixed", "wilson", 0.0, None, [15], 4),
    ("eo-schur", "mixed", "twisted-mass", 0.25, None, [15], 4),
    ("full", "mixed", "wilson", 0.0, None, [35], 5),
    ("full", "mixed", "wilson", 0.0, 4, [33, 33, 35, 33], 5),
    ("full", "low", "wilson", 0.0, None, [27], 1)]


@pytest.mark.parametrize("case", MIXED_GOLDENS,
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[4]}")
def test_mixed_golden_solves_through_the_kernels(dev, case):
    operator, precision, family, mu, nrhs, golden, outer = case
    with np.load(GOLDEN) as f:
        u, b = tl.fields_from_numpy(f["gauge"], f["b_batch"] if nrhs
                                    else f["b"], device=dev)
    plan = plan_mod.SolverPlan(operator=operator, precision=precision,
                               operator_family=family, mu=mu, nrhs=nrhs)
    kernels.reset_counts()
    _, st = plan_mod.solve(plan, u, b, 0.1, tol=1e-6, device=dev)
    its = st.rhs_iterations.tolist() if nrhs else [st.iterations]
    assert all(abs(i - g) <= 2 for i, g in zip(its, golden)), its
    assert st.outer_iterations == outer
    verified = torch.atleast_1d(st.verified)
    assert bool(verified.all()) == (precision == "mixed")
    k, o = st.iterations, st.outer_iterations
    c = kernels.counts()
    if operator == "eo-schur":
        want = {"wilson_hop_bf16": 4 * k, "wilson_hop": 4 * o + 4,
                "cg_update_bf16": k, "cg_xpay_bf16": k}
    elif precision == "mixed":
        want = {"wilson_full_bf16": 2 * k, "wilson_full": 2 * o + 1}
    else:
        want = {"wilson_full_bf16": 2 * k, "wilson_full": 1}
    for name, v in c.items():
        assert v == {"launches": want.get(name, 0), "plain_calls": 0}, name


# ---------------------------------------------------------------------------
# The bf16 pair instances of K1 and K4 (two sites a thread, each component
# of both read as one 32-bit word): even widths with 4-byte aligned bases
# run them, against the plain version at 1 bf16 ulp and batched equal to
# single bitwise; their outputs equal the one-site instance's bitwise (the
# one-site instance runs on copies of the same inputs 2 bytes off
# alignment); odd widths and such offsets run the one-site instance
# ---------------------------------------------------------------------------

# K1, even Xh: 4^4 (Xh = 2, staged by plain loads), 4x4x22x8 (Y = 22
# against the tile), 8x8x8x32 (Xh = 16 as at 32^3 x 64, TMA), 2x2x2x700
# (read in place)
PAIR_HOP_SHAPES = [(4, 4, 4, 4), (4, 4, 22, 8), (8, 8, 8, 32),
                   (2, 2, 2, 700)]
PAIR_HOP_FLAGS = [(0, False, True, True, False), (1, True, False, False, True),
                  (0, True, True, True, True), (1, False, False, True, False)]


@pytest.mark.parametrize("dims", PAIR_HOP_SHAPES,
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", PAIR_HOP_FLAGS)
def test_wilson_hop_bf16_pair_instance(dev, dims, flags):
    _bf16_hop_case(dev, dims, flags, n=3, seed=16)
    assert kernels.pair_launches()["wilson_hop_bf16"] == 4


# the equality checks also at 16^3 x 32 (3 M outputs): two roundings that
# differ in the f32 result differ in its bf16 rounding about once in 2^16
# entries, so a small shape can miss them
EQUAL_SHAPE = (16, 16, 16, 32)


@pytest.mark.parametrize("dims", PAIR_HOP_SHAPES + [EQUAL_SHAPE],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", PAIR_HOP_FLAGS)
def test_wilson_hop_bf16_pair_equals_one_site(dev, dims, flags):
    from repro_torch.kernels.wilson_dslash.kernel import wilson_hop
    parity, g5in, g5out, has_acc, twist = flags
    gen = torch.Generator(device=dev).manual_seed(17)
    lat = tl.LatticeShape(*dims)
    ue, uo = tl.split_eo_gauge(tl.random_gauge(gen, lat))
    upe, upo = (tl.pack_gauge(v, dtype=torch.bfloat16) for v in (ue, uo))
    psi = tl.pack_spinor(torch.stack(
        [tl.split_eo(tl.random_spinor(gen, lat))[0] for _ in range(2)]),
        dtype=torch.bfloat16)
    u_out, u_nbr = (upe, upo) if parity == 0 else (upo, upe)
    kw = dict(parity=parity, gamma5_in=g5in, gamma5_out=g5out,
              acc_coeff=1.3 if has_acc else 0.0, hop_coeff=-0.7,
              hop_twist=0.3 if twist else 0.0,
              acc_twist=0.2 if (has_acc and twist) else 0.0)
    acc = (0.5 * psi).to(torch.bfloat16) if has_acc else None
    kernels.reset_counts()
    pair = wilson_hop(u_out, u_nbr, psi, psi_acc=acc, **kw)
    assert kernels.pair_launches()["wilson_hop_bf16"] == 1
    one = wilson_hop(u_out, u_nbr, _off_by(psi, 1),
                     psi_acc=None if acc is None else _off_by(acc, 1), **kw)
    assert kernels.pair_launches()["wilson_hop_bf16"] == 1
    assert kernels.counts()["wilson_hop_bf16"]["launches"] == 2
    assert torch.equal(pair, one)


# K4 at X = 32 (its pair instance's width): 4x4x8x32, 3x5x7x32 (odd T,
# Z, Y: one 7-row tile), 2x2x12x32 (Y = 12 against an 8-row tile)
PAIR_FULL_SHAPES = [(4, 4, 8, 32), (3, 5, 7, 32), (2, 2, 12, 32)]


@pytest.mark.parametrize("dims", PAIR_FULL_SHAPES + [EQUAL_SHAPE],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", FULL_FLAGS)
def test_wilson_full_bf16_pair_instance(dev, dims, flags):
    gen = torch.Generator(device=dev).manual_seed(18)
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), dtype=torch.bfloat16)
    pp = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                     for _ in range(3)]),
                        dtype=torch.bfloat16)
    _bf16_full_case(up, pp, flags)
    assert kernels.pair_launches()["wilson_full_bf16"] == 4
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    g5in, g5out, twist = flags
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    kernels.reset_counts()
    pair = wilson_full(up, pp, 0.1, **kw)
    one = wilson_full(up, _off_by(pp, 1), 0.1, **kw)
    assert kernels.pair_launches()["wilson_full_bf16"] == 1
    assert kernels.counts()["wilson_full_bf16"]["launches"] == 2
    assert torch.equal(pair, one)


@pytest.mark.parametrize("case", [
    ("hop", (4, 4, 6, 6), 0, 0), ("hop", (4, 4, 4, 4), 1, 0),
    ("hop", (4, 4, 4, 4), 2, 1), ("full", (4, 4, 6, 5), 0, 0),
    ("full", (4, 4, 6, 8), 2, 0), ("full", (2, 2, 4, 32), 1, 0),
    ("full", (2, 2, 4, 32), 2, 1)],
    ids=lambda c: f"{c[0]}-{'x'.join(map(str, c[1]))}-off{c[2]}")
def test_bf16_instance_rule(dev, case):
    """The pair instances run with 4-byte aligned bases only, K1's at even
    Xh, K4's at X = 32: odd Xh, another X, or a base 2 bytes off runs the
    one-site instance."""
    from repro_torch.kernels.wilson_dslash.kernel import (wilson_full,
                                                          wilson_hop)
    kind, dims, elems, want = case
    gen = torch.Generator(device=dev).manual_seed(19)
    lat = tl.LatticeShape(*dims)
    kernels.reset_counts()
    if kind == "hop":
        ue, uo = tl.split_eo_gauge(tl.random_gauge(gen, lat))
        upe, upo = (tl.pack_gauge(v, dtype=torch.bfloat16) for v in (ue, uo))
        psi = tl.pack_spinor(tl.split_eo(tl.random_spinor(gen, lat))[0],
                             dtype=torch.bfloat16)
        wilson_hop(upe, upo, _off_by(psi, elems), parity=0)
    else:
        up = tl.pack_gauge(tl.random_gauge(gen, lat), dtype=torch.bfloat16)
        pp = tl.pack_spinor(tl.random_spinor(gen, lat), dtype=torch.bfloat16)
        wilson_full(up, _off_by(pp, elems), 0.1)
    name = f"wilson_{kind}_bf16"
    assert kernels.counts()[name]["launches"] == 1
    assert kernels.pair_launches()[name] == want


# K4's float16 pair instance at N = 1-5 for every gamma5 flag set with
# and without twist: bitwise the float16 one-site instance (a psi base 2
# bytes off 4-byte alignment runs it), a batched launch bitwise its
# single launches, and within 1 float16 ulp of the plain version (floor
# 2^-13 of the field's largest entry)
F16_ULP_FLOOR = 2.0 ** -13


def _f16_within_one_ulp(out, ref):
    assert out.dtype == ref.dtype == torch.float16
    bits = [v.contiguous().view(torch.int16).int() for v in (out, ref)]
    ords = [torch.where(v < 0, -(v & 0x7FFF), v) for v in bits]
    a, b = out.double(), ref.double()
    _, e = torch.frexp(F16_ULP_FLOOR * b.abs().max())
    floor = torch.ldexp(torch.ones((), dtype=torch.float64, device=b.device),
                        e - 11)
    ok = ((ords[0] - ords[1]).abs() <= 1) | ((a - b).abs() <= floor)
    assert bool(ok.all()), float((a - b).abs().max())


@pytest.mark.parametrize("dims", PAIR_FULL_SHAPES + [EQUAL_SHAPE],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", FULL_FLAGS)
def test_wilson_full_f16_pair_batches(dev, dims, flags):
    from repro_torch.kernels.wilson_dslash.kernel import wilson_full
    from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
    g5in, g5out, twist = flags
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    gen = torch.Generator(device=dev).manual_seed(23)
    lat = tl.LatticeShape(*dims)
    up = tl.pack_gauge(tl.random_gauge(gen, lat), dtype=torch.float16)
    pp5 = tl.pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                      for _ in range(5)]),
                         dtype=torch.float16)
    singles = [wilson_full(up, pp5[i], 0.1, **kw) for i in range(5)]
    for n in range(1, 6):
        pp = pp5[:n].contiguous()
        kernels.reset_counts()
        out = wilson_full(up, pp, 0.1, **kw)
        one = wilson_full(up, _off_by(pp, 1), 0.1, **kw)
        assert kernels.counts()["wilson_full_f16"]["launches"] == 2
        assert kernels.pair_launches()["wilson_full_f16"] == 1
        assert torch.equal(out, one), n
        for i in range(n):
            assert torch.equal(out[i], singles[i]), (n, i)
        _f16_within_one_ulp(out, wilson_full_ref(up, pp, 0.1, **kw))


# Two gloo ranks sharing card 0, T split over a ``data`` axis at 8x8x8x16:
# each rank's halo'd K1 (every flag set of chip_smoke.py's phase 2) and
# K4 (every gamma5 pair with and without twist, f32 and bf16) against the
# block of one global launch of the same kernel.  bf16: the boundary
# planes round twice (the bulk's output, then the correction), so 2 bf16
# ulps of the scale.
_MESH_RANK = r"""
import datetime, itertools, json, sys
import torch, torch.distributed as tdist
from repro_torch import kernels
from repro_torch.core import distributed as dist
from repro_torch.core import lattice as tl
from repro_torch.kernels.wilson_dslash import ops as wops

rank, d = int(sys.argv[1]), sys.argv[2]
timeout = datetime.timedelta(seconds=60)
torch.cuda.set_device(0)
tdist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                         rank=rank, world_size=2, timeout=timeout)
mesh = dist.Mesh((2,), ("data",), device="cuda:0", transport="gloo",
                 timeout=timeout)
psi_spec, gauge_spec, sharded = dist.lattice_specs(mesh, {0: "data"})
gen = torch.Generator(device="cuda").manual_seed(23)
lat = tl.LatticeShape(8, 8, 8, 16)
u, b = tl.random_gauge(gen, lat), tl.random_spinor(gen, lat)
u_e, u_o = tl.split_eo_gauge(u)
upe, upo = tl.pack_gauge(u_e), tl.pack_gauge(u_o)
pe, po = (tl.pack_spinor(h) for h in tl.split_eo(b))
loc = lambda v, spec: dist.local_block(mesh, v, spec)
ue, uo, pel, pol = (loc(upe, gauge_spec), loc(upo, gauge_spec),
                    loc(pe, psi_spec), loc(po, psi_spec))


def err(out, ref):
    return float((out.float() - ref.float()).abs().max()
                 / max(1.0, float(ref.float().abs().max())))


worst = {}
kernels.reset_counts()
for parity, g5in, g5out, has_acc, twist in itertools.product(
        (0, 1), (False, True), (False, True), (False, True), (False, True)):
    which = "eo" if parity == 0 else "oe"
    src, src_l = (po, pol) if parity == 0 else (pe, pel)
    acc, acc_l = (pe, pel) if parity == 0 else (po, pol)
    kw = dict(gamma5_in=g5in, gamma5_out=g5out,
              hop_coeff=-0.3 if (has_acc or twist) else 1.0,
              hop_twist=0.2 if twist else 0.0,
              acc_coeff=1.7 if has_acc else 0.0,
              acc_twist=-0.4 if (has_acc and twist) else 0.0)
    ref = loc(wops.hop_block(upe, upo, src, which=which,
                             psi_acc=acc if has_acc else None, **kw),
              psi_spec)
    out = dist.parity_hop_halo(which, ue, uo, src_l, mesh, sharded,
                               psi_acc=acc_l if has_acc else None, **kw)
    worst["wilson_hop"] = max(worst.get("wilson_hop", 0.0), err(out, ref))
up, pp = tl.pack_gauge(u), tl.pack_spinor(b)
bitwise = {}
for dtype, name in ((torch.float32, "wilson_full"),
                    (torch.bfloat16, "wilson_full_bf16"),
                    (torch.float16, "wilson_full_f16")):
    upd, ppd = up.to(dtype), pp.to(dtype)
    upl, ppl = dist.shard_lattice_fields(mesh, upd, ppd, {0: "data"})
    for g5in, g5out, tw in itertools.product((False, True), (False, True),
                                             (0.0, 0.25)):
        kw = dict(twist=tw, gamma5_in=g5in, gamma5_out=g5out)
        ref = loc(wops.dslash(upd, ppd, 0.1, **kw), psi_spec)
        out = dist.dslash_halo(upl, ppl, 0.1, mesh, sharded, **kw)
        assert out.dtype == dtype
        worst[name] = max(worst.get(name, 0.0), err(out, ref))
        bitwise[name] = bitwise.get(name, True) and torch.equal(out, ref)
torch.cuda.synchronize()
print("RESULT" + json.dumps({"worst": worst, "bitwise": bitwise,
                             "counts": kernels.counts()}))
tdist.destroy_process_group()
"""


def test_halo_kernels_on_a_two_rank_mesh_match_global_launches(dev,
                                                               tmp_path):
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parents[1]
                                          / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _MESH_RANK, str(r),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a mesh rank did not end within 300 s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
        res = json.loads([ln for ln in out.splitlines()
                          if ln.startswith("RESULT")][-1][len("RESULT"):])
        assert res["worst"]["wilson_hop"] <= 1e-5
        # K4 reads the neighbours' ghost planes: one global launch, bitwise
        assert res["bitwise"] == {"wilson_full": True,
                                  "wilson_full_bf16": True,
                                  "wilson_full_f16": True}, res
        for name in ("wilson_hop", "wilson_full", "wilson_full_bf16",
                     "wilson_full_f16"):
            c = res["counts"][name]
            assert c["launches"] > 0 and c["plain_calls"] == 0, (name, c)


# the launch space (kernels/dispatch.py): (kernel, T x Z x Y x W) with W
# the half field's Xh for K1 and X for K4, an odd and a ragged shape a
# dtype; K4 bf16 at X = 32 runs the pair instance
TILE_CASES = [
    ("wilson_hop", (4, 4, 6, 3), torch.float32),      # odd Xh
    ("wilson_hop", (4, 4, 22, 4), torch.float32),     # Y = 22, 8-row tile
    ("wilson_hop", (4, 4, 6, 3), torch.bfloat16),     # odd Xh: one-site
    ("wilson_hop", (4, 4, 22, 4), torch.bfloat16),    # pair, ragged
    ("wilson_full", (4, 4, 6, 5), torch.float32),     # odd X
    ("wilson_full", (4, 6, 22, 16), torch.float32),   # Y = 22, 8-row tile
    ("wilson_full", (4, 4, 6, 5), torch.bfloat16),    # odd X: one-site
    ("wilson_full", (4, 2, 12, 32), torch.bfloat16)]  # pair, ragged


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("case", TILE_CASES, ids=lambda c: "-".join(
    (c[0], "x".join(map(str, c[1])), str(c[2]).removeprefix("torch."))))
def test_every_tile_is_bitwise_the_default(dev, case, n):
    """Every candidate tile of the launch space (b over Y's divisors and
    0, K4's block-order chunks over T's) and one ragged b give the default
    tile's bits: a tile moves data, it never reorders a site's sums."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.dispatch import TileConfig
    kernel, dims, dtype = case
    fn = autotune.problem(kernel, dims, n, dtype, dev)
    tiles = autotune.candidates(kernel, dims, n, dtype)
    tiles.append(TileConfig(b=5, tchunk=tiles[0].tchunk))   # ragged rows
    with autotune.forced(tiles[0]):
        want = fn()
    kernels.reset_counts()
    for tile in tiles:
        with autotune.forced(tile):
            assert torch.equal(fn(), want), tile
    c = kernels.counts()[kernel + ("_bf16" if dtype == torch.bfloat16
                                   else "")]
    assert c["launches"] == len(tiles) and c["plain_calls"] == 0
    if dtype == torch.bfloat16 and dims[3] % 2 == 0 and (
            kernel == "wilson_hop" or dims[3] == 32):
        assert kernels.pair_launches()[kernel + "_bf16"] == len(tiles)


def test_a_tile_that_does_not_fit_raises_before_the_launch(dev):
    from repro_torch.kernels import autotune
    from repro_torch.kernels.dispatch import TileConfig
    hop = autotune.problem("wilson_hop", (4, 4, 8, 4), 1, torch.float32, dev)
    full = autotune.problem("wilson_full", (6, 4, 8, 8), 2, torch.float32,
                            dev)
    kernels.reset_counts()
    for fn, tile, match in (
            (hop, TileConfig(b=9), r"b=9 does not fit the Y extent 8"),
            (full, TileConfig(b=9), r"b=9 does not fit the Y extent 8"),
            (full, TileConfig(tchunk=4), r"legal tchunk values for T=6")):
        with autotune.forced(tile), pytest.raises(ValueError, match=match):
            fn()
    assert all(v["launches"] == 0 for v in kernels.counts().values())


def test_a_pair_instance_tile_is_refused_not_replaced(dev):
    """K4's bf16 pair instance (X = 32) stages its links: b = 0 raises in
    the wrapper; it is never swapped for the one-site instance."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.dispatch import TileConfig
    fn = autotune.problem("wilson_full", (4, 4, 8, 32), 1, torch.bfloat16,
                          dev)
    kernels.reset_counts()
    with autotune.forced(TileConfig(b=0)), pytest.raises(
            ValueError, match="pair instance stages its links"):
        fn()
    assert kernels.counts()["wilson_full_bf16"]["launches"] == 0
    with autotune.forced(TileConfig(b=1)):
        fn()
    assert kernels.pair_launches()["wilson_full_bf16"] == 1


def test_synthetic_lm_draws_the_same_prompt_every_time(dev):
    """The served prompt is SyntheticLM's batch 0: drawn eight times on the
    card at recurrentgemma's full vocabulary and 4 x 2112 tokens, every
    draw is the same (``torch.multinomial`` on an H100 drew 36-57 other
    tokens on every call with the same seed; scripts/token_draws.py)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    cfg = configs.get("recurrentgemma-9b")
    draws = [SyntheticLM(cfg, batch=4, seq_len=2112, seed=0,
                         device=str(dev)).batch_at(0)["tokens"]
             for _ in range(8)]
    assert all(torch.equal(d, draws[0]) for d in draws[1:])
