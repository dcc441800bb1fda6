"""Port vs JAX: the full-lattice slice (the full-lattice kernel K4 and the
``operator="full"`` solve).  This file and three more hold it:
``tests/test_torch_full_oracle.py`` (``ops.dslash`` against JAX's
oracles), ``tests/test_torch_full_algorithm.py`` (K4's emulated
algorithm at the fixture's shapes and its bf16 pair instance) and
``tests/test_torch_full_ragged.py`` (the algorithm at odd and ragged
shapes); they import the fixture, the emulation and the helpers here.

* ``core.wilson``'s full-lattice functions (natural dagger and normal
  operator, the packed split/merge, ``hop_term_packed``,
  ``dslash_packed`` and its dagger and normal operator) against
  ``repro.core.wilson`` at 4^4 and 4x6x8x16.
* ``ops.dslash`` against the JAX package's jnp oracle
  (``ops.dslash(use_pallas=False)``) for every (gamma5_in, gamma5_out,
  twist) at N = 1 and N = 3, and against the JAX Pallas kernel
  interpreted in three launches that together set each flag on and off
  and cover N = 3 (an interpreted launch costs seconds here).
* K4's algorithm, emulated here (this machine cannot run it) with its
  tile plan (``full_tile_plan``), the rows each tile stages in their
  slots, the slots and X indices its compute loop reads, one pass per
  output colour, its compile-time spin structure (``hop_spec``) and its
  site coefficients, against its plain version for every flag
  combination, also at odd and ragged shapes; the plan's sizes; the
  staged rows cover every neighbour.
* K4's bf16 pair instance (X = 32: two sites a thread, every component
  of both read as one 32-bit word, the X hops' unaligned pairs from the
  words around them), emulated on bf16 fields: bitwise the one-site
  emulation's, within 1 bf16 ulp of the plain version; the tile plan at
  esize 2, X = 32 and other widths.
* ``normal_op`` is two kernel calls for any N.
* ``plan.solve(SolverPlan(operator="full"))`` on the 4^4, seed-7,
  mass-0.1, tol-1e-6 problem of the JAX solver goldens: 27 iterations
  for Wilson, twisted mass at mu = 0.25 and each RHS of a 4-RHS batch,
  as the JAX reference backend takes; x agrees with JAX to 1e-4
  relative; a batch equals its own single solves bitwise; the packed
  layout agrees with the natural one.

Tolerance on fields: max-abs error <= 1e-5 times max(1, max |reference|),
the slack of f32 sums taken in another order (entries of the normal
operator reach ~70, where one f32 ulp is ~8e-6).
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SolverPlan as JaxPlan
from repro.core import lattice as jl
from repro.core import solve_plan as jax_solve
from repro.core import wilson as jw
from repro.kernels.wilson_dslash import ops as jops
from repro_torch.core import lattice as tl
from repro_torch.core import plan as tplan
from repro_torch.core import solvers
from repro_torch.core import wilson as tw
from repro_torch.core.lattice import fields_from_numpy, pack_gauge, pack_spinor
from repro_torch.kernels import counts, reset_counts
from repro_torch.kernels.wilson_dslash import kernel as tk
from repro_torch.kernels.wilson_dslash import ops as tops
from repro_torch.kernels.wilson_dslash.ref import wilson_full_ref
from repro_torch.launch import solve as cli

import torch_one_thread  # noqa: F401  (one intra-op thread)

MASS, TOL = 0.1, 1e-6
SHAPES = [jl.LatticeShape(4, 4, 4, 4), jl.LatticeShape(4, 6, 8, 16)]
# (gamma5_in, gamma5_out, twist): twist != 0 with both flags is the dagger
FLAGS = list(itertools.product((False, True), (False, True), (0.0, 0.25)))


def T(a):
    return torch.from_numpy(np.array(a))


def close(ours, ref, tol=1e-5):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    err = np.max(np.abs(ours - ref))
    assert err <= tol * max(1.0, np.max(np.abs(ref))), err


@pytest.fixture(scope="module", params=SHAPES, ids=str)
def fields(request):
    lat = request.param
    ku, kb = jax.random.split(jax.random.PRNGKey(51))
    u = jl.random_gauge(ku, lat)
    b = jnp.stack([jl.random_spinor(jax.random.fold_in(kb, i), lat)
                   for i in range(3)])
    return dict(u=np.asarray(u), b=np.asarray(b[0]),
                up=np.asarray(jl.pack_gauge(u)),
                pp=np.asarray(jl.pack_spinor(b)))


# ---------------------------------------------------------------------------
# core.wilson: the full-lattice oracles
# ---------------------------------------------------------------------------


def test_natural_dagger_and_normal_op_match_jax(fields):
    u, b = fields["u"], fields["b"]
    close(tw.dslash_dagger(T(u), T(b), MASS), jw.dslash_dagger(u, b, MASS))
    close(tw.normal_op(T(u), T(b), MASS), jw.normal_op(u, b, MASS))


def test_packed_split_and_merge_match_jax(fields):
    pp, up = fields["pp"][0], fields["up"]
    for ours, ref in zip(tw._split_packed_spinor(T(pp)),
                         jw._split_packed_spinor(pp)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for ours, ref in zip(tw._split_packed_gauge(T(up)),
                         jw._split_packed_gauge(up)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    re, im = tw._split_packed_spinor(T(pp))
    np.testing.assert_array_equal(tw._merge_packed_spinor(re, im).numpy(),
                                  pp)


@pytest.mark.parametrize("mu", range(4))
@pytest.mark.parametrize("forward", [True, False])
def test_hop_term_packed_matches_jax(fields, mu, forward):
    up, pp = fields["up"], fields["pp"][0]
    close(tw.hop_term_packed(T(up[mu]), T(pp), mu, forward),
          jw.hop_term_packed(up[mu], pp, mu, forward))


def test_dslash_packed_family_matches_jax(fields):
    up, pp, u, b = fields["up"], fields["pp"][0], fields["u"], fields["b"]
    close(tw.dslash_packed(T(up), T(pp), MASS),
          jw.dslash_packed(up, pp, MASS))
    close(tw.dslash_dagger_packed(T(up), T(pp), MASS),
          jw.dslash_dagger_packed(up, pp, MASS))
    close(tw.normal_op_packed(T(up), T(pp), MASS),
          jw.normal_op_packed(up, pp, MASS))
    # the packed operator is the natural one on the wire format
    close(tw.dslash_packed(T(jl.pack_gauge(u)), T(jl.pack_spinor(b)), MASS),
          jl.pack_spinor(jw.dslash(u, b, MASS)))
    assert tw.dslash_flops(100) == jw.dslash_flops(100) == 132000


# ---------------------------------------------------------------------------
# ops: the full-lattice entry points over K4
# ---------------------------------------------------------------------------


UNIT = (1, 1j, -1, -1j)   # i^k


def full_block_tile(i, dims, b, n, tchunk=None):
    """csrc/wilson_full.cu ``make_tile``: block i's tile (t, z, y-tile):
    y-tile fastest, then t within a chunk of ``tchunk`` planes (by
    default ``kernel.full_tchunk``'s rule: 4 when n > 1 and 4 | T, else
    1), then z, then the chunk."""
    T, Z, Y = dims
    tchunk = tk.full_tchunk(T, n, tchunk)
    nyb = -(-Y // b)
    rest = i // nyb
    zc = rest // tchunk
    return (zc // Z) * tchunk + rest % tchunk, zc % Z, i % nyb


def full_tile_links(dims, b, t, z, yb):
    """csrc/wilson_full.cu ``link_src``: the link rows a tile stages, as
    {slot: (mu, t, z, y)}.  Slot g*b + i holds group g of u_t, u_t(t-1),
    u_z, u_z(z-1), u_x at y0 + i; slot 5b + k the u_y row y0-1+k (Y
    wrapped)."""
    T, Z, Y = dims
    y0 = yb * b
    nb = min(b, Y - y0)
    tm, zm = (t - 1) % T, (z - 1) % Z
    links = {}
    for i in range(nb):
        y = y0 + i
        for g, row in enumerate(((0, t, z, y), (0, tm, z, y), (1, t, z, y),
                                 (1, t, zm, y), (3, t, z, y))):
            links[g * b + i] = row
    for k in range(nb + 1):
        links[5 * b + k] = (2, t, z, (y0 - 1 + k) % Y)
    return links


def full_site_reads(dims, b, t, z, y0, r, x):
    """The kernel's loop body for site (r, x) of the tile at (t, z, y0): per
    hop (mu, forward) the neighbour spinor it reads from the field (t, z,
    y, x) and the staged link slot and X index (r, x may be index
    arrays)."""
    T, Z, Y, X = dims
    y = y0 + r
    tp, tm, zp, zm = (t + 1) % T, (t - 1) % T, (z + 1) % Z, (z - 1) % Z
    yp, ym, xp, xm = (y + 1) % Y, (y - 1) % Y, (x + 1) % X, (x - 1) % X
    return [((0, True), (tp, z, y, x), 0 * b + r, x),
            ((0, False), (tm, z, y, x), 1 * b + r, x),
            ((1, True), (t, zp, y, x), 2 * b + r, x),
            ((1, False), (t, zm, y, x), 3 * b + r, x),
            ((2, True), (t, z, yp, x), 5 * b + r + 1, x),
            ((2, False), (t, z, ym, x), 5 * b + r, x),
            ((3, True), (t, z, y, xp), 4 * b + r, x),
            ((3, False), (t, z, y, xm), 4 * b + r, xm)]


def _cplx(rows, shape):
    """Packed components on the last axis -> complex (..., *shape)."""
    q = rows.reshape(rows.shape[:-1] + shape + (2,))
    return torch.complex(q[..., 0], q[..., 1])


def full_pair_words(x_, hop):
    """K4's pair kernel (csrc/wilson_full.cu ``wilson_full_pair_kernel``):
    for each site x = 2 xp + h of a row, the word (its even element index)
    and the half (0 low, 1 high) that its hop reads, for the spinor and
    for the link: the pair's own word, but for the X hops the neighbours
    x + 1 (the high half of its own word for site 0, the low half of the
    next pair's for site 1) and x - 1 (the high half of the previous
    pair's word for site 0, the low half of its own for site 1), wrapped
    at the row's ends; the backward X link likewise."""
    x = torch.arange(x_)
    h, x0 = x % 2, x - x % 2
    own = (x0, h)
    if hop == (3, True):
        return (torch.where(h == 0, x0, (x0 + 2) % x_), 1 - h), own
    if hop == (3, False):
        back = (torch.where(h == 0, (x0 - 2) % x_, x0), 1 - h)
        return back, back
    return own, own


def _widen_half(words, half, dtype=torch.bfloat16):
    """``wilson::half``: the half (0 low, 1 high) of 32-bit words of bf16
    pairs as f32, the selected half in the high 16 bits, zeros below; of
    float16 pairs, the selected half converted."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    if dtype == torch.float16:
        bits = torch.where(half == 1, w >> 16, w & 0xFFFF)
        bits = torch.where(bits >= 2 ** 15, bits - 2 ** 16, bits)
        return bits.to(torch.int16).view(torch.float16).float()
    bits = torch.where(half == 1, w & 0xFFFF0000, (w & 0xFFFF) << 16)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def emulate_wilson_full(up, pp, mass, *, twist, gamma5_in, gamma5_out,
                        pair=False, b=None, tchunk=None):
    """csrc/wilson_full.cu step by step: the host's tile plan, the link rows
    each tile stages (once for all N; the Y wrap included) in their slots,
    the loop body's spinor reads (from the field, X and Y wrapped) and link
    slots and X indices for every site of every tile at once, the
    compile-time projection/reconstruction of ``hop_spec`` (one projection
    per hop for all three colours), the SU(3) product (daggered for
    backward hops) and the epilogue: the site term of ``site_coeffs`` and
    the hops' sum scaled by -1/2.  Fields in their storage dtype (f32,
    bf16 or float16), staged as stored, widened where read, outputs
    rounded once.  ``pair``: the 16-bit pair instance, whose sites read
    their values as halves of 32-bit words (``full_pair_words``); the
    kernel runs hop by hop over its two sites, each link word read once
    for both (float16 at N = 1: one site's hops, then the other's), and
    each site's sums keep the one-site order, which this emulation,
    vectorised over sites and right-hand sides, computes.
    ``b``, ``tchunk``: a launch-space tile's rows and block order instead
    of the plan's."""
    m_hi, m_lo, tw_hi, tw_lo = tk.site_coeffs(mass, twist, gamma5_in,
                                              gamma5_out)
    batched = pp.dim() == 6
    ps = pp if batched else pp[None]
    n_rhs, t_, z_, y_, _, x_ = ps.shape
    dims = (t_, z_, y_, x_)
    if b is None:
        b, _ = tk.full_tile_plan(y_, x_, pp.element_size())
    assert b > 0
    assert not pair or tk.full_pair(x_, pp.element_size())
    tiles = [full_block_tile(i, dims[:3], b, n_rhs, tchunk)  # block order
             for i in range(t_ * z_ * -(-y_ // b))]
    lk = torch.zeros(len(tiles), 6 * b + 1, 18, x_, dtype=up.dtype)
    for i, (t, z, yb) in enumerate(tiles):
        for k, (mu, tt, zz, yy) in full_tile_links(dims[:3], b, t, z,
                                                   yb).items():
            lk[i, k] = up[mu, tt, zz, yy]
    if pair:    # words: (tile, slot, X/2, 18) and (N, T, Z, Y, X/2, 24)
        lk_w = lk.view(torch.int32).transpose(-1, -2)
        ps_w = ps.contiguous().view(torch.int32).transpose(-1, -2)
    lk = _cplx(lk.float().transpose(-1, -2), (3, 3))    # (tile, slot, X, 3, 3)
    ps = _cplx(ps.float().transpose(-1, -2), (4, 3))    # (N, T, Z, Y, X, 4, 3)
    tix = torch.arange(len(tiles))[:, None, None]
    tt, zz, y0 = (torch.tensor([tile[k] * (b if k == 2 else 1)
                                for tile in tiles])[:, None, None]
                  for k in range(3))
    r = torch.arange(b)[None, :, None]
    x = torch.arange(x_)[None, None, :]
    # rows past a ragged tile's end read wrapped rows and are dropped below
    acc = torch.zeros(n_rhs, len(tiles), b, x_, 4, 3, dtype=torch.complex64)
    widen = functools.partial(_widen_half, dtype=pp.dtype)
    for (mu, fwd), (st, sz, sy, sx), slot, xl in full_site_reads(
            dims, b, tt, zz, y0, r, x):
        st, sz, sy, sx = torch.broadcast_tensors(st, sz, sy % y_, sx)
        v = ps[:, st, sz, sy, sx]                   # (N, tile, b, X, 4, 3)
        ti, slot, xl = torch.broadcast_tensors(tix, slot, xl)
        link = lk[ti, slot, xl]                     # (tile, b, X, 3, 3)
        if pair:    # the same values, read as halves of words
            (sw, sh), (lw, lh) = full_pair_words(x_, (mu, fwd))
            v = _cplx(widen(ps_w[:, st, sz, sy, sw // 2], sh[:, None]),
                      (4, 3))
            link = _cplx(widen(lk_w[ti, slot, lw // 2], lh[:, None]), (3, 3))
        if not fwd:
            link = link.conj().transpose(-1, -2)
        proj, recon = tk.hop_spec(mu, fwd, gamma5_in, gamma5_out)
        h = torch.stack([v[..., a, :] + UNIT[q] * v[..., col, :]
                         for a, (col, q) in enumerate(proj)], dim=-2)
        g = torch.einsum("...rc,n...ac->n...ar", link, h)
        acc[..., :2, :] += g
        for i, (src, ph) in enumerate(recon):
            acc[..., 2 + i, :] += UNIT[ph] * g[..., src, :]
    m = torch.tensor([m_hi, m_hi, m_lo, m_lo])[:, None]
    tw_s = torch.tensor([tw_hi, tw_hi, tw_lo, tw_lo])[:, None]
    st, sz, sy, sx = torch.broadcast_tensors(tt, zz, (y0 + r) % y_, x)
    centre = ps[:, st, sz, sy, sx]
    if pair:        # the pair's own words
        (sw, sh), _ = full_pair_words(x_, (0, True))
        centre = _cplx(widen(ps_w[:, st, sz, sy, sw // 2], sh[:, None]),
                       (4, 3))
    res = (m + 1j * tw_s) * centre - 0.5 * acc
    out = torch.empty(n_rhs, t_, z_, y_, x_, 4, 3, dtype=torch.complex64)
    for i, (t, z, yb) in enumerate(tiles):
        nb = min(b, y_ - yb * b)
        out[:, t, z, yb * b:yb * b + nb] = res[:, i, :nb]
    packed = torch.view_as_real(out).reshape(out.shape[:5] + (24,))
    packed = packed.permute(0, 1, 2, 3, 5, 4).contiguous().to(pp.dtype)
    return packed if batched else packed[0]


# (Y, X) -> K4's tile plan (b, ls): 32^3 x 64, the card checks' shapes
# (bulk staged 8^4 and 4x4x22x8; Y = 22 against an 8-row tile at X = 16;
# odd X, staged by plain loads; one-row tiles at X = 348; rows too wide,
# read in place) and 4x6x8x16
FULL_PLANS = {(32, 32): (4, 576), (8, 8): (8, 168), (22, 8): (11, 168),
              (22, 16): (8, 304), (6, 5): (6, 90), (8, 16): (8, 304),
              (2, 348): (1, 6264), (2, 464): (0, 8352)}


@pytest.mark.parametrize("yx", list(FULL_PLANS), ids=lambda k: "%dx%d" % k)
def test_full_tile_plan(yx):
    y, x = yx
    b, ls = tk.full_tile_plan(y, x)
    assert (b, ls) == FULL_PLANS[yx]
    if x % 4 == 0 and x < 32:    # padded: a warp's rows in distinct banks
        assert ls >= 18 * x and ls % 32 == x % 32
    else:
        assert ls == 18 * x
    if b == 0:                   # one row at b = 1 is past the card's limit
        assert tk.full_smem_bytes(1, ls) > tk.HOP_SMEM_LIMIT
        return
    assert b * x <= max(tk.FULL_TILE_SITES, x)
    # a divisor of Y where one of at least half the sites exists
    bmax = max(1, min(y, tk.FULL_TILE_SITES // x))
    if any(y % d == 0 for d in range(-(-bmax // 2), bmax + 1)):
        assert y % b == 0
    smem = tk.full_smem_bytes(b, ls)
    assert smem == (4 + (6 * b + 1) * ls) * 4 <= tk.HOP_SMEM_LIMIT
    if b > 1:                    # two tiles fit in an SM's shared memory
        assert 2 * smem <= tk.HOP_SMEM_LIMIT
    if yx == (32, 32):           # three 128-thread blocks per SM
        assert smem == 57616 and 3 * smem <= tk.HOP_SMEM_LIMIT


def _full_true_reads(dims, t, z, y, x):
    """Per hop, the neighbour's spinor site and the link (mu, site) a site
    needs, from the operator's definition."""
    T, Z, Y, X = dims
    return {(0, True): ((t + 1) % T, z, y, x, (0, t, z, y, x)),
            (0, False): ((t - 1) % T, z, y, x, (0, (t - 1) % T, z, y, x)),
            (1, True): (t, (z + 1) % Z, y, x, (1, t, z, y, x)),
            (1, False): (t, (z - 1) % Z, y, x, (1, t, (z - 1) % Z, y, x)),
            (2, True): (t, z, (y + 1) % Y, x, (2, t, z, y, x)),
            (2, False): (t, z, (y - 1) % Y, x, (2, t, z, (y - 1) % Y, x)),
            (3, True): (t, z, y, (x + 1) % X, (3, t, z, y, x)),
            (3, False): (t, z, y, (x - 1) % X, (3, t, z, y, (x - 1) % X))}


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("dims", [(64, 32, 32), (4, 4, 22), (3, 5, 7),
                                  (8, 2, 6)], ids=lambda d: "x".join(
                                      map(str, d)))
def test_full_block_order_visits_every_tile_once(dims, n):
    t_, z_, y_ = dims
    b, _ = tk.full_tile_plan(y_, 32)
    nyb = -(-y_ // b)
    order = [full_block_tile(i, dims, b, n) for i in range(t_ * z_ * nyb)]
    assert sorted(order) == [(t, z, yb) for t in range(t_)
                             for z in range(z_) for yb in range(nyb)]
    if n > 1 and t_ % 4 == 0:   # the first 4 planes of one z line come first
        assert [tl[0] for tl in order[:4 * nyb:nyb]] == [0, 1, 2, 3]


@pytest.mark.parametrize("dims", [(4, 4, 4, 4), (8, 8, 8, 8), (4, 4, 22, 16),
                                  (4, 4, 6, 5), (3, 5, 7, 32)],
                         ids=lambda d: "x".join(map(str, d)))
def test_full_staged_rows_cover_every_neighbour(dims):
    """Every K4 block stages, in the slot its loop body reads, the link row
    of every hop of each of its sites (the backward Y link and its wrap,
    the backward X link and its wrap included): 6 nb + 1 rows, once for
    all N; the loop body reads every neighbour spinor where the operator
    needs it; no slot lies outside the shared memory the plan sizes; every
    site is in one tile."""
    t_, z_, y_, x_ = dims
    b, ls = tk.full_tile_plan(y_, x_)
    assert b > 0 and tk.full_smem_bytes(b, ls) <= tk.HOP_SMEM_LIMIT
    covered = []
    for t in range(t_):
        for z in range(z_):
            for yb in range(-(-y_ // b)):
                links = full_tile_links((t_, z_, y_), b, t, z, yb)
                nb = min(b, y_ - yb * b)
                assert len(links) == 6 * nb + 1 and max(links) < 6 * b + 1
                for r in range(nb):
                    y = yb * b + r
                    for x in range(x_):
                        covered.append((t, z, y, x))
                        want = _full_true_reads(dims, t, z, y, x)
                        for hop, site, slot, xl in full_site_reads(
                                dims, b, t, z, yb * b, r, x):
                            *nbr, (mu, *lsite) = want[hop]
                            assert site == tuple(nbr), hop
                            assert links[slot] + (xl,) == (mu, *lsite), hop
    assert sorted(covered) == sorted(set(covered))
    assert len(covered) == t_ * z_ * y_ * x_


# the 16-bit storage types' 1-ulp bars: (the floor as a share of the
# field's largest entry, significant bits)
ULP_BARS = {torch.bfloat16: (2.0 ** -16, 8), torch.float16: (2.0 ** -13, 11)}


def _within_one_ulp(out, ref):
    """At most 1 ulp of the 16-bit storage type an entry; an entry that
    cancels below the floor (2^-16 of the field's largest for bf16, 2^-13
    for float16) is held to the ulp at that floor (the bar of
    tests/test_torch_cuda.py and chip_smoke.py)."""
    assert out.dtype == ref.dtype and out.dtype in ULP_BARS
    share, digits = ULP_BARS[out.dtype]
    bits = [v.contiguous().view(torch.int16).int() for v in (out, ref)]
    ords = [torch.where(v < 0, -(v & 0x7FFF), v) for v in bits]
    a, b = out.double(), ref.double()
    _, e = torch.frexp(share * b.abs().max())
    floor = torch.ldexp(torch.ones((), dtype=torch.float64), e - digits)
    ok = ((ords[0] - ords[1]).abs() <= 1) | ((a - b).abs() <= floor)
    assert bool(ok.all()), float((a - b).abs().max())


def _bf16_within_one_ulp(out, ref):
    assert out.dtype == torch.bfloat16
    _within_one_ulp(out, ref)


def _full_pair_case(up, pp, flags):
    g5in, g5out, twist = flags
    kw = dict(twist=twist, gamma5_in=g5in, gamma5_out=g5out)
    pair = emulate_wilson_full(up, pp, MASS, pair=True, **kw)
    assert torch.equal(pair, emulate_wilson_full(up, pp, MASS, **kw))
    _bf16_within_one_ulp(pair, wilson_full_ref(up, pp, MASS, **kw))
    return pair, kw


def _bf16_fields(dims, n, seed, dtype=torch.bfloat16):
    gen = torch.Generator().manual_seed(seed)
    lat = tl.LatticeShape(*dims)
    up = pack_gauge(tl.random_gauge(gen, lat), dtype)
    pp = pack_spinor(torch.stack([tl.random_spinor(gen, lat)
                                  for _ in range(n)]), dtype)
    return up, pp


# (Y, X) -> K4's bf16 plan (b, ls): X = 32 runs the pair instance, 256
# sites a tile (b = 8 at 32^3 x 64, a thread per two sites), other widths
# the one-site one, 128 sites as in f32; X = 928 reads its links in place
FULL_BF16_PLANS = {(32, 32): (8, 576), (7, 32): (7, 576), (6, 32): (6, 576),
                   (8, 8): (8, 200), (22, 16): (8, 336), (6, 6): (6, 108),
                   (6, 5): (6, 90), (2, 464): (1, 8352), (2, 928): (0, 16704)}


@pytest.mark.parametrize("yx", list(FULL_BF16_PLANS),
                         ids=lambda k: "%dx%d" % k)
def test_full_tile_plan_bf16(yx):
    y, x = yx
    b, ls = tk.full_tile_plan(y, x, esize=2)
    assert (b, ls) == FULL_BF16_PLANS[yx]
    pair = tk.full_pair(x, 2)
    assert pair == (x == 32) and not tk.full_pair(x, 4)
    if b == 0:
        assert tk.full_smem_bytes(1, ls, 2) > tk.HOP_SMEM_LIMIT
        return
    sites = tk.FULL_TILE_SITES * (2 if pair else 1)
    assert b * x <= max(sites, x)
    if b > 1:
        assert 2 * tk.full_smem_bytes(b, ls, 2) <= tk.HOP_SMEM_LIMIT
    if pair:
        assert ls % 2 == 0
    if yx == (32, 32):   # 128 threads, three blocks an SM
        assert b * x // 2 == 128
        assert 3 * tk.full_smem_bytes(b, ls, 2) <= tk.HOP_SMEM_LIMIT


@pytest.mark.parametrize("twist", [0.0, 0.25])
def test_dslash_dagger_is_the_adjoint(fields, twist):
    # <phi, D psi> = <D^dag phi, psi>; the real dot of packed fields is the
    # real part of the complex one (f64, so only the algebra is tested)
    up, pp = T(fields["up"]).double(), T(fields["pp"]).double()
    phi, psi = pp[0], pp[1]
    kw = dict(twist=twist, use_kernels=False)
    lhs = (phi * tops.dslash(up, psi, MASS, **kw)).sum()
    rhs = (tops.dslash_dagger(up, phi, MASS, **kw) * psi).sum()
    assert abs(float(lhs - rhs)) <= 1e-12 * float(phi.norm() * psi.norm())


@pytest.mark.parametrize("n", [1, 4])
def test_normal_op_is_two_calls_for_any_n(fields, n):
    up, pp = fields["up"], fields["pp"]
    v = pp[0] if n == 1 else np.concatenate([pp, pp[:1]])
    reset_counts()
    out = tops.normal_op(T(up), T(v), MASS, twist=0.25)
    c = counts()
    assert c["wilson_full"] == {"launches": 0, "plain_calls": 2}
    assert all(c[k]["plain_calls"] == 0 for k in c if k != "wilson_full")
    close(out, jops.normal_op(up, v, MASS, twist=0.25, use_pallas=False))


def test_batched_dslash_equals_looped(fields):
    up, pp = T(fields["up"]), T(fields["pp"])
    out = tops.dslash(up, pp, MASS, twist=0.25, gamma5_in=True,
                      gamma5_out=True)
    for i in range(pp.shape[0]):
        assert torch.equal(out[i], tops.dslash(up, pp[i], MASS, twist=0.25,
                                               gamma5_in=True,
                                               gamma5_out=True))


def test_wrapper_rejects_bad_operands(fields):
    up, pp = T(fields["up"]), T(fields["pp"])
    with pytest.raises(ValueError, match="does not match"):
        tk.wilson_full(up, pp[..., :2], MASS)
    with pytest.raises(ValueError, match="rank"):
        tk.wilson_full(up, pp[0, 0], MASS)
    # bf16 (mixed precision, A8) and float16 (Queue B item 9) are storage
    # types of the kernel; float64 is none
    with pytest.raises(NotImplementedError, match="float16"):
        tk.wilson_full(up.double(), pp.double(), MASS)
    assert tk.wilson_full(up.half(), pp.half(), MASS).dtype == torch.float16
    # a mesh block's ghost planes: one plane of the block along a sharded
    # axis (T, Z or Y) and U of that axis at the previous rank's edge
    t_plane = pp.narrow(pp.dim() - 5, 0, 1)
    u_t = up[0].narrow(0, 0, 1)
    assert tk.wilson_full(up, pp, MASS, halo={0: (t_plane, t_plane, u_t)}
                          ).shape == pp.shape
    with pytest.raises(ValueError, match="halo axis"):
        tk.wilson_full(up, pp, MASS, halo={3: (t_plane, t_plane, u_t)})
    with pytest.raises(ValueError, match=r"halo\[1\] psi_prev must be"):
        tk.wilson_full(up, pp, MASS, halo={1: (t_plane, t_plane, u_t)})
    with pytest.raises(ValueError, match=r"halo\[0\] u_prev must be"):
        tk.wilson_full(up, pp, MASS, halo={0: (t_plane, t_plane,
                                               u_t.half())})


# ---------------------------------------------------------------------------
# plan.solve(operator="full") against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def problem():
    lat = jl.LatticeShape(4, 4, 4, 4)
    ku, kb = jax.random.split(jax.random.PRNGKey(7))
    u, b = jl.random_gauge(ku, lat), jl.random_spinor(kb, lat)
    batch = jnp.stack([jl.random_spinor(jax.random.fold_in(kb, i), lat)
                       for i in range(4)])
    ut, bt = fields_from_numpy(np.asarray(u), np.asarray(b), device="cpu")
    _, batch_t = fields_from_numpy(np.asarray(u), np.asarray(batch),
                                   device="cpu")
    return dict(u=u, b=b, batch=batch, ut=ut, bt=bt, batch_t=batch_t)


def _port(problem, b, layout="natural", u=None, **plan_kw):
    plan = tplan.SolverPlan(operator="full", **plan_kw)
    return tplan.solve(plan, problem["ut"] if u is None else u, b, MASS,
                       tol=TOL, maxiter=1000, layout=layout, device="cpu")


def _close_rel(x, ref, tol=1e-4):
    ref = np.asarray(ref)
    err = np.max(np.abs(x.numpy() - ref))
    assert err <= tol * np.max(np.abs(ref)), err


@pytest.mark.parametrize("family,mu", [("wilson", 0.0),
                                       ("twisted-mass", 0.25)])
def test_full_solve_matches_jax_and_goldens(problem, family, mu):
    reset_counts()
    x, st = _port(problem, problem["bt"], operator_family=family, mu=mu)
    k = st.iterations
    assert k == 27
    assert int(st.verdict) == solvers.CONVERGED and bool(st.verified)
    assert int(st.matvecs) == k
    # the launch accounting the chip run asserts, on the plain versions
    c = counts()
    assert c["wilson_full"]["plain_calls"] == 2 * k + 1
    assert all(c[n]["plain_calls"] == 0 for n in ("wilson_hop", "cg_update",
                                                  "cg_xpay"))
    assert all(v["launches"] == 0 for v in c.values())
    xj, sj = jax_solve(JaxPlan(operator="full", operator_family=family,
                               mu=mu, backend="reference"),
                       problem["u"], problem["b"], MASS, tol=TOL,
                       maxiter=1000)
    assert int(sj.iterations) == 27 and bool(sj.verified)
    _close_rel(x, xj)
    xr, sr = _port(problem, problem["bt"], operator_family=family, mu=mu,
                   backend="reference")
    assert sr.iterations == 27 and bool(sr.verified)
    _close_rel(xr, xj)


def test_full_batch_matches_jax_and_singles(problem):
    x4, st4 = _port(problem, problem["batch_t"], nrhs=4)
    assert st4.rhs_iterations.tolist() == [27] * 4
    assert st4.iterations == 27 and bool(st4.verified.all())
    xj, sj = jax_solve(JaxPlan(operator="full", backend="reference",
                               nrhs=4), problem["u"], problem["batch"],
                       MASS, tol=TOL, maxiter=1000)
    assert np.asarray(sj.rhs_iterations).tolist() == [27] * 4
    _close_rel(x4, xj)
    for i in (0, 3):
        xi, sti = _port(problem, problem["batch_t"][i])
        assert sti.iterations == 27
        assert torch.equal(xi, x4[i])


def test_packed_layout_agrees_with_natural(problem):
    up = pack_gauge(problem["ut"])
    x, st = _port(problem, problem["bt"])
    reset_counts()
    xp, stp = _port(problem, pack_spinor(problem["bt"]), layout="packed",
                    u=up)
    # the packed solve verifies through the kernel: one more call
    assert counts()["wilson_full"]["plain_calls"] == 2 * stp.iterations + 2
    assert stp.iterations == st.iterations == 27 and bool(stp.verified)
    assert torch.equal(xp, pack_spinor(x))
    rel = float(stp.true_residual_norm2 / (pack_spinor(problem["bt"])
                                           ** 2).sum()) ** 0.5
    assert rel < 10 * TOL
    xb, stb = _port(problem, pack_spinor(problem["batch_t"][:2]),
                    layout="packed", u=up, nrhs=2)
    assert stb.rhs_iterations.tolist() == [27, 27]
    assert bool(stb.verified.all())


def test_packed_layout_errors(problem):
    up, bp = pack_gauge(problem["ut"]), pack_spinor(problem["bt"])
    with pytest.raises(ValueError, match="full-operator contract"):
        tplan.solve(tplan.SolverPlan(), up, bp, MASS, layout="packed",
                    device="cpu")
    with pytest.raises(ValueError, match="rank-5 packed"):
        _port(problem, bp[None], layout="packed", u=up)
    with pytest.raises(ValueError, match="rank-6 packed"):
        _port(problem, bp, layout="packed", u=up, nrhs=1)
    with pytest.raises(ValueError, match="layout must be"):
        _port(problem, problem["bt"], layout="wire")
    with pytest.raises(ValueError, match="even-odd context"):
        tplan.resolve(tplan.SolverPlan(operator="full"), problem["ut"], MASS)
    # the kernels store float32, bf16 and float16 (Queue B item 9, done);
    # float64 low storage runs on the reference backend only
    with pytest.raises(NotImplementedError, match="float16"):
        tplan.SolverPlan(operator="full", precision="mixed", low="float64")
    assert tplan.SolverPlan(operator="full", precision="mixed",
                            low="float16").low_dtype == torch.float16
    with pytest.raises(NotImplementedError, match="r=1"):
        _port(problem, problem["bt"], r=0.5)


def test_cli_parity_full(capsys):
    assert cli.main(["--lattice", "4x4x4x4", "--parity", "full",
                     "--solver", "cgnr", "--device", "cpu", "--mass", "0.1",
                     "--operator", "twisted-mass", "--mu", "0.25"]) == 0
    out = capsys.readouterr().out
    assert "operator=full" in out
    assert "verdict: converged verified=True" in out
