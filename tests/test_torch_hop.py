"""Port vs JAX: the parity hop kernel's module (K1, wilson_dslash).

* ``hop_block`` for every flag combination (parity, gamma5_in,
  gamma5_out, accumulator, twist) against the JAX package's pure-jnp hop
  oracle (the JAX Pallas kernel itself, in interpret mode, is held
  against the port in test_torch_hop_pallas.py).  Tolerance: <= 1e-5
  max-abs (f32 sums in another order).
* The CUDA kernel's algorithm, emulated here with its tile plan, the rows
  each tile stages, its compile-time spin structure and its neighbour
  index arithmetic (this machine cannot run it), against the plain
  version for every flag combination; the staged rows cover every
  neighbour; the spin structure is the projector.
* The bf16 pair instance's algorithm (two sites a thread, every component
  of both read as one 32-bit word of a staged row), emulated with its
  tile plan and its word and half selection, bitwise against the one-site
  emulation on the same bf16 inputs and within 1 bf16 ulp of the plain
  version; the tile plans at esize 2, even and odd widths.
* Launch accounting: the Schur normal operator is 4 hop calls for any N.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lattice as jl
from repro.kernels.wilson_dslash import ops as jops
from repro_torch.kernels import reset_counts
from repro_torch.kernels.wilson_dslash import kernel as tk
from repro_torch.kernels.wilson_dslash import ops as tops
from repro_torch.kernels.wilson_dslash.ref import wilson_hop_ref

import torch_one_thread  # noqa: F401  (one intra-op thread)

SHAPES = {"4x4x4x4": jl.LatticeShape(4, 4, 4, 4),
          "4x4x4x8": jl.LatticeShape(4, 4, 4, 8)}


@pytest.fixture(scope="module")
def packed():
    out = {}
    for name, lat in SHAPES.items():
        ku, kb = jax.random.split(jax.random.PRNGKey(31))
        u = jl.random_gauge(ku, lat)
        ue, uo = jl.split_eo_gauge(u)
        be = jnp.stack([jl.split_eo(jl.random_spinor(jax.random.fold_in(
            kb, i), lat))[0] for i in range(3)])
        out[name] = tuple(np.asarray(a) for a in (
            jl.pack_gauge(ue), jl.pack_gauge(uo), jl.pack_spinor(be)))
    return out


def T(a):
    return torch.from_numpy(np.array(a))


def _flags(which, g5in, g5out, acc, twist):
    return dict(which=which, gamma5_in=g5in, gamma5_out=g5out,
                hop_coeff=-0.3 if (acc or twist) else 1.0,
                hop_twist=0.2 if twist else 0.0,
                acc_coeff=1.7 if acc else 0.0,
                acc_twist=-0.4 if (acc and twist) else 0.0)


def _both(packed, shape, n, flags, acc, **jax_kw):
    upe, upo, pb = packed[shape]
    pb = pb[0] if n == 1 else pb[:n]
    ours = tops.hop_block(T(upe), T(upo), T(pb),
                          psi_acc=T(-0.5 * pb) if acc else None, **flags)
    ref = jops.hop_block(upe, upo, pb, psi_acc=-0.5 * pb if acc else None,
                         **flags, **jax_kw)
    return ours.numpy(), np.asarray(ref)


ALL_FLAGS = list(itertools.product(("eo", "oe"), (False, True),
                                   (False, True), (False, True),
                                   (False, True)))


@pytest.mark.parametrize("flags", ALL_FLAGS, ids=lambda f: "-".join(
    map(str, f)))
def test_hop_block_every_flag_matches_jax_oracle(packed, flags):
    which, g5in, g5out, acc, twist = flags
    ours, ref = _both(packed, "4x4x4x8", 3,
                      _flags(which, g5in, g5out, acc, twist), acc,
                      use_pallas=False)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The CUDA kernel's algorithm, emulated with its tile plan and spin structure
# ---------------------------------------------------------------------------

UNIT = (1, 1j, -1, -1j)   # i^k


def tile_rows(dims, b, t, z, yb):
    """csrc/wilson_hop.cu ``link_src``/``spin_src``: the rows a tile stages,
    as {slot: row}.  Links: slot g*b + i holds hop g's link row (field,
    mu, t, z, y); spinors: slots g*b + i the t+-1, z+-1 rows, 4b + k the
    centre rows y0-1 .. y0+nb (Y wrapped), 5b + 2 + i the accumulator."""
    T, Z, Y = dims
    y0 = yb * b
    nb = min(b, Y - y0)
    tp, tm, zp, zm = (t + 1) % T, (t - 1) % T, (z + 1) % Z, (z - 1) % Z
    links, spins, accs = {}, {}, {}
    for i in range(nb):
        y = y0 + i
        for mu in range(4):
            links[2 * mu * b + i] = ("out", mu, t, z, y)
        links[1 * b + i] = ("nbr", 0, tm, z, y)
        links[3 * b + i] = ("nbr", 1, t, zm, y)
        links[5 * b + i] = ("nbr", 2, t, z, (y - 1) % Y)
        links[7 * b + i] = ("nbr", 3, t, z, y)
        for g, (tt, zz) in enumerate(((tp, z), (tm, z), (t, zp), (t, zm))):
            spins[g * b + i] = (tt, zz, y)
        accs[5 * b + 2 + i] = (t, z, y)
    for k in range(nb + 2):
        spins[4 * b + k] = (t, z, (y0 - 1 + k) % Y)
    return links, spins, accs


def hop_reads(b, r, j, s_out, xh):
    """The kernel's compute loop: per hop (mu, forward) the spinor slot and
    X index, the link slot and X index that site (r, j) of a tile reads
    (r, j, s_out may be index arrays)."""
    jf, jb = (j + s_out) % xh, (j - (1 - s_out)) % xh
    return [((0, True), 0 * b + r, j, 0 * b + r, j),
            ((0, False), 1 * b + r, j, 1 * b + r, j),
            ((1, True), 2 * b + r, j, 2 * b + r, j),
            ((1, False), 3 * b + r, j, 3 * b + r, j),
            ((2, True), 4 * b + r + 2, j, 4 * b + r, j),
            ((2, False), 4 * b + r, j, 5 * b + r, j),
            ((3, True), 4 * b + r + 1, jf, 6 * b + r, j),
            ((3, False), 4 * b + r + 1, jb, 7 * b + r, jb)]


def _cplx(rows, shape):
    """Packed components on the last axis -> complex (..., *shape)."""
    q = rows.reshape(rows.shape[:-1] + shape + (2,))
    return torch.complex(q[..., 0], q[..., 1])


def pair_hop_reads(b, r, j, s_out, xh):
    """The pair kernel's compute loop (csrc/wilson_hop.cu
    ``wilson_hop_pair_kernel``): per hop (mu, forward) the spinor slot and
    the link slot, and for each site j = 2 jp + h of the tile the word
    (its even element index) and the half (0 low, 1 high) it reads there.
    The forward X neighbours are the elements j + s_out + (0, 1) of the
    pair, the backward ones j - 1 + s_out + (0, 1): one word and half per
    site, selected by s_out and wrapped at the row's ends."""
    h, j0 = j % 2, j - j % 2                   # site of the pair, its word
    jn, jv = (j0 + 2) % xh, (j0 - 2) % xh      # the next and previous pair
    xf = torch.where(h == 0, j0, torch.where(s_out == 1, jn, j0))
    sf = torch.where(h == 0, s_out, 1 - s_out)
    xb = torch.where(h == 1, j0, torch.where(s_out == 1, j0, jv))
    sb = torch.where(h == 0, 1 - s_out, s_out)
    own = (j0, h)
    return [((0, True), 0 * b + r, own, 0 * b + r, own),
            ((0, False), 1 * b + r, own, 1 * b + r, own),
            ((1, True), 2 * b + r, own, 2 * b + r, own),
            ((1, False), 3 * b + r, own, 3 * b + r, own),
            ((2, True), 4 * b + r + 2, own, 4 * b + r, own),
            ((2, False), 4 * b + r, own, 5 * b + r, own),
            ((3, True), 4 * b + r + 1, (xf, sf), 6 * b + r, own),
            ((3, False), 4 * b + r + 1, (xb, sb), 7 * b + r, (xb, sb))]


def widen_half(words, half):
    """``wilson::half``: the half (0 low, 1 high) of 32-bit words of bf16
    pairs as f32, the selected half in the high 16 bits, zeros below."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(half == 1, w & 0xFFFF0000, (w & 0xFFFF) << 16)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def word_reads(rows, slot, word, half):
    """Component values (..., K) that sites read as words: ``rows`` (slots,
    K, X) of bf16, the word at even element ``word`` of row ``slot``."""
    words = rows.contiguous().view(torch.int32).transpose(1, 2)  # slot, X/2, K
    slot, word, half = torch.broadcast_tensors(slot, word, half)
    return widen_half(words[slot, word // 2], half[..., None])


def emulate_wilson_hop(u_out, u_nbr, psi, *, parity, gamma5_in, gamma5_out,
                       psi_acc, acc_coeff, hop_coeff, acc_twist, hop_twist,
                       pair=False, b=None):
    """csrc/wilson_hop.cu step by step: the host's tile plan, the rows each
    tile stages (Y wrap included) in their slots, the compute loop's slots
    and X indices (all (r, j) of a tile at once, as the tile's threads
    run them), the compile-time projection/reconstruction of ``hop_spec``,
    the SU(3) row (daggered for backward hops) and the epilogue with the
    hop's -1/2 folded into the coefficients.  Fields in their storage
    dtype (f32 or bf16), staged as stored, widened where read, outputs
    rounded once.  ``pair``: the bf16 pair instance, whose sites read
    their values as halves of 32-bit words (``pair_hop_reads``).  ``b``:
    a launch-space tile's rows instead of the plan's."""
    batched = psi.dim() == 6
    psi = psi if batched else psi[None]
    acc = None if psi_acc is None else (psi_acc if batched else psi_acc[None])
    n_rhs, t_, z_, y_, _, xh = psi.shape
    if b is None:
        b, _, _ = tk.hop_tile_plan(y_, xh, psi.element_size())
    assert b > 0
    assert not pair or tk.hop_pair(xh, psi.element_size())
    fields = {"out": u_out, "nbr": u_nbr}
    hc = float(np.float32(-0.5) * np.float32(hop_coeff))
    ht = float(np.float32(-0.5) * np.float32(hop_twist))
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0])[:, None]
    out = torch.empty_like(psi)
    for t in range(t_):
        for z in range(z_):
            for yb in range(-(-y_ // b)):
                links, spins, accs = tile_rows((t_, z_, y_), b, t, z, yb)
                lk = torch.zeros(8 * b, 18, xh, dtype=psi.dtype)
                for k, (f, mu, tt, zz, yy) in links.items():
                    lk[k] = fields[f][mu, tt, zz, yy]
                nb = min(b, y_ - yb * b)
                r = torch.arange(nb)[:, None]
                j = torch.arange(xh)[None, :]
                s_out = (t + z + yb * b + r + parity) & 1
                for n in range(n_rhs):
                    sp = torch.zeros(6 * b + 2, 24, xh, dtype=psi.dtype)
                    for k, (tt, zz, yy) in spins.items():
                        sp[k] = psi[n, tt, zz, yy]
                    if acc is not None:
                        for k, (tt, zz, yy) in accs.items():
                            sp[k] = acc[n, tt, zz, yy]
                    o = torch.zeros(nb, xh, 4, 3, dtype=torch.complex64)
                    if pair:
                        reads = [(hop, word_reads(sp, ss, *sw),
                                  word_reads(lk, ls, *lw))
                                 for hop, ss, sw, ls, lw in pair_hop_reads(
                                     b, r, j, s_out, xh)]
                    else:
                        reads = []
                        for hop, ss, js, ls, jl in hop_reads(b, r, j, s_out,
                                                             xh):
                            ss, js, ls, jl = torch.broadcast_tensors(
                                ss, js, ls, jl)
                            reads.append((hop,
                                          sp.transpose(1, 2)[ss, js].float(),
                                          lk.transpose(1, 2)[ls, jl].float()))
                    for (mu, fwd), sv, lv in reads:
                        v = _cplx(sv, (4, 3))
                        u = _cplx(lv, (3, 3))
                        proj, recon = tk.hop_spec(mu, fwd, gamma5_in,
                                                  gamma5_out)
                        h = torch.stack([v[..., a, :] + UNIT[q] * v[..., col, :]
                                         for a, (col, q) in enumerate(proj)],
                                        dim=-2)
                        g = (torch.einsum("...rc,...ac->...ar", u, h) if fwd
                             else torch.einsum("...cr,...ac->...ar", u.conj(),
                                               h))
                        o[..., :2, :] += g
                        for i, (src, ph) in enumerate(recon):
                            o[..., 2 + i, :] += UNIT[ph] * g[..., src, :]
                    res = hc * o + 1j * ht * g5 * o
                    if acc is not None:
                        a = sp[5 * b + 2:5 * b + 2 + nb].transpose(1, 2)
                        if pair:    # the pair's own words
                            a = word_reads(sp, 5 * b + 2 + r, j - j % 2,
                                           j % 2)
                        a = _cplx(a.float(), (4, 3))
                        res = res + acc_coeff * a + 1j * acc_twist * g5 * a
                    rows = torch.view_as_real(res).reshape(nb, xh, 24)
                    out[n, t, z, yb * b:yb * b + nb] = rows.transpose(1, 2)
    return out if batched else out[0]


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("flags", ALL_FLAGS, ids=lambda f: "-".join(
    map(str, f)))
def test_kernel_algorithm_matches_plain_version(packed, flags, n):
    which, g5in, g5out, acc, twist = flags
    upe, upo, pb = (T(a) for a in packed["4x4x4x8"])
    pb = pb[0] if n == 1 else pb
    f = _flags(which, g5in, g5out, acc, twist)
    del f["which"]
    u_out, u_nbr = (upe, upo) if which == "eo" else (upo, upe)
    kw = dict(parity=0 if which == "eo" else 1,
              psi_acc=0.7 * pb if acc else None, **f)
    np.testing.assert_allclose(
        emulate_wilson_hop(u_out, u_nbr, pb, **kw).numpy(),
        wilson_hop_ref(u_out, u_nbr, pb, **kw).numpy(), rtol=0, atol=1e-5)


def bf16_within_one_ulp(out, ref):
    """At most 1 bf16 ulp an entry; an entry that cancels below 2^-16 of
    the field's largest, where f32 sums in another order differ by more
    than its own ulp, is held to the ulp at that floor (the bar of
    tests/test_torch_cuda.py and chip_smoke.py)."""
    assert out.dtype == ref.dtype == torch.bfloat16
    bits = [v.contiguous().view(torch.int16).int() for v in (out, ref)]
    ords = [torch.where(v < 0, -(v & 0x7FFF), v) for v in bits]
    a, b = out.double(), ref.double()
    _, e = torch.frexp(2.0 ** -16 * b.abs().max())
    floor = torch.ldexp(torch.ones((), dtype=torch.float64), e - 8)
    ok = ((ords[0] - ords[1]).abs() <= 1) | ((a - b).abs() <= floor)
    assert bool(ok.all()), float((a - b).abs().max())


def _pair_case(u_out, u_nbr, psi, flags):
    """The pair instance's emulation on bf16 fields: bitwise the one-site
    emulation's, within 1 bf16 ulp of the plain version."""
    which, g5in, g5out, acc, twist = flags
    f = _flags(which, g5in, g5out, acc, twist)
    del f["which"]
    if which == "oe":
        u_out, u_nbr = u_nbr, u_out
    kw = dict(parity=0 if which == "eo" else 1,
              psi_acc=(0.7 * psi).bfloat16() if acc else None, **f)
    pair = emulate_wilson_hop(u_out, u_nbr, psi, pair=True, **kw)
    assert torch.equal(pair, emulate_wilson_hop(u_out, u_nbr, psi, **kw))
    bf16_within_one_ulp(pair, wilson_hop_ref(u_out, u_nbr, psi, **kw))


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("flags", ALL_FLAGS, ids=lambda f: "-".join(
    map(str, f)))
def test_pair_algorithm_equals_one_site(packed, flags, n):
    """Xh = 4: two pairs a row, so every pair's unaligned X neighbours
    wrap at one of the row's ends; both parities give both s_out on
    every row."""
    upe, upo, pb = (T(a).bfloat16() for a in packed["4x4x4x8"])
    _pair_case(upe, upo, pb[0] if n == 1 else pb, flags)


@pytest.mark.parametrize("dims", [(4, 4, 4, 4), (4, 4, 6, 16),
                                  (4, 4, 22, 8)],
                         ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("flags", [("eo", False, True, True, False),
                                   ("oe", True, False, False, True),
                                   ("eo", True, True, True, True)],
                         ids=lambda f: "-".join(map(str, f)))
def test_pair_algorithm_other_widths(dims, flags):
    """Xh = 2 (one pair a row: its next and previous pair are itself),
    Xh = 8 (interior pairs), Y = 22 against an 11-row tile."""
    from repro_torch.core import lattice as tl
    gen = torch.Generator().manual_seed(71)
    lat = tl.LatticeShape(*dims)
    ue, uo = tl.split_eo_gauge(tl.random_gauge(gen, lat))
    psi = torch.stack([tl.split_eo(tl.random_spinor(gen, lat))[0]
                       for _ in range(2)])
    _pair_case(tl.pack_gauge(ue, torch.bfloat16),
               tl.pack_gauge(uo, torch.bfloat16),
               tl.pack_spinor(psi, torch.bfloat16), flags)


# (Y, Xh) -> K1's bf16 plan (b, ls, ss): even Xh runs the pair instance, 64
# sites a tile (b = 4 at 32^3 x 64), odd Xh the one-site one, 32 sites as
# in f32; Xh = 350 reads in place
HOP_BF16_PLANS = {(32, 16): (4, 336, 400), (4, 2): (4, 36, 48),
                  (22, 4): (11, 72, 96), (6, 8): (6, 200, 200),
                  (6, 3): (6, 54, 72), (8, 5): (4, 90, 120),
                  (2, 350): (0, 6300, 8400)}


@pytest.mark.parametrize("yx", list(HOP_BF16_PLANS),
                         ids=lambda k: "%dx%d" % k)
def test_hop_tile_plan_bf16(yx):
    y, xh = yx
    b, ls, ss = tk.hop_tile_plan(y, xh, esize=2)
    assert (b, ls, ss) == HOP_BF16_PLANS[yx]
    pair = tk.hop_pair(xh, 2)
    assert pair == (xh % 2 == 0) and not tk.hop_pair(xh, 4)
    if b == 0:
        assert tk.hop_smem_bytes(1, ls, ss, 2) > tk.HOP_SMEM_LIMIT
        return
    sites = tk.HOP_TILE_SITES * (2 if pair else 1)
    assert b * xh <= max(sites, xh)
    assert tk.hop_smem_bytes(b, ls, ss, 2) <= tk.HOP_SMEM_TARGET
    if pair:   # words: even strides; a thread per colour of two sites
        assert ls % 2 == 0 and ss % 2 == 0 and 3 * b * xh // 2 <= 256
    else:      # the one-site tile is the f32 sizing rule's
        assert tk._tile_plan(y, xh, tk.HOP_TILE_SITES, tk.hop_smem_bytes,
                             2) == (b, ls, ss)


def test_pair_launch_counts():
    """A pair launch counts as a launch of its storage type's instance
    (bf16 or float16) and as a pair launch of that type; a reset zeroes
    both."""
    from repro_torch import kernels
    from repro_torch.kernels import build
    kernels.reset_counts()
    build.count(tk.wilson_hop, "launches", torch.bfloat16, pair=True)
    build.count(tk.wilson_hop, "launches", torch.bfloat16)
    build.count(tk.wilson_full, "launches", torch.bfloat16, pair=True)
    build.count(tk.wilson_full, "launches", torch.float16, pair=True)
    assert kernels.counts()["wilson_hop_bf16"]["launches"] == 2
    assert kernels.counts()["wilson_full_f16"]["launches"] == 1
    assert kernels.pair_launches() == {"wilson_hop_bf16": 1,
                                       "wilson_hop_f16": 0,
                                       "wilson_full_bf16": 1,
                                       "wilson_full_f16": 1}
    kernels.reset_counts()
    assert kernels.pair_launches() == {"wilson_hop_bf16": 0,
                                       "wilson_hop_f16": 0,
                                       "wilson_full_bf16": 0,
                                       "wilson_full_f16": 0}


def _true_reads(dims, t, z, y):
    """Per hop, the neighbour's spinor row and the link row a site at
    (t, z, y) needs, from the operator's definition (X offsets aside)."""
    T, Z, Y = dims
    return {(0, True): ((t + 1) % T, z, y, ("out", 0, t, z, y)),
            (0, False): ((t - 1) % T, z, y, ("nbr", 0, (t - 1) % T, z, y)),
            (1, True): (t, (z + 1) % Z, y, ("out", 1, t, z, y)),
            (1, False): (t, (z - 1) % Z, y, ("nbr", 1, t, (z - 1) % Z, y)),
            (2, True): (t, z, (y + 1) % Y, ("out", 2, t, z, y)),
            (2, False): (t, z, (y - 1) % Y, ("nbr", 2, t, z, (y - 1) % Y)),
            (3, True): (t, z, y, ("out", 3, t, z, y)),
            (3, False): (t, z, y, ("nbr", 3, t, z, y))}


@pytest.mark.parametrize("dims", [(4, 4, 4, 4), (4, 4, 4, 6), (4, 6, 8, 16),
                                  (8, 8, 8, 8), (4, 4, 22, 8)],
                         ids=lambda d: "x".join(map(str, d)))
def test_staged_rows_cover_every_neighbour(dims):
    """Every block stages, in the slot the compute loop reads, the row of
    every neighbour and link that each of its sites needs; no slot lies
    outside the shared memory the plan sizes; every site is in one tile."""
    t_, z_, y_, x_ = dims
    xh = x_ // 2
    b, ls, ss = tk.hop_tile_plan(y_, xh)
    assert 0 < b <= y_ and b * xh <= max(tk.HOP_TILE_SITES, xh)
    assert tk.hop_smem_bytes(b, ls, ss) <= tk.HOP_SMEM_LIMIT
    assert ls >= 18 * xh and ss >= 24 * xh
    covered = set()
    for t in range(t_):
        for z in range(z_):
            for yb in range(-(-y_ // b)):
                links, spins, accs = tile_rows((t_, z_, y_), b, t, z, yb)
                assert max(links) < 8 * b
                assert max(spins) < 5 * b + 2 and min(accs) >= 5 * b + 2
                assert max(accs) < 6 * b + 2
                for r in range(min(b, y_ - yb * b)):
                    y = yb * b + r
                    assert accs[5 * b + 2 + r] == (t, z, y)
                    want = _true_reads((t_, z_, y_), t, z, y)
                    for j in range(xh):
                        covered.add((t, z, y, j))
                        s_out = (t + z + y) & 1
                        for hop, sslot, js, lslot, jl in hop_reads(
                                b, r, j, s_out, xh):
                            *prow, link = want[hop]
                            assert spins[sslot] == tuple(prow), (hop, r)
                            assert links[lslot] == link, (hop, r)
                            if hop[0] == 3:  # x +- 1 in full coordinates
                                x = 2 * j + s_out
                                x_nbr = (x + (1 if hop[1] else -1)) % x_
                                assert 2 * js + (1 - s_out) == x_nbr
                                assert jl == (j if hop[1] else js)
                            else:
                                assert js == jl == j
    assert len(covered) == t_ * z_ * y_ * xh


@pytest.mark.parametrize("mu", range(4))
@pytest.mark.parametrize("forward", [True, False])
def test_hop_spec_is_the_projector(mu, forward):
    """The compile-time projection and reconstruction, with both gamma5
    flags folded in, rebuild g5out (1 -+ g_mu) g5in row by row."""
    from repro_torch.core.wilson import GAMMA5, _projectors
    pm, pp = _projectors(1.0)
    proj_m = (pm if forward else pp)[mu]
    for g5in, g5out in itertools.product((False, True), (False, True)):
        want = ((GAMMA5 if g5out else np.eye(4)) @ proj_m
                @ (GAMMA5 if g5in else np.eye(4)))
        proj, recon = tk.hop_spec(mu, forward, g5in, g5out)
        got = np.zeros((4, 4), complex)
        for a, (col, q) in enumerate(proj):
            got[a, a] = 1
            got[a, col] += UNIT[q]
        for i, (src, ph) in enumerate(recon):
            got[2 + i] = UNIT[ph] * got[src]
        np.testing.assert_allclose(got, want, atol=0)


def test_batched_hop_equals_looped(packed):
    upe, upo, pb = (T(a) for a in packed["4x4x4x4"])
    kw = dict(which="eo", gamma5_out=True, psi_acc=pb, acc_coeff=4.1,
              hop_coeff=-1 / 4.1)
    out = tops.hop_block(upe, upo, pb, **kw)
    for n in range(pb.shape[0]):
        kw["psi_acc"] = pb[n]
        assert torch.equal(out[n], tops.hop_block(upe, upo, pb[n], **kw))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("twist", [0.0, 0.25])
def test_schur_normal_op_is_four_hops_for_any_n(packed, n, twist):
    upe, upo, pb = (T(a) for a in packed["4x4x4x4"])
    reset_counts()
    tops.schur_normal_op(upe, upo, pb[:n], 0.1, twist=twist)
    assert tk.wilson_hop.plain_calls == 4
    assert tk.wilson_hop.launches == 0  # CPU tensors: plain versions only


def test_full_lattice_entry_points_name_their_roadmap_item():
    # the full-lattice kernel stores float32, bf16 (mixed precision,
    # ROADMAP A8) and float16 (ROADMAP Queue B item 9); float64 is none
    up = torch.zeros(4, 4, 4, 4, 18, 4, dtype=torch.float64)
    pp = torch.zeros(4, 4, 4, 24, 4, dtype=torch.float64)
    for fn in (tops.dslash, tops.normal_op):
        with pytest.raises(NotImplementedError, match="float16"):
            fn(up, pp, 0.1)
    for dt in (torch.bfloat16, torch.float16):   # 16 bits in, 16 bits out
        for fn in (tops.dslash, tops.normal_op):
            assert fn(up.to(dt), pp.to(dt), 0.1).dtype == dt
    with pytest.raises(ValueError, match="which"):
        tops.hop_block(None, None, None, which="ee")


def test_wrapper_rejects_bad_operands(packed):
    upe, upo, pb = (T(a) for a in packed["4x4x4x4"])
    with pytest.raises(ValueError, match="does not match"):
        tk.wilson_hop(upe, upo, pb[..., :1], parity=0)
    with pytest.raises(ValueError, match="psi_acc"):
        tk.wilson_hop(upe, upo, pb, parity=0, psi_acc=pb[0])
