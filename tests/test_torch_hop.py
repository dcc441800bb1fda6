"""Port vs JAX: the parity hop kernel's module (K1, wilson_dslash).

* ``hop_block`` for every flag combination (parity, gamma5_in,
  gamma5_out, accumulator, twist) against the JAX package's pure-jnp hop
  oracle (the JAX Pallas kernel itself, in interpret mode, is held
  against the port in test_torch_hop_pallas.py).  Tolerance: <= 1e-5
  max-abs (f32 sums in another order).
* The CUDA kernel's arithmetic, emulated here with its host tables and
  its neighbour index arithmetic (this machine cannot run it), against
  the plain version for every flag combination.
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
# The CUDA kernel's algorithm, emulated with its tables and index arithmetic
# ---------------------------------------------------------------------------


def emulate_wilson_hop(u_out, u_nbr, psi, *, parity, gamma5_in, gamma5_out,
                       psi_acc, acc_coeff, hop_coeff, acc_twist, hop_twist):
    """csrc/wilson_hop.cu step by step: neighbour indices (tp, tm, ...,
    jf, jb), the projection/reconstruction tables of ``hop_tables``, the
    SU(3) product (daggered for backward hops) and the epilogue."""
    tab = tk.hop_tables(gamma5_in, gamma5_out)
    proj = torch.from_numpy(tab[:128].reshape(8, 2, 4, 2).copy())
    recon = torch.from_numpy(tab[128:].reshape(8, 2, 2, 2).copy())
    proj = torch.complex(proj[..., 0], proj[..., 1])
    recon = torch.complex(recon[..., 0], recon[..., 1])
    batched = psi.dim() == 6
    psi = psi if batched else psi[None]
    _, t_, z_, y_, _, xh = psi.shape
    t, z, y, j = torch.meshgrid(torch.arange(t_), torch.arange(z_),
                                torch.arange(y_), torch.arange(xh),
                                indexing="ij")
    s_out = (t + z + y + parity) & 1
    tp, tm = (t + 1) % t_, (t - 1) % t_
    zp, zm = (z + 1) % z_, (z - 1) % z_
    yp, ym = (y + 1) % y_, (y - 1) % y_
    jf = (j + s_out) % xh
    jb = (j - (1 - s_out)) % xh

    ps = psi.permute(0, 1, 2, 3, 5, 4)          # (N, T, Z, Y, Xh, 24)
    ps = torch.complex(ps[..., 0::2], ps[..., 1::2]).reshape(
        ps.shape[:5] + (4, 3))

    def links(u, mu, idx):
        g = u.permute(0, 1, 2, 3, 5, 4)[mu][idx]  # (T, Z, Y, Xh, 18)
        return torch.complex(g[..., 0::2], g[..., 1::2]).reshape(
            g.shape[:4] + (3, 3))

    hops = [  # (H, dagger, spinor index, link field, link index)
        (0, False, (tp, z, y, j), u_out, 0, (t, z, y, j)),
        (1, True, (tm, z, y, j), u_nbr, 0, (tm, z, y, j)),
        (2, False, (t, zp, y, j), u_out, 1, (t, z, y, j)),
        (3, True, (t, zm, y, j), u_nbr, 1, (t, zm, y, j)),
        (4, False, (t, z, yp, j), u_out, 2, (t, z, y, j)),
        (5, True, (t, z, ym, j), u_nbr, 2, (t, z, ym, j)),
        (6, False, (t, z, y, jf), u_out, 3, (t, z, y, j)),
        (7, True, (t, z, y, jb), u_nbr, 3, (t, z, y, jb)),
    ]
    out = torch.zeros_like(ps)
    for h, dag, sidx, u, mu, uidx in hops:
        p = ps[(slice(None),) + sidx]                   # (N, ..., 4, 3)
        half = torch.einsum("ab,...bc->...ac", proj[h], p)
        link = links(u, mu, uidx)
        if dag:
            link = link.conj().transpose(-1, -2)
        g = torch.einsum("...rc,n...ac->n...ar", link, half)
        out[..., :2, :] -= 0.5 * g
        out[..., 2:, :] -= 0.5 * torch.einsum("ik,...kc->...ic", recon[h], g)
    g5 = torch.tensor([1.0, 1.0, -1.0, -1.0])[:, None]
    res = hop_coeff * out + 1j * hop_twist * g5 * out
    if psi_acc is not None:
        pa = psi_acc if batched else psi_acc[None]
        pa = pa.permute(0, 1, 2, 3, 5, 4)
        pa = torch.complex(pa[..., 0::2], pa[..., 1::2]).reshape(out.shape)
        res = res + acc_coeff * pa + 1j * acc_twist * g5 * pa
    packed = torch.view_as_real(res).reshape(res.shape[:5] + (24,))
    packed = packed.permute(0, 1, 2, 3, 5, 4).contiguous()
    return packed if batched else packed[0]


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
    # the full-lattice kernel takes float32; bf16 storage is mixed
    # precision's (ROADMAP A8)
    up = torch.zeros(4, 4, 4, 4, 18, 4, dtype=torch.bfloat16)
    pp = torch.zeros(4, 4, 4, 24, 4, dtype=torch.bfloat16)
    for fn in (tops.dslash, tops.normal_op):
        with pytest.raises(NotImplementedError, match="item 8"):
            fn(up, pp, 0.1)
    with pytest.raises(ValueError, match="which"):
        tops.hop_block(None, None, None, which="ee")


def test_wrapper_rejects_bad_operands(packed):
    upe, upo, pb = (T(a) for a in packed["4x4x4x4"])
    with pytest.raises(ValueError, match="does not match"):
        tk.wilson_hop(upe, upo, pb[..., :1], parity=0)
    with pytest.raises(ValueError, match="psi_acc"):
        tk.wilson_hop(upe, upo, pb, parity=0, psi_acc=pb[0])
