"""Port vs JAX: the fused CG vector kernels' module (K2 cg_update, K3
cg_xpay), against the JAX Pallas kernels in interpret mode.

Fields carry a ragged per-RHS length (not a multiple of any block), N up
to 4.  Updated fields agree to <= 1e-5 max-abs; the residual norms, sums
of thousands of squares taken in another order, to 1e-5 relative.  Frozen
lanes (alpha_n = 0) and closed gates must pass their fields through
bitwise, and a batched call must equal its single-RHS calls bitwise.
K3's split of each RHS into a scalar head, a float4 body and a scalar
tail is emulated and must write every element exactly once.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.cg_fused import ops as jops
from repro_torch.kernels.cg_fused import kernel as tk
from repro_torch.kernels.cg_fused import ops as tops

import torch_one_thread  # noqa: F401  (one intra-op thread)

SHAPE = (4, 2, 24, 7)   # 1344 reals per RHS: ragged against any block


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n,) + SHAPE).astype(np.float32)
            for _ in range(4)]


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [1, 4])
def test_cg_update_batched_matches_pallas(n):
    x, r, p, ap = _fields(n)
    alpha = np.linspace(-0.7, 1.3, n).astype(np.float32)
    if n > 1:
        alpha[1] = 0.0
    xo, ro, rs = tops.cg_update_batched(T(alpha), *(T(v) for v in
                                                    (x, r, p, ap)))
    jx, jr, jrs = jops.cg_update_batched(alpha, x, r, p, ap, interpret=True)
    np.testing.assert_allclose(xo.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(rs.numpy(), np.asarray(jrs), rtol=1e-5)
    if n > 1:  # the frozen lane comes back bitwise
        assert torch.equal(xo[1], T(x[1])) and torch.equal(ro[1], T(r[1]))


@pytest.mark.parametrize("n", [1, 4])
def test_cg_xpay_batched_matches_pallas(n):
    _, r, p, _ = _fields(n, seed=1)
    beta = np.linspace(0.1, 0.9, n).astype(np.float32)
    gate = np.arange(n) % 2 == 0
    po = tops.cg_xpay_batched(T(beta), T(r), T(p), T(gate))
    ref = jops.cg_xpay_batched(beta, r, p, gate, interpret=True)
    np.testing.assert_allclose(po.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    for i in np.flatnonzero(~gate):  # a closed gate keeps p bitwise
        assert torch.equal(po[i], T(p[i]))


def test_unbatched_forms_match_pallas():
    x, r, p, ap = (v[0] for v in _fields(1, seed=2))
    xo, ro, rs = tops.cg_update(torch.tensor(0.37), *(T(v) for v in
                                                      (x, r, p, ap)))
    jx, jr, jrs = jops.cg_update(np.float32(0.37), x, r, p, ap,
                                 interpret=True)
    np.testing.assert_allclose(xo.numpy(), np.asarray(jx), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ro.numpy(), np.asarray(jr), rtol=0, atol=1e-5)
    assert rs.shape == () and np.isclose(float(rs), float(jrs), rtol=1e-5)
    po = tops.cg_xpay(torch.tensor(0.61), T(r), T(p))
    np.testing.assert_allclose(po.numpy(), np.asarray(jops.cg_xpay(
        np.float32(0.61), r, p, interpret=True)), rtol=0, atol=1e-5)


def test_batched_equals_single_calls_bitwise():
    x, r, p, ap = (T(v) for v in _fields(3, seed=3))
    alpha = torch.tensor([0.2, -0.4, 0.9])
    xo, ro, rs = tops.cg_update_batched(alpha, x, r, p, ap)
    po = tops.cg_xpay_batched(alpha, r, p, torch.ones(3, dtype=torch.bool))
    for n in range(3):
        sx, sr, srs = tops.cg_update(alpha[n], x[n], r[n], p[n], ap[n])
        assert torch.equal(xo[n], sx) and torch.equal(ro[n], sr)
        assert torch.equal(rs[n], srs)
        assert torch.equal(po[n], tops.cg_xpay(alpha[n], r[n], p[n]))


def test_fused_engines_count_plain_calls_on_cpu():
    x, r, p, ap = (T(v) for v in _fields(2, seed=4))
    tk.cg_update.plain_calls = tk.cg_xpay.plain_calls = 0
    update, xpay = tops.fused_engine_batched()
    update(torch.tensor([0.1, 0.2]), x, r, p, ap)
    xpay(torch.tensor([0.1, 0.2]), r, p, torch.tensor([True, False]))
    update, xpay = tops.fused_engine()
    update(torch.tensor(0.1), x[0], r[0], p[0], ap[0])
    xpay(torch.tensor(0.1), r[0], p[0])
    assert tk.cg_update.plain_calls == 2 and tk.cg_xpay.plain_calls == 2
    assert tk.cg_update.launches == 0 and tk.cg_xpay.launches == 0


def test_wrappers_reject_bad_operands():
    x, r, p, ap = (T(v) for v in _fields(2, seed=5))
    with pytest.raises(ValueError, match="one shape"):
        tk.cg_update(torch.ones(2), x, r, p, ap[:, :1])
    with pytest.raises(ValueError, match="per-RHS"):
        tk.cg_xpay(torch.ones(3), r, p)


# ---------------------------------------------------------------------------
# K3's split of each RHS into a scalar head, a float4 body and a scalar tail
# ---------------------------------------------------------------------------

def _cu_constant(name):
    src = (Path(tk.__file__).resolve().parents[2] / "csrc" /
           "cg_fused.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def xpay_writes(offsets, length, blocks):
    """csrc/cg_fused.cu ``xpay_rhs`` step by step for one RHS whose r, p
    and p' start ``offsets`` floats past a 16-byte boundary, run by
    ``blocks`` blocks: how often each element is written, and whether every
    float4 the body touches is 16-byte aligned."""
    threads, vec = _cu_constant("THREADS"), _cu_constant("XPAY_VEC")
    writes = np.zeros(length, np.int64)
    nthr = blocks * threads
    mis = {(4 * o) % 16 for o in offsets}
    head = length           # misaligned against each other: all scalar
    if len(mis) == 1:
        head = min(((16 - mis.pop()) & 15) // 4, length)
    nvec = (length - head) // 4
    tail0 = head + 4 * nvec
    for tid in range(nthr):              # the scalar head and tail loops
        writes[tid:head:nthr] += 1
        writes[tail0 + tid:length:nthr] += 1
    aligned = all((4 * (o + head)) % 16 == 0 for o in offsets) or nvec == 0
    for blk in range(blocks):            # the float4 body
        for tid in range(threads):
            v0 = blk * threads * vec + tid
            while v0 < nvec:
                for u in range(vec):
                    v = v0 + u * threads
                    if v < nvec:
                        writes[head + 4 * v:head + 4 * v + 4] += 1
                v0 += nthr * vec
    return writes, aligned


@pytest.mark.parametrize("length", [1, 3, 4, 5, 12345, 8 ** 4 * 12])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_xpay_split_writes_every_element_once(offset, length):
    """Every element of every RHS is written exactly once, whatever its
    base's alignment (a batch puts RHS n at n L floats, a caller's view
    anywhere), with r, p, p' aligned alike or against each other, and the
    float4 body only touches aligned vectors."""
    for n in range(3):
        base = offset + n * length
        for offsets in ((base, base, base), (base, base, 0)):
            for blocks in (1, 3):
                writes, aligned = xpay_writes(offsets, length, blocks)
                assert (writes == 1).all(), (offsets, blocks)
                assert aligned
