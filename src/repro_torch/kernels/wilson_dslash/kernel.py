"""K1 ``wilson_hop`` and K4 ``wilson_full``: the Wilson kernels' wrappers
and their host-side plans.

The CUDA sources are ``repro_torch/csrc/wilson_hop.cu`` (K1, the parity
hop) and ``repro_torch/csrc/wilson_full.cu`` (K4, the full-lattice
operator); their header notes say what bounds each kernel and how it is
laid out.  They replace the Pallas kernels ``repro/kernels/wilson_dslash/
kernel.py::_dslash_parity_kernel`` and ``::_dslash_kernel``, and share the
compile-time spin structure of ``csrc/wilson_common.cuh``, mirrored here
by :func:`hop_spec`, and the staging helpers of ``csrc/stage.cuh``;
:func:`hop_tile_plan` and :func:`full_tile_plan` size their shared-memory
tiles, after the launch space's tile (:mod:`..dispatch`).

Fields and links are float32, bf16 or float16 (the mixed-precision
solve's low operator), one dtype per call; the kernels compute in f32 and
round each output once to that dtype.  Each wrapper runs its plain version
(:mod:`..ref`) for tensors on the CPU, and only then; for CUDA tensors it
launches the kernel or raises.
``<wrapper>.launches`` counts kernel launches and ``<wrapper>.plain_calls``
plain-version calls (``launches_bf16`` / ``launches_f16`` and
``plain_calls_bf16`` / ``plain_calls_f16`` those on 16-bit storage,
``launches_bf16_pair`` / ``launches_f16_pair`` the 16-bit launches that
ran the pair instance, two sites a thread), so a run can show which path
it took;
``<wrapper>.last_tile`` the tile its last launch ran (its ``b``, K4's
``tchunk``, and the launch space's pick).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.lattice import GAUGE_G, NDIRS, SPINOR_S
from repro_torch.kernels import build, dispatch
from repro_torch.kernels.wilson_dslash.ref import (wilson_full_ref,
                                                   wilson_hop_ref)


# gamma_mu[row] has one nonzero, i^k at column col (DeGrand-Rossi basis,
# mu in (t, z, y, x)); csrc/wilson_common.cuh holds the same two tables
GAMMA_COL = ((2, 3, 0, 1), (2, 3, 0, 1), (3, 2, 1, 0), (3, 2, 1, 0))
GAMMA_K = ((0, 0, 0, 0), (1, 3, 3, 1), (2, 0, 0, 2), (1, 1, 3, 3))


def hop_spec(mu: int, forward: bool, gamma5_in: bool, gamma5_out: bool):
    """The compile-time spin structure of one hop, as the kernels'
    templates compute it (``csrc/wilson_common.cuh``): the projection
    ``h_a = psi_a + i^q_a psi_col_a`` for a = 0, 1 and the reconstruction
    ``o_{2+i} += i^ph_i g_src_i``.  Returns ``((col_0, q_0), (col_1,
    q_1)), ((src_0, ph_0), (src_1, ph_1))`` with the units as powers of i.

    The hop's projector is (1 + sigma g_mu), sigma = -1 forward (i^2);
    gamma5 = diag(+,+,-,-) on the input negates psi_2,3 (q + 2), on the
    output spins 2,3 (ph + 2).  For r = 1 only.
    """
    sig = 2 if forward else 0
    proj = tuple((GAMMA_COL[mu][a],
                  (sig + GAMMA_K[mu][a] + 2 * bool(gamma5_in)) % 4)
                 for a in range(2))
    recon = tuple((GAMMA_COL[mu][2 + i],
                   (sig + GAMMA_K[mu][2 + i] + 2 * bool(gamma5_out)) % 4)
                  for i in range(2))
    return proj, recon


# The Wilson kernels' tiles: a block owns the rows (t, z, y0 .. y0+b-1) and
# stages rows of them in shared memory.  HOP_TILE_SITES sets K1's b: 32
# sites (96 threads) is b = 2 at 32^3 x 64, the fastest of b = 1, 2, 3, 4,
# 5, 8 that scripts/compare_kernels.py timed on the H100 (PERF.md).
# FULL_TILE_SITES sets K4's: 128 sites (one thread each) is b = 4 at
# 32^3 x 64.  The 16-bit pair instances (two sites a thread, see
# :func:`hop_pair` and :func:`full_pair`) keep the threads and take twice
# the sites: b = 4 for K1 and 8 for K4 at 32^3 x 64.  These are the
# defaults; a tile of the launch space (:mod:`..dispatch`) may set b, and
# K4's block order, instead.
HOP_TILE_SITES = 32
FULL_TILE_SITES = 128
HOP_SMEM_LIMIT = 227 * 1024      # bytes a block may use on the H100
HOP_SMEM_TARGET = HOP_SMEM_LIMIT // 2   # two blocks per SM where it fits


def hop_smem_bytes(rows: int, ls: int, ss: int, esize: int = 4) -> int:
    """Shared memory of a K1 tile: 8 b link rows, 6 b + 2 spinor rows (t+-1,
    z+-1, the centre with its Y halo, the accumulator), rounded up to 8
    bytes, and the mbarrier with 8 bytes of slack."""
    staged = (8 * rows * ls + (6 * rows + 2) * ss) * esize
    return -(-staged // 8) * 8 + 16


def full_smem_bytes(rows: int, ls: int, esize: int = 4) -> int:
    """Shared memory of a K4 tile: the mbarrier (16 bytes with its slack)
    and the 6 b + 1 link rows it stages (the spinors are read through
    L1)."""
    return 16 + (6 * rows + 1) * ls * esize


def _full_smem(rows: int, ls: int, ss: int, esize: int) -> int:
    return full_smem_bytes(rows, ls, esize)


def _strides(width: int, esize: int) -> tuple[int, int]:
    """Shared-memory row strides (elements) of links and spinors for rows
    of ``width`` elements of ``esize`` bytes per component plane.  Where
    a warp spans rows (width < 32) and width is a whole number of 16-byte
    vectors, a stride is padded to width modulo the 128 bytes of the 32
    banks (32 f32, 64 bf16), so the rows a warp spans fall in distinct
    banks and every row stays 16-byte aligned."""
    lanes, vec = 128 // esize, 16 // esize

    def pad(w):
        return w if width % vec or width >= 32 else w + (width - w) % lanes

    return pad(18 * width), pad(24 * width)


@functools.lru_cache(maxsize=None)
def _tile_plan(y: int, width: int, sites: int, smem_bytes,
               esize: int = 4) -> tuple[int, int, int]:
    """``(b, ls, ss)`` for rows of ``width`` elements of ``esize`` bytes
    per component plane (strides by :func:`_strides`).

    b covers about ``sites`` sites, prefers a divisor of Y, and shrinks
    until the tile fits twice in an SM's shared memory (once at b = 1).
    b == 0: a row does not fit in shared memory, and the kernel reads the
    fields in place.  Cached, as every launch asks for its plan.
    """
    ls, ss = _strides(width, esize)
    bmax = max(1, min(y, sites // width))
    b = next((d for d in range(bmax, 0, -1)
              if y % d == 0 and 2 * d >= bmax), bmax)
    while b > 1 and smem_bytes(b, ls, ss, esize) > HOP_SMEM_TARGET:
        b -= 1
    if smem_bytes(b, ls, ss, esize) > HOP_SMEM_LIMIT:
        b = 0
    return b, ls, ss


def max_rows(y: int, width: int, smem_bytes, esize: int = 4) -> int:
    """The largest b <= Y whose tile fits an SM's shared memory (0: none
    does)."""
    ls, ss = _strides(width, esize)
    return next((d for d in range(y, 0, -1)
                 if smem_bytes(d, ls, ss, esize) <= HOP_SMEM_LIMIT), 0)


@functools.lru_cache(maxsize=None)
def _forced_plan(kernel: str, y: int, width: int, b: int, smem_bytes,
                 esize: int) -> tuple[int, int, int]:
    """``(b, ls, ss)`` for a tile's b, or ValueError naming the legal
    values: 0 (rows read in place) and every b up to Y whose tile fits
    shared memory.  Cached: a forced tile costs a launch no scan."""
    ls, ss = _strides(width, esize)
    top = max_rows(y, width, smem_bytes, esize)
    if b < 0 or b > top:
        legal = "0 (rows read in place)" + (f" and 1..{top}" if top else "")
        raise ValueError(
            f"{kernel}: b={b} does not fit the Y extent {y} and "
            f"{HOP_SMEM_LIMIT} bytes of shared memory; legal b values for "
            f"Y={y}, rows of {width} x {esize}-byte elements: {legal}")
    return b, ls, ss


def hop_pair(xh: int, esize: int) -> bool:
    """Whether K1 runs its pair instance, two adjacent sites a thread with
    each component of both read as one 32-bit word: 16-bit storage (bf16
    or float16) and an even Xh, given 4-byte aligned bases, as
    ``csrc/wilson_hop.cu``
    tests.  Otherwise the one-site instance runs.  The pair instance takes
    every tile the one-site instance does."""
    return esize == 2 and xh % 2 == 0


def full_pair(x: int, esize: int) -> bool:
    """Whether K4 runs its pair instance: 16-bit storage (bf16 or float16)
    and X = 32,
    whose compile-time instance holds two sites' sums in three blocks an
    SM (a runtime-X one spilled and lost to the one-site instance at
    X = 48, PERF.md), given 4-byte aligned bases, as
    ``csrc/wilson_full.cu`` tests (and 4-byte aligned ghost planes on a
    mesh block).  It stages its links, so it refuses b = 0
    (:func:`full_tile_plan`)."""
    return esize == 2 and x == 32


def hop_tile_plan(y: int, xh: int, esize: int = 4,
                  b: int | None = None) -> tuple[int, int, int]:
    """K1's tile ``(b, ls, ss)``: b rows of Y per block, and the shared
    memory row strides (elements) of links and spinors (see
    :func:`_tile_plan`; b == 0: rows read in place).  ``b``: a tile's rows
    instead of the heuristic's (ValueError if they do not fit)."""
    if b is not None:
        return _forced_plan("wilson_hop", y, xh, b, hop_smem_bytes, esize)
    sites = HOP_TILE_SITES * (2 if hop_pair(xh, esize) else 1)
    return _tile_plan(y, xh, sites, hop_smem_bytes, esize)


def full_tile_plan(y: int, x: int, esize: int = 4,
                   b: int | None = None) -> tuple[int, int]:
    """K4's tile ``(b, ls)`` on the full X axis: b rows of Y per block and
    the shared-memory stride (elements) of its staged link rows (see
    :func:`_tile_plan`; b == 0: links read in place).  ``b``: a tile's
    rows instead of the heuristic's (ValueError if they do not fit, or if
    b = 0 meets the 16-bit pair instance, which stages its links and would
    otherwise be swapped for the one-site instance)."""
    if b is not None:
        if b == 0 and full_pair(x, esize):
            raise ValueError(
                f"wilson_full: b=0 (links read in place) is refused at "
                f"X={x} in 16-bit storage: the pair instance stages its "
                "links; legal "
                f"b values there: 1..{max_rows(y, x, _full_smem, esize)}")
        b, ls, _ = _forced_plan("wilson_full", y, x, b, _full_smem, esize)
        return b, ls
    sites = FULL_TILE_SITES * (2 if full_pair(x, esize) else 1)
    b, ls, _ = _tile_plan(y, x, sites, _full_smem, esize)
    return b, ls


def full_tchunk(t: int, n: int, tchunk: int | None = None) -> int:
    """K4's block order: the t planes a chunk takes before z.  The default
    is 4 with N > 1 right-hand sides and T a multiple of 4 (a plane's
    N-fold rows stay in L2 between their three uses), else 1 (the z
    neighbours closer, which N = 1 needs more; PERF.md).  ``tchunk``: a
    tile's chunk instead (ValueError unless it divides T)."""
    if tchunk is None:
        return 4 if n > 1 and t % 4 == 0 else 1
    legal = [c for c in dispatch.TCHUNKS if t % c == 0]
    if tchunk not in legal:
        raise ValueError(
            f"wilson_full: tchunk={tchunk} does not divide the T extent "
            f"{t}; legal tchunk values for T={t}: {legal}")
    return tchunk


def hop_launch_plan(shape, n: int, dtype):
    """K1's plan at a launch of half field shape (T, Z, Y, Xh), N
    right-hand sides and storage ``dtype``: ``((b, ls, ss), tile)``, the
    launch space's tile (:func:`..dispatch.pick_tile`) resolved by
    :func:`hop_tile_plan` (the default tile calls it positionally, as it
    always was: ``scripts/compare_kernels.py`` swaps the plan to time
    tile heights)."""
    _, _, y, xh = shape
    tile = dispatch.pick_tile("wilson_hop", shape, n, dtype)
    es = dtype.itemsize
    plan = (hop_tile_plan(y, xh, es) if tile.b is None
            else hop_tile_plan(y, xh, es, b=tile.b))
    return plan, tile


def full_launch_plan(shape, n: int, dtype):
    """K4's plan at a launch of field shape (T, Z, Y, X): ``((b, ls,
    tchunk), tile)``, the launch space's tile resolved by
    :func:`full_tile_plan` and :func:`full_tchunk`."""
    t, _, y, x = shape
    tile = dispatch.pick_tile("wilson_full", shape, n, dtype)
    es = dtype.itemsize
    b, ls = (full_tile_plan(y, x, es) if tile.b is None
             else full_tile_plan(y, x, es, b=tile.b))
    return (b, ls, full_tchunk(t, n, tile.tchunk)), tile


def _rows16(esize: int, *elems: int) -> bool:
    return all(e * esize % 16 == 0 for e in elems)


def hop_bulk(xh: int, ls: int, ss: int, esize: int = 4) -> bool:
    """Whether K1 stages a tile's rows with TMA bulk copies (given 16-byte
    aligned bases): every row and stride a multiple of 16 bytes, as
    ``csrc/wilson_hop.cu`` tests.  Otherwise plain loads stage them."""
    return _rows16(esize, GAUGE_G * xh, SPINOR_S * xh, ls, ss)


def full_bulk(x: int, ls: int, esize: int = 4) -> bool:
    """Whether K4 stages its link rows with TMA bulk copies (given a
    16-byte aligned gauge base), as ``csrc/wilson_full.cu`` tests."""
    return _rows16(esize, GAUGE_G * x, ls)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("wilson_hop")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wilson_hop.argtypes = ([p, p, p, p, p] + [i] * 11 + [f] * 4
                               + [i, p, ctypes.POINTER(i)])
    lib.wilson_hop.restype = ctypes.c_int
    return lib


def _check_operands(u_out, u_nbr, psi, psi_acc):
    if psi.dim() not in (5, 6):
        raise ValueError(f"spinor rank must be 5 or 6, got {psi.dim()}")
    nd, t, z, y, g, xh = u_out.shape
    if nd != NDIRS or g != GAUGE_G or u_nbr.shape != u_out.shape:
        raise ValueError(f"gauge halves must be (4,T,Z,Y,18,Xh), got "
                         f"{tuple(u_out.shape)} and {tuple(u_nbr.shape)}")
    if tuple(psi.shape[-5:]) != (t, z, y, SPINOR_S, xh):
        raise ValueError(f"spinor {tuple(psi.shape)} does not match gauge "
                         f"{tuple(u_out.shape)}")
    if t % 2 or z % 2 or y % 2:
        raise ValueError("even-odd kernels need even T/Z/Y extents: an odd "
                         f"periodic extent breaks bipartiteness, got "
                         f"{(t, z, y)}")
    if psi_acc is not None and psi_acc.shape != psi.shape:
        raise ValueError(f"psi_acc {tuple(psi_acc.shape)} must match psi "
                         f"{tuple(psi.shape)}")


def wilson_hop(u_out: torch.Tensor, u_nbr: torch.Tensor, psi: torch.Tensor,
               *, parity: int, gamma5_in: bool = False,
               gamma5_out: bool = False, psi_acc: torch.Tensor | None = None,
               acc_coeff: float = 0.0, hop_coeff: float = 1.0,
               acc_twist: float = 0.0,
               hop_twist: float = 0.0) -> torch.Tensor:
    """One parity hop block with the fused epilogue (see
    :func:`..ref.wilson_hop_ref` for the function).  ``psi`` is a packed
    half field (T,Z,Y,24,Xh) or an (N,T,Z,Y,24,Xh) batch; every operand
    of one storage dtype: float32, bf16 or float16."""
    _check_operands(u_out, u_nbr, psi, psi_acc)
    operands = [u_out, u_nbr, psi] + ([psi_acc] if psi_acc is not None
                                      else [])
    storage = build.storage_code("wilson_hop", operands)
    kw = dict(parity=parity, gamma5_in=gamma5_in, gamma5_out=gamma5_out,
              psi_acc=psi_acc, acc_coeff=acc_coeff, hop_coeff=hop_coeff,
              acc_twist=acc_twist, hop_twist=hop_twist)
    if psi.device.type == "cpu":
        build.count(wilson_hop, "plain_calls", psi.dtype)
        return wilson_hop_ref(u_out, u_nbr, psi, **kw)
    for name, v in zip(("u_out", "u_nbr", "psi", "psi_acc"), operands):
        if v.device != psi.device or not v.is_contiguous():
            raise ValueError(f"wilson_hop: {name} must be a contiguous "
                             f"tensor on {psi.device}, got one on "
                             f"{v.device}")
    _, t, z, y, _, xh = u_out.shape
    n = psi.shape[0] if psi.dim() == 6 else 1
    plan, tile = hop_launch_plan((t, z, y, xh), n, psi.dtype)
    wilson_hop.last_tile = {"b": plan[0], "picked": tile.to_entry()}
    out = torch.empty_like(psi)
    lib = _lib()
    pair = ctypes.c_int(0)
    rc = lib.wilson_hop(
        u_out.data_ptr(), u_nbr.data_ptr(), psi.data_ptr(),
        psi_acc.data_ptr() if psi_acc is not None else None,
        out.data_ptr(), t, z, y, xh, n, int(parity) & 1, int(bool(gamma5_in)),
        int(bool(gamma5_out)), *plan, float(hop_coeff), float(hop_twist),
        float(acc_coeff), float(acc_twist), storage,
        torch.cuda.current_stream(psi.device).cuda_stream, ctypes.byref(pair))
    build.check(lib, rc, "wilson_hop")
    build.count(wilson_hop, "launches", psi.dtype, pair.value)
    return out


build.zero_counts(wilson_hop)
wilson_hop.last_tile = None


# ---------------------------------------------------------------------------
# K4: the full-lattice operator
# ---------------------------------------------------------------------------


def site_coeffs(mass, twist: float, gamma5_in: bool,
                gamma5_out: bool) -> tuple[float, float, float, float]:
    """K4's site term ``g5out ((m+4) + i twist g5) g5in`` as per-spin-block
    coefficients ``(m_hi, m_lo, tw_hi, tw_lo)``: spins 0,1 take
    ``(m+4, twist)``; spins 2,3 take ``-(m+4)`` when exactly one flag is
    set (g5 once) and ``-twist`` when the flags agree (g5 once or three
    times).  The kernel adds ``m psi + tw (i psi)``.
    """
    m4 = float(mass) + 4.0
    one = bool(gamma5_in) != bool(gamma5_out)
    tw = float(twist)
    return m4, -m4 if one else m4, tw, tw if one else -tw


@functools.lru_cache(maxsize=None)
def _full_lib() -> ctypes.CDLL:
    lib = build.library("wilson_full")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wilson_full.argtypes = ([p, p, p] + [i] * 10 + [f] * 4
                                + [i, p, p, ctypes.POINTER(i)])
    lib.wilson_full.restype = ctypes.c_int
    return lib


def _check_full_operands(up, pp):
    if pp.dim() not in (5, 6):
        raise ValueError(f"spinor rank must be 5 or 6, got {pp.dim()}")
    nd, t, z, y, g, x = up.shape
    if nd != NDIRS or g != GAUGE_G:
        raise ValueError(f"gauge must be (4,T,Z,Y,18,X), got "
                         f"{tuple(up.shape)}")
    if tuple(pp.shape[-5:]) != (t, z, y, SPINOR_S, x):
        raise ValueError(f"spinor {tuple(pp.shape)} does not match gauge "
                         f"{tuple(up.shape)}")
    return build.storage_code("wilson_full", (up, pp))


def _plane_shape(shape, axis: int) -> tuple:
    out = list(shape)
    out[axis] = 1
    return tuple(out)


def _check_halo(up, pp, halo) -> list:
    """The ghost planes of ``halo`` (see :func:`..ref.wilson_full_ref`)
    checked against the block, as the C entry's nine pointers: the psi
    planes before and after the block along T, Z and Y, then U_t, U_z and
    U_y at the previous rank's last plane (None: the axis is not
    sharded)."""
    batch = pp.dim() - 5
    ptrs = [None] * 9
    for mu, planes in halo.items():
        if mu not in (0, 1, 2):
            raise ValueError(f"wilson_full: halo axis {mu!r}; the sharded "
                             "axes are 0 (T), 1 (Z) and 2 (Y), X never")
        prev, nxt, u_prev = planes
        want = _plane_shape(pp.shape, batch + mu)
        for name, v, shape in (("psi_prev", prev, want),
                               ("psi_next", nxt, want),
                               ("u_prev", u_prev,
                                _plane_shape(up.shape[1:], mu))):
            if tuple(v.shape) != shape or v.dtype != pp.dtype:
                raise ValueError(
                    f"wilson_full: halo[{mu}] {name} must be {shape} "
                    f"{pp.dtype}, got {tuple(v.shape)} {v.dtype}")
            if pp.device.type != "cpu" and (v.device != pp.device
                                            or not v.is_contiguous()):
                raise ValueError(f"wilson_full: halo[{mu}] {name} must be "
                                 f"a contiguous tensor on {pp.device}")
        ptrs[2 * mu], ptrs[2 * mu + 1] = prev, nxt
        ptrs[6 + mu] = u_prev
    return ptrs


def wilson_full(up: torch.Tensor, pp: torch.Tensor, mass, *,
                twist: float = 0.0, gamma5_in: bool = False,
                gamma5_out: bool = False, halo=None) -> torch.Tensor:
    """``g5out (D + i twist g5) (g5in psi)`` on the full lattice (see
    :func:`..ref.wilson_full_ref`).  ``pp`` is a packed field
    (T,Z,Y,24,X) or an (N,T,Z,Y,24,X) batch, ``up`` the packed gauge
    field (4,T,Z,Y,18,X), both of one storage dtype (float32, bf16 or
    float16).

    ``halo``: for a rank's block of a mesh, ``{axis: (psi_prev, psi_next,
    u_prev)}`` for each sharded axis (0 T, 1 Z, 2 Y): the ghost planes
    the kernel reads where a neighbour row wraps across that face, so
    every site sums what one launch on the global field sums, in its
    order."""
    storage = _check_full_operands(up, pp)
    ghosts = _check_halo(up, pp, halo) if halo else [None] * 9
    kw = dict(twist=twist, gamma5_in=gamma5_in, gamma5_out=gamma5_out)
    if pp.device.type == "cpu":
        build.count(wilson_full, "plain_calls", pp.dtype)
        return wilson_full_ref(up, pp, mass, halo=halo, **kw)
    for name, v in (("up", up), ("pp", pp)):
        if v.device != pp.device or not v.is_contiguous():
            raise ValueError(f"wilson_full: {name} must be a contiguous "
                             f"tensor on {pp.device}")
    _, t, z, y, _, x = up.shape
    n = pp.shape[0] if pp.dim() == 6 else 1
    plan, tile = full_launch_plan((t, z, y, x), n, pp.dtype)
    wilson_full.last_tile = {"b": plan[0], "tchunk": plan[2],
                             "picked": tile.to_entry()}
    out = torch.empty_like(pp)
    lib = _full_lib()
    pair = ctypes.c_int(0)
    ghost_ptrs = (ctypes.c_void_p * 9)(
        *(None if v is None else v.data_ptr() for v in ghosts))
    rc = lib.wilson_full(
        up.data_ptr(), pp.data_ptr(), out.data_ptr(), t, z, y, x, n,
        int(bool(gamma5_in)), int(bool(gamma5_out)), *plan,
        *site_coeffs(mass, twist, gamma5_in, gamma5_out), storage,
        torch.cuda.current_stream(pp.device).cuda_stream, ghost_ptrs,
        ctypes.byref(pair))
    build.check(lib, rc, "wilson_full")
    build.count(wilson_full, "launches", pp.dtype, pair.value)
    return out


build.zero_counts(wilson_full)
wilson_full.last_tile = None
