// K4 wilson_full: the full-lattice Dirac-Wilson operator on packed fields,
// with gamma5 folding and the twisted-mass site term, for Hopper (sm_90a).
//
//   out = g5out D (g5in psi),
//   D psi(x) = (m + 4) psi(x) + i twist g5 psi(x)
//            - 1/2 sum_mu [ (1 - g_mu) U_mu(x) psi(x+mu)
//                         + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu) ]
//
// With both flags set this is D(-twist)^dag's form g5 D g5, so the CGNR
// normal operator D^dag D is two launches with no gamma5 pass between them.
//
// Replaces the Pallas kernel repro/kernels/wilson_dslash/kernel.py
// `_dslash_kernel` (launched by `dslash_pallas`), with its double-buffered
// gauge streaming mode (`_db_gauge_plane`, `_db_scratch`).
//
// Layouts (float32, bf16 or float16, one type per launch): psi, out
// [N][T][Z][Y][24][X]; u [4][T][Z][Y][18][X],
// component index (spin*3+color)*2+reim resp. (row*3+col)*2+reim, X
// innermost.  Every direction wraps periodically; the X neighbours are
// x +- 1 on the full axis.  A "row" is one (t, z, y) line of a field: 24
// (spinor) or 18 (link) planes of X elements.
//
// What bounds it: memory.  Each site's 4 links (72 floats) are needed once
// for all N right-hand sides, and per RHS 24 floats of spinor in (each
// spinor is a neighbour of 8 sites, once from DRAM at best) and 24 out:
// (72/N + 48)*4 bytes per site and RHS against 1320 flops, under 3
// flop/byte at N = 1, far below the card's fp32 ridge of 20, so tensor
// cores would buy nothing (and TF32 would break the 1e-5 tolerance).  On
// the card (PERF.md) its time followed the bytes that reach the
// SMs from L2 and DRAM, not its instruction count: staging the spinor rows
// in shared memory as K1 does (5b+2 rows per RHS, three threads per site,
// a two-stage ring) was built and measured slower than reading them
// through L1, since at X = 32 a staged row is 3 KB and a tile that fits
// shared memory re-fetches each neighbour row about 7 times, where a
// 128-thread block's L1 serves the x and y neighbours of its 4 rows.  The
// design:
//  * one thread per site computes all three colours (wilson::hop_site):
//    one spin projection per hop, the compile-time spin structure of
//    wilson_common.cuh; at X = 32 168 registers and three 128-thread
//    blocks an SM, at other widths two (more registers, no spill);
//  * a block owns a tile (t, z, y0 .. y0+b-1, all X) of about 128 sites
//    (b = 4 at X = 32), blocks ordered y-tile fastest, then z, then t, so
//    resident blocks share their t+-1 and z+-1 rows in L2; with N > 1 the
//    order takes t in chunks of 4 planes before z by default, which keeps
//    a plane's N-fold larger rows in L2 between their three uses (the
//    chunk and b are the launch space's knobs, kernels/dispatch.py);
//  * the tile's 6b + 1 link rows are staged in shared memory once, with
//    TMA bulk copies completing on an mbarrier (stage.cuh), and serve all
//    N right-hand sides (the tile's own u_t, u_z, u_x rows, u_t at t-1, u_z
//    at z-1, and u_y at y0-1 .. y0+b-1, so the backward Y link of row i is
//    the u_y row before it; the backward X link is the u_x row at x-1);
//  * the spinors are read through L1 (ld.global.nc): the block's rows share
//    their x and y neighbours there;
//  * each thread loops over the N right-hand sides with the same
//    instruction sequence and explicit fmaf, so a batched launch equals N
//    single launches bitwise;
//  * a tile whose link rows a bulk copy cannot take (a row is 18 X
//    elements, a multiple of 16 bytes only for even X in f32 and X a
//    multiple of 4 in bf16; a base pointer off 16 bytes) is staged by all
//    threads with plain loads instead; rows too wide for shared memory (X
//    above about 460 in f32) are read in place (STAGED = false).  Same
//    compute code, every shape;
//  * bf16 storage (the mixed-precision solve's inner operator): links and
//    spinors are read as stored, half the bytes, and widened to f32 where a
//    thread reads them (wilson_common.cuh); the sums and the site term are
//    f32 and each output is rounded once on its store.  The f32 instances
//    are the same code with ST = float.  Read one bf16 element at a time,
//    that code issues as many loads as the f32 one for half the bytes,
//    and its time followed the loads, not the bytes (PERF.md); so at
//    X = 32 with 4-byte aligned bases bf16 runs a pair instance instead
//    (wilson_full_pair_kernel): a thread owns two adjacent sites, reads
//    each component of both as one 32-bit word (half the loads), keeps the
//    128-thread block with twice the sites a tile (b = 8) and computes
//    each site with the one-site code, so its outputs equal the one-site
//    instance's bitwise.  Other widths and misaligned bases keep the
//    one-site instance (a shape rule, kernel.py::full_pair);
//  * float16 storage is bf16's in every respect (the same one-site and
//    X = 32 pair instances on __half2 words, narrowed once with
//    __float2half_rn / __floats2half2_rn); its two instances share one
//    epilogue with the roundings written out (f16_epilogue), so they agree
//    bitwise whatever FMA contractions nvcc would choose;
//  * a rank's block of a mesh (core/distributed.py::dslash_halo) is one
//    launch with ghost planes: for each sharded face (T, Z, Y; X is never
//    sharded) the neighbours' boundary planes of psi and, for the backward
//    hop into the block's first plane, U at the previous rank's last
//    plane.  A neighbour row that wraps across a sharded face is read from
//    the ghost plane instead of the block's own far plane (nbr_row,
//    back_link), and nothing else changes, so each site sums the terms of
//    one launch on the global field in its order: the gathered blocks are
//    that launch bitwise.  The ghost reads are a template flag (HALO), so
//    the instances without them are the code they were.
//  The host (kernels/wilson_dslash/kernel.py::full_tile_plan and
//  ::full_tchunk) picks b, the shared-memory row stride and the chunk; the
//  same plan drives the CPU tests' emulation.  Offsets are 64-bit: an N = 4 field at 32^3 x 64 holds
//  201 M floats.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "stage.cuh"
#include "wilson_common.cuh"

namespace {

using stage::bulk_copy;
using stage::mbar_expect;
using stage::mbar_init;
using stage::mbar_wait;
using wilson::G;
using wilson::S;
using wilson::hop_site;
using wilson::narrow;
using wilson::wide;

constexpr int FULL_THREADS = 128;  // a block's threads

template <class ST>
struct FullArgs {
  const ST* u;
  const ST* psi;
  ST* out;
  int T, Z, Y, X, N;
  int rows;                    // b, the tile's y extent
  int tchunk;                  // t planes a chunk of the block order
  int ls;                      // shared-memory link row stride (elements)
  int bulk;                    // stage with TMA bulk copies (else plain loads)
  float m_hi, m_lo, tw_hi, tw_lo;  // the site term on spins 0,1 and 2,3
};

// A mesh block's launch (the HALO instances): the ghost planes beside the
// arguments (null: the axis wraps in the block).  gsp[axis][0] is the
// previous rank's last psi plane along axis (0 T, 1 Z, 2 Y), gsp[axis][1]
// the next rank's first, each [N][face rows][24][X]; glk[axis] U_axis at
// the previous rank's last plane, [face rows][18][X].  A face's rows are
// the other two of (t, z, y), row-major.  The instances without ghosts
// take FullArgs alone: a larger parameter block changed how ptxas
// allocated the pair instance's registers (96 bytes spilled instead of
// 56) and cost it 10 % on the card.
template <class ST>
struct HaloArgs : FullArgs<ST> {
  const ST* gsp[3][2];
  const ST* glk[3];
};

template <class ST, bool HALO>
using ArgsOf = std::conditional_t<HALO, HaloArgs<ST>, FullArgs<ST>>;

// The tile's geometry.
struct Tile {
  int t, z, y0, nb, tp, tm, zp, zm;
};

__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

template <class ST>
__device__ __forceinline__ long srow(const FullArgs<ST>& a, int t, int z,
                                     int y) {
  return (((long)t * a.Z + z) * a.Y + y) * S * a.X;
}
template <class ST>
__device__ __forceinline__ long grow(const FullArgs<ST>& a, int mu, int t,
                                     int z, int y) {
  return ((((long)mu * a.T + t) * a.Z + z) * a.Y + y) * G * a.X;
}

// The rows of a face of `axis`, and the row of (t, z, y) in it.
template <class ST>
__device__ __forceinline__ long face_rows(const FullArgs<ST>& a, int axis) {
  return axis == 0 ? (long)a.Z * a.Y
                   : (axis == 1 ? (long)a.T * a.Y : (long)a.T * a.Z);
}
template <class ST>
__device__ __forceinline__ long face_row(const FullArgs<ST>& a, int axis,
                                         int t, int z, int y) {
  return axis == 0 ? (long)z * a.Y + y
                   : (axis == 1 ? (long)t * a.Y + y : (long)t * a.Z + z);
}

// The psi row of RHS n (p = psi + n * field) that the hop along `axis`
// (FWD: to +1) from the row (t, z, y) reads, at the neighbour (tn, zn, yn)
// wrapped in the block; with HALO, the ghost plane's row where the hop
// crosses a sharded face.
template <bool HALO, class A, class ST>
__device__ __forceinline__ const ST* nbr_row(const A& a, const ST* p, int n,
                                             int axis, bool fwd, int t, int z,
                                             int y, int tn, int zn, int yn) {
  if constexpr (HALO) {
    const int c = axis == 0 ? t : (axis == 1 ? z : y);
    const int ext = axis == 0 ? a.T : (axis == 1 ? a.Z : a.Y);
    const ST* g = a.gsp[axis][fwd ? 1 : 0];
    if (g != nullptr && c == (fwd ? ext - 1 : 0))
      return g + (n * face_rows(a, axis) + face_row(a, axis, t, z, y)) *
                     (long)S * a.X;
  }
  return p + srow(a, tn, zn, yn);
}

// U_axis at (tn, zn, yn), the backward neighbour of the row (t, z, y) in
// the block; with HALO, the ghost plane's row where the hop crosses a
// sharded face.
template <bool HALO, class A>
__device__ __forceinline__ auto back_link(const A& a, int axis, int t, int z,
                                          int y, int tn, int zn, int yn) {
  if constexpr (HALO) {
    const int c = axis == 0 ? t : (axis == 1 ? z : y);
    if (a.glk[axis] != nullptr && c == 0)
      return a.glk[axis] + face_row(a, axis, t, z, y) * (long)G * a.X;
  }
  return a.u + grow(a, axis, tn, zn, yn);
}

// The tile of index i: y-tile fastest, then t within a chunk of tchunk
// planes, then z, then the chunk.
template <class ST>
__device__ __forceinline__ Tile make_tile(const FullArgs<ST>& a, int i) {
  const int nyb = (a.Y + a.rows - 1) / a.rows;
  Tile tl;
  const int yb = i % nyb, rest = i / nyb;
  const int zc = rest / a.tchunk;
  tl.z = zc % a.Z;
  tl.t = (zc / a.Z) * a.tchunk + rest % a.tchunk;
  tl.y0 = yb * a.rows;
  tl.nb = min(a.rows, a.Y - tl.y0);
  tl.tp = tl.t + 1 == a.T ? 0 : tl.t + 1;
  tl.tm = tl.t == 0 ? a.T - 1 : tl.t - 1;
  tl.zp = tl.z + 1 == a.Z ? 0 : tl.z + 1;
  tl.zm = tl.z == 0 ? a.Z - 1 : tl.z - 1;
  return tl;
}

// Link row k of the tile, in staging order, and its slot: groups u_t,
// u_t(t-1), u_z, u_z(z-1), u_x (nb rows each, at g*b + i), then u_y at
// rows y0-1 .. y0+nb-1 (at 5b + i); with HALO the backward rows that
// cross a sharded face come from its ghost plane.
template <bool HALO, class ST>
__device__ __forceinline__ const ST* link_src(const ArgsOf<ST, HALO>& a,
                                              const Tile& tl, int k,
                                              int* slot) {
  const int nb = tl.nb;
  if (k < 5 * nb) {
    const int g = k / nb, i = k - g * nb, y = tl.y0 + i;
    *slot = g * a.rows + i;
    switch (g) {
      case 0: return a.u + grow(a, 0, tl.t, tl.z, y);
      case 1: return back_link<HALO>(a, 0, tl.t, tl.z, y, tl.tm, tl.z, y);
      case 2: return a.u + grow(a, 1, tl.t, tl.z, y);
      case 3: return back_link<HALO>(a, 1, tl.t, tl.z, y, tl.t, tl.zm, y);
      default: return a.u + grow(a, 3, tl.t, tl.z, y);
    }
  }
  k -= 5 * nb;
  *slot = 5 * a.rows + k;
  // the row y0 - 1 + k is the backward Y neighbour of row y0 + k
  return back_link<HALO>(a, 2, tl.t, tl.z, tl.y0 + k, tl.t, tl.z,
                         wrap(tl.y0 - 1 + k, a.Y));
}

// Stage the tile's 6 nb + 1 link rows at sl.  Bulk: the first warp issues
// the copies, completing on `bar`; plain: every thread loads its share.
// The caller waits on `bar` or syncs.
template <bool HALO, class ST>
__device__ __forceinline__ void stage_links(const ArgsOf<ST, HALO>& a,
                                            const Tile& tl, ST* sl,
                                            uint64_t* bar) {
  const int nl = 6 * tl.nb + 1, llen = G * a.X;
  if (a.bulk) {
    if (threadIdx.x >= 32) return;
    if (threadIdx.x == 0)
      mbar_expect(bar, (uint32_t)(nl * llen * sizeof(ST)));
    __syncwarp();
    for (int k = threadIdx.x; k < nl; k += 32) {
      int slot;
      const ST* src = link_src<HALO, ST>(a, tl, k, &slot);
      bulk_copy(sl + slot * a.ls, src, (uint32_t)(llen * sizeof(ST)), bar);
    }
    return;
  }
  for (int k = 0; k < nl; ++k) {
    int slot;
    const ST* src = link_src<HALO, ST>(a, tl, k, &slot);
    ST* dst = sl + slot * a.ls;
    for (int e = threadIdx.x; e < llen; e += blockDim.x)
      dst[e] = wilson::ldg(src + e);
  }
}

// The float16 instances' epilogue for one component pair: the site term
// m psi + i tw psi and the hops' sum with its -1/2, each operation rounded
// as written (no contraction left to nvcc), shared by the one-site and pair
// instances so that they agree bitwise.
__device__ __forceinline__ void f16_epilogue(float m, float tw, bool twisted,
                                             float pr, float pi, float hr,
                                             float hi, float& vr, float& vi) {
  float nr = __fmul_rn(m, pr), ni = __fmul_rn(m, pi);
  if (twisted) {
    nr = __fmaf_rn(-tw, pi, nr);
    ni = __fmaf_rn(tw, pr, ni);
  }
  vr = __fmaf_rn(-0.5f, hr, nr);
  vi = __fmaf_rn(-0.5f, hi, ni);
}

// One thread per site of the tile, all N right-hand sides.  Links: the
// staged rows (STAGED) or the field in place; spinors: through L1.  XC > 0
// makes X and the unpadded link stride compile time, so every component of
// a row is an immediate offset.  HALO: the ghost reads of a mesh block.
template <class ST, bool G5IN, bool G5OUT, bool STAGED, int XC, bool HALO>
__global__ void __launch_bounds__(FULL_THREADS, STAGED && XC > 0 ? 3 : 2)
wilson_full_kernel(const ArgsOf<ST, HALO> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = a.rows, X = XC > 0 ? XC : a.X;
  const int ls = XC > 0 ? G * XC : a.ls;
  const Tile tl = make_tile(a, blockIdx.x);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  ST* sl = reinterpret_cast<ST*>(smem_raw + 16);  // 6 b + 1 link rows
  if (STAGED) {
    if (a.bulk) {
      if (threadIdx.x == 0) mbar_init(bar);
      __syncthreads();
    }
    stage_links<HALO, ST>(a, tl, sl, bar);
    if (a.bulk)
      mbar_wait(bar, 0);
    else
      __syncthreads();
  }
  const long field = (long)a.T * a.Z * a.Y * S * X;
  const bool twisted = a.tw_hi != 0.f;
  // a row's component k at site xx: spinors through L1, links from shared
  // memory or, in place, through L1
  auto at = [X](const ST* row, int xx) {
    return [row, xx, X](int k) { return wide(wilson::ldg(row + xx + k * X)); };
  };
  auto lk = [X](const ST* row, int xx) {
    return [row, xx, X](int k) {
      return wide(STAGED ? row[xx + k * X] : wilson::ldg(row + xx + k * X));
    };
  };
  for (int site = threadIdx.x; site < tl.nb * X; site += blockDim.x) {
    const int r = site / X, x = site - r * X;
    const int y = tl.y0 + r;
    const int yp = wrap(y + 1, a.Y), ym = wrap(y - 1, a.Y);
    const int xp = x + 1 == X ? 0 : x + 1, xm = x == 0 ? X - 1 : x - 1;
    // link rows: u_t, u_t(t-1), u_z, u_z(z-1), u_x (g = 0..4), u_y at y - 1
    // and y (g = 5, 6)
    auto link = [&](int g) -> const ST* {
      if (STAGED) return sl + (g < 5 ? g * b + r : 5 * b + r + g - 5) * ls;
      switch (g) {
        case 0: return a.u + grow(a, 0, tl.t, tl.z, y);
        case 1: return back_link<HALO>(a, 0, tl.t, tl.z, y, tl.tm, tl.z, y);
        case 2: return a.u + grow(a, 1, tl.t, tl.z, y);
        case 3: return back_link<HALO>(a, 1, tl.t, tl.z, y, tl.t, tl.zm, y);
        case 4: return a.u + grow(a, 3, tl.t, tl.z, y);
        case 5: return back_link<HALO>(a, 2, tl.t, tl.z, y, tl.t, tl.z, ym);
        default: return a.u + grow(a, 2, tl.t, tl.z, y);
      }
    };
    const long here = srow(a, tl.t, tl.z, y);
    for (int n = 0; n < a.N; ++n) {
      const ST* p = a.psi + n * field;
      float o_r[3][4], o_i[3][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int s = 0; s < 4; ++s) o_r[c][s] = o_i[c][s] = 0.f;
      // the t, z and y neighbours' rows (ghost rows across sharded faces)
      auto nbr = [&](int axis, bool fwd, int tn, int zn, int yn) {
        return nbr_row<HALO>(a, p, n, axis, fwd, tl.t, tl.z, y, tn, zn, yn);
      };
      hop_site<0, true, G5IN, G5OUT>(o_r, o_i, at(nbr(0, true, tl.tp, tl.z, y), x), lk(link(0), x));
      hop_site<0, false, G5IN, G5OUT>(o_r, o_i, at(nbr(0, false, tl.tm, tl.z, y), x), lk(link(1), x));
      hop_site<1, true, G5IN, G5OUT>(o_r, o_i, at(nbr(1, true, tl.t, tl.zp, y), x), lk(link(2), x));
      hop_site<1, false, G5IN, G5OUT>(o_r, o_i, at(nbr(1, false, tl.t, tl.zm, y), x), lk(link(3), x));
      hop_site<2, true, G5IN, G5OUT>(o_r, o_i, at(nbr(2, true, tl.t, tl.z, yp), x), lk(link(6), x));
      hop_site<2, false, G5IN, G5OUT>(o_r, o_i, at(nbr(2, false, tl.t, tl.z, ym), x), lk(link(5), x));
      hop_site<3, true, G5IN, G5OUT>(o_r, o_i, at(p + here, xp), lk(link(4), x));
      hop_site<3, false, G5IN, G5OUT>(o_r, o_i, at(p + here, xm), lk(link(4), xm));

      // epilogue: the site term m (g5out g5in) psi + i tw (g5out g5 g5in)
      // psi per spin block, multiplying by i as (re, im) -> (-im, re), plus
      // the hops' sum with its -1/2
      const auto c0 = at(p + here, x);
      ST* o = a.out + n * field + here + x;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float m = s < 2 ? a.m_hi : a.m_lo;
        const float tw = s < 2 ? a.tw_hi : a.tw_lo;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = (s * 3 + c) * 2;
          const float pr = c0(k), pi = c0(k + 1);
          if constexpr (std::is_same_v<ST, wilson::f16>) {
            float vr, vi;
            f16_epilogue(m, tw, twisted, pr, pi, o_r[c][s], o_i[c][s], vr,
                         vi);
            o[k * X] = narrow<ST>(vr);
            o[(k + 1) * X] = narrow<ST>(vi);
            continue;
          }
          float nr = m * pr, ni = m * pi;
          if (twisted) {
            nr -= tw * pi;
            ni += tw * pr;
          }
          o[k * X] = narrow<ST>(nr + -0.5f * o_r[c][s]);
          o[(k + 1) * X] = narrow<ST>(ni + -0.5f * o_i[c][s]);
        }
      }
    }
  }
}

// One 32-bit word of shared memory as one load: read through a 16-bit
// pointer, nvcc splits a link word into a 16-bit load a half.
template <class T>
__device__ __forceinline__ unsigned lds_word(const T* p) {
  unsigned w;
  asm("ld.shared.b32 %0, [%1];" : "=r"(w) : "r"(stage::smem_u32(p)));
  return w;
}

// The pair instance (bf16 or float16, X = 32, staged links, 4-byte aligned
// bases):
// one thread per two sites (x, x + 1) of the tile, x even, all N
// right-hand sides, one at a time.  Every component of the two sites is
// one 32-bit word, read once, whose halves feed the one-site hop code
// (hop_site) once per site; the X hops read the unaligned pairs from the
// two aligned words around them (the forward neighbours x + 1, x + 2 are
// the high half of the pair's own word and the low half of the next
// pair's; the backward ones x - 1, x the high half of the previous pair's
// and the low half of its own; the backward X link likewise), wrapping at
// the row's ends.  With STEP = 2 the loop runs hop by hop over the two
// sites: each link word is one 32-bit shared load for both (lds_word; the
// backward X link two), 144 loads where the sites' 16-bit halves were
// 270.  With STEP = 1 it runs one site's eight hops, then the other's,
// each link half read where hop_site uses it: the float16 instance at
// N = 1, where STEP = 2 was 1.7 % slower (and STEP = 1 with each hop's
// halves read ahead into registers 2.6 %); at N = 2-8 STEP = 2 was 2.7-
// 5.8 % faster, and bf16 no slower at any N (PERF.md).  Either way each
// site sums its hops in the one-site order, so the outputs stay bitwise
// the one-site instance's.  Links widened once for a chunk of RHS, the
// next RHS's rows prefetched, one site a thread with 16-bit reads and f32
// links were all slower (PERF.md).  The outputs are stored a word at a
// time.  The staging is the one-site kernel's.  Two sites' 48 sums fit three 128-thread blocks an
// SM only with X compile time (168 registers); with X a runtime value the
// same code took 255 registers and spilled 256-672 bytes, and at X = 48
// ran slower than the one-site instance (PERF.md), so other widths keep
// that one.
template <class ST, bool G5IN, bool G5OUT, bool HALO, int STEP>
__global__ void __launch_bounds__(FULL_THREADS, 3)
wilson_full_pair_kernel(const ArgsOf<ST, HALO> a) {
  using bf16 = ST;  // the element type, bf16 or float16
  using wilson::HI;
  using wilson::LO;
  constexpr int X = 32, H = X / 2, ls = G * X;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = a.rows;
  const Tile tl = make_tile(a, blockIdx.x);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  bf16* sl = reinterpret_cast<bf16*>(smem_raw + 16);  // 6 b + 1 link rows
  if (a.bulk) {
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
  }
  stage_links<HALO, ST>(a, tl, sl, bar);
  if (a.bulk)
    mbar_wait(bar, 0);
  else
    __syncthreads();
  const long field = (long)a.T * a.Z * a.Y * S * X;
  const bool twisted = a.tw_hi != 0.f;
  // a row's component k at site xx, the half `sel` of the word at xx (even):
  // spinors through L1, links from shared memory
  auto at = [](const bf16* row, int xx, unsigned sel) {
    return [row, xx, sel](int k) {
      return wilson::half<ST>(wilson::ldg_word(row + xx + k * X), sel);
    };
  };
  auto lk = [](const bf16* row, int xx, unsigned sel) {
    return [row, xx, sel](int k) {
      return wilson::half<ST>(wilson::word(row + xx + k * X), sel);
    };
  };
  for (int w = threadIdx.x; w < tl.nb * H; w += blockDim.x) {
    const int r = w / H, x = 2 * (w - r * H);
    const int y = tl.y0 + r;
    const int yp = wrap(y + 1, a.Y), ym = wrap(y - 1, a.Y);
    // the next and the previous pair
    const int xp = x + 2 == X ? 0 : x + 2, xm = x == 0 ? X - 2 : x - 2;
    // link rows: u_t, u_t(t-1), u_z, u_z(z-1), u_x (g = 0..4), u_y at y - 1
    // and y (g = 5, 6)
    auto link = [&](int g) -> const bf16* {
      return sl + (g < 5 ? g * b + r : 5 * b + r + g - 5) * ls;
    };
    const long here = srow(a, tl.t, tl.z, y);
    // site h's own word and half; the words and halves of its X
    // neighbours x + h + 1 and x + h - 1
    const int own[2] = {x, x}, xf[2] = {x, xp}, xb[2] = {xm, x};
    const unsigned sel[2] = {LO, HI}, sx[2] = {HI, LO};
    for (int n = 0; n < a.N; ++n) {
      const bf16* p = a.psi + n * field;
      float o_r[2][3][4], o_i[2][3][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 3; ++c)
#pragma unroll
          for (int s = 0; s < 4; ++s) o_r[h][c][s] = o_i[h][c][s] = 0.f;
      // the t, z and y neighbours' rows (ghost rows across sharded faces)
      auto nbr = [&](int axis, bool fwd, int tn, int zn, int yn) {
        return nbr_row<HALO>(a, p, n, axis, fwd, tl.t, tl.z, y, tn, zn, yn);
      };
      // one hop for the sites h0 .. h0 + STEP - 1: psi's row `row` at
      // word psx[h], half pss[h]; the link row `lrow` at lx[h], half
      // lsel[h]: with STEP = 2 each word one load for both sites (unless
      // `split`, the backward X link), with STEP = 1 the site's halves
      // read where hop_site uses them
      auto hop = [&](auto mu_c, auto fwd_c, int h0, const bf16* row,
                     const int(&psx)[2], const unsigned(&pss)[2],
                     const bf16* lrow, const int(&lx)[2],
                     const unsigned(&lsel)[2], auto split_c) {
        constexpr int MU = decltype(mu_c)::value;
        constexpr bool FWD = decltype(fwd_c)::value;
        if constexpr (STEP == 1) {
          hop_site<MU, FWD, G5IN, G5OUT>(o_r[h0], o_i[h0],
                                         at(row, psx[h0], pss[h0]),
                                         lk(lrow, lx[h0], lsel[h0]));
        } else {
          float lv[2][G];
#pragma unroll
          for (int k = 0; k < G; ++k) {
            const unsigned w0 = lds_word(lrow + lx[0] + k * X);
            const unsigned w1 = decltype(split_c)::value
                                    ? lds_word(lrow + lx[1] + k * X)
                                    : w0;
            lv[0][k] = wilson::half<ST>(w0, lsel[0]);
            lv[1][k] = wilson::half<ST>(w1, lsel[1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            hop_site<MU, FWD, G5IN, G5OUT>(
                o_r[h], o_i[h], at(row, psx[h], pss[h]),
                [&lv, h](int k) { return lv[h][k]; });
        }
      };
      using I0 = std::integral_constant<int, 0>;
      using I1 = std::integral_constant<int, 1>;
      using I2 = std::integral_constant<int, 2>;
      using I3 = std::integral_constant<int, 3>;
      using F = std::true_type;
      using B = std::false_type;
      // the one-site kernel's hops in its order, for both sites at once
      // (STEP = 2) or for one site after the other
#pragma unroll
      for (int h0 = 0; h0 < 2; h0 += STEP) {
        hop(I0{}, F{}, h0, nbr(0, true, tl.tp, tl.z, y), own, sel, link(0), own, sel, B{});
        hop(I0{}, B{}, h0, nbr(0, false, tl.tm, tl.z, y), own, sel, link(1), own, sel, B{});
        hop(I1{}, F{}, h0, nbr(1, true, tl.t, tl.zp, y), own, sel, link(2), own, sel, B{});
        hop(I1{}, B{}, h0, nbr(1, false, tl.t, tl.zm, y), own, sel, link(3), own, sel, B{});
        hop(I2{}, F{}, h0, nbr(2, true, tl.t, tl.z, yp), own, sel, link(6), own, sel, B{});
        hop(I2{}, B{}, h0, nbr(2, false, tl.t, tl.z, ym), own, sel, link(5), own, sel, B{});
        hop(I3{}, F{}, h0, p + here, xf, sx, link(4), own, sel, B{});
        hop(I3{}, B{}, h0, p + here, xb, sx, link(4), xb, sx, F{});
      }

      // epilogue: the one-site kernel's, per site, on the centre's words
      bf16* o = a.out + n * field + here + x;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float m = s < 2 ? a.m_hi : a.m_lo;
        const float tw = s < 2 ? a.tw_hi : a.tw_lo;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int k = (s * 3 + c) * 2;
          const auto c0 = at(p + here, x, LO), c1 = at(p + here, x, HI);
          float v_r[2], v_i[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float pr = h ? c1(k) : c0(k), pi = h ? c1(k + 1) : c0(k + 1);
            if constexpr (std::is_same_v<ST, wilson::f16>) {
              f16_epilogue(m, tw, twisted, pr, pi, o_r[h][c][s],
                           o_i[h][c][s], v_r[h], v_i[h]);
              continue;
            }
            float nr = m * pr, ni = m * pi;
            if (twisted) {
              nr -= tw * pi;
              ni += tw * pr;
            }
            v_r[h] = nr + -0.5f * o_r[h][c][s];
            v_i[h] = ni + -0.5f * o_i[h][c][s];
          }
          wilson::store_pair(o + k * X, v_r[0], v_r[1]);
          wilson::store_pair(o + (k + 1) * X, v_i[0], v_i[1]);
        }
      }
    }
  }
}

// Launch one kernel instance; its opt-in for more than 48 KB of shared
// memory is kept per instance.
template <auto KERN, class A>
cudaError_t run(const A& a, int blocks, int threads, size_t smem,
                cudaStream_t s) {
  static stage::SmemOptIn opt_in;
  const cudaError_t err = opt_in.allow((const void*)KERN, smem);
  if (err != cudaSuccess) return err;
  KERN<<<blocks, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <class ST, bool HALO, bool G5IN, bool G5OUT, bool STAGED,
          int XC = 0>
cudaError_t launch(const ArgsOf<ST, HALO>& a, int blocks, int threads,
                   size_t smem, cudaStream_t s) {
  return run<wilson_full_kernel<ST, G5IN, G5OUT, STAGED, XC, HALO>>(
      a, blocks, threads, smem, s);
}

template <class ST, bool HALO, bool G5IN, bool G5OUT, int STEP = 2>
cudaError_t launch_pair(const ArgsOf<ST, HALO>& a, int blocks, int threads,
                        size_t smem, cudaStream_t s) {
  return run<wilson_full_pair_kernel<ST, G5IN, G5OUT, HALO, STEP>>(
      a, blocks, threads, smem, s);
}

// The instance of `key` (bits: g5in, g5out, staged, X = 32; 16 and up: the
// pair instance, with the g5 bits; 20 and up: float16's at N = 1, STEP =
// 1) with or without the ghost reads.
template <class ST, bool HALO>
cudaError_t dispatch(int key, const ArgsOf<ST, HALO>& a, int blocks,
                     int threads, size_t smem, cudaStream_t s) {
  if constexpr (std::is_same_v<ST, wilson::f16> && !HALO) {
    switch (key) {
      case 20: return launch_pair<ST, HALO, false, false, 1>(a, blocks, threads, smem, s);
      case 21: return launch_pair<ST, HALO, true, false, 1>(a, blocks, threads, smem, s);
      case 22: return launch_pair<ST, HALO, false, true, 1>(a, blocks, threads, smem, s);
      case 23: return launch_pair<ST, HALO, true, true, 1>(a, blocks, threads, smem, s);
      default: break;
    }
  }
  if constexpr (sizeof(ST) == 2) {
    switch (key) {
      case 16: return launch_pair<ST, HALO, false, false>(a, blocks, threads, smem, s);
      case 17: return launch_pair<ST, HALO, true, false>(a, blocks, threads, smem, s);
      case 18: return launch_pair<ST, HALO, false, true>(a, blocks, threads, smem, s);
      case 19: return launch_pair<ST, HALO, true, true>(a, blocks, threads, smem, s);
      default: break;
    }
  }
  switch (key) {
    case 0: return launch<ST, HALO, false, false, false>(a, blocks, threads, smem, s);
    case 1: return launch<ST, HALO, true, false, false>(a, blocks, threads, smem, s);
    case 2: return launch<ST, HALO, false, true, false>(a, blocks, threads, smem, s);
    case 3: return launch<ST, HALO, true, true, false>(a, blocks, threads, smem, s);
    case 4: return launch<ST, HALO, false, false, true>(a, blocks, threads, smem, s);
    case 5: return launch<ST, HALO, true, false, true>(a, blocks, threads, smem, s);
    case 6: return launch<ST, HALO, false, true, true>(a, blocks, threads, smem, s);
    case 7: return launch<ST, HALO, true, true, true>(a, blocks, threads, smem, s);
    case 12: return launch<ST, HALO, false, false, true, 32>(a, blocks, threads, smem, s);
    case 13: return launch<ST, HALO, true, false, true, 32>(a, blocks, threads, smem, s);
    case 14: return launch<ST, HALO, false, true, true, 32>(a, blocks, threads, smem, s);
    case 15: return launch<ST, HALO, true, true, true, 32>(a, blocks, threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <class ST>
int full(const void* u, const void* psi, void* out, int T, int Z, int Y,
         int X, int N, int g5in, int g5out, int rows, int ls, int tchunk,
         float m_hi, float m_lo, float tw_hi, float tw_lo, cudaStream_t s,
         const void* const* ghosts, int* pair) {
  // the block order's t chunks must tile T (make_tile)
  if (tchunk < 1 || T % tchunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = rows > 0;
  const int b = staged ? rows : 1;
  HaloArgs<ST> h{};
  FullArgs<ST>& a = h;
  a = FullArgs<ST>{static_cast<const ST*>(u), static_cast<const ST*>(psi),
                   static_cast<ST*>(out), T, Z, Y, X, N, b, tchunk, ls, 0,
                   m_hi, m_lo, tw_hi, tw_lo};
  bool halo = false, ghosts16 = true, ghosts4 = true;
  for (int i = 0; ghosts != nullptr && i < 9; ++i) {
    const uintptr_t g = reinterpret_cast<uintptr_t>(ghosts[i]);
    if (g == 0) continue;
    halo = true;
    ghosts4 = ghosts4 && (g & 3u) == 0;
    if (i < 6) {
      h.gsp[i / 2][i % 2] = static_cast<const ST*>(ghosts[i]);
    } else {
      h.glk[i - 6] = static_cast<const ST*>(ghosts[i]);
      ghosts16 = ghosts16 && (g & 15u) == 0;  // staged link rows
    }
  }
  // bulk copies need 16-byte rows, strides and bases (kernel.py::full_bulk)
  const bool bulk = staged && ((size_t)G * X * sizeof(ST)) % 16 == 0 &&
                    ((size_t)ls * sizeof(ST)) % 16 == 0 &&
                    (reinterpret_cast<uintptr_t>(u) & 15u) == 0 && ghosts16;
  a.bulk = bulk ? 1 : 0;
  const int blocks = T * Z * ((Y + b - 1) / b);
  int threads = b * X;
  threads = threads < FULL_THREADS ? ((threads + 31) / 32) * 32 : FULL_THREADS;
  // the mbarrier (with slack to 16 bytes) and the 6 b + 1 link rows
  const size_t smem =
      staged ? 16 + (size_t)(6 * b + 1) * ls * sizeof(ST) : 0;
  // X = 32 (the 32^3 x 64 lattice's rows, unpadded) has instances of its
  // own with X compile time
  const bool x32 = staged && X == 32 && ls == G * 32;
  int key = (g5in ? 1 : 0) | (g5out ? 2 : 0) | (staged ? 4 : 0) |
            (x32 ? 8 : 0);
  // the pair instance's rule (kernel.py::full_pair): 16-bit storage, the
  // X = 32 tiles, and every base 4-byte aligned, so that each pair of
  // sites is one word
  auto word = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
  };
  *pair = 0;
  if (sizeof(ST) == 2 && x32 && word(u) && word(psi) && word(out) &&
      ghosts4) {
    *pair = 1;
    key = 16 | (key & 3);
    // float16 at N = 1 without ghosts: one site's hops after the other's
    if (std::is_same_v<ST, wilson::f16> && N == 1 && !halo) key |= 4;
    threads = b * X / 2;  // a thread per two sites
    threads = threads < FULL_THREADS ? ((threads + 31) / 32) * 32
                                     : FULL_THREADS;
  }
  const cudaError_t err =
      halo ? dispatch<ST, true>(key, h, blocks, threads, smem, s)
           : dispatch<ST, false>(key, a, blocks, threads, smem, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g5in, g5out: the gamma5 flags (each instance has them compiled in);
// rows, ls: the tile plan of kernel.py::full_tile_plan (rows == 0: the
// links are read in place, nothing is staged; ls in elements); tchunk:
// the t planes a chunk of the block order takes before z, dividing T
// (kernel.py::full_tchunk: by default 4 with N > 1 right-hand sides, where
// a plane's rows are reused as t+1, centre and t-1 by blocks up to 2
// chunks apart and 4 planes a chunk keeps them in L2, else 1, which keeps
// the z neighbours closer, as N = 1 needs more; PERF.md); (m_hi,
// m_lo, tw_hi, tw_lo): the folded site term; storage: 0 float32, 1 bf16,
// 2 float16, for the field, the links and the ghost planes.  ghosts: null
// or nine pointers (null where an axis is not sharded): the psi planes
// before and after the block along T, Z and Y ([N][face rows][24][X]),
// then U_t, U_z and U_y at the previous rank's last plane ([face
// rows][18][X]); see HaloArgs.  *pair is set to 1 when a pair instance
// (bf16 or float16) ran, else 0.  Returns a cudaError_t code.
int wilson_full(const void* u, const void* psi, void* out, int T, int Z,
                int Y, int X, int N, int g5in, int g5out, int rows, int ls,
                int tchunk, float m_hi, float m_lo, float tw_hi, float tw_lo,
                int storage, void* stream, const void* const* ghosts,
                int* pair) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 1)
    return full<wilson::bf16>(u, psi, out, T, Z, Y, X, N, g5in, g5out, rows,
                              ls, tchunk, m_hi, m_lo, tw_hi, tw_lo, s, ghosts,
                              pair);
  if (storage == 2)
    return full<wilson::f16>(u, psi, out, T, Z, Y, X, N, g5in, g5out, rows,
                             ls, tchunk, m_hi, m_lo, tw_hi, tw_lo, s, ghosts,
                             pair);
  return full<float>(u, psi, out, T, Z, Y, X, N, g5in, g5out, rows, ls,
                     tchunk, m_hi, m_lo, tw_hi, tw_lo, s, ghosts, pair);
}

}  // extern "C"
