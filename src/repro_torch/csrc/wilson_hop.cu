// K1 wilson_hop: the even-odd parity hop block of the Wilson operator on
// packed, parity-compressed half fields, for Hopper (sm_90a).
//
//   out = (acc_coeff + acc_twist i g5) psi_acc
//       + (hop_coeff + hop_twist i g5) g5out Hop(g5in psi),
//   Hop psi(x) = -1/2 sum_mu [ (1 - g_mu) U_mu(x) psi(x+mu)
//                            + (1 + g_mu) U_mu(x-mu)^dag psi(x-mu) ]
//
// Replaces the Pallas kernel repro/kernels/wilson_dslash/kernel.py
// `_dslash_parity_kernel` (launched by `_dslash_parity_pallas`, which
// `dslash_eo_pallas` / `dslash_oe_pallas` call with parity 0 / 1).
//
// Layouts (float32, bf16 or float16, one type per launch): psi, psi_acc, out
// [N][T][Z][Y][24][Xh]; u_out, u_nbr
// [4][T][Z][Y][18][Xh], component index (spin*3+color)*2+reim resp.
// (row*3+col)*2+reim, X innermost.  u_out holds the links at the output
// parity's sites (forward hops), u_nbr those at the neighbour parity
// (backward hops take U_mu(x-mu)^dag there).  A "row" below is one
// (t, z, y) line of a field: 24 (spinor) or 18 (link) planes of Xh
// elements.
//
// What bounds it: memory.  Per output site and RHS the kernel must read
// 8 links (144 floats; no link is read by two sites), the neighbours'
// spinors (each read by 8 sites, once from DRAM at best) and the
// accumulator, and write 24 floats: about 1.7 flop/byte at N = 1, far
// below the card's fp32 ridge.  Its first version, one thread per site
// with every operand a 4-byte load into registers, needed 168 registers,
// held few bytes in flight per SM and reached 42 % of the bytes bound; a
// batch re-read the links for every RHS.  The design:
//  * a block owns a tile (t, z, y0 .. y0+b-1, all Xh) and stages every
//    row the tile reads in shared memory with TMA bulk copies
//    (cp.async.bulk, completion counted on one mbarrier; the helpers are
//    stage.cuh's, shared with K4): the centre rows
//    y0-1 .. y0+b (the Y and X neighbours, the Y wrap a row of its own),
//    the t+-1 and z+-1 rows, the accumulator rows and the 8 link rows per
//    y.  Bytes in flight cost no registers, and each neighbour spinor is
//    fetched from L2 (5b+2)/b times per site instead of 8;
//  * three threads per site, one per output colour: each projects all
//    three colours of the neighbour (12 complex adds) and multiplies one
//    link row, so a thread holds 8 accumulators and few operands;
//  * the spin structure is compile time (wilson_common.cuh): the kernel
//    is a template on g5in and g5out, and every hop on its direction and
//    sign;
//  * links are staged once per tile and serve all N right-hand sides;
//    the spinor rows of RHS n are staged after RHS n-1 is done, and other
//    resident blocks cover the wait.  Every RHS runs the same instruction
//    sequence on the same staged layout, so a batched launch equals N
//    single launches bitwise;
//  * a tile whose rows a bulk copy cannot take (a link row is 18 Xh
//    elements, a multiple of 16 bytes only for even Xh in f32 and Xh a
//    multiple of 8 in bf16 with its padded strides; a base pointer off 16
//    bytes) is staged by all threads with plain loads instead; a row too
//    wide for shared memory (Xh above about 170 in f32) is read from
//    global memory in place (STAGED = false).  Same compute code, every
//    shape;
//  * bf16 storage (the mixed-precision solve's inner operator) stages the
//    rows as stored, so a tile takes half the bytes of shared memory and
//    of traffic, and widens each value to f32 where a thread reads it
//    (wilson_common.cuh); the sums and the epilogue are f32 and each
//    output is rounded once on its store.  The f32 instances are the same
//    code with T = float.  Read one bf16 element at a time, that code
//    issues as many shared loads as the f32 one for half the bytes and
//    ran no faster (PERF.md); so at even Xh with 4-byte aligned bases bf16
//    runs a pair instance instead (wilson_hop_pair_kernel): a work item is
//    one colour of two adjacent sites, each component of both one 32-bit
//    word of a staged row (half the loads), twice the sites a tile (b = 4
//    at Xh = 16) for the same threads, and each site computed with the
//    one-site code and its roundings, so its outputs equal the one-site
//    instance's bitwise.  Odd Xh and misaligned bases keep the one-site
//    instance (a shape rule, kernel.py::hop_pair);
//  * float16 storage is bf16's in every respect: the same one-site and
//    pair instances on 16-bit elements (__half2 words), widened with
//    __half2float and narrowed once with __float2half_rn /
//    __floats2half2_rn (subnormals kept, round to nearest even).  Its two
//    instances share one written-out epilogue (pair_epilogue), so they
//    agree bitwise whatever FMA contractions nvcc would choose;
//  * the Schur axpy and the twisted-mass site term stay in the epilogue,
//    so the Schur normal operator is four launches of this kernel.
//  The host (kernels/wilson_dslash/kernel.py::hop_tile_plan) picks b and
//  the shared-memory strides; the same plan drives the CPU tests'
//  emulation.  Offsets are 64-bit: an N = 4 half field at 32^3 x 64 holds
//  100 M floats.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "stage.cuh"
#include "wilson_common.cuh"

namespace {

using wilson::G;
using wilson::S;
using wilson::hop_colour;
using wilson::narrow;
using wilson::wide;
using stage::bulk_copy;
using stage::mbar_expect;
using stage::mbar_init;
using stage::mbar_wait;

constexpr int HOP_THREADS = 256;  // most threads a block; <= 128 registers

template <class T>
struct HopArgs {
  const T* u_out;
  const T* u_nbr;
  const T* psi;
  const T* acc;  // null: no accumulator
  T* out;
  int T_, Z, Y, Xh, N, parity;
  int rows;            // b, the tile's y extent
  int ls, ss;          // shared-memory row strides (elements) of links, spinors
  int bulk;            // stage with TMA bulk copies (else plain loads)
  float hc, ht;        // -1/2 hop_coeff, -1/2 hop_twist (the hop's -1/2)
  float ac, at;        // acc_coeff, acc_twist
};

// The tile's geometry and where each row it reads lives.
struct Tile {
  int t, z, y0, nb, tp, tm, zp, zm;
  __device__ int wrap_y(int y, int Y) const {
    return y < 0 ? y + Y : (y >= Y ? y - Y : y);
  }
};

template <class T>
__device__ __forceinline__ long srow(const HopArgs<T>& a, int t, int z,
                                     int y) {
  return (((long)t * a.Z + z) * a.Y + y) * S * a.Xh;
}
template <class T>
__device__ __forceinline__ long grow(const HopArgs<T>& a, int mu, int t,
                                     int z, int y) {
  return ((((long)mu * a.T_ + t) * a.Z + z) * a.Y + y) * G * a.Xh;
}

// Byte offset of the mbarrier: after the 8 b link rows and 6 b + 2 spinor
// rows, 8-byte aligned, with 8 bytes of slack (see the host).
template <class T>
__host__ __device__ __forceinline__ size_t bar_offset(int b, int ls, int ss) {
  const size_t rows = ((size_t)8 * b * ls + (size_t)(6 * b + 2) * ss) * sizeof(T);
  return ((rows + 7) & ~(size_t)7) + 8;
}

// Link row k of the tile (8 groups of nb): group g = hop 2 mu + (0 fwd,
// 1 bwd), row i = y0 + i, the backward Y link from row y - 1.
template <class T>
__device__ __forceinline__ const T* link_src(const HopArgs<T>& a,
                                             const Tile& tl, int g, int i) {
  const int y = tl.y0 + i, mu = g >> 1;
  if (!(g & 1)) return a.u_out + grow(a, mu, tl.t, tl.z, y);
  switch (mu) {
    case 0: return a.u_nbr + grow(a, 0, tl.tm, tl.z, y);
    case 1: return a.u_nbr + grow(a, 1, tl.t, tl.zm, y);
    case 2: return a.u_nbr + grow(a, 2, tl.t, tl.z, tl.wrap_y(y - 1, a.Y));
    default: return a.u_nbr + grow(a, 3, tl.t, tl.z, y);
  }
}

// Spinor row k of the tile for RHS n: groups t+1, t-1, z+1, z-1 (nb rows
// each, staged at g*b + i), the centre rows y0-1 .. y0+nb (at 4b + i), the
// accumulator rows (at 5b + 2 + i).
template <class T>
__device__ __forceinline__ const T* spin_src(const HopArgs<T>& a,
                                             const Tile& tl, long nf, int k,
                                             int* slot) {
  const int nb = tl.nb;
  if (k < 4 * nb) {
    const int g = k / nb, i = k - g * nb, y = tl.y0 + i;
    *slot = g * a.rows + i;
    const int t = g == 0 ? tl.tp : (g == 1 ? tl.tm : tl.t);
    const int z = g == 2 ? tl.zp : (g == 3 ? tl.zm : tl.z);
    return a.psi + nf + srow(a, t, z, y);
  }
  k -= 4 * nb;
  if (k < nb + 2) {
    *slot = 4 * a.rows + k;
    return a.psi + nf + srow(a, tl.t, tl.z, tl.wrap_y(tl.y0 - 1 + k, a.Y));
  }
  k -= nb + 2;
  *slot = 5 * a.rows + 2 + k;
  return a.acc + nf + srow(a, tl.t, tl.z, tl.y0 + k);
}

// Stage the tile's rows for RHS n (and the links when `links`) into
// shared memory; returns once the rows are issued (bulk) or written
// (plain, after a barrier).
template <class T>
__device__ __forceinline__ void stage(const HopArgs<T>& a, const Tile& tl,
                                      T* sl, T* ss, uint64_t* bar, int n,
                                      bool links) {
  const long nf = (long)n * a.T_ * a.Z * a.Y * S * a.Xh;
  const int nl = links ? 8 * tl.nb : 0;
  const int ns = 5 * tl.nb + 2 + (a.acc ? tl.nb : 0);
  const int llen = G * a.Xh, slen = S * a.Xh;
  if (a.bulk) {
    if (threadIdx.x >= 32) return;
    if (threadIdx.x == 0)
      mbar_expect(bar, (uint32_t)((nl * llen + ns * slen) * sizeof(T)));
    __syncwarp();
    for (int k = threadIdx.x; k < nl + ns; k += 32) {
      if (k < nl) {
        const int g = k / tl.nb, i = k - g * tl.nb;
        bulk_copy(sl + (g * a.rows + i) * a.ls, link_src(a, tl, g, i),
                  (uint32_t)(llen * sizeof(T)), bar);
      } else {
        int slot;
        const T* src = spin_src(a, tl, nf, k - nl, &slot);
        bulk_copy(ss + slot * a.ss, src, (uint32_t)(slen * sizeof(T)), bar);
      }
    }
    return;
  }
  for (int k = 0; k < nl + ns; ++k) {
    const T* src;
    T* dst;
    int len;
    if (k < nl) {
      const int g = k / tl.nb, i = k - g * tl.nb;
      src = link_src(a, tl, g, i);
      dst = sl + (g * a.rows + i) * a.ls;
      len = llen;
    } else {
      int slot;
      src = spin_src(a, tl, nf, k - nl, &slot);
      dst = ss + slot * a.ss;
      len = slen;
    }
    for (int e = threadIdx.x; e < len; e += blockDim.x)
      dst[e] = wilson::ldg(src + e);
  }
  __syncthreads();
}

// The one-site kernel's epilogue for spin s of one site, its roundings
// written out.  That kernel writes nr = hc hr, nr -= hg hi, nr += ac ar,
// nr -= ag ai (ni alike) and leaves nvcc free to contract a product and a
// sum into one FMA, and which product it fuses differs between the three
// code paths it splits the loop body into (no accumulator; accumulator
// and twist; accumulator, no twist) and between spins.  Written as plain
// expressions in the pair kernel, whose code paths differ, the same
// source was contracted otherwise and gave 1-ulp differences.  The FMAs
// here are those of the one-site bf16 instances as nvcc 12.9 compiles
// them for sm_90a (read from their PTX and SASS, every instance alike), so
// a pair rounds each site as the one-site instance does; the tests hold
// the two instances bitwise equal on the card.  The float16 instances,
// one-site and pair, both call this function, so they agree whatever
// nvcc would contract.
template <class T>
__device__ __forceinline__ void pair_epilogue(const HopArgs<T>& a,
                                              int s, float hr, float hi,
                                              float ar, float ai, float& nr,
                                              float& ni) {
  const float g5 = s < 2 ? 1.f : -1.f;
  const float hg = a.ht * g5;
  if (!a.acc) {
    nr = __fmul_rn(a.hc, hr);
    ni = __fmul_rn(a.hc, hi);
    if (a.ht != 0.f) {
      nr = __fmaf_rn(-hg, hi, nr);
      ni = __fmaf_rn(hg, hr, ni);
    }
    return;
  }
  if (a.ht != 0.f) {
    nr = __fmaf_rn(a.hc, hr, -__fmul_rn(hg, hi));
    ni = s < 2 ? __fmaf_rn(hg, hr, __fmul_rn(a.hc, hi))
               : __fmaf_rn(a.hc, hi, __fmul_rn(hg, hr));
    nr = __fmaf_rn(a.ac, ar, nr);
    ni = __fmaf_rn(a.ac, ai, ni);
  } else if (s == 0) {
    nr = __fmaf_rn(a.ac, ar, __fmul_rn(a.hc, hr));
    ni = __fmaf_rn(a.ac, ai, __fmul_rn(a.hc, hi));
  } else {
    nr = __fmaf_rn(a.hc, hr, __fmul_rn(a.ac, ar));
    ni = __fmaf_rn(a.hc, hi, __fmul_rn(a.ac, ai));
  }
  if (a.at != 0.f) {
    const float ag = a.at * g5;
    nr = __fmaf_rn(-ag, ai, nr);
    ni = __fmaf_rn(ag, ar, ni);
  }
}

template <class T, bool G5IN, bool G5OUT, bool STAGED>
__global__ void __launch_bounds__(HOP_THREADS, 2)
wilson_hop_kernel(const HopArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int nyb = (a.Y + a.rows - 1) / a.rows;
  Tile tl;
  {
    const int yb = blockIdx.x % nyb;
    const int tz = blockIdx.x / nyb;
    tl.z = tz % a.Z;
    tl.t = tz / a.Z;
    tl.y0 = yb * a.rows;
    tl.nb = min(a.rows, a.Y - tl.y0);
    tl.tp = tl.t + 1 == a.T_ ? 0 : tl.t + 1;
    tl.tm = tl.t == 0 ? a.T_ - 1 : tl.t - 1;
    tl.zp = tl.z + 1 == a.Z ? 0 : tl.z + 1;
    tl.zm = tl.z == 0 ? a.Z - 1 : tl.z - 1;
  }
  const int b = a.rows, xh = a.Xh;
  T* sl = smem;                                // 8 b link rows
  T* ss = smem + 8 * b * a.ls;                 // 6 b + 2 spinor rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem_raw + bar_offset<T>(b, a.ls, a.ss));
  if (STAGED && a.bulk) {
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
  }
  const long field = (long)a.T_ * a.Z * a.Y * S * xh;
  const int work = 3 * tl.nb * xh;  // (colour, row, j) items of the tile

  for (int n = 0; n < a.N; ++n) {
    if (STAGED) {
      stage(a, tl, sl, ss, bar, n, n == 0);
      if (a.bulk) mbar_wait(bar, n & 1);
    }
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      const int c = w / (tl.nb * xh);
      const int rj = w - c * tl.nb * xh;
      const int r = rj / xh, j = rj - r * xh;
      const int y = tl.y0 + r;
      const int s_out = (tl.t + tl.z + y + a.parity) & 1;
      const int jf = j + s_out == xh ? 0 : j + s_out;
      const int jb = j - (1 - s_out) < 0 ? xh - 1 : j - (1 - s_out);
      // row pointers, made where each hop reads them: the staged copies,
      // or the fields in place
      const long nf = (long)n * field;
      auto spin = [&](int g) -> const T* {  // t+1, t-1, z+1, z-1, acc
        if (STAGED) return ss + (g < 4 ? g * b + r : 5 * b + 2 + r) * a.ss;
        if (g == 4) return a.acc + nf + srow(a, tl.t, tl.z, y);
        return a.psi + nf +
               srow(a, g == 0 ? tl.tp : (g == 1 ? tl.tm : tl.t),
                    g == 2 ? tl.zp : (g == 3 ? tl.zm : tl.z), y);
      };
      auto centre = [&](int d) -> const T* {  // rows y - 1, y, y + 1
        if (STAGED) return ss + (4 * b + r + d) * a.ss;
        return a.psi + nf + srow(a, tl.t, tl.z, tl.wrap_y(y - 1 + d, a.Y));
      };
      auto link = [&](int g) -> const T* {
        if (STAGED) return sl + (g * b + r) * a.ls;
        return link_src(a, tl, g, r);
      };
      float o_r[4] = {0.f, 0.f, 0.f, 0.f}, o_i[4] = {0.f, 0.f, 0.f, 0.f};
      auto at = [xh](const T* row, int jj) {
        return [row, jj, xh](int k) { return wide(row[k * xh + jj]); };
      };
      hop_colour<0, true, G5IN, G5OUT>(o_r, o_i, c, at(spin(0), j), at(link(0), j));
      hop_colour<0, false, G5IN, G5OUT>(o_r, o_i, c, at(spin(1), j), at(link(1), j));
      hop_colour<1, true, G5IN, G5OUT>(o_r, o_i, c, at(spin(2), j), at(link(2), j));
      hop_colour<1, false, G5IN, G5OUT>(o_r, o_i, c, at(spin(3), j), at(link(3), j));
      hop_colour<2, true, G5IN, G5OUT>(o_r, o_i, c, at(centre(2), j), at(link(4), j));
      hop_colour<2, false, G5IN, G5OUT>(o_r, o_i, c, at(centre(0), j), at(link(5), j));
      hop_colour<3, true, G5IN, G5OUT>(o_r, o_i, c, at(centre(1), jf), at(link(6), j));
      hop_colour<3, false, G5IN, G5OUT>(o_r, o_i, c, at(centre(1), jb), at(link(7), jb));

      // epilogue: site-term maps on the hop (with its -1/2) and the
      // accumulator; i g5 mixes each component's re/im planes with the
      // spin block's g5 sign
      T* o = a.out + nf + srow(a, tl.t, tl.z, y) + j;
      const T* acc_row = a.acc ? spin(4) : nullptr;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float g5 = s < 2 ? 1.f : -1.f;
        const float hr = o_r[s], hi = o_i[s];
        float nr = a.hc * hr, ni = a.hc * hi;
        if (a.ht != 0.f) {
          const float hg = a.ht * g5;
          nr -= hg * hi;
          ni += hg * hr;
        }
        const int k = (s * 3 + c) * 2;
        if constexpr (std::is_same_v<T, wilson::f16>) {
          // float16: the pair instance's roundings, written out
          // (pair_epilogue), so that the two instances agree bitwise
          const float ar = a.acc ? wide(acc_row[k * xh + j]) : 0.f;
          const float ai = a.acc ? wide(acc_row[(k + 1) * xh + j]) : 0.f;
          pair_epilogue(a, s, hr, hi, ar, ai, nr, ni);
        } else if (a.acc) {
          const float ar = wide(acc_row[k * xh + j]);
          const float ai = wide(acc_row[(k + 1) * xh + j]);
          nr += a.ac * ar;
          ni += a.ac * ai;
          if (a.at != 0.f) {
            const float ag = a.at * g5;
            nr -= ag * ai;
            ni += ag * ar;
          }
        }
        o[k * xh] = narrow<T>(nr);
        o[(k + 1) * xh] = narrow<T>(ni);
      }
    }
    if (STAGED) __syncthreads();  // the staged rows are reused for n + 1
  }
}

// The pair instance (bf16 or float16, even Xh, 4-byte aligned bases): a
// work item is
// one output colour of two sites (j, j + 1) of a row, j even.  Every
// component of the two sites is one 32-bit word of a staged row (or of the
// field, in place), read once, whose halves feed the one-site hop code
// (hop_colour) once per site.  The X hops: a row's sites sit at x = 2 j +
// s_out, so the forward neighbours are the elements j + s_out + (0, 1) and
// the backward ones j - 1 + s_out + (0, 1); for s_out = 1 the forward pair
// is the high half of the pair's own word and the low half of the next
// pair's, for s_out = 0 the backward pair the high half of the previous
// pair's word and the low half of its own (the backward X link likewise),
// with the wrap at the row's ends.  s_out differs between the rows a warp
// spans, so the word and the half each site takes are selected, not
// branched on.  The outputs are stored a word at a time.  The staging is
// the one-site kernel's.
template <class T, bool G5IN, bool G5OUT, bool STAGED>
__global__ void __launch_bounds__(HOP_THREADS, 2)
wilson_hop_pair_kernel(const HopArgs<T> a) {
  using wilson::HI;
  using wilson::LO;
  using wilson::word;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int nyb = (a.Y + a.rows - 1) / a.rows;
  Tile tl;
  {
    const int yb = blockIdx.x % nyb;
    const int tz = blockIdx.x / nyb;
    tl.z = tz % a.Z;
    tl.t = tz / a.Z;
    tl.y0 = yb * a.rows;
    tl.nb = min(a.rows, a.Y - tl.y0);
    tl.tp = tl.t + 1 == a.T_ ? 0 : tl.t + 1;
    tl.tm = tl.t == 0 ? a.T_ - 1 : tl.t - 1;
    tl.zp = tl.z + 1 == a.Z ? 0 : tl.z + 1;
    tl.zm = tl.z == 0 ? a.Z - 1 : tl.z - 1;
  }
  const int b = a.rows, xh = a.Xh, hp = xh / 2;
  T* sl = smem;                                // 8 b link rows
  T* ss = smem + 8 * b * a.ls;                 // 6 b + 2 spinor rows
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem_raw + bar_offset<T>(b, a.ls, a.ss));
  if (STAGED && a.bulk) {
    if (threadIdx.x == 0) mbar_init(bar);
    __syncthreads();
  }
  const long field = (long)a.T_ * a.Z * a.Y * S * xh;
  const int work = 3 * tl.nb * hp;  // (colour, row, pair) items of the tile

  for (int n = 0; n < a.N; ++n) {
    if (STAGED) {
      stage(a, tl, sl, ss, bar, n, n == 0);
      if (a.bulk) mbar_wait(bar, n & 1);
    }
    for (int w = threadIdx.x; w < work; w += blockDim.x) {
      const int c = w / (tl.nb * hp);
      const int rq = w - c * tl.nb * hp;
      const int r = rq / hp, j = 2 * (rq - r * hp);
      const int y = tl.y0 + r;
      const int s_out = (tl.t + tl.z + y + a.parity) & 1;
      // the word and half each site (0, 1) reads in the X hops: forward
      // (j HI, j+2 LO) for s_out = 1, (j LO, j HI) for s_out = 0; backward
      // (j LO, j HI) for s_out = 1, (j-2 HI, j LO) for s_out = 0
      const int jn = j + 2 == xh ? 0 : j + 2, jv = j == 0 ? xh - 2 : j - 2;
      const int xf[2] = {j, s_out ? jn : j}, xb[2] = {s_out ? j : jv, j};
      const unsigned sf[2] = {s_out ? HI : LO, s_out ? LO : HI};
      const unsigned sb[2] = {s_out ? LO : HI, s_out ? HI : LO};
      const long nf = (long)n * field;
      auto spin = [&](int g) -> const T* {  // t+1, t-1, z+1, z-1, acc
        if (STAGED) return ss + (g < 4 ? g * b + r : 5 * b + 2 + r) * a.ss;
        if (g == 4) return a.acc + nf + srow(a, tl.t, tl.z, y);
        return a.psi + nf +
               srow(a, g == 0 ? tl.tp : (g == 1 ? tl.tm : tl.t),
                    g == 2 ? tl.zp : (g == 3 ? tl.zm : tl.z), y);
      };
      auto centre = [&](int d) -> const T* {  // rows y - 1, y, y + 1
        if (STAGED) return ss + (4 * b + r + d) * a.ss;
        return a.psi + nf + srow(a, tl.t, tl.z, tl.wrap_y(y - 1 + d, a.Y));
      };
      auto link = [&](int g) -> const T* {
        if (STAGED) return sl + (g * b + r) * a.ls;
        return link_src(a, tl, g, r);
      };
      float o_r[2][4], o_i[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < 4; ++s) o_r[h][s] = o_i[h][s] = 0.f;
      // a row's component k, the half `sel` of the word at jj (even)
      auto at = [xh](const T* row, int jj, unsigned sel) {
        return [row, jj, sel, xh](int k) {
          return wilson::half<T>(word(row + k * xh + jj), sel);
        };
      };
      // site j + h: the same hops in the same order as the one-site
      // kernel; site 1 reads the words site 0 read
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned sel = h ? HI : LO;
        hop_colour<0, true, G5IN, G5OUT>(o_r[h], o_i[h], c, at(spin(0), j, sel), at(link(0), j, sel));
        hop_colour<0, false, G5IN, G5OUT>(o_r[h], o_i[h], c, at(spin(1), j, sel), at(link(1), j, sel));
        hop_colour<1, true, G5IN, G5OUT>(o_r[h], o_i[h], c, at(spin(2), j, sel), at(link(2), j, sel));
        hop_colour<1, false, G5IN, G5OUT>(o_r[h], o_i[h], c, at(spin(3), j, sel), at(link(3), j, sel));
        hop_colour<2, true, G5IN, G5OUT>(o_r[h], o_i[h], c, at(centre(2), j, sel), at(link(4), j, sel));
        hop_colour<2, false, G5IN, G5OUT>(o_r[h], o_i[h], c, at(centre(0), j, sel), at(link(5), j, sel));
        hop_colour<3, true, G5IN, G5OUT>(o_r[h], o_i[h], c, at(centre(1), xf[h], sf[h]), at(link(6), j, sel));
        hop_colour<3, false, G5IN, G5OUT>(o_r[h], o_i[h], c, at(centre(1), xb[h], sb[h]), at(link(7), xb[h], sb[h]));
      }

      // epilogue: the one-site kernel's roundings (pair_epilogue), per
      // site, on the accumulator's words
      T* o = a.out + nf + srow(a, tl.t, tl.z, y) + j;
      const T* acc_row = a.acc ? spin(4) : nullptr;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = (s * 3 + c) * 2;
        float v_r[2], v_i[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float ar = 0.f, ai = 0.f;
          if (a.acc) {
            const unsigned sel = h ? HI : LO;
            ar = wilson::half<T>(word(acc_row + k * xh + j), sel);
            ai = wilson::half<T>(word(acc_row + (k + 1) * xh + j), sel);
          }
          pair_epilogue(a, s, o_r[h][s], o_i[h][s], ar, ai, v_r[h], v_i[h]);
        }
        wilson::store_pair(o + k * xh, v_r[0], v_r[1]);
        wilson::store_pair(o + (k + 1) * xh, v_i[0], v_i[1]);
      }
    }
    if (STAGED) __syncthreads();  // the staged rows are reused for n + 1
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

template <class T, bool G5IN, bool G5OUT, bool STAGED>
cudaError_t launch(const HopArgs<T>& a, int blocks, int threads, size_t smem,
                   cudaStream_t s) {
  return run<wilson_hop_kernel<T, G5IN, G5OUT, STAGED>>(a, blocks, threads,
                                                        smem, s);
}

template <class T, bool G5IN, bool G5OUT, bool STAGED>
cudaError_t launch_pair(const HopArgs<T>& a, int blocks, int threads,
                        size_t smem, cudaStream_t s) {
  return run<wilson_hop_pair_kernel<T, G5IN, G5OUT, STAGED>>(a, blocks,
                                                             threads, smem,
                                                             s);
}

template <class T>
int hop(const void* u_out, const void* u_nbr, const void* psi,
        const void* acc, void* out, int T_, int Z, int Y, int Xh, int N,
        int parity, int g5in, int g5out, int rows, int ls, int ss,
        float hop_coeff, float hop_twist, float acc_coeff, float acc_twist,
        cudaStream_t s, int* pair) {
  const bool staged = rows > 0;
  const int b = staged ? rows : 1;
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  // bulk copies need 16-byte rows, strides and bases (kernel.py::hop_bulk)
  auto rows16 = [](long elems) { return (elems * sizeof(T)) % 16 == 0; };
  const bool bulk = staged && rows16((long)G * Xh) && rows16((long)S * Xh) &&
                    rows16(ls) && rows16(ss) && aligned(u_out) &&
                    aligned(u_nbr) && aligned(psi) &&
                    (acc == nullptr || aligned(acc));
  const HopArgs<T> a{static_cast<const T*>(u_out), static_cast<const T*>(u_nbr),
                     static_cast<const T*>(psi), static_cast<const T*>(acc),
                     static_cast<T*>(out), T_, Z, Y, Xh, N, parity & 1,
                     b, ls, ss, bulk ? 1 : 0, -0.5f * hop_coeff,
                     -0.5f * hop_twist, acc_coeff, acc_twist};
  const int blocks = T_ * Z * ((Y + b - 1) / b);
  int threads = 3 * b * Xh;
  threads = threads < HOP_THREADS ? ((threads + 31) / 32) * 32 : HOP_THREADS;
  // links, spinor rows, the 8-byte mbarrier with its slack
  const size_t smem = staged ? bar_offset<T>(b, ls, ss) + 8 : 0;
  cudaError_t err;
  const int key = (g5in ? 1 : 0) | (g5out ? 2 : 0) | (staged ? 4 : 0);
  *pair = 0;
  if constexpr (sizeof(T) == 2) {
    // the pair instance's rule: even Xh (so are the plan's strides) and
    // every base 4-byte aligned, so that each pair of sites is one word
    auto word = [](const void* p) {
      return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
    };
    if (Xh % 2 == 0 && ls % 2 == 0 && ss % 2 == 0 && word(u_out) &&
        word(u_nbr) && word(psi) && word(acc) && word(out)) {
      *pair = 1;
      threads = 3 * b * Xh / 2;  // a thread per colour of two sites
      threads = threads < HOP_THREADS ? ((threads + 31) / 32) * 32
                                      : HOP_THREADS;
      switch (key) {
        case 0: err = launch_pair<T, false, false, false>(a, blocks, threads, smem, s); break;
        case 1: err = launch_pair<T, true, false, false>(a, blocks, threads, smem, s); break;
        case 2: err = launch_pair<T, false, true, false>(a, blocks, threads, smem, s); break;
        case 3: err = launch_pair<T, true, true, false>(a, blocks, threads, smem, s); break;
        case 4: err = launch_pair<T, false, false, true>(a, blocks, threads, smem, s); break;
        case 5: err = launch_pair<T, true, false, true>(a, blocks, threads, smem, s); break;
        case 6: err = launch_pair<T, false, true, true>(a, blocks, threads, smem, s); break;
        default: err = launch_pair<T, true, true, true>(a, blocks, threads, smem, s); break;
      }
      return static_cast<int>(err);
    }
  }
  switch (key) {
    case 0: err = launch<T, false, false, false>(a, blocks, threads, smem, s); break;
    case 1: err = launch<T, true, false, false>(a, blocks, threads, smem, s); break;
    case 2: err = launch<T, false, true, false>(a, blocks, threads, smem, s); break;
    case 3: err = launch<T, true, true, false>(a, blocks, threads, smem, s); break;
    case 4: err = launch<T, false, false, true>(a, blocks, threads, smem, s); break;
    case 5: err = launch<T, true, false, true>(a, blocks, threads, smem, s); break;
    case 6: err = launch<T, false, true, true>(a, blocks, threads, smem, s); break;
    default: err = launch<T, true, true, true>(a, blocks, threads, smem, s); break;
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows, ls, ss: the tile plan of kernel.py::hop_tile_plan (rows == 0: the
// rows are read in place, nothing is staged; strides in elements); acc may
// be null.  hop_coeff and hop_twist are the caller's, the hop's -1/2 is
// applied here.  storage: 0 float32, 1 bf16, 2 float16, for every field
// and link.  *pair is set to 1 when a pair instance (bf16 or float16) ran,
// else 0.  Returns a cudaError_t code.
int wilson_hop(const void* u_out, const void* u_nbr, const void* psi,
               const void* acc, void* out, int T, int Z, int Y, int Xh,
               int N, int parity, int g5in, int g5out, int rows, int ls,
               int ss, float hop_coeff, float hop_twist, float acc_coeff,
               float acc_twist, int storage, void* stream, int* pair) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 1)
    return hop<wilson::bf16>(u_out, u_nbr, psi, acc, out, T, Z, Y, Xh, N,
                             parity, g5in, g5out, rows, ls, ss, hop_coeff,
                             hop_twist, acc_coeff, acc_twist, s, pair);
  if (storage == 2)
    return hop<wilson::f16>(u_out, u_nbr, psi, acc, out, T, Z, Y, Xh, N,
                            parity, g5in, g5out, rows, ls, ss, hop_coeff,
                            hop_twist, acc_coeff, acc_twist, s, pair);
  return hop<float>(u_out, u_nbr, psi, acc, out, T, Z, Y, Xh, N, parity, g5in,
                    g5out, rows, ls, ss, hop_coeff, hop_twist, acc_coeff,
                    acc_twist, s, pair);
}

}  // extern "C"
