// Shared by K1 (wilson_hop.cu) and K4 (wilson_full.cu): the packed layout's
// component counts and one hop of the spin-projection trick, with the
// spin structure of every hop fixed at compile time.
//
// A hop adds -1/2 (1 -+ g_mu) U psi_nbr to the output spinor o.  It projects
// the neighbour's 4-spinor to two half spinors, multiplies each by the link
// (U for a forward hop, U^dag for a backward one), and rebuilds spins 2 and 3
// from the two products with a phase.  For r = 1 each projector has rank 2,
// so this halves the link work.
//
// What bounded the first version: the projection and reconstruction were
// generic complex 2x4 and 2x2 products with coefficients passed as kernel
// parameters, so the compiler could not drop the zeros of (1 -+ g_mu) nor
// use that its other entries are +-1 and +-i: 24 complex multiply-adds per
// projection where 12 complex adds do.  Here each hop is a template on its
// direction, its sign and the gamma5 flags.  In the DeGrand-Rossi basis
// (core/wilson.py) every g_mu has one nonzero per row, a unit i^k, and
// g5 = diag(+,+,-,-), so
//
//   half spinor a = 0, 1:  h_a = psi_a + i^q_a psi_{col_a}
//   output spin 2 + i:     o_{2+i} += i^ph_i (U h)_{src_i}
//
// with q, ph and the columns computed below by constexpr functions from
// the gamma table alone; gamma5 on the input negates psi_2,3 (q + 2), on
// the output spins 2,3 (ph + 2).  A unit i^k times (re, im) is a swap and
// sign changes, which the compiler folds into the adds.  The -1/2 of each
// hop is left to the caller's epilogue (a power of two: scaling the sum
// once rounds exactly as scaling every term).
// The same tables, written in Python, drive the CPU tests' emulations
// (kernels/wilson_dslash/kernel.py::hop_spec).
//
// Storage: the fields and links are float32, bf16 or float16 (the
// mixed-precision solve's low operator), one type T per launch.  Every
// value is widened to f32 where it is read into a register (`wide`), all
// arithmetic is f32, and an output is rounded once, to nearest even, where
// it is stored (`narrow`); staged rows stay in T in shared memory.  float16
// narrows with the intrinsics __float2half_rn / __floats2half2_rn, which
// keep subnormals (a late inner solve's residual entries, 1e-5 to 1e-7,
// lie below float16's smallest normal 6.1e-5) and round to nearest even as
// XLA's convert and torch's `.to(torch.float16)` do; a value past 65504
// becomes inf, as there.  The narrow pair instances read two adjacent
// sites' values of a component as one 32-bit word (`word`, `half`,
// `store_pair` below).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace wilson {

constexpr int S = 24;  // packed spinor components per site
constexpr int G = 18;  // packed link components

using bf16 = __nv_bfloat16;
using f16 = __half;

__device__ __forceinline__ float wide(float v) { return v; }
__device__ __forceinline__ float wide(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float wide(f16 v) { return __half2float(v); }

template <class T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 narrow<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ f16 narrow<f16>(float v) {
  return __float2half_rn(v);
}

// One element through the read-only (L1) path, as stored.
__device__ __forceinline__ float ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ bf16 ldg(const bf16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ f16 ldg(const f16* p) {
  return __ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// The pair instances of K1 and K4 (bf16 and float16 storage): a thread
// computes two adjacent sites of a row and reads each component of both as
// one 32-bit word (p 4-byte aligned), the lower site in the low half.
// `half<T>` widens one half of a word, exactly as `wide` widens the
// element: for bf16 a byte permute puts the selected half in the high 16
// bits of an f32 and zeroes the low ones; float16 converts the selected
// half (one instruction where the half is known at compile time).  Each site then runs the one-site
// hop code on its values (explicit fmaf and adds, rounded alike in every
// instance), so with an epilogue that rounds as the one-site kernel's does,
// a pair instance's outputs equal the one-site instance's bitwise.
constexpr unsigned LO = 0x1044u;  // the low half (the lower site)
constexpr unsigned HI = 0x3244u;  // the high half
template <class T>
__device__ __forceinline__ float half(unsigned w, unsigned sel);
template <>
__device__ __forceinline__ float half<bf16>(unsigned w, unsigned sel) {
  return __uint_as_float(__byte_perm(w, 0u, sel));
}
template <>
__device__ __forceinline__ float half<f16>(unsigned w, unsigned sel) {
  return __half2float(
      __ushort_as_half((unsigned short)(sel == HI ? w >> 16 : w)));
}
template <class T>
__device__ __forceinline__ unsigned word(const T* p) {
  return *reinterpret_cast<const unsigned*>(p);
}
template <class T>
__device__ __forceinline__ unsigned ldg_word(const T* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}
// Two sites' outputs, each rounded once to nearest even, as one word.
__device__ __forceinline__ void store_pair(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(f16* p, float v0, float v1) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(v0, v1);
}

// gamma_mu[row] has one nonzero, i^gamma_k at column gamma_col; mu in
// (t, z, y, x).  Columns: row ^ 2 for t, z and 3 - row for y, x; the
// powers of i, 2 bits each at 4 mu + row: t 0 0 0 0, z 1 3 3 1, y 2 0 0 2,
// x 1 1 3 3 (the same tables as kernel.py::GAMMA_COL / GAMMA_K).
__host__ __device__ constexpr int gamma_col(int mu, int row) {
  return mu < 2 ? (row ^ 2) : (3 - row);
}
__host__ __device__ constexpr int gamma_k(int mu, int row) {
  return (int)((0xF5827D00u >> (2 * (4 * mu + row))) & 3u);
}

// (1 + sigma g_mu), sigma = -1 forward (i^2), +1 backward (i^0)
__host__ __device__ constexpr int sigma_k(bool fwd) { return fwd ? 2 : 0; }
__host__ __device__ constexpr int proj_col(int mu, int a) {
  return gamma_col(mu, a);
}
__host__ __device__ constexpr int proj_k(int mu, bool fwd, bool g5in, int a) {
  return (sigma_k(fwd) + gamma_k(mu, a) + (g5in ? 2 : 0)) & 3;
}
__host__ __device__ constexpr int recon_src(int mu, int i) {
  return gamma_col(mu, 2 + i);
}
__host__ __device__ constexpr int recon_k(int mu, bool fwd, bool g5out,
                                          int i) {
  return (sigma_k(fwd) + gamma_k(mu, 2 + i) + (g5out ? 2 : 0)) & 3;
}

// (re, im) times i^K, the result added to (ar, ai)
template <int K>
__device__ __forceinline__ void add_unit(float& ar, float& ai, float re,
                                         float im) {
  if (K == 0) { ar += re; ai += im; }
  if (K == 1) { ar -= im; ai += re; }
  if (K == 2) { ar -= re; ai -= im; }
  if (K == 3) { ar += im; ai -= re; }
}

// The half spinor of colour c: h[a] = psi_a + i^q_a psi_col_a, psi read
// through `at(component)`.
template <int MU, bool FWD, bool G5IN, class At>
__device__ __forceinline__ void project(float (&h_r)[2], float (&h_i)[2],
                                        int c, const At& at) {
  constexpr int b0 = proj_col(MU, 0), b1 = proj_col(MU, 1);
  h_r[0] = at((0 * 3 + c) * 2 + 0);
  h_i[0] = at((0 * 3 + c) * 2 + 1);
  h_r[1] = at((1 * 3 + c) * 2 + 0);
  h_i[1] = at((1 * 3 + c) * 2 + 1);
  add_unit<proj_k(MU, FWD, G5IN, 0)>(h_r[0], h_i[0], at((b0 * 3 + c) * 2),
                                     at((b0 * 3 + c) * 2 + 1));
  add_unit<proj_k(MU, FWD, G5IN, 1)>(h_r[1], h_i[1], at((b1 * 3 + c) * 2),
                                     at((b1 * 3 + c) * 2 + 1));
}

// o[spin] (for one output colour) += the hop's contribution rebuilt from
// g[a] = (U h_a) of that colour.
template <int MU, bool FWD, bool G5OUT>
__device__ __forceinline__ void reconstruct(float (&o_r)[4], float (&o_i)[4],
                                            const float (&g_r)[2],
                                            const float (&g_i)[2]) {
  o_r[0] += g_r[0];
  o_i[0] += g_i[0];
  o_r[1] += g_r[1];
  o_i[1] += g_i[1];
  constexpr int s0 = recon_src(MU, 0), s1 = recon_src(MU, 1);
  add_unit<recon_k(MU, FWD, G5OUT, 0)>(o_r[2], o_i[2], g_r[s0], g_i[s0]);
  add_unit<recon_k(MU, FWD, G5OUT, 1)>(o_r[3], o_i[3], g_r[s1], g_i[s1]);
}

// (U h)[row] for a forward hop, (U^dag h)[row] for a backward one, both
// half spinors at once; the link read through `u(component)`.  Explicit
// fmaf keeps the rounding the same in every instance.
template <bool FWD, class Ul>
__device__ __forceinline__ void link_row(float (&g_r)[2], float (&g_i)[2],
                                         int row, const float (&h_r)[2][3],
                                         const float (&h_i)[2][3],
                                         const Ul& u) {
  g_r[0] = g_i[0] = g_r[1] = g_i[1] = 0.f;
#pragma unroll
  for (int col = 0; col < 3; ++col) {
    const int e = FWD ? (row * 3 + col) : (col * 3 + row);
    const float ur = u(e * 2 + 0);
    const float ui = FWD ? u(e * 2 + 1) : -u(e * 2 + 1);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      g_r[a] = fmaf(ur, h_r[a][col], fmaf(-ui, h_i[a][col], g_r[a]));
      g_i[a] = fmaf(ur, h_i[a][col], fmaf(ui, h_r[a][col], g_i[a]));
    }
  }
}

// One hop for one output colour `row`: project every colour of the
// neighbour, multiply by the link's row (column for U^dag), rebuild.
template <int MU, bool FWD, bool G5IN, bool G5OUT, class At, class Ul>
__device__ __forceinline__ void hop_colour(float (&o_r)[4], float (&o_i)[4],
                                           int row, const At& psi,
                                           const Ul& u) {
  float h_r[2][3], h_i[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float pr[2], pi[2];
    project<MU, FWD, G5IN>(pr, pi, c, psi);
    h_r[0][c] = pr[0];
    h_i[0][c] = pi[0];
    h_r[1][c] = pr[1];
    h_i[1][c] = pi[1];
  }
  float g_r[2], g_i[2];
  link_row<FWD>(g_r, g_i, row, h_r, h_i, u);
  reconstruct<MU, FWD, G5OUT>(o_r, o_i, g_r, g_i);
}

// One hop for all three output colours of a site (K4's one thread per
// site): the projection once, then the three link rows.
template <int MU, bool FWD, bool G5IN, bool G5OUT, class At, class Ul>
__device__ __forceinline__ void hop_site(float (&o_r)[3][4],
                                         float (&o_i)[3][4], const At& psi,
                                         const Ul& u) {
  float h_r[2][3], h_i[2][3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float pr[2], pi[2];
    project<MU, FWD, G5IN>(pr, pi, c, psi);
    h_r[0][c] = pr[0];
    h_i[0][c] = pi[0];
    h_r[1][c] = pr[1];
    h_i[1][c] = pi[1];
  }
#pragma unroll
  for (int row = 0; row < 3; ++row) {
    float g_r[2], g_i[2];
    link_row<FWD>(g_r, g_i, row, h_r, h_i, u);
    reconstruct<MU, FWD, G5OUT>(o_r[row], o_i[row], g_r, g_i);
  }
}

}  // namespace wilson
