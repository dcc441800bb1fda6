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
// `_dslash_kernel` (launched by `dslash_pallas`).
//
// Layouts (f32): psi, out [N][T][Z][Y][24][X]; u [4][T][Z][Y][18][X],
// component index (spin*3+color)*2+reim resp. (row*3+col)*2+reim, X
// innermost.  Every direction wraps periodically; the X neighbours are
// x +- 1 on the full axis (K1's parity-compressed j + s_out does not apply).
//
// What bounds it: memory.  Each site's 4 links (72 floats) are read once,
// and per RHS 24 floats of spinor in (each spinor is a neighbour of 8 sites,
// so once from DRAM when the caches hold the planes) and 24 out:
// (72/N + 48)*4 bytes per site and RHS against 1320 flops, under 3 flop/byte
// at N = 1, far below the card's fp32 ridge of 20.  The design, K1's:
//  * one thread per site, threads along X, so each of the 24 (18) component
//    planes is read with neighbouring threads on neighbouring addresses; the
//    X shift moves a whole row together and stays coalesced but for the wrap;
//  * the spin-projection trick with its spin structure fixed at compile
//    time (wilson_common.cuh, shared with K1): the kernel is a template on
//    g5in and g5out, each hop on its direction and sign, so a projection
//    is 12 complex adds;
//  * the site term as four floats per launch: (m + 4) on spins 0,1 and
//    +-(m + 4) on spins 2,3 (negated when exactly one flag is set), and the
//    twist on spins 0,1 and +-twist on spins 2,3 (negated when the flags
//    agree), computed on the host; it is added in the epilogue, as K1 adds
//    its accumulator (seeding the sum with it spilled more);
//  * the thread loops over the N right-hand sides with the same per-site
//    instruction sequence for every n, so a batched launch equals N single
//    launches bitwise; links are re-read for each n from L1/L2.  K1's
//    staged tiles (links held across the batch, TMA bulk copies into
//    shared memory) are not carried over yet: K4's own redesign (launch
//    geometry, batch reuse, registers) is queued.
// Offsets are 64-bit throughout: an N = 4 field at 32^3 x 64 holds 201 M
// floats.

#include <cuda_runtime.h>

#include "wilson_common.cuh"

namespace {

using wilson::G;
using wilson::S;
using wilson::hop_site;

// The site term's coefficients on spins 0,1 (hi) and 2,3 (lo).
struct SiteTerm {
  float m_hi, m_lo, tw_hi, tw_lo;
};

template <bool G5IN, bool G5OUT>
__global__ void __launch_bounds__(128)
wilson_full_kernel(const float* __restrict__ u, const float* __restrict__ psi,
                   float* __restrict__ out, int T, int Z, int Y, int X, int N,
                   const SiteTerm st) {
  const long sites = (long)T * Z * Y * X;
  const long site = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= sites) return;
  const int x = (int)(site % X);
  long rest = site / X;
  const int y = (int)(rest % Y);
  rest /= Y;
  const int z = (int)(rest % Z);
  const int t = (int)(rest / Z);

  const int tp = (t + 1 == T) ? 0 : t + 1, tm = (t == 0) ? T - 1 : t - 1;
  const int zp = (z + 1 == Z) ? 0 : z + 1, zm = (z == 0) ? Z - 1 : z - 1;
  const int yp = (y + 1 == Y) ? 0 : y + 1, ym = (y == 0) ? Y - 1 : y - 1;
  const int xp = (x + 1 == X) ? 0 : x + 1, xm = (x == 0) ? X - 1 : x - 1;

  const long xs = X;
  auto sp = [&](int tt, int zz, int yy, int xx) -> long {
    return (((long)tt * Z + zz) * Y + yy) * S * xs + xx;
  };
  auto gl = [&](int mu, int tt, int zz, int yy, int xx) -> long {
    return ((((long)mu * T + tt) * Z + zz) * Y + yy) * G * xs + xx;
  };
  auto at = [xs](const float* p) {
    return [p, xs](int k) { return __ldg(p + k * xs); };
  };
  const long field = (long)T * Z * Y * S * xs;
  const long here = sp(t, z, y, x);
  const bool twisted = st.tw_hi != 0.f;

  for (int n = 0; n < N; ++n) {
    const float* p = psi + n * field;
    float o_r[3][4], o_i[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int s = 0; s < 4; ++s) o_r[c][s] = o_i[c][s] = 0.f;

    hop_site<0, true, G5IN, G5OUT>(o_r, o_i, at(p + sp(tp, z, y, x)), at(u + gl(0, t, z, y, x)));
    hop_site<0, false, G5IN, G5OUT>(o_r, o_i, at(p + sp(tm, z, y, x)), at(u + gl(0, tm, z, y, x)));
    hop_site<1, true, G5IN, G5OUT>(o_r, o_i, at(p + sp(t, zp, y, x)), at(u + gl(1, t, z, y, x)));
    hop_site<1, false, G5IN, G5OUT>(o_r, o_i, at(p + sp(t, zm, y, x)), at(u + gl(1, t, zm, y, x)));
    hop_site<2, true, G5IN, G5OUT>(o_r, o_i, at(p + sp(t, z, yp, x)), at(u + gl(2, t, z, y, x)));
    hop_site<2, false, G5IN, G5OUT>(o_r, o_i, at(p + sp(t, z, ym, x)), at(u + gl(2, t, z, ym, x)));
    hop_site<3, true, G5IN, G5OUT>(o_r, o_i, at(p + sp(t, z, y, xp)), at(u + gl(3, t, z, y, x)));
    hop_site<3, false, G5IN, G5OUT>(o_r, o_i, at(p + sp(t, z, y, xm)), at(u + gl(3, t, z, y, xm)));

    // epilogue: the site term m (g5out g5in) psi + i tw (g5out g5 g5in) psi
    // per spin block, multiplying by i as (re, im) -> (-im, re), plus the
    // hops' sum with its -1/2
    const float* c0 = p + here;
    float* o = out + n * field + here;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float m = s < 2 ? st.m_hi : st.m_lo;
      const float tw = s < 2 ? st.tw_hi : st.tw_lo;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pr = __ldg(c0 + ((s * 3 + c) * 2 + 0) * xs);
        const float pi = __ldg(c0 + ((s * 3 + c) * 2 + 1) * xs);
        float nr = m * pr, ni = m * pi;
        if (twisted) {
          nr -= tw * pi;
          ni += tw * pr;
        }
        o[((s * 3 + c) * 2 + 0) * xs] = nr + -0.5f * o_r[c][s];
        o[((s * 3 + c) * 2 + 1) * xs] = ni + -0.5f * o_i[c][s];
      }
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// g5in, g5out: the gamma5 flags (each instance has them compiled in);
// (m_hi, m_lo, tw_hi, tw_lo) is the folded site term.  Returns
// cudaGetLastError().
int wilson_full(const float* u, const float* psi, float* out, int T, int Z,
                int Y, int X, int N, int g5in, int g5out, float m_hi,
                float m_lo, float tw_hi, float tw_lo, void* stream) {
  const SiteTerm st{m_hi, m_lo, tw_hi, tw_lo};
  const long sites = (long)T * Z * Y * X;
  const int threads = 128;
  const unsigned blocks = (unsigned)((sites + threads - 1) / threads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kern = g5in ? (g5out ? wilson_full_kernel<true, true>
                            : wilson_full_kernel<true, false>)
                   : (g5out ? wilson_full_kernel<false, true>
                            : wilson_full_kernel<false, false>);
  kern<<<blocks, threads, 0, s>>>(u, psi, out, T, Z, Y, X, N, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
