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
// Layouts (f32): psi, psi_acc, out [N][T][Z][Y][24][Xh]; u_out, u_nbr
// [4][T][Z][Y][18][Xh], component index (spin*3+color)*2+reim resp.
// (row*3+col)*2+reim, X innermost.  u_out holds the links at the output
// parity's sites (forward hops), u_nbr those at the neighbour parity
// (backward hops take U_mu(x-mu)^dag there).
//
// What bounds it: memory.  Per output site and RHS the kernel must read
// 8 links (144 floats), 24 floats of neighbour spinor data (each spinor is
// read by 8 neighbours, so once from DRAM when the caches hold the
// planes) and write 24, plus 24 read for the accumulator: (144/N + 48)*4
// bytes against 1320 flops, about 1.7 flop/byte at N = 1, far below the
// card's fp32 ridge.  The design:
//  * one thread per output site, threads along X, so each of the 24 (18)
//    component planes is read with neighbouring threads on neighbouring
//    addresses; the X-neighbour shift (j + s_out, j - (1 - s_out)) moves
//    a whole row together and stays coalesced;
//  * the spin-projection trick: each hop projects the 4-spinor to two
//    half spinors before the SU(3) product, then rebuilds rows 2 and 3
//    from rows 0 and 1 with a phase, halving the link work;
//  * g5in/g5out and the hop direction's projector arrive as small
//    constant tables (kernel parameters, folded on the host), so the
//    dagger costs no extra pass;
//  * the Schur axpy and the twisted-mass site term are folded into the
//    epilogue, so the Schur normal operator is four launches of this
//    kernel and nothing else;
//  * the thread loops over the N right-hand sides in one launch with the
//    same per-site instruction sequence for every n, so a batched launch
//    equals N single launches bitwise; the links are re-read for each n
//    from L1/L2 rather than DRAM.  Holding them in registers across the
//    batch, and staging planes through shared memory with TMA, is later
//    work.

#include <cuda_runtime.h>

#include <cstring>

#include "wilson_common.cuh"

namespace {

using wilson::G;
using wilson::HopTables;
using wilson::S;
using wilson::hop;

struct Epilogue {
  float hop_coeff, hop_twist, acc_coeff, acc_twist;
};

__global__ void __launch_bounds__(128)
wilson_hop_kernel(const float* __restrict__ u_out,
                  const float* __restrict__ u_nbr,
                  const float* __restrict__ psi,
                  const float* __restrict__ acc, float* __restrict__ out,
                  int T, int Z, int Y, int Xh, int N, int parity,
                  const HopTables tab, const Epilogue ep) {
  const long sites = (long)T * Z * Y * Xh;
  const long site = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= sites) return;
  const int j = (int)(site % Xh);
  long rest = site / Xh;
  const int y = (int)(rest % Y);
  rest /= Y;
  const int z = (int)(rest % Z);
  const int t = (int)(rest / Z);

  // output sites of this row sit at x = 2j + s_out
  const int s_out = (t + z + y + parity) & 1;
  const int tp = (t + 1 == T) ? 0 : t + 1, tm = (t == 0) ? T - 1 : t - 1;
  const int zp = (z + 1 == Z) ? 0 : z + 1, zm = (z == 0) ? Z - 1 : z - 1;
  const int yp = (y + 1 == Y) ? 0 : y + 1, ym = (y == 0) ? Y - 1 : y - 1;
  const int jf = (j + s_out == Xh) ? 0 : j + s_out;
  const int jb = (j - (1 - s_out) < 0) ? Xh - 1 : j - (1 - s_out);

  const long xs = Xh;
  auto sp = [&](int tt, int zz, int yy, int jj) -> long {
    return (((long)tt * Z + zz) * Y + yy) * S * xs + jj;
  };
  auto gl = [&](int mu, int tt, int zz, int yy, int jj) -> long {
    return ((((long)mu * T + tt) * Z + zz) * Y + yy) * G * xs + jj;
  };
  const long field = (long)T * Z * Y * S * xs;
  const long here = sp(t, z, y, j);

  for (int n = 0; n < N; ++n) {
    const float* p = psi + n * field;
    float o_r[4][3], o_i[4][3];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int c = 0; c < 3; ++c) o_r[s][c] = o_i[s][c] = 0.f;

    hop<0, false>(o_r, o_i, p + sp(tp, z, y, j), u_out + gl(0, t, z, y, j), xs, tab);
    hop<1, true>(o_r, o_i, p + sp(tm, z, y, j), u_nbr + gl(0, tm, z, y, j), xs, tab);
    hop<2, false>(o_r, o_i, p + sp(t, zp, y, j), u_out + gl(1, t, z, y, j), xs, tab);
    hop<3, true>(o_r, o_i, p + sp(t, zm, y, j), u_nbr + gl(1, t, zm, y, j), xs, tab);
    hop<4, false>(o_r, o_i, p + sp(t, z, yp, j), u_out + gl(2, t, z, y, j), xs, tab);
    hop<5, true>(o_r, o_i, p + sp(t, z, ym, j), u_nbr + gl(2, t, z, ym, j), xs, tab);
    hop<6, false>(o_r, o_i, p + sp(t, z, y, jf), u_out + gl(3, t, z, y, j), xs, tab);
    hop<7, true>(o_r, o_i, p + sp(t, z, y, jb), u_nbr + gl(3, t, z, y, jb), xs, tab);

    // epilogue: site-term maps on the hop and the accumulator; i g5 mixes
    // each component's re/im planes with the spin block's g5 sign
    float* o = out + n * field + here;
    const float* a = acc ? acc + n * field + here : nullptr;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float g5 = s < 2 ? 1.f : -1.f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float hr = o_r[s][c], hi = o_i[s][c];
        float nr = ep.hop_coeff * hr, ni = ep.hop_coeff * hi;
        if (ep.hop_twist != 0.f) {
          const float hg = ep.hop_twist * g5;
          nr -= hg * hi;
          ni += hg * hr;
        }
        if (a) {
          const float ar = __ldg(a + ((s * 3 + c) * 2 + 0) * xs);
          const float ai = __ldg(a + ((s * 3 + c) * 2 + 1) * xs);
          nr += ep.acc_coeff * ar;
          ni += ep.acc_coeff * ai;
          if (ep.acc_twist != 0.f) {
            const float ag = ep.acc_twist * g5;
            nr -= ag * ai;
            ni += ag * ar;
          }
        }
        o[((s * 3 + c) * 2 + 0) * xs] = nr;
        o[((s * 3 + c) * 2 + 1) * xs] = ni;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// tables: host pointer to 192 floats laid out as HopTables (copied into
// the launch's parameters); acc may be null.  Returns cudaGetLastError().
int wilson_hop(const float* u_out, const float* u_nbr, const float* psi,
               const float* acc, float* out, int T, int Z, int Y, int Xh,
               int N, int parity, const float* tables, float hop_coeff,
               float hop_twist, float acc_coeff, float acc_twist,
               void* stream) {
  static_assert(sizeof(HopTables) == 192 * sizeof(float), "table layout");
  HopTables tab;
  std::memcpy(&tab, tables, sizeof(tab));
  const Epilogue ep{hop_coeff, hop_twist, acc_coeff, acc_twist};
  const long sites = (long)T * Z * Y * Xh;
  const int threads = 128;
  const unsigned blocks = (unsigned)((sites + threads - 1) / threads);
  wilson_hop_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      u_out, u_nbr, psi, acc, out, T, Z, Y, Xh, N, parity, tab, ep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
