// Shared by K1 (wilson_hop.cu) and K4 (wilson_full.cu): the packed layout's
// component counts, the host-folded spin tables, and one hop of the
// spin-projection trick.
//
// A hop adds -1/2 (1 -+ g_mu) U psi_nbr to the output spinor o.  It projects
// the neighbour's 4-spinor to two half spinors, multiplies each by the link
// (U for a forward hop, U^dag for a backward one), and rebuilds spins 2 and 3
// from the two products with a phase.  For r = 1 each projector has rank 2,
// so this halves the link work.

#pragma once

namespace wilson {

constexpr int S = 24;  // packed spinor components per site
constexpr int G = 18;  // packed link components

// Per hop h = 2*mu + (0 forward, 1 backward):
//   proj[h][a][b]  : coefficient of source spin b in half-spinor row a
//   recon[h][i][k] : phase taking half-spinor row k to output spin 2+i
// (re, im) pairs; gamma5 folding is already applied by the host.
struct HopTables {
  float proj[8][2][4][2];
  float recon[8][2][2][2];
};

// psi and u point at the neighbour spinor's and the link's first component;
// consecutive components are xs floats apart.
template <int H, bool DAG>
__device__ __forceinline__ void hop(float (&o_r)[4][3], float (&o_i)[4][3],
                                    const float* __restrict__ psi,
                                    const float* __restrict__ u, long xs,
                                    const HopTables& tab) {
  // stage 1: project to two half spinors h[a][c]
  float h_r[2][3], h_i[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) h_r[a][c] = h_i[a][c] = 0.f;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float pr = __ldg(psi + ((b * 3 + c) * 2 + 0) * xs);
      const float pi = __ldg(psi + ((b * 3 + c) * 2 + 1) * xs);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const float cr = tab.proj[H][a][b][0], ci = tab.proj[H][a][b][1];
        h_r[a][c] += cr * pr - ci * pi;
        h_i[a][c] += cr * pi + ci * pr;
      }
    }
  }
  // stage 2: g[a] = U h[a] (forward) or U^dag h[a] (backward)
  float g_r[2][3], g_i[2][3];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) g_r[a][c] = g_i[a][c] = 0.f;
#pragma unroll
  for (int row = 0; row < 3; ++row) {
#pragma unroll
    for (int col = 0; col < 3; ++col) {
      const int e = DAG ? (col * 3 + row) : (row * 3 + col);
      const float ur = __ldg(u + (e * 2 + 0) * xs);
      const float ui = DAG ? -__ldg(u + (e * 2 + 1) * xs)
                           : __ldg(u + (e * 2 + 1) * xs);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        g_r[a][row] += ur * h_r[a][col] - ui * h_i[a][col];
        g_i[a][row] += ur * h_i[a][col] + ui * h_r[a][col];
      }
    }
  }
  // stage 3: rebuild the 4-spinor and accumulate with -1/2
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      o_r[a][c] -= 0.5f * g_r[a][c];
      o_i[a][c] -= 0.5f * g_i[a][c];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float rr = 0.f, ri = 0.f;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float pr = tab.recon[H][i][k][0], pi = tab.recon[H][i][k][1];
        rr += pr * g_r[k][c] - pi * g_i[k][c];
        ri += pr * g_i[k][c] + pi * g_r[k][c];
      }
      o_r[2 + i][c] -= 0.5f * rr;
      o_i[2 + i][c] -= 0.5f * ri;
    }
  }
}

}  // namespace wilson
