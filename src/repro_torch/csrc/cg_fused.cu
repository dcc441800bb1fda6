// K2 cg_update and K3 cg_xpay: the CG iteration's vector algebra in two
// streaming passes over N right-hand sides of length L, for Hopper
// (sm_90a).
//
//   K2: x' = x + a_n p,  r' = r - a_n Ap,  rs_n = ||r'_n||^2
//   K3: p' = gate_n ? r + b_n p : p          (gate null: always)
//
// K2 replaces the Pallas kernels repro/kernels/cg_fused/kernel.py
// `cg_update_pallas` (N = 1) and `cg_update_batched_pallas`; K3 replaces
// `cg_xpay_pallas` (no gate) and `cg_xpay_batched_pallas`.
//
// What bounds them: memory.  K2 reads 4 and writes 2 floats per element
// (24 bytes) for 5 flops; K3 reads 2 and writes 1 (12 bytes) for 2 flops.
// The design:
//  * a grid of (blocks, N): each block streams a grid-stride share of
//    one RHS with consecutive threads on consecutive addresses, and the
//    ragged end of L is masked in the loop, so no padded copy is made;
//  * the norm is a two-stage reduction with no atomics: each block
//    writes one partial sum of r'^2 (a fixed-order shared-memory tree) to
//    an (N, blocks) buffer, and a second kernel sums each RHS's partials
//    in a fixed order.  The block count depends on L alone, so every RHS
//    of a batch reduces exactly as a single-RHS call does, bit for bit;
//  * a frozen RHS (a_n == 0) copies x and r through without reading p
//    and Ap, so it comes back bitwise unchanged; a closed gate copies p.
//
// K3 moves 16 bytes per access: with one 4-byte load of r and of p per
// thread and trip, too few bytes are in flight per thread to reach the
// memory rate.  So:
//  * float4 loads and stores, XPAY_VEC vectors per thread and trip, all
//    loads issued before any store (2 x 64 bytes in flight), on K2's
//    grid of (blocks_for(L), N);
//  * RHS n starts at r + n L, which a ragged L or a caller's view
//    (x[i:i+1]) may leave off 16-byte alignment: a scalar head runs up
//    to the first aligned element, the float4 body follows and a scalar
//    tail ends it.  Where r, p and p' are misaligned against each other
//    the head is the whole RHS.  Every element is one fmaf(b, p, r), so
//    the split changes no bit and a batched call equals N single calls
//    bitwise; a closed gate copies p through the same paths.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr long MAX_BLOCKS = 2048;

__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

__global__ void __launch_bounds__(THREADS)
cg_update_kernel(const float* __restrict__ alpha, const float* __restrict__ x,
                 const float* __restrict__ r, const float* __restrict__ p,
                 const float* __restrict__ ap, float* __restrict__ xo,
                 float* __restrict__ ro, float* __restrict__ partial, long L) {
  __shared__ float sh[THREADS];
  const int n = blockIdx.y;
  const float a = alpha[n];
  const long base = (long)n * L;
  const long stride = (long)gridDim.x * THREADS;
  float acc = 0.f;
  if (a != 0.f) {
    for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < L; i += stride) {
      const float xv = x[base + i] + a * p[base + i];
      const float rv = r[base + i] - a * ap[base + i];
      xo[base + i] = xv;
      ro[base + i] = rv;
      acc += rv * rv;
    }
  } else {
    for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < L; i += stride) {
      const float rv = r[base + i];
      xo[base + i] = x[base + i];
      ro[base + i] = rv;
      acc += rv * rv;
    }
  }
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) partial[(long)n * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partial, int nblk,
                    float* __restrict__ rs) {
  __shared__ float sh[THREADS];
  const int n = blockIdx.x;
  float acc = 0.f;
  for (int i = threadIdx.x; i < nblk; i += THREADS)
    acc += partial[(long)n * nblk + i];
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) rs[n] = s;
}

constexpr int XPAY_VEC = 4;  // float4 vectors per thread and loop trip

template <bool UPDATE>
__device__ __forceinline__ float xpay1(float b, float r, float p) {
  return UPDATE ? fmaf(b, p, r) : p;
}

// One RHS: p' over [0, L) of r, p, po, by the blocks sharing blockIdx.y.
template <bool UPDATE>
__device__ __forceinline__ void xpay_rhs(float b, const float* __restrict__ r,
                                         const float* __restrict__ p,
                                         float* __restrict__ po, long L) {
  const long tid = (long)blockIdx.x * THREADS + threadIdx.x;
  const long nthr = (long)gridDim.x * THREADS;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(p) & 15u;
  const long lead = (long)((16u - mis) & 15u) / 4;  // floats to alignment
  long head = L;  // floats before the body: all, unless r, p and po share
  if ((reinterpret_cast<uintptr_t>(r) & 15u) == mis &&  // their alignment
      (reinterpret_cast<uintptr_t>(po) & 15u) == mis)
    head = lead < L ? lead : L;
  const long nvec = (L - head) / 4;
  const long tail0 = head + 4 * nvec;
  for (long i = tid; i < head; i += nthr)
    po[i] = xpay1<UPDATE>(b, r[i], p[i]);
  for (long i = tail0 + tid; i < L; i += nthr)
    po[i] = xpay1<UPDATE>(b, r[i], p[i]);
  const float4* __restrict__ r4 = reinterpret_cast<const float4*>(r + head);
  const float4* __restrict__ p4 = reinterpret_cast<const float4*>(p + head);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(po + head);
  for (long v0 = (long)blockIdx.x * THREADS * XPAY_VEC + threadIdx.x;
       v0 < nvec; v0 += nthr * XPAY_VEC) {
    float4 rv[XPAY_VEC], pv[XPAY_VEC];
#pragma unroll
    for (int u = 0; u < XPAY_VEC; ++u) {
      const long v = v0 + (long)u * THREADS;
      if (v < nvec) {
        if (UPDATE) rv[u] = r4[v];
        pv[u] = p4[v];
      }
    }
#pragma unroll
    for (int u = 0; u < XPAY_VEC; ++u) {
      const long v = v0 + (long)u * THREADS;
      if (v < nvec) {
        float4 o = pv[u];
        if (UPDATE)
          o = make_float4(fmaf(b, o.x, rv[u].x), fmaf(b, o.y, rv[u].y),
                          fmaf(b, o.z, rv[u].z), fmaf(b, o.w, rv[u].w));
        o4[v] = o;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
cg_xpay_kernel(const float* __restrict__ beta,
               const unsigned char* __restrict__ gate,
               const float* __restrict__ r, const float* __restrict__ p,
               float* __restrict__ po, long L) {
  const int n = blockIdx.y;
  const long base = (long)n * L;
  if (gate == nullptr || gate[n] != 0)
    xpay_rhs<true>(beta[n], r + base, p + base, po + base, L);
  else
    xpay_rhs<false>(0.f, r + base, p + base, po + base, L);
}

int blocks_for(long L) {
  const long b = (L + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of per-block partial sums cg_update writes for each RHS:
// the caller allocates an (N, cg_update_blocks(L)) float scratch.
int cg_update_blocks(long L) { return blocks_for(L); }

int cg_update(const float* alpha, const float* x, const float* r,
              const float* p, const float* ap, float* xo, float* ro,
              float* partial, float* rs, int N, long L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = blocks_for(L);
  cg_update_kernel<<<dim3(nblk, N), THREADS, 0, s>>>(alpha, x, r, p, ap, xo,
                                                     ro, partial, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<N, THREADS, 0, s>>>(partial, nblk, rs);
  return static_cast<int>(cudaGetLastError());
}

// gate: null (every RHS updates) or N bytes, nonzero where it updates.
int cg_xpay(const float* beta, const unsigned char* gate, const float* r,
            const float* p, float* po, int N, long L, void* stream) {
  cg_xpay_kernel<<<dim3(blocks_for(L), N), THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(beta, gate, r, p, po,
                                                        L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
