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
//  Wider (16-byte) loads are later work.

#include <cuda_runtime.h>

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

__global__ void __launch_bounds__(THREADS)
cg_xpay_kernel(const float* __restrict__ beta,
               const unsigned char* __restrict__ gate,
               const float* __restrict__ r, const float* __restrict__ p,
               float* __restrict__ po, long L) {
  const int n = blockIdx.y;
  const long base = (long)n * L;
  const long stride = (long)gridDim.x * THREADS;
  const long i0 = (long)blockIdx.x * THREADS + threadIdx.x;
  if (gate == nullptr || gate[n] != 0) {
    const float b = beta[n];
    for (long i = i0; i < L; i += stride)
      po[base + i] = r[base + i] + b * p[base + i];
  } else {
    for (long i = i0; i < L; i += stride) po[base + i] = p[base + i];
  }
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
