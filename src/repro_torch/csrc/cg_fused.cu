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
//
// Storage: float32, bf16 or float16 (the mixed-precision solve's inner
// CG), one type for every field of a call; the scalars, the arithmetic and
// the reductions are f32 in all three.  A narrow instance widens each
// element to f32 on load, computes as the f32 instance does and rounds
// once to nearest even on the store; K2 reduces ||r'||^2 from the f32 r'
// before it is rounded (as the JAX kernels do), with the same two-stage
// order.  16-bit storage halves the bytes, so both kernels move 16 bytes
// per access there: 8 elements in one vector, with the alignment head and
// tail counted in elements, the scalar path where the fields' alignments
// differ.  bf16 and float16 run the same code: float16 narrows with
// __float2half_rn / __floats2half2_rn, which keep subnormals (the inner
// residual's late entries) and give inf past 65504, as torch's and XLA's
// casts do.  The f32 instances are the code above, unchanged.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr long MAX_BLOCKS = 2048;

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

// 16 bytes of T: E elements, unpacked to and packed from f32.
template <class T>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static constexpr int E = 4;
  __device__ static void unpack(const V& v, float (&f)[E]) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static V pack(const float (&f)[E]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<bf16> {
  using V = uint4;
  static constexpr int E = 8;
  __device__ static void unpack(const V& v, float (&f)[E]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static V pack(const float (&f)[E]) {
    V v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};
template <>
struct Vec<f16> {
  using V = uint4;
  static constexpr int E = 8;
  __device__ static void unpack(const V& v, float (&f)[E]) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ static V pack(const float (&f)[E]) {
    V v;
    __half2* h = reinterpret_cast<__half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

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

// Elements before the 16-byte body when every pointer shares p's
// alignment, else all L (the scalar path).
template <class T>
__device__ __forceinline__ long head_len(const T* p,
                                         const uintptr_t (&others)[5],
                                         int nothers, long L) {
  const uintptr_t mis = reinterpret_cast<uintptr_t>(p) & 15u;
  for (int i = 0; i < nothers; ++i)
    if ((others[i] & 15u) != mis) return L;
  const long lead = (long)((16u - mis) & 15u) / (long)sizeof(T);
  return lead < L ? lead : L;
}

// K2 on one RHS of 16-bit storage (bf16 or float16): the scalar head and
// tail, then 8 elements a trip; returns the thread's share of ||r'||^2
// (f32, before rounding).
template <class T, bool ACTIVE>
__device__ __forceinline__ float update_rhs_narrow(
    float a, const T* __restrict__ x, const T* __restrict__ r,
    const T* __restrict__ p, const T* __restrict__ ap, T* __restrict__ xo,
    T* __restrict__ ro, long L) {
  using VT = Vec<T>;
  constexpr int E = VT::E;
  const long tid = (long)blockIdx.x * THREADS + threadIdx.x;
  const long nthr = (long)gridDim.x * THREADS;
  const uintptr_t others[5] = {
      reinterpret_cast<uintptr_t>(r), reinterpret_cast<uintptr_t>(p),
      reinterpret_cast<uintptr_t>(ap), reinterpret_cast<uintptr_t>(xo),
      reinterpret_cast<uintptr_t>(ro)};
  const long head = head_len(x, others, 5, L);
  const long nvec = (L - head) / E;
  const long tail0 = head + E * nvec;
  float acc = 0.f;
  auto one = [&](long i) {
    if (ACTIVE) {
      const float rv = fmaf(-a, wide(ap[i]), wide(r[i]));
      xo[i] = narrow<T>(fmaf(a, wide(p[i]), wide(x[i])));
      ro[i] = narrow<T>(rv);
      acc = fmaf(rv, rv, acc);
    } else {
      const float rv = wide(r[i]);
      xo[i] = x[i];
      ro[i] = r[i];
      acc = fmaf(rv, rv, acc);
    }
  };
  for (long i = tid; i < head; i += nthr) one(i);
  for (long i = tail0 + tid; i < L; i += nthr) one(i);
  using V = typename VT::V;
  const V* __restrict__ x4 = reinterpret_cast<const V*>(x + head);
  const V* __restrict__ r4 = reinterpret_cast<const V*>(r + head);
  const V* __restrict__ p4 = reinterpret_cast<const V*>(p + head);
  const V* __restrict__ a4 = reinterpret_cast<const V*>(ap + head);
  V* __restrict__ xo4 = reinterpret_cast<V*>(xo + head);
  V* __restrict__ ro4 = reinterpret_cast<V*>(ro + head);
  for (long v = tid; v < nvec; v += nthr) {
    const V xv = x4[v], rv = r4[v];
    float rf[E];
    VT::unpack(rv, rf);
    if (ACTIVE) {
      float xf[E], pf[E], af[E];
      VT::unpack(xv, xf);
      VT::unpack(p4[v], pf);
      VT::unpack(a4[v], af);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xf[e] = fmaf(a, pf[e], xf[e]);
        rf[e] = fmaf(-a, af[e], rf[e]);
      }
      xo4[v] = VT::pack(xf);
      ro4[v] = VT::pack(rf);
    } else {
      xo4[v] = xv;
      ro4[v] = rv;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) acc = fmaf(rf[e], rf[e], acc);
  }
  return acc;
}

template <class T>
__global__ void __launch_bounds__(THREADS)
cg_update_kernel(const float* __restrict__ alpha, const T* __restrict__ x,
                 const T* __restrict__ r, const T* __restrict__ p,
                 const T* __restrict__ ap, T* __restrict__ xo,
                 T* __restrict__ ro, float* __restrict__ partial, long L) {
  __shared__ float sh[THREADS];
  const int n = blockIdx.y;
  const float a = alpha[n];
  const long base = (long)n * L;
  const long stride = (long)gridDim.x * THREADS;
  float acc = 0.f;
  if constexpr (sizeof(T) != 4) {
    acc = a != 0.f
              ? update_rhs_narrow<T, true>(a, x + base, r + base, p + base,
                                           ap + base, xo + base, ro + base, L)
              : update_rhs_narrow<T, false>(a, x + base, r + base, p + base,
                                            ap + base, xo + base, ro + base,
                                            L);
  } else if (a != 0.f) {
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

constexpr int XPAY_VEC = 4;  // 16-byte vectors per thread and loop trip

template <bool UPDATE, class T>
__device__ __forceinline__ T xpay1(float b, T r, T p) {
  return UPDATE ? narrow<T>(fmaf(b, wide(p), wide(r))) : p;
}

// One RHS: p' over [0, L) of r, p, po, by the blocks sharing blockIdx.y.
template <bool UPDATE, class T>
__device__ __forceinline__ void xpay_rhs(float b, const T* __restrict__ r,
                                         const T* __restrict__ p,
                                         T* __restrict__ po, long L) {
  using VT = Vec<T>;
  constexpr int E = VT::E;
  const long tid = (long)blockIdx.x * THREADS + threadIdx.x;
  const long nthr = (long)gridDim.x * THREADS;
  const uintptr_t others[5] = {reinterpret_cast<uintptr_t>(r),
                               reinterpret_cast<uintptr_t>(po), 0, 0, 0};
  // elements before the body: all, unless r, p and po share their alignment
  const long head = head_len(p, others, 2, L);
  const long nvec = (L - head) / E;
  const long tail0 = head + E * nvec;
  for (long i = tid; i < head; i += nthr)
    po[i] = xpay1<UPDATE>(b, r[i], p[i]);
  for (long i = tail0 + tid; i < L; i += nthr)
    po[i] = xpay1<UPDATE>(b, r[i], p[i]);
  const typename VT::V* __restrict__ r4 =
      reinterpret_cast<const typename VT::V*>(r + head);
  const typename VT::V* __restrict__ p4 =
      reinterpret_cast<const typename VT::V*>(p + head);
  typename VT::V* __restrict__ o4 = reinterpret_cast<typename VT::V*>(po + head);
  for (long v0 = (long)blockIdx.x * THREADS * XPAY_VEC + threadIdx.x;
       v0 < nvec; v0 += nthr * XPAY_VEC) {
    typename VT::V rv[XPAY_VEC], pv[XPAY_VEC];
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
        typename VT::V o = pv[u];
        if (UPDATE) {
          float rf[E], pf[E];
          VT::unpack(rv[u], rf);
          VT::unpack(pv[u], pf);
#pragma unroll
          for (int e = 0; e < E; ++e) pf[e] = fmaf(b, pf[e], rf[e]);
          o = VT::pack(pf);
        }
        o4[v] = o;
      }
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS)
cg_xpay_kernel(const float* __restrict__ beta,
               const unsigned char* __restrict__ gate,
               const T* __restrict__ r, const T* __restrict__ p,
               T* __restrict__ po, long L) {
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

template <class T>
int update(const float* alpha, const void* x, const void* r, const void* p,
           const void* ap, void* xo, void* ro, float* partial, float* rs,
           int N, long L, cudaStream_t s) {
  const int nblk = blocks_for(L);
  cg_update_kernel<T><<<dim3(nblk, N), THREADS, 0, s>>>(
      alpha, static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(ap),
      static_cast<T*>(xo), static_cast<T*>(ro), partial, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<N, THREADS, 0, s>>>(partial, nblk, rs);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int xpay(const float* beta, const unsigned char* gate, const void* r,
         const void* p, void* po, int N, long L, cudaStream_t s) {
  cg_xpay_kernel<T><<<dim3(blocks_for(L), N), THREADS, 0, s>>>(
      beta, gate, static_cast<const T*>(r), static_cast<const T*>(p),
      static_cast<T*>(po), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The number of per-block partial sums cg_update writes for each RHS:
// the caller allocates an (N, cg_update_blocks(L)) float scratch.
int cg_update_blocks(long L) { return blocks_for(L); }

// storage: 0 float32, 1 bf16, 2 float16 (every field of the call); alpha,
// partial and rs are float32.
int cg_update(const float* alpha, const void* x, const void* r,
              const void* p, const void* ap, void* xo, void* ro,
              float* partial, float* rs, int N, long L, int storage,
              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 1)
    return update<bf16>(alpha, x, r, p, ap, xo, ro, partial, rs, N, L, s);
  if (storage == 2)
    return update<f16>(alpha, x, r, p, ap, xo, ro, partial, rs, N, L, s);
  return update<float>(alpha, x, r, p, ap, xo, ro, partial, rs, N, L, s);
}

// gate: null (every RHS updates) or N bytes, nonzero where it updates;
// storage as for cg_update.
int cg_xpay(const float* beta, const unsigned char* gate, const void* r,
            const void* p, void* po, int N, long L, int storage,
            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (storage == 1) return xpay<bf16>(beta, gate, r, p, po, N, L, s);
  if (storage == 2) return xpay<f16>(beta, gate, r, p, po, N, L, s);
  return xpay<float>(beta, gate, r, p, po, N, L, s);
}

}  // extern "C"
