// Shared by K1 (wilson_hop.cu) and K4 (wilson_full.cu): staging rows of a
// field into shared memory with TMA bulk copies (cp.async.bulk, completion
// counted in bytes on an mbarrier), and the per-device opt-in for more than
// 48 KB of dynamic shared memory.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace stage {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The opt-in for more than 48 KB of dynamic shared memory, kept per device
// (it is a per-device attribute of a kernel): one static instance beside
// each kernel instance's launch.
struct SmemOptIn {
  static constexpr int MAX_DEVICES = 64;
  // bytes the kernel may use on each device, once raised; devices past the
  // table opt in every time
  int opted_in[MAX_DEVICES] = {};

  // Let `kern` use `smem` bytes: above 48 KB its limit is raised to the
  // device's opt-in maximum, once per device.
  cudaError_t allow(const void* kern, size_t smem) {
    int dev = 0, unkept = 0;
    cudaGetDevice(&dev);
    int& raised = dev < MAX_DEVICES ? opted_in[dev] : unkept;
    if ((int)smem > raised && smem > 48 * 1024) {
      int most = 0;
      cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
      const cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
      if (err != cudaSuccess) return err;
      raised = most;
    }
    return cudaSuccess;
  }
};

}  // namespace stage
