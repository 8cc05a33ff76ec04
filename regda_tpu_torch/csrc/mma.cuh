// What the kernels of this directory share: the warp-level tensor-core
// operations of the bfloat16 kernels (`mma.sync.m16n8k16` and the `ldmatrix`
// loads that feed it) and the launch with its shared-memory opt-in. Each .cu
// file is one translation unit and one library, so everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// c (16 x 8, float32) += a (16 x 16, row-major) @ b (16 x 8, column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of an (n, k) row-major tile in shared memory: lanes 0..15 name
// the rows of two 8 x 8 matrices
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// B fragment of a (k, n) row-major tile in shared memory: lanes 0..15 name
// the 16 k-rows
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

// A fragment of the transpose of a (k, m) row-major tile: lane l names row
// (l & 7) of matrix l >> 3
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem_row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Launch `kernel` on `stream`. Dynamic shared memory above 48 KB needs an
// opt-in per kernel and device. It is made when a launch needs more than any
// before it of that kernel on that device did, not on every launch (the
// kernel is a template argument, so each instance keeps its own record); a
// size beyond the device's limit is refused by the opt-in itself with
// cudaErrorInvalidValue.
constexpr int kMaxDevices = 64;

template <auto kernel, typename... KernelArgs>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   KernelArgs... args) {
  static size_t opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // leave no stale error for the caller's next check
      return err;
    }
    opted_in[dev] = smem;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
