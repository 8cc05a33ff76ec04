// What the two mask post-processing kernels (stability.cu, mask_stats.cu)
// share: reading a composed resize matrix in band form, and the strips in
// which both walk a frame. Output index u of a resize reads source indices
// start[u] .. start[u] + 3 with the four weights taps[u] (ops/kernels/_band.py
// makes the form; a composed half-pixel linear resize has no more than four
// adjacent non-zeros a row). Each sum is `dot_taps`'s: the taps in index order
// with fused multiply-adds, those past the last non-zero one of a warp's rows
// (columns) skipped — they add exact zeros to a finite sum.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kTaps = 4;
constexpr int kStripRows = 32;   // output rows that a block resizes at a time
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSrcRowsMax = 40;  // staged source rows a strip may need
constexpr int kCols = 2;         // output columns a thread keeps in registers
constexpr int kSmemMax = 232448 - 1024;   // dynamic shared memory a block opts in to, at most

// the logits' element types: a 16-byte chunk widened to float32
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// taps up to and including the last non-zero one (1 .. 4): the rest add exact
// zeros to a finite sum, and skipping them changes no result
__device__ __forceinline__ int used_taps(const float4& t) {
  return t.w != 0.f ? 4 : t.z != 0.f ? 3 : t.y != 0.f ? 2 : 1;
}
// sum_i t[i] * v[i] over the first kN taps, in this order, with fused
// multiply-adds
template <int kN>
__device__ __forceinline__ float dot_taps(const float4& t, const float (&v)[kTaps]) {
  float acc = t.x * v[0];
  if (kN > 1) acc = fmaf(t.y, v[1], acc);
  if (kN > 2) acc = fmaf(t.z, v[2], acc);
  if (kN > 3) acc = fmaf(t.w, v[3], acc);
  return acc;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// output rows [u0, u0 + n) of a strip read staged source rows [lo, lo + span)
struct Strip {
  int u0, n, lo, span;
};

// The next strip from u0: up to kStripRows rows whose source rows fit the
// staging buffer (one row always fits). Every warp computes the same.
__device__ Strip plan_strip(const int* h_start, int u0, int ch, int src_rows, int lane) {
  int n = min(kStripRows, ch - u0);
  while (true) {
    int lo = lane < n ? h_start[u0 + lane] : INT_MAX;
    int hi = lane < n ? h_start[u0 + lane] + kTaps : INT_MIN;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(kFullMask, lo, o));
      hi = max(hi, __shfl_xor_sync(kFullMask, hi, o));
    }
    if (hi - lo <= src_rows || n == 1) return Strip{u0, n, lo, hi - lo};
    n = (n + 1) / 2;
  }
}

}  // namespace
