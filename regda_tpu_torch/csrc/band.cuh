// What the two mask post-processing kernels (stability.cu, mask_stats.cu)
// share: reading a composed resize matrix in band form. Output index u of a
// resize reads source indices start[u] .. start[u] + 3 with the four weights
// taps[u] (ops/kernels/_band.py makes the form; a composed half-pixel linear
// resize has no more than four adjacent non-zeros a row).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 4;
constexpr int kStripRows = 32;   // output rows that a block resizes at a time
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// sum_i t[i] * v[i] in float32, in this order, with fused multiply-adds
__device__ __forceinline__ float dot4(const float4 t, float v0, float v1, float v2, float v3) {
  float acc = t.x * v0;
  acc = fmaf(t.y, v1, acc);
  acc = fmaf(t.z, v2, acc);
  return fmaf(t.w, v3, acc);
}

// Column resize of one row-resized row held in shared memory: output column v
__device__ __forceinline__ float col_resize(const float* __restrict__ row,
                                            const int* __restrict__ w_start,
                                            const float4* __restrict__ w_taps, int v) {
  const int c = w_start[v];
  return dot4(w_taps[v], row[c], row[c + 1], row[c + 2], row[c + 3]);
}

}  // namespace
