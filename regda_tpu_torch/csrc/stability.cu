// Exact stability counts of SAM's everything-mode: for each candidate mask,
// how many pixels of its logits, resized to crop resolution, lie above
// +offset and above -offset.
//
// Replaces three Pallas TPU kernels of regda_tpu/models/sam/pallas_stability.py:
// `stability_counts_fused` (pallas_call at :135; interleaved (M, S, S) logits),
// `stability_counts_blocked` (:303) and `stability_counts_blocked_v2` (:415;
// both candidate-major blocked (M, 16h, w) logits). The two blocked kernels
// compute one function and differ only in how their matrix products are laid
// out for the TPU's matrix unit, which does not carry over: here they are one
// entry, and the interleaved layout is the other entry of the same body.
//
// Per candidate, with X its (SH, SW) logits and M_h (ch, SH), M_w (cw, SW) the
// composed resize matrices:
//
//   Y1 = M_h X          products of values rounded to X's type, summed in
//                       float32, the result rounded to X's type
//   Y  = Y1 M_w^T       summed in float32, compared as float32
//   inter = #{Y > +offset},  union = #{Y > -offset}   over the (ch, cw) frame
//
// the precision contract of the TPU kernels and of `stability_counts_plain`.
//
// What bounds it on an H100, and what the design does about it: a composed
// half-pixel resize matrix has at most four adjacent non-zeros a row, so the
// function is a separable interpolation of 4 + 4 taps per output pixel and a
// count: about 3 MFLOP and 128 KB read per candidate at 512^2 from bfloat16,
// where the dense products of the TPU kernels are 201 MFLOP. Bytes bound it
// (each logit read once, two floats written). So the matrices arrive in band
// form (first source index and four weights per output row, see
// ops/kernels/_band.py) and no dense product is formed. One block owns one
// candidate and walks its frame in strips of 32 output rows: it row-resizes
// the strip into shared memory (32 x SW floats; the whole row-resized
// candidate, 512 x 256, would not fit), column-resizes from there, and counts
// in registers. The few source rows that two strips share come from L1/L2,
// so device memory sees each logit once. The blocked layout is read in place
// by index arithmetic (full-res pixel (4y + 2dy + gy, 4x + 2dx + gx) sits at
// row (dy*8 + dx*4 + gy*2 + gx)*h + y, column x), one plane at a time so that
// a warp's loads are contiguous; nothing is re-laid out in device memory. A
// candidate whose gate flag is 0 costs one block that writes two zeros.
// Counts are whole numbers below 2^24, exact in float32, and each block
// writes its own two: no atomics, the same result in every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"
#include "mma.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, bool kBlocked>
__global__ void __launch_bounds__(kThreads)
stability_kernel(const T* __restrict__ x, const int* __restrict__ active,
                 const int* __restrict__ h_start, const float4* __restrict__ h_taps,
                 const int* __restrict__ w_start, const float4* __restrict__ w_taps,
                 float* __restrict__ out, int sh, int sw, int ch, int cw, float offset) {
  extern __shared__ float y1[];              // (kStripRows, sw)
  __shared__ int s_counts[kWarps][2];
  const int m = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (active != nullptr && active[m] == 0) {
    if (threadIdx.x == 0) out[2 * m] = out[2 * m + 1] = 0.f;
    return;
  }
  const T* xm = x + (long long)m * sh * sw;
  const int h = sh >> 2, w = sw >> 2;        // the blocked layout's plane size
  int inter = 0, uni = 0;

  for (int u0 = 0; u0 < ch; u0 += kStripRows) {
    const int rows = min(kStripRows, ch - u0);
    // row resize of the strip into shared memory
    for (int lu = warp; lu < rows; lu += kWarps) {
      const int u = u0 + lu;
      const int r = h_start[u];
      const float4 t = h_taps[u];
      float* dst = y1 + lu * sw;
      if (kBlocked) {
        // source row r + i lies in the row planes (dy, gy) = bits 1 and 0 of
        // it; walk the column planes (dx, gx) so that a warp reads along one
        // plane's row
        const T* src[kTaps];
#pragma unroll
        for (int i = 0; i < kTaps; ++i) {
          const int rr = r + i;
          src[i] = xm + ((long long)(((rr >> 1) & 1) * 8 + (rr & 1) * 2) * h + (rr >> 2)) * w;
        }
        for (int p = 0; p < 4; ++p) {
          const long long plane = (long long)((p >> 1) * 4 + (p & 1)) * h * w;
          for (int xx = lane; xx < w; xx += 32)
            dst[4 * xx + p] = round_to<T>(dot4(
                t, to_float(src[0][plane + xx]), to_float(src[1][plane + xx]),
                to_float(src[2][plane + xx]), to_float(src[3][plane + xx])));
        }
      } else {
        const T* src = xm + (long long)r * sw;
        for (int c = lane; c < sw; c += 32)
          dst[c] = round_to<T>(dot4(t, to_float(src[c]), to_float(src[sw + c]),
                                    to_float(src[2 * sw + c]), to_float(src[3 * sw + c])));
      }
    }
    __syncthreads();
    // column resize from shared memory, and the two counts
    for (int lu = warp; lu < rows; lu += kWarps) {
      const float* src = y1 + lu * sw;
      for (int v = lane; v < cw; v += 32) {
        const float y = col_resize(src, w_start, w_taps, v);
        inter += y > offset;
        uni += y > -offset;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    inter += __shfl_xor_sync(kFullMask, inter, o);
    uni += __shfl_xor_sync(kFullMask, uni, o);
  }
  if (lane == 0) {
    s_counts[warp][0] = inter;
    s_counts[warp][1] = uni;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int a = 0, b = 0;
    for (int i = 0; i < kWarps; ++i) {
      a += s_counts[i][0];
      b += s_counts[i][1];
    }
    out[2 * m] = (float)a;
    out[2 * m + 1] = (float)b;
  }
}

template <typename T, bool kBlocked>
cudaError_t run(const void* x, const int* active, const int* h_start, const float* h_taps,
                const int* w_start, const float* w_taps, float* out, int m, int sh, int sw,
                int ch, int cw, float offset, cudaStream_t stream) {
  const size_t smem = (size_t)kStripRows * sw * sizeof(float);
  return launch<stability_kernel<T, kBlocked>>(
      dim3((unsigned)m), kThreads, smem, stream, (const T*)x, active, h_start,
      (const float4*)h_taps, w_start, (const float4*)w_taps, out, sh, sw, ch, cw, offset);
}

}  // namespace

extern "C" {

// x: (m, sh, sw) interleaved logits (blocked = 0) or (m, 16 * (sh / 4), sw / 4)
// candidate-major blocked logits (blocked = 1), contiguous, float32 (is_bf16 =
// 0) or bfloat16 (is_bf16 = 1). active: (m,) int32 or null. h_start (ch,)
// int32 and h_taps (ch, 4) float32, 16-byte aligned: output row u reads source
// rows h_start[u] .. h_start[u] + 3 (all below sh) with these weights, already
// rounded to x's type; w_start (cw,), w_taps (cw, 4) likewise for columns.
// out: (m, 2) float32, the counts above +offset and above -offset; zeros for
// a candidate whose flag is 0. Launches on `stream`; returns a cudaError_t
// (cudaErrorInvalidValue for a shape it does not take).
int stability_launch(const void* x, const void* active, const void* h_start,
                     const void* h_taps, const void* w_start, const void* w_taps, void* out,
                     int m, int sh, int sw, int ch, int cw, float offset, int is_bf16,
                     int blocked, void* stream) {
  if (m <= 0) return cudaSuccess;
  if (sh < kTaps || sw < kTaps || ch <= 0 || cw <= 0) return cudaErrorInvalidValue;
  if (blocked && ((sh & 3) || (sw & 3))) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define STABILITY_RUN(T, B)                                                               \
  return run<T, B>(x, (const int*)active, (const int*)h_start, (const float*)h_taps,     \
                   (const int*)w_start, (const float*)w_taps, (float*)out, m, sh, sw, ch, \
                   cw, offset, s)
  if (is_bf16) {
    if (blocked) STABILITY_RUN(__nv_bfloat16, true);
    STABILITY_RUN(__nv_bfloat16, false);
  }
  if (blocked) STABILITY_RUN(float, true);
  STABILITY_RUN(float, false);
#undef STABILITY_RUN
}

const char* stability_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
