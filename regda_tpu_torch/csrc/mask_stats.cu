// Fused mask statistics of SAM's everything-mode: each budgeted low-res mask
// logit is resized to crop resolution, thresholded at 0, packed 8 pixels a
// byte, and reduced to its box and its area.
//
// Replaces the Pallas TPU kernel `mask_stats_fused`
// (regda_tpu/models/sam/pallas_stats.py:108, pallas_call at :148). Per slot,
// with X its (SH, SW) logits and M_h (ch, SH), M_w (cw, SW) the composed
// resize matrices, all in float32 (the result is thresholded at 0, so nothing
// is rounded on the way, as the TPU kernel runs its products at the highest
// precision):
//
//   Y = M_h X M_w^T,  mask = Y > 0 over the (ch, cw) frame
//   bits[u][k]  = mask[u][8k .. 8k + 7], the first pixel in the top bit
//                 (numpy.packbits order); pixels past cw are 0
//   box         = [min x, min y, max x, max y] of the mask, inclusive;
//                 [0, 0, 0, 0] for an empty mask
//   area        = number of mask pixels
//
// What bounds it on an H100, and what the design does about it: as in
// stability.cu the matrices have at most four adjacent non-zeros a row, so
// the work is 4 + 4 taps per output pixel, about 3 MFLOP per slot at 512^2,
// against 128 KB (bfloat16 logits) read and 32 KB of bits written: bytes bound
// it. The matrices arrive in band form (ops/kernels/_band.py). One block owns
// one slot and walks its frame in strips of 32 output rows: it row-resizes
// the strip into shared memory and column-resizes from there. A warp computes
// 32 consecutive pixels of a row, and `__ballot_sync` hands it their 32 bits at
// once: reversed, they are four bytes of the packed row. The area is the
// ballots' population count, a row is in the box when its ballot is not 0,
// and each lane keeps the least and largest column it saw set. The TPU
// kernel's packing product (0/1 times powers of two), its int32 output and its
// padding of the frame to (8, 128) tiles answer that chip's compiler and are
// not carried over. A slot whose gate flag is 0 costs no resize: its bits,
// box and area are written as zeros, so that whoever gathers such a slot
// paints nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "band.cuh"
#include "mma.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_stats_kernel(const T* __restrict__ x, const int* __restrict__ active,
                  const int* __restrict__ h_start, const float4* __restrict__ h_taps,
                  const int* __restrict__ w_start, const float4* __restrict__ w_taps,
                  uint8_t* __restrict__ bits, float* __restrict__ boxes,
                  float* __restrict__ areas, int sh, int sw, int ch, int cw) {
  extern __shared__ float y1[];              // (kStripRows, sw)
  __shared__ int s_part[kWarps][5];          // area, y0, y1, x0, x1 per warp
  const int m = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cwb = (cw + 7) >> 3;             // bytes in a packed row
  uint8_t* bm = bits + (long long)m * ch * cwb;
  if (active != nullptr && active[m] == 0) {
    for (int i = threadIdx.x; i < ch * cwb; i += kThreads) bm[i] = 0;
    if (threadIdx.x < 4) boxes[4 * m + threadIdx.x] = 0.f;
    if (threadIdx.x == 0) areas[m] = 0.f;
    return;
  }
  const T* xm = x + (long long)m * sh * sw;
  int area = 0, y_lo = ch, y_hi = -1;        // the same in every lane of a warp
  int x_lo = cw, x_hi = -1;                  // this lane's columns

  for (int u0 = 0; u0 < ch; u0 += kStripRows) {
    const int rows = min(kStripRows, ch - u0);
    for (int lu = warp; lu < rows; lu += kWarps) {
      const int u = u0 + lu;
      const float4 t = h_taps[u];
      const T* src = xm + (long long)h_start[u] * sw;
      float* dst = y1 + lu * sw;
      for (int c = lane; c < sw; c += 32)
        dst[c] = dot4(t, to_float(src[c]), to_float(src[sw + c]),
                      to_float(src[2 * sw + c]), to_float(src[3 * sw + c]));
    }
    __syncthreads();
    for (int lu = warp; lu < rows; lu += kWarps) {
      const int u = u0 + lu;
      const float* src = y1 + lu * sw;
      uint8_t* row = bm + (long long)u * cwb;
      for (int v0 = 0; v0 < cw; v0 += 32) {  // every lane takes every turn
        const int v = v0 + lane;
        const bool on = v < cw && col_resize(src, w_start, w_taps, v) > 0.f;
        const unsigned ballot = __ballot_sync(kFullMask, on);
        // lane i holds pixel v0 + i in bit i; a packed byte wants its first
        // pixel in the top bit
        const unsigned packed = __brev(ballot);
        const int kb = (v0 >> 3) + lane;
        if (lane < 4 && kb < cwb) row[kb] = (uint8_t)(packed >> (24 - 8 * lane));
        area += __popc(ballot);
        if (ballot) {
          y_lo = min(y_lo, u);
          y_hi = max(y_hi, u);
        }
        if (on) {
          x_lo = min(x_lo, v);
          x_hi = max(x_hi, v);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x_lo = min(x_lo, __shfl_xor_sync(kFullMask, x_lo, o));
    x_hi = max(x_hi, __shfl_xor_sync(kFullMask, x_hi, o));
  }
  if (lane == 0) {
    s_part[warp][0] = area;
    s_part[warp][1] = y_lo;
    s_part[warp][2] = y_hi;
    s_part[warp][3] = x_lo;
    s_part[warp][4] = x_hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) {
      area += s_part[i][0];
      y_lo = min(y_lo, s_part[i][1]);
      y_hi = max(y_hi, s_part[i][2]);
      x_lo = min(x_lo, s_part[i][3]);
      x_hi = max(x_hi, s_part[i][4]);
    }
    const bool empty = area == 0;
    boxes[4 * m] = empty ? 0.f : (float)x_lo;
    boxes[4 * m + 1] = empty ? 0.f : (float)y_lo;
    boxes[4 * m + 2] = empty ? 0.f : (float)x_hi;
    boxes[4 * m + 3] = empty ? 0.f : (float)y_hi;
    areas[m] = (float)area;
  }
}

template <typename T>
cudaError_t run(const void* x, const int* active, const int* h_start, const float* h_taps,
                const int* w_start, const float* w_taps, uint8_t* bits, float* boxes,
                float* areas, int m, int sh, int sw, int ch, int cw, cudaStream_t stream) {
  const size_t smem = (size_t)kStripRows * sw * sizeof(float);
  return launch<mask_stats_kernel<T>>(
      dim3((unsigned)m), kThreads, smem, stream, (const T*)x, active, h_start,
      (const float4*)h_taps, w_start, (const float4*)w_taps, bits, boxes, areas, sh, sw, ch,
      cw);
}

}  // namespace

extern "C" {

// x: (m, sh, sw) logits, contiguous, float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1). active: (m,) int32 or null. h_start (ch,) int32 and h_taps
// (ch, 4) float32, 16-byte aligned: output row u reads source rows h_start[u]
// .. h_start[u] + 3 (all below sh) with these weights; w_start (cw,), w_taps
// (cw, 4) likewise for columns. bits: (m, ch, ceil(cw / 8)) uint8; boxes:
// (m, 4) float32 [x0, y0, x1, y1]; areas: (m,) float32; all zeros for a slot
// whose flag is 0. Launches on `stream`; returns a cudaError_t
// (cudaErrorInvalidValue for a shape it does not take).
int mask_stats_launch(const void* x, const void* active, const void* h_start,
                      const void* h_taps, const void* w_start, const void* w_taps,
                      void* bits, void* boxes, void* areas, int m, int sh, int sw, int ch,
                      int cw, int is_bf16, void* stream) {
  if (m <= 0) return cudaSuccess;
  if (sh < kTaps || sw < kTaps || ch <= 0 || cw <= 0) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16)
    return run<__nv_bfloat16>(x, (const int*)active, (const int*)h_start,
                              (const float*)h_taps, (const int*)w_start,
                              (const float*)w_taps, (uint8_t*)bits, (float*)boxes,
                              (float*)areas, m, sh, sw, ch, cw, s);
  return run<float>(x, (const int*)active, (const int*)h_start, (const float*)h_taps,
                    (const int*)w_start, (const float*)w_taps, (uint8_t*)bits, (float*)boxes,
                    (float*)areas, m, sh, sw, ch, cw, s);
}

const char* mask_stats_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
