// One-pass LayerNorm over the last axis, for the SAM ViT blocks.
//
// Replaces the Pallas TPU kernel `layernorm`
// (regda_tpu/models/sam/pallas_ln.py:64, pallas_call at :101). It computes
// what that kernel's body and its `_stock` twin compute, per row of C values:
//
//   mu  = mean(x)                 in float32
//   var = mean((x - mu)^2)        in float32 (two-pass form, not E[x^2]-mu^2)
//   out = ((x - mu) * rsqrt(var + eps) * scale + bias)  rounded to x's type
//
// with float32 scale and bias and x in float32 or bfloat16.
//
// What bounds it on an H100, and what the design does about it: the work is
// ~8 operations per element against 2 or 4 bytes read and as many written,
// far below the card's operations-per-byte balance, so device-memory bytes
// bound it. The least traffic is one read of x and one write of out. A row
// (C <= 1280) fits in one warp's registers, so each warp owns a row: it reads
// the row once as 16-byte vectors (neighbouring lanes on neighbouring
// addresses), takes both moments from registers with warp shuffles, and
// writes the result as 16-byte vectors. Nothing goes through shared memory
// and no block synchronises. Rows are independent, so the row count needs no
// padding: the last block simply has idle warps. Scale and bias (C floats
// each) are re-read by every warp and stay in L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// 16 bytes of T <-> floats
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bfloat16 is the high half of a float
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T, int C>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ out,
                 long long rows, float eps) {
  constexpr int kElems = Vec16<T>::kElems;
  static_assert(C % kElems == 0, "a row must be whole 16-byte vectors");
  constexpr int kVecs = C / kElems;          // 16-byte vectors in a row
  constexpr int kPerLane = (kVecs + 31) / 32;

  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave; no block-wide sync follows
  const T* src = x + row * C;
  T* dst = out + row * C;

  float v[kPerLane][kElems];
  float sum = 0.f;
#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    const int vi = lane + 32 * p;
    if (vi < kVecs) {
      Vec16<T>::load(src + vi * kElems, v[p]);
#pragma unroll
      for (int e = 0; e < kElems; ++e) sum += v[p][e];
    }
  }
  const float mu = warp_sum(sum) * (1.0f / C);

  float sq = 0.f;
#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    if (lane + 32 * p < kVecs) {
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        v[p][e] -= mu;
        sq += v[p][e] * v[p][e];
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) * (1.0f / C) + eps);

#pragma unroll
  for (int p = 0; p < kPerLane; ++p) {
    const int vi = lane + 32 * p;
    if (vi < kVecs) {
      float y[kElems];
#pragma unroll
      for (int e = 0; e < kElems; e += 4) {
        const float4 w =
            __ldg(reinterpret_cast<const float4*>(scale + vi * kElems + e));
        const float4 b =
            __ldg(reinterpret_cast<const float4*>(bias + vi * kElems + e));
        y[e] = v[p][e] * rstd * w.x + b.x;
        y[e + 1] = v[p][e + 1] * rstd * w.y + b.y;
        y[e + 2] = v[p][e + 2] * rstd * w.z + b.z;
        y[e + 3] = v[p][e + 3] * rstd * w.w + b.w;
      }
      Vec16<T>::store(dst + vi * kElems, y);
    }
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* scale, const void* bias,
                   void* out, long long rows, float eps, cudaStream_t stream) {
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  layernorm_kernel<T, C><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      (const T*)x, (const float*)scale, (const float*)bias, (T*)out, rows, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_width(const void* x, const void* scale,
                             const void* bias, void* out, long long rows,
                             int c, float eps, cudaStream_t stream) {
  switch (c) {  // the ViT widths: vit_t, vit_b, vit_l, vit_h
    case 64: return launch<T, 64>(x, scale, bias, out, rows, eps, stream);
    case 768: return launch<T, 768>(x, scale, bias, out, rows, eps, stream);
    case 1024: return launch<T, 1024>(x, scale, bias, out, rows, eps, stream);
    case 1280: return launch<T, 1280>(x, scale, bias, out, rows, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x, out: (rows, c) contiguous, 16-byte aligned, float32 (is_bf16 = 0) or
// bfloat16 (is_bf16 = 1); scale, bias: (c,) float32, 16-byte aligned.
// Launches on `stream`; returns a cudaError_t: cudaErrorInvalidValue for a
// width the kernel is not built for (64, 768, 1024 and 1280 are).
int layernorm_launch(const void* x, const void* scale, const void* bias,
                     void* out, long long rows, int c, float eps, int is_bf16,
                     void* stream) {
  if (rows <= 0) return cudaSuccess;
  return is_bf16 ? launch_for_width<__nv_bfloat16>(x, scale, bias, out, rows, c,
                                                   eps, (cudaStream_t)stream)
                 : launch_for_width<float>(x, scale, bias, out, rows, c, eps,
                                           (cudaStream_t)stream);
}

const char* layernorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
