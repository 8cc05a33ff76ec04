// SAM mask head: both 2x2/stride-2 transposed convs, the LayerNorm2d between
// them, both gelus and the hypernetwork product, in one pass over the image
// tokens.
//
// Replaces the Pallas TPU kernel `upscale_hyper_masks`
// (regda_tpu/models/sam/pallas_upscale.py:224, pallas_call at :309). A
// transposed conv with kernel = stride = 2 is a per-pixel linear map, so the
// whole chain is pointwise in the H x W source grid. Per prompt b and pixel p
// (C = 256 channels in, 4 blocks (dy, dx) of 64, then 16 sub-pixels
// (dy, dx, gy, gx) of 32):
//
//   t1  = src[b, p, :] @ k1 + b1                     (256)      f32
//   y   = gelu(round(LN_64(t1) * lnw + lnb))          per 64-block, eps 1e-6
//   t2  = gelu(round(y_block @ k2 + b2))              (4 x 128 = 16 x 32)
//   out[b, m, sub, p] = t2[sub, :] . hyper[b, m, :]   f32 sum, then out type
//
// The rounding points are those of `upscale_plain` (the counterpart of
// `_upscale_stock`): products accumulate in float32, y and t2 are rounded to
// the compute type before each gelu, the gelu is the exact erf form evaluated
// in float32 and rounded once, and the hypernetwork product accumulates the
// rounded values in float32. LayerNorm moments are the two-pass float32 ones
// of the unrounded t1.
//
// What does not carry over from the TPU kernel: the block-average matrix that
// put the LayerNorm moments on the matrix unit, the kron(I2, k2) padding that
// kept ConvT2 at the matrix unit's width, the block-diagonal embedding of the
// hypernetwork and the rational erf (Mosaic has no erf; `erff` is used here).
// Moments are register sums and shuffles, ConvT2 is one 64 x 128 product per
// block, and the hypernetwork product is 32 multiply-adds per output.
//
// What bounds it on an H100: per pixel 98,304 + 512 * M multiply-adds against
// 512 bytes read (bf16) and 32 * M bytes written, so the tensor cores bound
// it, narrowly (0.053 ms of operations against 0.048 ms of bytes at 64
// prompts); the 768 erf evaluations per pixel cost as much again on the
// ordinary units. Two kernels:
//  * bfloat16: `upscale_mma_kernel`. k1 (128 KB) and k2 (16 KB) stay in one
//    block's shared memory; the block walks over tiles of 128 pixels. Each
//    of 8 warps owns 16 pixels and chains `mma.sync.m16n8k16` products: the
//    accumulators of one product are normalised, rounded and re-packed in
//    registers as the A fragments of the next, so t1, y and t2 never leave
//    the registers.
//  * float32: `upscale_simt_kernel` on the ordinary float32 units (the tensor
//    cores take float32 only as TF32). k1 in float32 is 256 KB and does not
//    fit a block, so it is streamed through shared memory in 32-row slices.
// A prompt whose `active` flag is 0 gets zeros, written explicitly: the
// caller's candidate selection multiplies over all rows, and an unwritten
// NaN would pass through a zero weight.

#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kC = 256;     // input channels
constexpr int kC4 = 64;     // channels after the first transposed conv
constexpr int kC8 = 32;     // channels after the second
constexpr int kMaxM = 4;    // hypernetwork rows (mask tokens) per prompt
constexpr float kEps = 1e-6f;

struct Args {
  const void* src;      // (B, HW, 256) compute type
  const void* hyper;    // (B, M, 32) compute type
  const void* k1;       // (256, 256) compute type, columns (dy, dx, f)
  const float* b1;      // (256)
  const float* lnw;     // (64)
  const float* lnb;     // (64)
  const void* k2;       // (64, 128) compute type, columns (gy, gx, f)
  const float* b2;      // (128)
  const int* active;    // (B) or null: 0 writes zeros for that prompt
  void* out;            // blocked (B, M * 16, HW) or pixel-major (B, HW, M * 16)
  int batch, hw, m, blocked;
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752440f));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// element (b, row, p) of the output, row = m * 16 + sub-pixel
template <typename OutT>
__device__ __forceinline__ OutT* out_ptr(const Args& a, int b, int row, int p) {
  OutT* o = static_cast<OutT*>(a.out);
  const long long rows = (long long)a.m * 16;
  return a.blocked ? o + ((long long)b * rows + row) * a.hw + p
                   : o + ((long long)b * a.hw + p) * rows + row;
}

template <typename OutT>
__device__ void zero_tile(const Args& a, int b, int p0, int pixels, int tid,
                          int threads) {
  const int rows = a.m * 16;
  for (int i = tid; i < rows * pixels; i += threads) {
    const int row = a.blocked ? i / pixels : i % rows;
    const int px = a.blocked ? i % pixels : i / rows;
    if (p0 + px < a.hw) store_out(out_ptr<OutT>(a, b, row, p0 + px), 0.f);
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int kMmaPixels = 128;     // pixels per tile: 8 warps of 16
constexpr int kLdX = kC + 8;        // padded rows: ldmatrix rows on 8 bank groups
constexpr int kLdK2 = 4 * kC8 + 8;

constexpr size_t kMmaSmemBytes =
    sizeof(__nv_bfloat16) * (size_t)(kC * kLdX + kC4 * kLdK2 + kMmaPixels * kLdX) +
    sizeof(float) * (size_t)(kC + 2 * kC4 + 4 * kC8 + kMaxM * kC8);

template <typename OutT>
__global__ void __launch_bounds__(256, 1) upscale_mma_kernel(const Args a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* k1s = reinterpret_cast<bf16*>(smem);      // [256][kLdX]
  bf16* k2s = k1s + kC * kLdX;                    // [64][kLdK2]
  bf16* xs = k2s + kC4 * kLdK2;                   // [128][kLdX]
  float* b1s = reinterpret_cast<float*>(xs + kMmaPixels * kLdX);
  float* lnws = b1s + kC;
  float* lnbs = lnws + kC4;
  float* b2s = lnbs + kC4;
  float* hys = b2s + 4 * kC8;                     // [M][32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int lrow = lane & 7, lmat = (lane >> 3) & 1;

  // the weights, once per block
  {
    const bf16* k1 = static_cast<const bf16*>(a.k1);
    for (int c = tid; c < kC * (kC / 8); c += 256) {
      const int r = c / (kC / 8), ch = c % (kC / 8);
      *reinterpret_cast<uint4*>(k1s + r * kLdX + ch * 8) =
          *reinterpret_cast<const uint4*>(k1 + r * kC + ch * 8);
    }
    const bf16* k2 = static_cast<const bf16*>(a.k2);
    for (int c = tid; c < kC4 * (4 * kC8 / 8); c += 256) {
      const int r = c / (4 * kC8 / 8), ch = c % (4 * kC8 / 8);
      *reinterpret_cast<uint4*>(k2s + r * kLdK2 + ch * 8) =
          *reinterpret_cast<const uint4*>(k2 + r * 4 * kC8 + ch * 8);
    }
    for (int i = tid; i < kC; i += 256) b1s[i] = a.b1[i];
    for (int i = tid; i < kC4; i += 256) {
      lnws[i] = a.lnw[i];
      lnbs[i] = a.lnb[i];
    }
    for (int i = tid; i < 4 * kC8; i += 256) b2s[i] = a.b2[i];
  }

  const int tiles_per_prompt = (a.hw + kMmaPixels - 1) / kMmaPixels;
  const int tiles = a.batch * tiles_per_prompt;
  const int wrow = warp * 16;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / tiles_per_prompt;
    const int p0 = (tile % tiles_per_prompt) * kMmaPixels;
    if (a.active != nullptr && a.active[b] == 0) {  // the same for all threads
      zero_tile<OutT>(a, b, p0, kMmaPixels, tid, 256);
      continue;
    }
    __syncthreads();  // the previous tile has been read (and the weights written)
    {
      const bf16* src = static_cast<const bf16*>(a.src) + (long long)b * a.hw * kC;
      for (int c = tid; c < kMmaPixels * (kC / 8); c += 256) {
        const int r = c / (kC / 8), ch = c % (kC / 8);
        uint4 t = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + r < a.hw)
          t = *reinterpret_cast<const uint4*>(src + (long long)(p0 + r) * kC + ch * 8);
        *reinterpret_cast<uint4*>(xs + r * kLdX + ch * 8) = t;
      }
      const bf16* hy = static_cast<const bf16*>(a.hyper) + (long long)b * a.m * kC8;
      for (int i = tid; i < a.m * kC8; i += 256) hys[i] = __bfloat162float(hy[i]);
    }
    __syncthreads();

    const int px0 = p0 + wrow + g, px1 = px0 + 8;  // this thread's two pixels
#pragma unroll 1
    for (int j = 0; j < 4; ++j) {  // the (dy, dx) block of 64 channels
      float t1[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) t1[nt][0] = t1[nt][1] = t1[nt][2] = t1[nt][3] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kC / 16; ++kk) {
        uint32_t xa[4];
        const bf16* p = xs + (wrow + g) * kLdX + kk * 16 + 2 * tig;
        xa[0] = *reinterpret_cast<const uint32_t*>(p);
        xa[1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdX);
        xa[2] = *reinterpret_cast<const uint32_t*>(p + 8);
        xa[3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLdX + 8);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1,
                            k1s + (kk * 16 + lmat * 8 + lrow) * kLdX + j * kC4 + nt * 8);
          mma_bf16(t1[nt], xa, b0, b1);
        }
      }
      // bias, then the two-pass moments of each pixel's 64 values: 16 in this
      // thread, the rest in the other three threads of the quad
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias = b1s[j * kC4 + nt * 8 + 2 * tig + e];
          t1[nt][e] += bias;
          t1[nt][2 + e] += bias;
          s0 += t1[nt][e];
          s1 += t1[nt][2 + e];
        }
      }
      s0 += __shfl_xor_sync(kFullMask, s0, 1);
      s0 += __shfl_xor_sync(kFullMask, s0, 2);
      s1 += __shfl_xor_sync(kFullMask, s1, 1);
      s1 += __shfl_xor_sync(kFullMask, s1, 2);
      const float mu0 = s0 * (1.f / kC4), mu1 = s1 * (1.f / kC4);
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          t1[nt][e] -= mu0;
          t1[nt][2 + e] -= mu1;
          v0 += t1[nt][e] * t1[nt][e];
          v1 += t1[nt][2 + e] * t1[nt][2 + e];
        }
      }
      v0 += __shfl_xor_sync(kFullMask, v0, 1);
      v0 += __shfl_xor_sync(kFullMask, v0, 2);
      v1 += __shfl_xor_sync(kFullMask, v1, 1);
      v1 += __shfl_xor_sync(kFullMask, v1, 2);
      const float r0 = rsqrtf(v0 * (1.f / kC4) + kEps);
      const float r1 = rsqrtf(v1 * (1.f / kC4) + kEps);
      // y = gelu(round(affine)), rounded again as the next product's A operand
      uint32_t ya[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * tig + e;
          const float w = lnws[col], bb = lnbs[col];
          y[e] = gelu_erf(round_bf16(t1[nt][e] * r0 * w + bb));
          y[2 + e] = gelu_erf(round_bf16(t1[nt][2 + e] * r1 * w + bb));
        }
        // n-tiles 2k and 2k + 1 of this product are k-step k of the next
        ya[nt >> 1][(nt & 1) * 2] = pack_bf16(y[0], y[1]);
        ya[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(y[2], y[3]);
      }
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {  // the (gy, gx) sub-pixel of 32 channels
        float t2[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) t2[nt][0] = t2[nt][1] = t2[nt][2] = t2[nt][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kC4 / 16; ++kk) {
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1,
                              k2s + (kk * 16 + lmat * 8 + lrow) * kLdK2 + s * kC8 + nt * 8);
            mma_bf16(t2[nt], ya[kk], b0, b1);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bias = b2s[s * kC8 + nt * 8 + 2 * tig + e];
            t2[nt][e] = round_bf16(gelu_erf(round_bf16(t2[nt][e] + bias)));
            t2[nt][2 + e] = round_bf16(gelu_erf(round_bf16(t2[nt][2 + e] + bias)));
          }
        }
        const int sub = j * 4 + s;
        for (int m = 0; m < a.m; ++m) {
          float o0 = 0.f, o1 = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float h = hys[m * kC8 + nt * 8 + 2 * tig + e];
              o0 = fmaf(t2[nt][e], h, o0);
              o1 = fmaf(t2[nt][2 + e], h, o1);
            }
          }
          o0 += __shfl_xor_sync(kFullMask, o0, 1);
          o0 += __shfl_xor_sync(kFullMask, o0, 2);
          o1 += __shfl_xor_sync(kFullMask, o1, 1);
          o1 += __shfl_xor_sync(kFullMask, o1, 2);
          if (tig == 0) {
            if (px0 < a.hw) store_out(out_ptr<OutT>(a, b, m * 16 + sub, px0), o0);
            if (px1 < a.hw) store_out(out_ptr<OutT>(a, b, m * 16 + sub, px1), o1);
          }
        }
      }
    }
  }
}

// ----------------------------------------------------------------- float32

constexpr int kSimtPixels = 64;       // pixels per tile
constexpr int kSimtSlice = 32;        // rows of k1 in shared memory at a time
constexpr int kLdXT = kSimtPixels + 1;   // src tile, channel-major: [c][pixel]
constexpr int kLdT1 = kC + 1;            // t1 tile: [pixel][channel]

constexpr size_t kSimtSmemBytes =
    sizeof(float) * (size_t)(kC * kLdXT + kSimtSlice * kC + kSimtPixels * kLdT1 +
                             kC4 * 4 * kC8 + kC + 2 * kC4 + 4 * kC8 + kMaxM * kC8);

template <typename OutT>
__global__ void __launch_bounds__(256, 1) upscale_simt_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [256][kLdXT]
  float* k1c = xs + kC * kLdXT;                 // [32][256]
  float* t1s = k1c + kSimtSlice * kC;           // [64][kLdT1]
  float* k2s = t1s + kSimtPixels * kLdT1;       // [64][128]
  float* b1s = k2s + kC4 * 4 * kC8;
  float* lnws = b1s + kC;
  float* lnbs = lnws + kC4;
  float* b2s = lnbs + kC4;
  float* hys = b2s + 4 * kC8;                   // [M][32]

  const int tid = threadIdx.x;
  const int tiles_per_prompt = (a.hw + kSimtPixels - 1) / kSimtPixels;
  const int b = blockIdx.x / tiles_per_prompt;
  const int p0 = (blockIdx.x % tiles_per_prompt) * kSimtPixels;
  if (a.active != nullptr && a.active[b] == 0) {
    zero_tile<OutT>(a, b, p0, kSimtPixels, tid, 256);
    return;
  }
  const float* src = static_cast<const float*>(a.src) + (long long)b * a.hw * kC;
  const float* k1 = static_cast<const float*>(a.k1);
  const float* k2 = static_cast<const float*>(a.k2);
  const float* hy = static_cast<const float*>(a.hyper) + (long long)b * a.m * kC8;

  for (int i = tid; i < kSimtPixels * kC; i += 256) {
    const int r = i / kC, c = i % kC;
    xs[c * kLdXT + r] = p0 + r < a.hw ? src[(long long)(p0 + r) * kC + c] : 0.f;
  }
  for (int i = tid; i < kC4 * 4 * kC8; i += 256) k2s[i] = k2[i];
  for (int i = tid; i < kC; i += 256) b1s[i] = a.b1[i];
  for (int i = tid; i < kC4; i += 256) {
    lnws[i] = a.lnw[i];
    lnbs[i] = a.lnb[i];
  }
  for (int i = tid; i < 4 * kC8; i += 256) b2s[i] = a.b2[i];
  for (int i = tid; i < a.m * kC8; i += 256) hys[i] = hy[i];

  // t1 = src @ k1 + b1: this thread's pixels are ty + 16 i, its channels
  // tx + 16 c
  {
    const int tx = tid & 15, ty = tid >> 4;
    float acc[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[i][c] = 0.f;
    for (int k0 = 0; k0 < kC; k0 += kSimtSlice) {
      __syncthreads();  // the previous slice has been read (and xs is written)
      for (int i = tid; i < kSimtSlice * kC; i += 256) k1c[i] = k1[k0 * kC + i];
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < kSimtSlice; ++k) {
        float xv[4], kv[16];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[(k0 + k) * kLdXT + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < 16; ++c) kv[c] = k1c[k * kC + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 16; ++c) acc[i][c] = fmaf(xv[i], kv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 16; ++c)
        t1s[(ty + 16 * i) * kLdT1 + tx + 16 * c] = acc[i][c] + b1s[tx + 16 * c];
  }
  __syncthreads();

  // LayerNorm and gelu of one pixel's one 64-block per thread, in place
  const int px = tid & 63, quarter = tid >> 6;
  {
    float* row = t1s + px * kLdT1 + quarter * kC4;
    float mu = 0.f;
    for (int f = 0; f < kC4; ++f) mu += row[f];
    mu *= 1.f / kC4;
    float var = 0.f;
    for (int f = 0; f < kC4; ++f) var += (row[f] - mu) * (row[f] - mu);
    const float r = rsqrtf(var * (1.f / kC4) + kEps);
    for (int f = 0; f < kC4; ++f)
      row[f] = gelu_erf((row[f] - mu) * r * lnws[f] + lnbs[f]);
  }
  __syncthreads();

  // per (dy, dx) block: t2 = gelu(y @ k2 + b2) for this thread's pixel and
  // its (gy, gx) sub-pixel, then the hypernetwork rows
  const int s = quarter;
#pragma unroll 1
  for (int j = 0; j < 4; ++j) {
    float t2[kC8];
#pragma unroll
    for (int c = 0; c < kC8; ++c) t2[c] = 0.f;
    const float* y = t1s + px * kLdT1 + j * kC4;
#pragma unroll 4
    for (int k = 0; k < kC4; ++k) {
      const float yv = y[k];
      const float4* kr = reinterpret_cast<const float4*>(k2s + k * 4 * kC8 + s * kC8);
#pragma unroll
      for (int c4 = 0; c4 < kC8 / 4; ++c4) {
        const float4 w = kr[c4];
        t2[4 * c4] = fmaf(yv, w.x, t2[4 * c4]);
        t2[4 * c4 + 1] = fmaf(yv, w.y, t2[4 * c4 + 1]);
        t2[4 * c4 + 2] = fmaf(yv, w.z, t2[4 * c4 + 2]);
        t2[4 * c4 + 3] = fmaf(yv, w.w, t2[4 * c4 + 3]);
      }
    }
#pragma unroll
    for (int c = 0; c < kC8; ++c) t2[c] = gelu_erf(t2[c] + b2s[s * kC8 + c]);
    if (p0 + px < a.hw) {
      for (int m = 0; m < a.m; ++m) {
        float o = 0.f;
#pragma unroll
        for (int c = 0; c < kC8; ++c) o = fmaf(t2[c], hys[m * kC8 + c], o);
        store_out(out_ptr<OutT>(a, b, m * 16 + j * 4 + s, p0 + px), o);
      }
    }
  }
}

// ---------------------------------------------------------------- launches

}  // namespace

extern "C" {

// src (B, HW, 256), hyper (B, M, 32), k1 (256, 256) and k2 (64, 128) are
// contiguous, 16-byte aligned and float32 (is_bf16 = 0) or bfloat16 (1); b1
// (256), lnw and lnb (64) and b2 (128) are float32; active is null or (B)
// int32; out is float32 (out_bf16 = 0) or bfloat16 (1), laid out
// (B, M * 16, HW) when `blocked`, else (B, HW, M * 16). M is 1 to 4.
// Launches on `stream`; returns a cudaError_t: cudaErrorInvalidValue for a
// channel count other than 256 or an M outside 1..4.
int upscale_launch(const void* src, const void* hyper, const void* k1,
                   const float* b1, const float* lnw, const float* lnb,
                   const void* k2, const float* b2, const int* active, void* out,
                   int batch, int hw, int m, int c, int is_bf16, int out_bf16,
                   int blocked, void* stream) {
  if (batch <= 0 || hw <= 0) return cudaSuccess;
  if (c != kC || m < 1 || m > kMaxM) return cudaErrorInvalidValue;
  const Args a = {src, hyper, k1, b1, lnw, lnb, k2, b2, active, out,
                  batch, hw, m, blocked};
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long tiles =
        (long long)batch * ((hw + kMmaPixels - 1) / kMmaPixels);
    const int blocks = (int)(tiles < sms ? tiles : sms);  // one resident block per SM
    return out_bf16 ? launch<upscale_mma_kernel<__nv_bfloat16>>(blocks, 256, kMmaSmemBytes,
                                                                s, a)
                    : launch<upscale_mma_kernel<float>>(blocks, 256, kMmaSmemBytes, s, a);
  }
  const long long blocks =
      (long long)batch * ((hw + kSimtPixels - 1) / kSimtPixels);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return out_bf16 ? launch<upscale_simt_kernel<__nv_bfloat16>>((int)blocks, 256,
                                                               kSimtSmemBytes, s, a)
                  : launch<upscale_simt_kernel<float>>((int)blocks, 256, kSimtSmemBytes, s, a);
}

const char* upscale_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
