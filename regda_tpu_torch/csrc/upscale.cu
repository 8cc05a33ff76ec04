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
// hypernetwork and the rational erf (Mosaic has no erf; the exact erf form
// is used here, through a table in the bf16 kernel).
// Moments are register sums and shuffles, ConvT2 is four 64 x 32 products
// per block, and the hypernetwork product one tensor-core product of K = 32.
//
// What bounds it on an H100: per pixel 98,304 + 512 * M multiply-adds against
// 512 bytes read (bf16) and 32 * M bytes written, so the tensor cores bound
// it, narrowly (0.053 ms of operations against 0.048 ms of bytes at 64
// prompts). What sets the pace is the epilogue on the ordinary units: for
// each of 768 values a pixel a gelu (a shared-memory table read, see
// `gelu_table2`, in place of `erff`) and the LayerNorm, bias and rounding
// around it; the two warpgroups take turns, one's products under the other's
// epilogue. Two kernels:
//  * bfloat16: `upscale_wgmma_kernel`, warp-specialised. One persistent
//    block on each SM: a producer warpgroup (one thread issues TMA loads,
//    `setmaxnreg` hands its registers to the others) and two consumer
//    warpgroups. k1 (128 KB) and k2 (16 KB) stay in shared memory as `wgmma`
//    B operands. The producer streams tiles of 64 pixels x 256 channels
//    (32 KB, 128-byte swizzled, zeros past HW) into a two-stage ring; stage
//    w feeds consumer warpgroup w and is released by an `mbarrier` as soon as
//    the tile's last ConvT1 product has completed, so the next load overlaps
//    the last (dy, dx) block's epilogue, and the two warpgroups' epilogues
//    overlap each other's products. Per tile and (dy, dx) block: ConvT1 is
//    one `wgmma` chain (64 x 64, K = 256, A from the ring); LayerNorm, the
//    affine, gelu (the table) and both roundings run on its accumulators in
//    registers;
//    ConvT2 is a `wgmma` per sub-pixel with y, re-packed as bf16, as the A
//    operand in registers; the hypernetwork product is two `mma.sync`
//    (16 pixels x 32, hyper rows padded from M to 8) per warp and
//    sub-pixel, on the rounded t2 in registers. Outputs are staged in shared
//    memory, 4 bf16 (2 float32) sub-pixels at a time, and written as whole
//    rows: 128-byte runs of 64 pixels in the blocked layout.
//  * float32: `upscale_simt_kernel` on the ordinary float32 units (the tensor
//    cores take float32 only as TF32). k1 in float32 is 256 KB and does not
//    fit a block, so it is streamed through shared memory in 32-row slices.
// A prompt whose `active` flag is 0 gets zeros, written explicitly: the
// caller's candidate selection multiplies over all rows, and an unwritten
// NaN would pass through a zero weight.

#include <cuda.h>
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

// The gelu of the bf16 kernel, bf16 -> bf16 (both of its call sites round
// the input and the result to bf16): round_bf16(gelu_erf(x)) for every bf16 x,
// bit for bit. A table in shared memory, built from gelu_erf on the card,
// holds the results for 2^-16 <= |x| < 8, read without a branch. Outside it
// the exact form is (0.5 x) * m with m = 1 + erff(x / sqrt 2) in {1, 2, 0}:
// for |x| < 2^-16, 1 + erff moves 0.5 x by less than half a bf16 step (or
// not at all), so the rounded result is round(0.5 x); for |x| >= 8 erff is
// +-1 in float32; inf and NaN follow the same products. Those few values
// (about one a thousand batches of a warp on the main path) are fixed after
// a warp vote. `upscale_gelu_check` compares the whole path with
// the exact form on all 65,536 inputs.
constexpr uint32_t kGeluLo = 0x3780u;   // bf16 bits of 2^-16
constexpr uint32_t kGeluHi = 0x4100u;   // bf16 bits of 8
constexpr uint32_t kGeluSpan = kGeluHi - kGeluLo;
constexpr int kGeluTableBytes = 2 * kGeluSpan * 2;   // [sign][|x| bits - kGeluLo]

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t gelu_exact_bits(uint32_t h) {
  return bf16_bits(gelu_erf(__uint_as_float(h << 16)));
}
__device__ void build_gelu_table(uint16_t* tab, int tid, int threads) {
  for (int i = tid; i < 2 * (int)kGeluSpan; i += threads)
    tab[i] = (uint16_t)gelu_exact_bits((i < (int)kGeluSpan ? 0u : 0x8000u) |
                                       (kGeluLo + i % kGeluSpan));
}
// gelu of a bf16 pair from the table; sets `miss` if a half lies outside it
__device__ __forceinline__ uint32_t gelu_table2(uint32_t hh, const uint16_t* tab,
                                                uint32_t& miss) {
  const uint32_t lo = hh & 0xffffu, hi = hh >> 16;
  const uint32_t il = (lo & 0x7fffu) - kGeluLo, ih = (hi & 0x7fffu) - kGeluLo;
  miss |= (uint32_t)(il >= kGeluSpan) | (uint32_t)(ih >= kGeluSpan);
  const uint32_t tl = tab[min(il, kGeluSpan - 1) + (lo >> 15) * kGeluSpan];
  const uint32_t th = tab[min(ih, kGeluSpan - 1) + (hi >> 15) * kGeluSpan];
  return tl | (th << 16);
}
__device__ __forceinline__ uint32_t gelu_outside(uint32_t h) {
  const float m = (h & 0x7fffu) < kGeluLo ? 1.f : ((h & 0x8000u) ? 0.f : 2.f);
  return bf16_bits(0.5f * __uint_as_float(h << 16) * m);
}
// the halves of `r` = gelu_table2(hh) that lie outside the table, corrected
__device__ __forceinline__ uint32_t gelu_fix2(uint32_t hh, uint32_t r) {
  const uint32_t lo = hh & 0xffffu, hi = hh >> 16;
  if ((lo & 0x7fffu) - kGeluLo >= kGeluSpan) r = (r & 0xffff0000u) | gelu_outside(lo);
  if ((hi & 0x7fffu) - kGeluLo >= kGeluSpan) r = (r & 0xffffu) | (gelu_outside(hi) << 16);
  return r;
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

constexpr int kTilePx = 64;                  // pixels per tile: one wgmma's 64 rows
constexpr int kSliceBytes = kTilePx * 128;   // 64 channels of a tile, 128B-swizzled
constexpr int kTileBytes = 4 * kSliceBytes;  // a source tile, 32 KB
constexpr int kConsumers = 2;                // consumer warpgroups, one ring stage each
constexpr int kWsThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;   // 128*40 + 256*232 <= 65536

// shared memory, in bytes from a 1024-byte aligned base
constexpr int kRingOff = 0;                                   // [2][4 slices][64][128 B]
constexpr int kK1Off = kRingOff + kConsumers * kTileBytes;    // k1, core matrices
constexpr int kK2Off = kK1Off + kC * kC * 2;                  // k2, core matrices
constexpr int kB1Off = kK2Off + kC4 * 4 * kC8 * 2;            // b1 (256 f32)
constexpr int kLnwOff = kB1Off + kC * 4;                      // lnw, lnb (64 f32 each)
constexpr int kLnbOff = kLnwOff + kC4 * 4;
constexpr int kB2Off = kLnbOff + kC4 * 4;                     // b2 (128 f32)
constexpr int kBarOff = kB2Off + 4 * kC8 * 4;                 // full[2], empty[2]
constexpr int kGeluOff = kBarOff + 2 * kConsumers * 8;        // the gelu table
constexpr int kStageOff = kGeluOff + kGeluTableBytes;          // output staging
// staged outputs per consumer: kStageSubs sub-pixels of a tile, [m * kStageSubs + s][64 px]
// (8 bytes of each pixel and mask: 4 bf16 or 2 float32 sub-pixels)
template <typename OutT>
constexpr int kStageSubs = 8 / sizeof(OutT);
template <typename OutT>
__host__ __device__ constexpr size_t stage_bytes() {
  return (size_t)kMaxM * kStageSubs<OutT> * kTilePx * sizeof(OutT);
}
template <typename OutT>
constexpr size_t ws_smem_bytes() {   // + 1024: the base is aligned by hand
  return kStageOff + kConsumers * stage_bytes<OutT>() + 1024;
}
static_assert(ws_smem_bytes<float>() <= 232448, "the mask head's shared memory");

// The outputs of sub-pixels sub0 .. sub0 + kStageSubs - 1 of the 64 pixels
// from p0 of prompt b, taken from `st` or zeros when `st` is null, written by
// the 128 threads of one warpgroup: blocked rows as 16-byte runs along a row
// when HW allows, pixel-major as the 8 adjacent bytes of a pixel and mask.
template <typename OutT>
__device__ void store_block(const Args& a, int b, int p0, int sub0, const OutT* st, int t) {
  constexpr int kS = kStageSubs<OutT>;
  OutT* o = static_cast<OutT*>(a.out);
  const int rows = a.m * 16;
  const int valid = min(kTilePx, a.hw - p0);
  if (a.blocked) {
    constexpr int kVec = 16 / sizeof(OutT);
    OutT* ob = o + (long long)b * rows * a.hw + p0;
    if (a.hw % kVec == 0) {   // then a run is all inside HW or all outside
      for (int i = t; i < a.m * kS * (kTilePx / kVec); i += 128) {
        const int r = i / (kTilePx / kVec), px = (i % (kTilePx / kVec)) * kVec;
        if (px >= valid) continue;
        const uint4 v = st ? *reinterpret_cast<const uint4*>(st + r * kTilePx + px)
                           : make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(ob + (long long)((r / kS) * 16 + sub0 + r % kS) * a.hw + px) =
            v;
      }
    } else {
      for (int i = t; i < a.m * kS * kTilePx; i += 128) {
        const int r = i / kTilePx, px = i % kTilePx;
        if (px < valid)
          ob[(long long)((r / kS) * 16 + sub0 + r % kS) * a.hw + px] =
              st ? st[r * kTilePx + px] : OutT(0.f);
      }
    }
  } else {
    for (int i = t; i < valid * a.m; i += 128) {
      const int px = i / a.m, m = i % a.m;
      uint2 v;
      OutT* e = reinterpret_cast<OutT*>(&v);
#pragma unroll
      for (int s = 0; s < kS; ++s) e[s] = st ? st[(m * kS + s) * kTilePx + px] : OutT(0.f);
      *reinterpret_cast<uint2*>(o + ((long long)b * a.hw + p0 + px) * rows + m * 16 + sub0) = v;
    }
  }
}

// One persistent block on each SM walks tiles blockIdx.x, + gridDim.x, ...;
// its k-th tile goes to ring stage and consumer warpgroup k % 2. Warpgroup 2
// is the producer: one thread loads each live tile by TMA (4 boxes of 64
// channels x 64 pixels, zero-filled past HW) and arrives on full[s]; a gated
// tile is announced without a load. Consumer warpgroup w runs the chain on
// its tiles and releases stage w (empty[w], one arrival a warp) as soon as
// its last ConvT1 product has completed.
template <typename OutT>
__global__ void __launch_bounds__(kWsThreads, 1)
    upscale_wgmma_kernel(const __grid_constant__ CUtensorMap tmap, const Args a) {
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from the shared array, so that accesses stay shared loads
  unsigned char* const smem = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* k1s = reinterpret_cast<bf16*>(smem + kK1Off);
  bf16* k2s = reinterpret_cast<bf16*>(smem + kK2Off);
  float* b1s = reinterpret_cast<float*>(smem + kB1Off);
  float* lnws = reinterpret_cast<float*>(smem + kLnwOff);
  float* lnbs = reinterpret_cast<float*>(smem + kLnbOff);
  float* b2s = reinterpret_cast<float*>(smem + kB2Off);
  uint16_t* gtab = reinterpret_cast<uint16_t*>(smem + kGeluOff);
  const uint32_t full0 = smem_addr(smem + kBarOff), empty0 = full0 + 8 * kConsumers;

  const int tid = threadIdx.x;
  // the weights, once per block, as the MN-major B operands of the products:
  // element (k, n) at core_offset(k, n / 8, N / 8) + n % 8
  {
    const bf16* k1 = static_cast<const bf16*>(a.k1);
    for (int c = tid; c < kC * (kC / 8); c += kWsThreads) {
      const int r = c / (kC / 8), ch = c % (kC / 8);
      *reinterpret_cast<uint4*>(k1s + core_offset(r, ch, kC / 8)) =
          *reinterpret_cast<const uint4*>(k1 + r * kC + ch * 8);
    }
    const bf16* k2 = static_cast<const bf16*>(a.k2);
    for (int c = tid; c < kC4 * (4 * kC8 / 8); c += kWsThreads) {
      const int r = c / (4 * kC8 / 8), ch = c % (4 * kC8 / 8);
      *reinterpret_cast<uint4*>(k2s + core_offset(r, ch, 4 * kC8 / 8)) =
          *reinterpret_cast<const uint4*>(k2 + r * 4 * kC8 + ch * 8);
    }
    for (int i = tid; i < kC; i += kWsThreads) b1s[i] = a.b1[i];
    for (int i = tid; i < kC4; i += kWsThreads) {
      lnws[i] = a.lnw[i];
      lnbs[i] = a.lnb[i];
    }
    for (int i = tid; i < 4 * kC8; i += kWsThreads) b2s[i] = a.b2[i];
    build_gelu_table(gtab, tid, kWsThreads);
    if (tid == 0) {
      for (int s = 0; s < kConsumers; ++s) {
        mbar_init(full0 + 8 * s, 1);
        mbar_init(empty0 + 8 * s, 4);
      }
      mbar_init_fence();
    }
    fence_proxy_async();   // the weights, for wgmma's reads
  }
  __syncthreads();

  const int tiles_per_prompt = (a.hw + kTilePx - 1) / kTilePx;
  const int tiles = a.batch * tiles_per_prompt;
  const int wg = tid >> 7;

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (tid != kConsumers * 128) return;
    for (int k = 0;; ++k) {
      const long long tile = blockIdx.x + (long long)k * gridDim.x;
      if (tile >= tiles) break;
      const int s = k % kConsumers, round = k / kConsumers;
      const int b = (int)tile / tiles_per_prompt;
      const int p0 = ((int)tile % tiles_per_prompt) * kTilePx;
      mbar_wait(empty0 + 8 * s, (round & 1) ^ 1);   // the first round passes at once
      if (a.active != nullptr && a.active[b] == 0) {
        mbar_arrive(full0 + 8 * s);
        continue;
      }
      mbar_arrive_expect_tx(full0 + 8 * s, kTileBytes);
      const uint32_t dst = smem_addr(smem + kRingOff + s * kTileBytes);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        tma_load_3d(dst + q * kSliceBytes, &tmap, q * 64, p0, b, full0 + 8 * s);
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  setmaxnreg_inc<kConsumerRegs>();
  const int t = tid & 127, warp = t >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t full = full0 + 8 * wg, empty = empty0 + 8 * wg;
  OutT* st = reinterpret_cast<OutT*>(smem + kStageOff + wg * stage_bytes<OutT>());
  const uint64_t adesc = wgmma_desc_sw128(smem + kRingOff + wg * kTileBytes);
  const int prow0 = warp * 16 + g;   // this thread's pixels in the tile: prow0, prow0 + 8

#pragma unroll 1
  for (int n = 0;; ++n) {
    const long long tile = blockIdx.x + (long long)(kConsumers * n + wg) * gridDim.x;
    if (tile >= tiles) break;
    const int b = (int)tile / tiles_per_prompt;
    const int p0 = ((int)tile % tiles_per_prompt) * kTilePx;
    mbar_wait(full, n & 1);
    if (a.active != nullptr && a.active[b] == 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
      for (int sub0 = 0; sub0 < 16; sub0 += kStageSubs<OutT>)
        store_block<OutT>(a, b, p0, sub0, nullptr, t);
      continue;
    }
    // the hypernetwork rows as mma.sync B fragments: B[k][n] = hyper[b, n, k],
    // n = g; rows past M are zeros
    uint32_t hb[2][2];
    {
      const bf16* hy = static_cast<const bf16*>(a.hyper) + ((long long)b * a.m + g) * kC8;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        hb[ks][0] = g < a.m ? *reinterpret_cast<const uint32_t*>(hy + 16 * ks + 2 * tig) : 0u;
        hb[ks][1] = g < a.m ? *reinterpret_cast<const uint32_t*>(hy + 16 * ks + 2 * tig + 8) : 0u;
      }
    }

#pragma unroll 1
    for (int j = 0; j < 4; ++j) {  // the (dy, dx) block of 64 channels
      // t1 = src_tile @ k1[:, block j]: A the ring stage (K-major, swizzled),
      // B k1 (MN-major), 16 steps of K = 16
      float t1[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wgmma_ss_tb<kC4>(t1, adesc + (kk >> 2) * (kSliceBytes >> 4) + (kk & 3) * 2,
                         wgmma_desc(k1s + core_offset(16 * kk, 8 * j, kC / 8), kC / 8 * 128, 128),
                         kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(t1);
      if (j == 3) {  // the last product that reads the stage has completed
        __syncwarp();
        if (lane == 0) mbar_arrive(empty);
      }
      // bias, then the two-pass moments of each pixel's 64 values: 16 in this
      // thread, the rest in the other three threads of the quad
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bias = b1s[j * kC4 + nt * 8 + 2 * tig + e];
          t1[4 * nt + e] += bias;
          t1[4 * nt + 2 + e] += bias;
          s0 += t1[4 * nt + e];
          s1 += t1[4 * nt + 2 + e];
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
          t1[4 * nt + e] -= mu0;
          t1[4 * nt + 2 + e] -= mu1;
          v0 += t1[4 * nt + e] * t1[4 * nt + e];
          v1 += t1[4 * nt + 2 + e] * t1[4 * nt + 2 + e];
        }
      }
      v0 += __shfl_xor_sync(kFullMask, v0, 1);
      v0 += __shfl_xor_sync(kFullMask, v0, 2);
      v1 += __shfl_xor_sync(kFullMask, v1, 1);
      v1 += __shfl_xor_sync(kFullMask, v1, 2);
      const float r0 = rsqrtf(v0 * (1.f / kC4) + kEps);
      const float r1 = rsqrtf(v1 * (1.f / kC4) + kEps);
      // y = round(gelu(round(affine))), ConvT2's A operand in registers:
      // n-tiles 2k and 2k + 1 of t1 are k-step k of ConvT2
      uint32_t yin[4][4], ya[4][4], miss = 0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = nt * 8 + 2 * tig + e;
          const float w = lnws[col], bb = lnbs[col];
          y[e] = t1[4 * nt + e] * r0 * w + bb;
          y[2 + e] = t1[4 * nt + 2 + e] * r1 * w + bb;
        }
        yin[nt >> 1][(nt & 1) * 2] = pack_bf16(y[0], y[1]);
        yin[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(y[2], y[3]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i)
        ya[i >> 2][i & 3] = gelu_table2(yin[i >> 2][i & 3], gtab, miss);
      if (__any_sync(kFullMask, miss)) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          ya[i >> 2][i & 3] = gelu_fix2(yin[i >> 2][i & 3], ya[i >> 2][i & 3]);
      }
#pragma unroll 1
      for (int s = 0; s < 4; ++s) {  // the (gy, gx) sub-pixel of 32 channels
        // t2 = y @ k2[:, sub-pixel s]: A y from registers, B k2 (MN-major)
        float t2[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) t2[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kC4 / 16; ++kk)
          wgmma_rs_tb<kC8>(t2, ya[kk],
                           wgmma_desc(k2s + core_offset(16 * kk, 4 * s, 4 * kC8 / 8),
                                      4 * kC8 / 8 * 128, 128));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(t2);
        // t2 = round(gelu(round(t2 + b2))), packed as the A operand of the
        // hypernetwork product (mma.sync, per warp: its 16 pixels x 32)
        uint32_t hin[2][4], ha[2][4], hmiss = 0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const float b0 = b2s[s * kC8 + nt * 8 + 2 * tig];
          const float b1 = b2s[s * kC8 + nt * 8 + 2 * tig + 1];
          hin[nt >> 1][(nt & 1) * 2] = pack_bf16(t2[4 * nt] + b0, t2[4 * nt + 1] + b1);
          hin[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(t2[4 * nt + 2] + b0, t2[4 * nt + 3] + b1);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
          ha[i >> 2][i & 3] = gelu_table2(hin[i >> 2][i & 3], gtab, hmiss);
        if (__any_sync(kFullMask, hmiss)) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            ha[i >> 2][i & 3] = gelu_fix2(hin[i >> 2][i & 3], ha[i >> 2][i & 3]);
        }
        // out[px, m] = t2[px, :] . hyper[m, :], float32 sums of the rounded
        // values: c[0], c[1] pixel prow0, masks 2 tig, 2 tig + 1; c[2], c[3]
        // pixel prow0 + 8
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(c, ha[0], hb[0][0], hb[0][1]);
        mma_bf16(c, ha[1], hb[1][0], hb[1][1]);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 2 * tig + e;
          const int r = m * kStageSubs<OutT> + s % kStageSubs<OutT>;
          if (m < a.m) {
            store_out(st + r * kTilePx + prow0, c[e]);
            store_out(st + r * kTilePx + prow0 + 8, c[2 + e]);
          }
        }
        if ((s + 1) % kStageSubs<OutT> == 0) {
          named_barrier(1 + wg, 128);   // the sub-pixels' outputs are staged
          store_block<OutT>(a, b, p0, 4 * j + s + 1 - kStageSubs<OutT>, st, t);
          named_barrier(1 + wg, 128);   // and read: the staging is free
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

// The table gelu against the exact form, for every bf16 bit pattern
__global__ void __launch_bounds__(256) gelu_check_kernel(uint16_t* fast, uint16_t* exact) {
  __shared__ uint16_t tab[2 * kGeluSpan];
  build_gelu_table(tab, threadIdx.x, blockDim.x);
  __syncthreads();
  for (uint32_t h = 2 * (blockIdx.x * blockDim.x + threadIdx.x); h < 65536u;
       h += 2 * gridDim.x * blockDim.x) {
    const uint32_t hh = h | ((h + 1) << 16);   // the pair path of the kernel
    uint32_t miss = 0;
    uint32_t r = gelu_table2(hh, tab, miss);
    if (miss) r = gelu_fix2(hh, r);
    fast[h] = (uint16_t)(r & 0xffffu);
    fast[h + 1] = (uint16_t)(r >> 16);
    exact[h] = (uint16_t)gelu_exact_bits(h);
    exact[h + 1] = (uint16_t)gelu_exact_bits(h + 1);
  }
}

// ---------------------------------------------------------------- launches

// cuTensorMapEncodeTiled lives in libcuda; it is looked up through the
// runtime, so that the library needs no link to libcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The bf16 source (B, HW, 256) as a 3-D tensor map whose box is one ring
// slice: 64 channels x 64 pixels of one prompt, 128-byte swizzled, zeros past HW
cudaError_t source_map(CUtensorMap* map, const void* src, int batch, int hw) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)kC, (cuuint64_t)hw, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)kC * 2, (cuuint64_t)hw * kC * 2};
  const cuuint32_t box[3] = {64, kTilePx, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(src),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

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
    const long long tiles = (long long)batch * ((hw + kTilePx - 1) / kTilePx);
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    CUtensorMap map;
    err = source_map(&map, src, batch, hw);
    if (err != cudaSuccess) return err;
    const int blocks = (int)(tiles < sms ? tiles : sms);  // one persistent block per SM
    return out_bf16
               ? launch<upscale_wgmma_kernel<__nv_bfloat16>>(
                     blocks, kWsThreads, ws_smem_bytes<__nv_bfloat16>(), s, map, a)
               : launch<upscale_wgmma_kernel<float>>(blocks, kWsThreads, ws_smem_bytes<float>(),
                                                     s, map, a);
  }
  const long long blocks =
      (long long)batch * ((hw + kSimtPixels - 1) / kSimtPixels);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return out_bf16 ? launch<upscale_simt_kernel<__nv_bfloat16>>((int)blocks, 256,
                                                               kSimtSmemBytes, s, a)
                  : launch<upscale_simt_kernel<float>>((int)blocks, 256, kSimtSmemBytes, s, a);
}

// fast and exact: (65536) uint16 each, for bf16 input bits 0 .. 65535 the
// bits of the bf16 kernel's gelu and of round_bf16(gelu_erf(x)). Launches on
// `stream`; returns a cudaError_t.
int upscale_gelu_check(void* fast, void* exact, void* stream) {
  return launch<gelu_check_kernel>(64, 256, 0, (cudaStream_t)stream, (uint16_t*)fast,
                                   (uint16_t*)exact);
}

const char* upscale_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
