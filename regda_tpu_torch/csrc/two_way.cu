// SAM two-way transformer, from layer 0's image-to-token update to the final
// attention, for B prompts against one shared image embedding.
//
// Replaces the Pallas TPU kernel `two_way_fused`
// (regda_tpu/models/sam/pallas_twoway.py:474, pallas_call at :460). With
// T image tokens (4096), C = 256, D = 128, H = 8 heads of 16 and NP = 8 token
// rows per prompt (columns j = h * 8 + n below), per prompt:
//
//   keys1 = LN(softmax_n(qimg0_h . ktok0_h / 4 + maskb) @ vrow0 + keys0)
//   u1    = softmax_T((keys1 + pe) @ E1 / 4)^T @ keys1       (64, C)
//   token work: value and out projections of u1, two LayerNorms, the MLP,
//               the token projections of the next two attentions
//   keys2 = LN(softmax_n(((keys1 + pe) @ F1 + browi) / 4 + maskb) @ vrow1 + keys1)
//   uf    = softmax_T((keys2 + pe) @ Ef / 4)^T @ keys2
//   queries_out = LN(q3 + out projection of uf's values)
//
// The reassociations are the TPU kernel's: the head-split k-projection of
// the token-to-image attentions is folded into E = W_k @ Q~ (Q~ the
// block-diagonal embedding of the per-head query tokens), so no (T, D)
// projection of the keys is ever formed, and its bias is dropped, which is
// exact because that softmax runs over T; the image-to-token attention folds
// its q-projection into F = W_q @ K~ and keeps the bias row `browi`, which
// does not cancel in a softmax over tokens; the out-projection of both
// image-to-token updates is folded into the 64 value rows,
// vrow = V~ @ W_o + b_o / H, exact because each head's row of the attention
// sums to 1. What does not carry over: the 0/1 selection matrices, the
// ones-products for moments and column sums and the one-maximum-per-row
// softmax existed to suit the TPU's matrix unit and compiler. Here a head's
// 8 columns sit in one quad of a warp, so group maxima and sums are two
// shuffles; LayerNorm moments are the centred float32 ones; the softmax over
// T is a tile loop with a running maximum and sum per column.
//
// The TPU kernel keeps one prompt's (T, C) key state, 2 MB, in fast memory
// for the whole chain. A Hopper block has 227 KB, and the chain alternates
// row-local work with reductions over all T rows, so one call is five
// launches on one stream:
//   1. prep    per prompt: vrow0, E1                          (token kernel)
//   2. pass A  per (prompt, split of T), tiles of 64 rows: keys1 of the tile
//              into shared memory, folded at once into the split's partial
//              column softmax over (keys1 + pe) @ E1 and its ex^T @ keys1
//   3. mid     per prompt: merge the partials; token work; F1, browi, vrow1, Ef
//   4. pass B  per (prompt, split), tiles of 64 rows: keys1 again from keys0,
//              qimg0 and vrow0 (the same device function, so the same bits),
//              keys2 from it, written once, and folded into the partials over
//              (keys2 + pe) @ Ef
//   5. final   per prompt: merge; queries_out
// keys1 never reaches device memory: recomputing it costs pass B one more
// (64, 256) product a row, against a write and three reads of 2 MB a prompt.
//
// What bounds it on an H100: about 1.1 GFLOP per prompt against one 2 MB
// write of keys2 and reads of keys0, pe and qimg0, which all prompts share
// and which stay in L2, so the tensor cores bound it (0.063 ms at 64
// prompts). What holds these kernels far above that is latency, not bytes:
// a pass runs one block an SM, and each 64-row tile is a chain of short
// products, LayerNorm moments that the two warpgroups exchange, and
// barriers; the token kernels stream every weight once per prompt. Hence
// the prefetches a phase ahead and the wide weight loads below. Kernels:
//  * bfloat16 passes: `pass_wgmma_kernel`, two warpgroups on `wgmma`. Both
//    passes hold their (64, 256) operands (vrow0, E1^T or Ef^T; pass B also
//    vrow1 and F1^T) in shared memory for the whole split, one block an SM;
//    every product over the tile's 64 rows is one asynchronous `wgmma`
//    chain, the residual rows load while it runs, and the two warpgroups
//    split its columns (see the section's note).
//  * float32 passes: `pass_simt_kernel`, the same five launches on the
//    ordinary float32 units (the tensor cores take float32 only as TF32), so
//    the card-side float32 check holds the algorithm the bfloat16 path runs.
//  * the three token kernels: one block of 1024 threads per prompt. In
//    bfloat16 their products run on `mma.sync` (8 token rows as the top half
//    of an m16 tile; the weights, transposed by the wrapper where they are B
//    operands, read as 32-bit pairs, the loads of a product unrolled ahead of
//    its `mma`s); in float32 on the ordinary units.

#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kC = 256;      // channels of the image tokens
constexpr int kD = 128;      // internal width of the cross attentions
constexpr int kH = 8;        // heads
constexpr int kHd = kD / kH; // head width
constexpr int kNP = 8;       // token rows per prompt
constexpr int kJ = kH * kNP; // (head, token) columns
constexpr float kScale = 0.25f;   // 1 / sqrt(kHd)
constexpr float kEps = 1e-5f;
constexpr int kSlot = kJ * kC;    // elements of one per-prompt scratch operand
constexpr int kPart = kSlot + 2 * kJ;  // floats of one column-pass partial

enum Weight {  // order of the weight table, the wrapper's WKEYS
  WO0, BO0, N40W, N40B, WQT, BQT, WKT, BKT, WVT, BVT, WOT, BOT, N2W, N2B,
  W1, B1, W2, B2, N3W, N3B, WQI, BQI, WKI, BKI, WVI, BVI, WOI, BOI, N41W, N41B,
  WQF, BQF, WKF, BKF, WVF, BVF, WOF, BOF, NFW, NFB, kWeights
};
enum Slot { VROW0, E1, F1, VROW1, EF, kSlots };

struct Params {
  const void* ktok0;   // (B, 8, 128)
  const void* vtok0;   // (B, 8, 128)
  const void* q1;      // (B, 8, 256)
  const void* qpe;     // (B, 8, 256)
  const void* keys0;   // (T, 256)
  const void* pe;      // (T, 256)
  const void* qimg0;   // (T, 128)
  const float* maskb;  // (8)
  const void* w[kWeights];  // matrices in the compute type (see two_way_launch); vectors float32
  void* keys2;         // (B, T, 256) out
  void* qout;          // (B, 8, 256) out
  void* scratch;       // (B, kSlots, kSlot) compute type
  float* partials;     // (B, splits * kPart + 8 * 256 + 64)
  int batch, t, mlp, rows_per_split, splits;
};

__device__ __forceinline__ long long partial_stride(const Params& p) {
  return (long long)p.splits * kPart + kNP * kC + kJ;
}

template <typename T> __device__ __forceinline__ float ldf(const T* p);
template <> __device__ __forceinline__ float ldf<float>(const float* p) { return *p; }
template <> __device__ __forceinline__ float ldf<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__device__ __forceinline__ const T* weight(const Params& p, int which) {
  return static_cast<const T*>(p.w[which]);
}
__device__ __forceinline__ const float* vec(const Params& p, int which) {
  return static_cast<const float*>(p.w[which]);
}
template <typename T>
__device__ __forceinline__ T* slot(const Params& p, int b, int which) {
  return static_cast<T*>(p.scratch) + ((long long)b * kSlots + which) * kSlot;
}

// ------------------------------------------------------------ token kernels
//
// One block of 1024 threads per prompt. Token states live in shared memory
// as [channel][8 rows] float32, the layout `matvec8` reads.

constexpr int kTokThreads = 1024;
constexpr int kBig = 2048 * kNP;  // floats of the two large buffers
constexpr size_t kTokSmemBytes =
    sizeof(float) * (size_t)(2 * kBig + 7 * kC * kNP + 3 * kD * kNP);

// ys = xs (8, K) @ W (K, N): `epi(row, n, sum)` gets each float32 sum. Ends
// with a barrier.
//  * float32: W is (K, N). The threads split N, and K as well when N is
//    below the block's size; partial sums meet in `part`.
//  * bfloat16: W comes transposed, (N, K), and the product runs on the
//    tensor cores: the 8 rows are the top half of an m16n8k16 A fragment
//    (the bottom half zeros; xs holds values of the compute type, so the
//    packing is exact), and warp w takes the 8-column tiles w, w + 32, ....
//    The weights stream from L2 once per prompt, so what bounds this is the
//    bytes in flight: K is taken in chunks of 64, and within a chunk the
//    lane with tig = t loads row n of W^T at columns 16 t .. 16 t + 15 (two
//    16-byte loads) and uses them as its B pairs of the chunk's four
//    k-steps, k-step s taking columns 16 t + 4 s + {0, 1} and + {2, 3}; its
//    A pairs come from the same columns, so every product term is the
//    plain one and only the order of the float32 sum differs.
template <typename T, typename Epi>
__device__ void matvec8(const float* xs, const T* w, int k_dim, int n_dim,
                        float* part, Epi epi) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 2) {
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
    for (int nt = warp; nt < n_dim / 8; nt += kTokThreads / 32) {
      const T* wrow = w + (long long)(nt * 8 + g) * k_dim + 16 * tig;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
      for (int c0 = 0; c0 < k_dim; c0 += 64) {
        const uint4 wa = *reinterpret_cast<const uint4*>(wrow + c0);
        const uint4 wb = *reinterpret_cast<const uint4*>(wrow + c0 + 8);
        const uint32_t bw[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          const float* x = xs + (c0 + 16 * tig + 4 * st) * kNP + g;
          const uint32_t a[4] = {pack_bf16(x[0], x[kNP]), 0u, pack_bf16(x[2 * kNP], x[3 * kNP]),
                                 0u};
          mma_bf16(acc[st & 1], a, bw[2 * st], bw[2 * st + 1]);
        }
      }
      const int n = nt * 8 + 2 * tig;
      epi(g, n, acc[0][0] + acc[1][0]);
      epi(g, n + 1, acc[0][1] + acc[1][1]);
    }
    __syncthreads();
    return;
  }
  const int cols = n_dim < kTokThreads ? n_dim : kTokThreads;
  const int ksplit = kTokThreads / cols, klen = k_dim / ksplit;
  const int ks = tid / cols, n0 = tid % cols;
  for (int n = n0; n < n_dim; n += cols) {
    float acc[kNP];
#pragma unroll
    for (int r = 0; r < kNP; ++r) acc[r] = 0.f;
    const T* wp = w + (long long)(ks * klen) * n_dim + n;
    const float* xp = xs + ks * klen * kNP;
#pragma unroll 8
    for (int k = 0; k < klen; ++k) {
      const float wv = ldf(wp + (long long)k * n_dim);
      const float4 x0 = *reinterpret_cast<const float4*>(xp + k * kNP);
      const float4 x1 = *reinterpret_cast<const float4*>(xp + k * kNP + 4);
      acc[0] = fmaf(x0.x, wv, acc[0]);
      acc[1] = fmaf(x0.y, wv, acc[1]);
      acc[2] = fmaf(x0.z, wv, acc[2]);
      acc[3] = fmaf(x0.w, wv, acc[3]);
      acc[4] = fmaf(x1.x, wv, acc[4]);
      acc[5] = fmaf(x1.y, wv, acc[5]);
      acc[6] = fmaf(x1.z, wv, acc[6]);
      acc[7] = fmaf(x1.w, wv, acc[7]);
    }
    float* o = part + ((long long)ks * n_dim + n) * kNP;
#pragma unroll
    for (int r = 0; r < kNP; ++r) o[r] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < n_dim * kNP; i += kTokThreads) {
    const int n = i >> 3, r = i & 7;
    float v = 0.f;
    for (int s = 0; s < ksplit; ++s) v += part[((long long)s * n_dim + n) * kNP + r];
    epi(r, n, v);
  }
  __syncthreads();
}

// LayerNorm over the 256 channels of each of the 8 rows of `in` ([c][8]);
// warp r takes row r. `epi(row, c, value)`. Ends with a barrier.
template <typename Epi>
__device__ void ln_rows(const float* in, const float* w, const float* b, Epi epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < kNP) {
    float v[kC / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) {
      v[i] = in[(lane + 32 * i) * kNP + warp];
      s += v[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
    const float mu = s * (1.f / kC);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) {
      v[i] -= mu;
      q += v[i] * v[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(kFullMask, q, off);
    const float r = rsqrtf(q * (1.f / kC) + kEps);
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) {
      const int c = lane + 32 * i;
      epi(warp, c, v[i] * r * w[c] + b[c]);
    }
  }
  __syncthreads();
}

// Token states are float32 in shared memory, holding values of the compute
// type; as mma operands they pack exactly into bfloat16 pairs.
__device__ __forceinline__ uint32_t pack_tok(const float* tok, int row, int n) {
  return pack_bf16(tok[row * kNP + n], tok[(row + 1) * kNP + n]);
}

// E[c][j] = sum over head h's 16 channels of W[c][h * 16 + d] * tok[d][n],
// j = h * 8 + n: the (C, D) projection folded with the block-diagonal
// embedding of the 8 tokens' (D) vectors. tok is [d][8] in shared memory. In
// bfloat16, per head one m16n8k16 product per 16 rows of W (k = the head's
// 16 channels, n = the 8 tokens), 128 in all over the block's 32 warps.
template <typename T>
__device__ void fold_projection(const T* w, const float* tok, T* out) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int u = warp; u < (kC / 16) * kH; u += kTokThreads / 32) {
      const int mt = u / kH, h = u % kH, d = h * kHd + 2 * tig;
      const T* w0 = w + (mt * 16 + g) * kD + d;
      const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(w0),
                             *reinterpret_cast<const uint32_t*>(w0 + 8 * kD),
                             *reinterpret_cast<const uint32_t*>(w0 + 8),
                             *reinterpret_cast<const uint32_t*>(w0 + 8 * kD + 8)};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, a, pack_tok(tok, d, g), pack_tok(tok, d + 8, g));
      T* o = out + (mt * 16 + g) * kJ + h * kNP + 2 * tig;
      *reinterpret_cast<uint32_t*>(o) = pack_bf16(acc[0], acc[1]);
      *reinterpret_cast<uint32_t*>(o + 8 * kJ) = pack_bf16(acc[2], acc[3]);
    }
    return;
  }
  for (int i = threadIdx.x; i < kC * kJ; i += kTokThreads) {
    const int j = i % kJ, c = i / kJ, h = j / kNP, n = j % kNP;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHd; ++d)
      s = fmaf(ldf(w + c * kD + h * kHd + d), tok[(h * kHd + d) * kNP + n], s);
    stf(out + i, s);
  }
}

// vrow[j][c] = sum over head h's channels of tok[d][n] * W_o[h * 16 + d][c]
// + b_o[c] / H: the value rows with the out-projection folded in. In
// bfloat16 W_o comes transposed, (C, D): per head and 8 columns one
// m16n8k16 product (rows = the 8 tokens, the upper 8 zeros), 256 in all.
template <typename T>
__device__ void fold_values(const T* wo, const float* bo, const float* tok, T* out) {
  if constexpr (sizeof(T) == 2) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int u = warp; u < kH * (kC / 8); u += kTokThreads / 32) {
      const int h = u / (kC / 8), c0 = (u % (kC / 8)) * 8, d = h * kHd + 2 * tig;
      const uint32_t a[4] = {pack_tok(tok, d, g), 0u, pack_tok(tok, d + 8, g), 0u};
      const T* w0 = wo + (c0 + g) * kD + d;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(acc, a, *reinterpret_cast<const uint32_t*>(w0),
               *reinterpret_cast<const uint32_t*>(w0 + 8));
      const int c = c0 + 2 * tig;
      *reinterpret_cast<uint32_t*>(out + (h * kNP + g) * kC + c) =
          pack_bf16(acc[0] + bo[c] * (1.f / kH), acc[1] + bo[c + 1] * (1.f / kH));
    }
    return;
  }
  for (int i = threadIdx.x; i < kJ * kC; i += kTokThreads) {
    const int c = i % kC, j = i / kC, h = j / kNP, n = j % kNP;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHd; ++d)
      s = fmaf(tok[(h * kHd + d) * kNP + n], ldf(wo + (h * kHd + d) * kC + c), s);
    stf(out + i, s + bo[c] * (1.f / kH));
  }
}

// Merge the passes' partials of prompt b into u = softmax_T(..)^T @
// keys (64, 256), then the per-head value projection, its bias (exact: the
// softmax rows sum to 1) and the out-projection: out[c][row], rounded.
template <typename T>
__device__ void token_to_image_tail(const Params& p, int b, int wv, int bv, int wo,
                                    int bo, float* us, float* part, float* mg,
                                    float* out) {
  const int tid = threadIdx.x;
  const float* base = p.partials + (long long)b * partial_stride(p);
  // weights of the partials and the reciprocal of the merged sum, per column
  float* wgt = part;                 // [splits][64]
  float* inv = part + p.splits * kJ;
  if (tid < kJ) {
    float m = -INFINITY;
    for (int s = 0; s < p.splits; ++s) m = fmaxf(m, base[(long long)s * kPart + tid]);
    float sum = 0.f;
    for (int s = 0; s < p.splits; ++s) {
      const float e = expf(base[(long long)s * kPart + tid] - m);
      wgt[s * kJ + tid] = e;
      sum += e * base[(long long)s * kPart + kJ + tid];
    }
    inv[tid] = 1.f / sum;
  }
  __syncthreads();
  // each thread's 16 elements of a split's partial load together
  constexpr int kPer = kSlot / kTokThreads;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) v[k] = 0.f;
  for (int s = 0; s < p.splits; ++s) {
    const float* src = base + (long long)s * kPart + 2 * kJ;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = tid + kTokThreads * k;
      v[k] = fmaf(wgt[s * kJ + i / kC], src[i], v[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + kTokThreads * k;
    us[i] = rnd<T>(v[k] * inv[i / kC]);
  }
  __syncthreads();
  const float* bvv = vec(p, bv);
  if constexpr (sizeof(T) == 2) {
    // per head and 8 of its channels one m16n8k16 product per 16 of the 256
    // channels of u (rows = the head's 8 columns, the upper 8 zeros); W_v
    // comes transposed, (D, C)
    const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, tig = lane & 3;
    if (warp < 2 * kH) {
      const int h = warp >> 1, d0 = h * kHd + (warp & 1) * 8;
      const float* ur = us + (h * kNP + g) * kC + 2 * tig;
      const T* w0 = weight<T>(p, wv) + (d0 + g) * kC + 2 * tig;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(ur[16 * kk], ur[16 * kk + 1]), 0u,
                               pack_bf16(ur[16 * kk + 8], ur[16 * kk + 9]), 0u};
        mma_bf16(acc, a, *reinterpret_cast<const uint32_t*>(w0 + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(w0 + 16 * kk + 8));
      }
      const int d = d0 + 2 * tig;
      mg[d * kNP + g] = rnd<T>(rnd<T>(acc[0]) + bvv[d]);
      mg[(d + 1) * kNP + g] = rnd<T>(rnd<T>(acc[1]) + bvv[d + 1]);
    }
  } else {
    const int j = tid / kHd, d = tid % kHd, h = j / kNP, n = j % kNP;
    const T* w = weight<T>(p, wv) + h * kHd + d;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < kC; ++c) s = fmaf(us[j * kC + c], ldf(w + c * kD), s);
    mg[(h * kHd + d) * kNP + n] = rnd<T>(rnd<T>(s) + bvv[h * kHd + d]);
  }
  __syncthreads();
  const float* bias = vec(p, bo);
  matvec8<T>(mg, weight<T>(p, wo), kD, kC, part,
             [&](int r, int n, float v) { out[n * kNP + r] = rnd<T>(v + bias[n]); });
}

struct TokenSmem {
  float *big0, *big1, *c0, *c1, *c2, *c3, *c4, *c5, *c6, *d0, *d1, *d2;
  __device__ explicit TokenSmem(unsigned char* raw) {
    float* f = reinterpret_cast<float*>(raw);
    big0 = f;
    big1 = big0 + kBig;
    c0 = big1 + kBig;
    c1 = c0 + kC * kNP;
    c2 = c1 + kC * kNP;
    c3 = c2 + kC * kNP;
    c4 = c3 + kC * kNP;
    c5 = c4 + kC * kNP;
    c6 = c5 + kC * kNP;
    d0 = c6 + kC * kNP;
    d1 = d0 + kD * kNP;
    d2 = d1 + kD * kNP;
  }
};

// rows (8, width) of prompt b in device memory -> [channel][8] shared memory
template <typename T>
__device__ void load_rows(const void* src, int b, int width, float* dst) {
  const T* s = static_cast<const T*>(src) + (long long)b * kNP * width;
  for (int i = threadIdx.x; i < kNP * width; i += kTokThreads)
    dst[(i % width) * kNP + i / width] = ldf(s + i);
}

template <typename T>
__global__ void __launch_bounds__(kTokThreads, 1) prep_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TokenSmem m(smem);
  const int b = blockIdx.x, tid = threadIdx.x;
  load_rows<T>(p.q1, b, kC, m.c0);
  load_rows<T>(p.qpe, b, kC, m.c1);
  load_rows<T>(p.vtok0, b, kD, m.d0);
  __syncthreads();
  for (int i = tid; i < kC * kNP; i += kTokThreads) m.c2[i] = rnd<T>(m.c0[i] + m.c1[i]);
  __syncthreads();
  const float* bqt = vec(p, BQT);
  float* qt = m.d1;
  matvec8<T>(m.c2, weight<T>(p, WQT), kC, kD, m.big1,
             [&](int r, int n, float v) { qt[n * kNP + r] = rnd<T>(v + bqt[n]); });
  fold_projection<T>(weight<T>(p, WKT), qt, slot<T>(p, b, E1));
  fold_values<T>(weight<T>(p, WO0), vec(p, BO0), m.d0, slot<T>(p, b, VROW0));
}

template <typename T>
__global__ void __launch_bounds__(kTokThreads, 1) mid_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TokenSmem m(smem);
  const int b = blockIdx.x, tid = threadIdx.x;
  float* q1 = m.c0;
  float* qpe = m.c1;
  load_rows<T>(p.q1, b, kC, q1);
  load_rows<T>(p.qpe, b, kC, qpe);
  float* out_t = m.c2;
  token_to_image_tail<T>(p, b, WVT, BVT, WOT, BOT, m.big0, m.big1, m.d0, out_t);
  for (int i = tid; i < kC * kNP; i += kTokThreads) out_t[i] += q1[i];
  __syncthreads();
  float* q2 = m.c3;
  float* q2r = m.c4;
  ln_rows(out_t, vec(p, N2W), vec(p, N2B), [&](int r, int c, float v) {
    q2[c * kNP + r] = v;
    q2r[c * kNP + r] = rnd<T>(v);
  });
  // the MLP: relu(q2 @ w1 + b1) @ w2 + b2
  const float* b1 = vec(p, B1);
  float* hidden = m.big0;
  matvec8<T>(q2r, weight<T>(p, W1), kC, p.mlp, m.big1, [&](int r, int n, float v) {
    hidden[n * kNP + r] = rnd<T>(fmaxf(v + b1[n], 0.f));
  });
  const float* b2 = vec(p, B2);
  float* pre3 = m.c2;
  matvec8<T>(hidden, weight<T>(p, W2), p.mlp, kC, m.big1, [&](int r, int n, float v) {
    pre3[n * kNP + r] = q2[n * kNP + r] + v + b2[n];
  });
  float* q3g = p.partials + (long long)b * partial_stride(p) + (long long)p.splits * kPart;
  float* qp3 = m.c3;
  float* q3r = m.c4;
  ln_rows(pre3, vec(p, N3W), vec(p, N3B), [&](int r, int c, float v) {
    q3g[r * kC + c] = v;
    qp3[c * kNP + r] = rnd<T>(v + qpe[c * kNP + r]);
    q3r[c * kNP + r] = rnd<T>(v);
  });
  // token projections of the image-to-token and the final attention
  const float *bki = vec(p, BKI), *bvi = vec(p, BVI), *bqf = vec(p, BQF);
  float *kt = m.d0, *vt = m.d1, *qf = m.d2;
  matvec8<T>(qp3, weight<T>(p, WKI), kC, kD, m.big1,
             [&](int r, int n, float v) { kt[n * kNP + r] = rnd<T>(v + bki[n]); });
  matvec8<T>(q3r, weight<T>(p, WVI), kC, kD, m.big1,
             [&](int r, int n, float v) { vt[n * kNP + r] = rnd<T>(v + bvi[n]); });
  matvec8<T>(qp3, weight<T>(p, WQF), kC, kD, m.big1,
             [&](int r, int n, float v) { qf[n * kNP + r] = rnd<T>(v + bqf[n]); });
  fold_projection<T>(weight<T>(p, WQI), kt, slot<T>(p, b, F1));
  fold_values<T>(weight<T>(p, WOI), vec(p, BOI), vt, slot<T>(p, b, VROW1));
  fold_projection<T>(weight<T>(p, WKF), qf, slot<T>(p, b, EF));
  if (tid < kJ) {  // the q-bias of the image-to-token attention, per column
    const int h = tid / kNP, n = tid % kNP;
    const float* bqi = vec(p, BQI);
    float s = 0.f;
    for (int d = 0; d < kHd; ++d) s = fmaf(bqi[h * kHd + d], kt[(h * kHd + d) * kNP + n], s);
    q3g[kNP * kC + tid] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kTokThreads, 1) final_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TokenSmem m(smem);
  const int b = blockIdx.x, tid = threadIdx.x;
  float* outf = m.c2;
  token_to_image_tail<T>(p, b, WVF, BVF, WOF, BOF, m.big0, m.big1, m.d0, outf);
  const float* q3g = p.partials + (long long)b * partial_stride(p) + (long long)p.splits * kPart;
  for (int i = tid; i < kC * kNP; i += kTokThreads)
    outf[i] += q3g[(i % kNP) * kC + i / kNP];
  __syncthreads();
  T* qout = static_cast<T*>(p.qout) + (long long)b * kNP * kC;
  ln_rows(outf, vec(p, NFW), vec(p, NFB),
          [&](int r, int c, float v) { stf(qout + r * kC + c, v); });
}

// ------------------------------------------------ the two passes, float32
//
// `pass_simt_kernel<kB>`: per (prompt, split), tiles of 32 rows, 8 warps of
// 4 rows. The row update keeps the warp's 4 rows in registers (lane l takes
// the logits' columns l and l + 32 and the channels l + 32 i) and writes
// them to a tile in shared memory; the column fold has thread c own channel
// c of all 64 rows of ex^T @ keys (64 registers) and threads 0..63 the
// running maximum and sum of column j. The (64, 256) operands are read from
// device memory through L1: the float32 chain holds the card's results to
// float32, it is not the main path.

constexpr int kSimtTile = 32;
constexpr int kSimtWarpRows = 4;

// The row update of one warp's 4 rows, tile rows l0 .. l0 + 3 (device rows
// row0 .. row0 + 3; rows past T are computed on row T - 1):
//   kSecond = false: keys1 = LN(softmax_n(qimg0_h . ktok0_h / 4 + maskb) @ vrow0 + keys0)
//   kSecond = true:  keys2 = LN(softmax_n(((keys1 + pe) @ F1 + browi) / 4 + maskb)
//                               @ vrow1 + keys1), keys1 from the tile `tin`
// into the tile `tout`, and for kSecond into keys2 for rows below `end`.
template <bool kSecond>
__device__ void simt_rows(const Params& p, int b, int row0, int l0, int end, const float* tin,
                          float* tout, float* attn, float* kpe, const float* brow) {
  const int lane = threadIdx.x & 31;
  const float* vrow = slot<float>(p, b, kSecond ? VROW1 : VROW0);
  const float* pe = static_cast<const float*>(p.pe);
  const float* lnw = vec(p, kSecond ? N41W : N40W);
  const float* lnb = vec(p, kSecond ? N41B : N40B);
  const float mask0 = p.maskb[lane % kNP];  // columns l and l + 32 are one token
  float lg[kSimtWarpRows][2];
  if (kSecond) {
    const float* fs = slot<float>(p, b, F1);
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) {
      const int row = min(row0 + r, p.t - 1);
#pragma unroll
      for (int i = 0; i < kC / 32; ++i) {
        const int c = lane + 32 * i;
        kpe[r * kC + c] = tin[(l0 + r) * kC + c] + pe[(long long)row * kC + c];
      }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) lg[r][0] = lg[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float f0 = fs[c * kJ + lane], f1 = fs[c * kJ + lane + 32];
#pragma unroll
      for (int r = 0; r < kSimtWarpRows; ++r) {
        const float x = kpe[r * kC + c];
        lg[r][0] = fmaf(x, f0, lg[r][0]);
        lg[r][1] = fmaf(x, f1, lg[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) {
      lg[r][0] += brow[lane];
      lg[r][1] += brow[lane + 32];
    }
  } else {
    const float* qimg = static_cast<const float*>(p.qimg0);
    const float* kt = static_cast<const float*>(p.ktok0) + (long long)b * kNP * kD;
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) {
      const int row = min(row0 + r, p.t - 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = lane + 32 * half, h = j / kNP, n = j % kNP;
        float s = 0.f;
#pragma unroll
        for (int d = 0; d < kHd; ++d)
          s = fmaf(qimg[(long long)row * kD + h * kHd + d], kt[n * kD + h * kHd + d], s);
        lg[r][half] = s;
      }
    }
  }
  // softmax over each head's 8 tokens: 8 neighbouring lanes
#pragma unroll
  for (int r = 0; r < kSimtWarpRows; ++r) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float l = lg[r][half] * kScale + mask0;
      float mx = l;
#pragma unroll
      for (int off = 1; off < kNP; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float e = expf(l - mx);
      float sum = e;
#pragma unroll
      for (int off = 1; off < kNP; off <<= 1) sum += __shfl_xor_sync(kFullMask, sum, off);
      attn[r * kJ + lane + 32 * half] = e / sum;
    }
  }
  __syncwarp();
  // x = attn @ vrow + keys_in, then LayerNorm over the 256 channels
  float x[kSimtWarpRows][kC / 32];
#pragma unroll
  for (int r = 0; r < kSimtWarpRows; ++r)
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) x[r][i] = 0.f;
#pragma unroll 2
  for (int j = 0; j < kJ; ++j) {
    float v[kC / 32];
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) v[i] = vrow[j * kC + lane + 32 * i];
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) {
      const float a = attn[r * kJ + j];
#pragma unroll
      for (int i = 0; i < kC / 32; ++i) x[r][i] = fmaf(a, v[i], x[r][i]);
    }
  }
  const float* keys0 = static_cast<const float*>(p.keys0);
  float* keys2 = static_cast<float*>(p.keys2) + (long long)b * p.t * kC;
#pragma unroll
  for (int r = 0; r < kSimtWarpRows; ++r) {
    const int row = min(row0 + r, p.t - 1);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) {
      const int c = lane + 32 * i;
      x[r][i] += kSecond ? tin[(l0 + r) * kC + c] : keys0[(long long)row * kC + c];
      s += x[r][i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFullMask, s, off);
    const float mu = s * (1.f / kC);
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) {
      x[r][i] -= mu;
      q += x[r][i] * x[r][i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) q += __shfl_xor_sync(kFullMask, q, off);
    const float rs = rsqrtf(q * (1.f / kC) + kEps);
#pragma unroll
    for (int i = 0; i < kC / 32; ++i) {
      const int c = lane + 32 * i;
      const float y = x[r][i] * rs * lnw[c] + lnb[c];
      tout[(l0 + r) * kC + c] = y;
      if (kSecond && row0 + r < end) keys2[(long long)(row0 + r) * kC + c] = y;
    }
  }
  __syncwarp();  // attn and kpe are rewritten by the warp's next call
}

constexpr size_t simt_pass_smem_bytes(bool second) {
  return sizeof(float) * (size_t)((second ? 2 : 1) * kSimtTile * kC + 8 * kSimtWarpRows * kJ +
                                  8 * kSimtWarpRows * kC + kSimtTile * kJ + 2 * kJ);
}

template <bool kB>
__global__ void __launch_bounds__(256, 1) pass_simt_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* t1 = reinterpret_cast<float*>(smem);          // [32][256] keys1
  float* t2 = t1 + kSimtTile * kC;                     // [32][256] keys2 (pass B)
  float* attn_all = t2 + (kB ? kSimtTile * kC : 0);    // per warp [4][64]
  float* kpe_all = attn_all + 8 * kSimtWarpRows * kJ;  // per warp [4][256]
  float* ls = kpe_all + 8 * kSimtWarpRows * kC;        // [32][64] logits, then ex
  float* alphas = ls + kSimtTile * kJ;                 // [64]
  float* brow = alphas + kJ;                           // [64] (pass B)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, split = blockIdx.x;
  if (kB && tid < kJ)
    brow[tid] = p.partials[(long long)b * partial_stride(p) + (long long)p.splits * kPart +
                           kNP * kC + tid];
  float* attn = attn_all + warp * kSimtWarpRows * kJ;
  float* kpe = kpe_all + warp * kSimtWarpRows * kC;
  const float* es = slot<float>(p, b, kB ? EF : E1);
  const float* pe = static_cast<const float*>(p.pe);
  float* keys = kB ? t2 : t1;  // what the column fold reads

  float u[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) u[j] = 0.f;
  float run_max = -INFINITY, run_sum = 0.f;  // of column tid, threads 0..63

  const int begin = split * p.rows_per_split;
  const int end = min(p.t, begin + p.rows_per_split);
  for (int tile0 = begin; tile0 < end; tile0 += kSimtTile) {
    __syncthreads();  // the previous tile has been read (and brow is written)
    const int l0 = warp * kSimtWarpRows, row0 = tile0 + l0;
    simt_rows<false>(p, b, row0, l0, end, nullptr, t1, attn, kpe, brow);
    if (kB) simt_rows<true>(p, b, row0, l0, end, t1, t2, attn, kpe, brow);  // the warp's own rows
    // logits of the warp's 4 rows: (keys + pe) @ E
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) {
      const int row = min(row0 + r, p.t - 1);
#pragma unroll
      for (int i = 0; i < kC / 32; ++i) {
        const int c = lane + 32 * i;
        kpe[r * kC + c] = keys[(l0 + r) * kC + c] + pe[(long long)row * kC + c];
      }
    }
    __syncwarp();
    float lg[kSimtWarpRows][2];
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) lg[r][0] = lg[r][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float f0 = es[c * kJ + lane], f1 = es[c * kJ + lane + 32];
#pragma unroll
      for (int r = 0; r < kSimtWarpRows; ++r) {
        const float x = kpe[r * kC + c];
        lg[r][0] = fmaf(x, f0, lg[r][0]);
        lg[r][1] = fmaf(x, f1, lg[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) {
      const bool valid = row0 + r < end;
      float* l = ls + (l0 + r) * kJ;
      l[lane] = valid ? lg[r][0] * kScale : -INFINITY;
      l[lane + 32] = valid ? lg[r][1] * kScale : -INFINITY;
    }
    __syncthreads();
    if (tid < kJ) {
      float mx = run_max;
      for (int r = 0; r < kSimtTile; ++r) mx = fmaxf(mx, ls[r * kJ + tid]);
      const float alpha = expf(run_max - mx);  // the tile's first row is valid
      float sum = 0.f;
      for (int r = 0; r < kSimtTile; ++r) {
        const float ex = expf(ls[r * kJ + tid] - mx);
        sum += ex;
        ls[r * kJ + tid] = ex;
      }
      run_sum = run_sum * alpha + sum;
      run_max = mx;
      alphas[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kJ; ++j) u[j] *= alphas[j];
    for (int r = 0; r < kSimtTile; ++r) {
      if (tile0 + r >= end) break;
      const float kv = keys[r * kC + tid];
      const float4* ex = reinterpret_cast<const float4*>(ls + r * kJ);
#pragma unroll
      for (int j4 = 0; j4 < kJ / 4; ++j4) {
        const float4 e4 = ex[j4];
        u[4 * j4] = fmaf(e4.x, kv, u[4 * j4]);
        u[4 * j4 + 1] = fmaf(e4.y, kv, u[4 * j4 + 1]);
        u[4 * j4 + 2] = fmaf(e4.z, kv, u[4 * j4 + 2]);
        u[4 * j4 + 3] = fmaf(e4.w, kv, u[4 * j4 + 3]);
      }
    }
  }
  float* part = p.partials + (long long)b * partial_stride(p) + (long long)split * kPart;
  if (tid < kJ) {
    part[tid] = run_max;
    part[kJ + tid] = run_sum;
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) part[2 * kJ + j * kC + tid] = u[j];
}

// ----------------------------------------------- the two passes, bfloat16
//
// `pass_wgmma_kernel<kB>`: per (prompt, split), tiles of 64 rows, two
// warpgroups. Every product of 64 tile rows is one `wgmma` chain; the two
// warpgroups split its columns: in the row update warpgroup w takes
// channels 128 w .. + 127 (the halves meet their LayerNorm moments in shared
// memory), in the fold's logits columns 32 w .. + 31, and of the (64, 256)
// product ex^T @ keys channels 128 w .. + 127. A warp of a warpgroup holds
// rows 16 (warp % 4) + {g, g + 8} of each accumulator. Operands in shared
// memory are in the core-matrix layout of mma.cuh, so that every product
// reads them as they lie: the value rows and the key tile as N-major B,
// (keys + pe), ex^T and the transposed folded projections as K-major.

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

constexpr int kTile = 64;       // rows per tile of the bfloat16 passes
constexpr int kLdKt = kD + 8;   // [8][kLdKt]: layer 0's k tokens, plain rows
constexpr int kCc = kC / 8;     // 16-byte chunks of a 256-wide row
constexpr int kRowGroup = kCc * 128;  // bytes between 8-row groups of such a tile

// element (row, c) of a (rows, 256) tile in the core-matrix layout
__device__ __forceinline__ int cm256(int row, int c) {
  return core_offset(row, c >> 3, kCc) + (c & 7);
}

constexpr int kLdQ = kD + 8;  // [64][kLdQ]: the tile's rows of qimg0, plain rows

struct PassSmem {
  bf16 *vrow0, *vrow1, *et, *f1t, *kp, *keys, *ext, *kt0, *qs, *k0s;
  float *ln0w, *ln0b, *ln1w, *ln1b, *brow, *maskb, *red, *wred, *alphas, *mfin;
  // pass A also prefetches the tile's keys0; pass B has no room for it
  static constexpr size_t bytes(bool second) {
    return sizeof(bf16) * (size_t)((second ? 4 : 2) * kJ * kC + (second ? 2 : 3) * kTile * kC +
                                   kJ * kTile + kNP * kLdKt + kTile * kLdQ) +
           sizeof(float) * (size_t)(4 * kC + kJ + kNP + 4 * kTile + 4 * kJ + 2 * kJ);
  }
  __device__ PassSmem(unsigned char* raw, bool second) {
    vrow0 = reinterpret_cast<bf16*>(raw);  // [64 j][256 c], N-major B
    et = vrow0 + kJ * kC;                  // [64 j][256 c]: E1^T or Ef^T, K-major B
    kp = et + kJ * kC;                     // [64 rows][256 c]: pe, then keys + pe, K-major A
    keys = kp + kTile * kC;                // [64 rows][256 c]: keys1, then keys2; N-major B
    ext = keys + kTile * kC;               // [64 j][64 rows]: ex^T, K-major A
    vrow1 = ext + kJ * kTile;              // (pass B) [64 j][256 c], N-major B
    f1t = vrow1 + (second ? kJ * kC : 0);  // (pass B) [64 j][256 c]: F1^T, K-major B
    kt0 = f1t + (second ? kJ * kC : 0);    // [8][kLdKt]
    qs = kt0 + kNP * kLdKt;                // [64 rows][kLdQ]
    k0s = second ? nullptr : qs + kTile * kLdQ;  // (pass A) [64 rows][256 c]: keys0
    ln0w = reinterpret_cast<float*>(qs + kTile * kLdQ + (second ? 0 : kTile * kC));
    ln0b = ln0w + kC;
    ln1w = ln0b + kC;
    ln1b = ln1w + kC;
    brow = ln1b + kC;        // [64] (pass B)
    maskb = brow + kJ;       // [8]
    red = maskb + kNP;       // [sum, square][half][64 rows]
    wred = red + 4 * kTile;  // [4 warps][64 columns]
    alphas = wred + 4 * kJ;  // [64]
    mfin = alphas + kJ;      // [64]
  }
};

// Prefetches of a tile's shared rows (rows past T are row T - 1) by
// `cp.async`, so that no product waits on L2: qimg0 into plain rows, a
// (T, 256) operand into the core-matrix layout. The caller commits.
__device__ __forceinline__ void prefetch_qimg(const Params& p, const PassSmem& m, int tile0) {
  const bf16* q = static_cast<const bf16*>(p.qimg0);
#pragma unroll
  for (int k = 0; k < kTile * (kD / 8) / 256; ++k) {
    const int i = threadIdx.x + 256 * k, r = i / (kD / 8), ch = i % (kD / 8);
    const long long row = min(tile0 + r, p.t - 1);
    cp_async16(m.qs + r * kLdQ + ch * 8, q + row * kD + ch * 8, 16);
  }
}
__device__ __forceinline__ void prefetch_rows(bf16* dst, const void* src, int t, int tile0) {
  const bf16* s = static_cast<const bf16*>(src);
#pragma unroll
  for (int k = 0; k < kTile * kCc / 256; ++k) {
    const int i = threadIdx.x + 256 * k, r = i / kCc, ch = i % kCc;
    const long long row = min(tile0 + r, t - 1);
    cp_async16(dst + core_offset(r, ch, kCc), s + row * kC + ch * 8, 16);
  }
}

// A (64 j, 256 c) matrix from device memory into the core-matrix layout:
// as it is (N-major B of the value rows) or, from (256 c, 64 j), transposed
// (K-major B of a folded projection). Each thread's eight 16-byte loads are
// issued before any of its stores.
constexpr int kPassThreads = 256;
constexpr int kStageLoads = kJ * kCc / kPassThreads;
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src) {
  uint4 v[kStageLoads];
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int i = threadIdx.x + kPassThreads * k;
    v[k] = *reinterpret_cast<const uint4*>(src + i * 8);
  }
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int i = threadIdx.x + kPassThreads * k;
    *reinterpret_cast<uint4*>(dst + core_offset(i / kCc, i % kCc, kCc)) = v[k];
  }
}
__device__ __forceinline__ void stage_transposed(bf16* dst, const bf16* src) {
  uint4 v[kStageLoads];
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int i = threadIdx.x + kPassThreads * k;
    v[k] = *reinterpret_cast<const uint4*>(src + i * 8);
  }
#pragma unroll
  for (int k = 0; k < kStageLoads; ++k) {
    const int i = threadIdx.x + kPassThreads * k, c = i / (kJ / 8), j0 = (i % (kJ / 8)) * 8;
    const bf16* e = reinterpret_cast<const bf16*>(&v[k]);
#pragma unroll
    for (int e8 = 0; e8 < 8; ++e8) dst[cm256(j0 + e8, c)] = e[e8];
  }
}

// The row update of one tile, both warpgroups:
//   kSecond = false: keys1 = LN(softmax_n(qimg0_h . ktok0_h / 4 + maskb) @ vrow0 + keys0)
//   kSecond = true:  keys2 = LN(softmax_n(((keys1 + pe) @ F1 + browi) / 4 + maskb)
//                               @ vrow1 + keys1), from the tile's keys1
// Rows past T are computed on row T - 1. qimg0's rows come from the
// prefetched tile, keys0's from the prefetched tile in pass A and from L2 in
// pass B, pe from the (keys + pe) tile, where it was prefetched. The result
// goes to the key tile and, plus pe and rounded, to the (keys + pe) tile.
// Once the first update has read qimg0 and keys0, it prefetches the next
// tile's (from `next0`, if below `end`); the second update prefetches pe
// again as soon as its logits have read the (keys + pe) tile. Three
// barriers (the second update four); ends with the tiles written and fenced.
template <bool kSecond>
__device__ __forceinline__ void wg_rows(const Params& p, const PassSmem& m, int tile0, int end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wg = warp >> 2;
  const int l0 = (warp & 3) * 16 + g, l1 = l0 + 8;  // rows within the tile
  const long long q0 = min(tile0 + l0, p.t - 1), q1 = min(tile0 + l1, p.t - 1);
  const float mk0 = m.maskb[2 * tig], mk1 = m.maskb[2 * tig + 1];

  // logits (16 rows x 64 columns per warp): n-tile h holds head h's 8 tokens
  float lg[kJ / 2];
  if (kSecond) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk)
      wgmma_ss<64>(lg, wgmma_desc(m.kp, 128, kRowGroup) + 16 * kk,
                   wgmma_desc(m.f1t, 128, kRowGroup) + 16 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(lg);
    __syncthreads();  // both warpgroups' logits have read the (keys + pe) tile
    prefetch_rows(m.kp, p.pe, p.t, tile0);
    cp_async_commit();
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const float bq0 = m.brow[h * 8 + 2 * tig], bq1 = m.brow[h * 8 + 2 * tig + 1];
      lg[4 * h] += bq0;
      lg[4 * h + 1] += bq1;
      lg[4 * h + 2] += bq0;
      lg[4 * h + 3] += bq1;
    }
  } else {
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      const int c = h * kHd + 2 * tig;
      const bf16* q = m.qs + l0 * kLdQ + c;
      const uint32_t a[4] = {ld32(q), ld32(q + 8 * kLdQ), ld32(q + 8), ld32(q + 8 * kLdQ + 8)};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      // B[k = channel][n = token] = ktok0[token][channel]: pairs along k
      mma_bf16(acc, a, ld32(m.kt0 + g * kLdKt + c), ld32(m.kt0 + g * kLdKt + c + 8));
#pragma unroll
      for (int e = 0; e < 4; ++e) lg[4 * h + e] = acc[e];
    }
  }
  // softmax over each head's 8 tokens: the 4 threads of a quad hold 2 each;
  // the probabilities, rounded, are the A operand of the product with the
  // value rows, heads 2k and 2k + 1 its k-step k
  uint32_t pa[kH / 2][4];
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    float v0 = lg[4 * h] * kScale + mk0, v1 = lg[4 * h + 1] * kScale + mk1;
    float v2 = lg[4 * h + 2] * kScale + mk0, v3 = lg[4 * h + 3] * kScale + mk1;
    float ma = fmaxf(v0, v1), mb = fmaxf(v2, v3);
    ma = fmaxf(ma, __shfl_xor_sync(kFullMask, ma, 1));
    ma = fmaxf(ma, __shfl_xor_sync(kFullMask, ma, 2));
    mb = fmaxf(mb, __shfl_xor_sync(kFullMask, mb, 1));
    mb = fmaxf(mb, __shfl_xor_sync(kFullMask, mb, 2));
    v0 = __expf(v0 - ma);
    v1 = __expf(v1 - ma);
    v2 = __expf(v2 - mb);
    v3 = __expf(v3 - mb);
    float sa = v0 + v1, sb = v2 + v3;
    sa += __shfl_xor_sync(kFullMask, sa, 1);
    sa += __shfl_xor_sync(kFullMask, sa, 2);
    sb += __shfl_xor_sync(kFullMask, sb, 1);
    sb += __shfl_xor_sync(kFullMask, sb, 2);
    const float ia = 1.f / sa, ib = 1.f / sb;
    pa[h >> 1][(h & 1) * 2] = pack_bf16(v0 * ia, v1 * ia);
    pa[h >> 1][(h & 1) * 2 + 1] = pack_bf16(v2 * ib, v3 * ib);
  }
  // x = attn @ vrow, this warpgroup's 128 channels
  const int c0 = wg * (kC / 2);
  float x[kC / 4];
#pragma unroll
  for (int i = 0; i < kC / 4; ++i) x[i] = 0.f;
  const bf16* vrow = (kSecond ? m.vrow1 : m.vrow0) + core_offset(0, c0 >> 3, kCc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kJ / 16; ++kc)
    wgmma_rs_tb<kC / 2>(x, pa[kc], wgmma_desc(vrow + core_offset(16 * kc, 0, kCc), kRowGroup, 128));
  wgmma_commit();
  // meanwhile: the residual rows
  const bf16* keys0 = static_cast<const bf16*>(p.keys0);
  const bf16* resid = kSecond ? m.keys : m.k0s;
  uint32_t res[kC / 16][2];
#pragma unroll
  for (int i = 0; i < kC / 16; ++i) {
    const int c = c0 + 8 * i + 2 * tig;
    res[i][0] = resid ? ld32(resid + cm256(l0, c)) : ld32(keys0 + q0 * kC + c);
    res[i][1] = resid ? ld32(resid + cm256(l1, c)) : ld32(keys0 + q1 * kC + c);
  }
  wgmma_wait<0>();
  fence_regs(x);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int i = 0; i < kC / 16; ++i) {
    x[4 * i] += bf16_lo(res[i][0]);
    x[4 * i + 1] += bf16_hi(res[i][0]);
    x[4 * i + 2] += bf16_lo(res[i][1]);
    x[4 * i + 3] += bf16_hi(res[i][1]);
    s0 += x[4 * i] + x[4 * i + 1];
    s1 += x[4 * i + 2] + x[4 * i + 3];
  }
  // LayerNorm moments over 256 channels: a quad's 32, then the two halves
  s0 += __shfl_xor_sync(kFullMask, s0, 1);
  s0 += __shfl_xor_sync(kFullMask, s0, 2);
  s1 += __shfl_xor_sync(kFullMask, s1, 1);
  s1 += __shfl_xor_sync(kFullMask, s1, 2);
  if (tig == 0) {
    m.red[wg * kTile + l0] = s0;
    m.red[wg * kTile + l1] = s1;
  }
  __syncthreads();  // also: every read of the key tile above is done
  if (!kSecond && tile0 + kTile < end) {  // the next tile's qimg0 and keys0
    prefetch_qimg(p, m, tile0 + kTile);
    if (m.k0s) prefetch_rows(m.k0s, p.keys0, p.t, tile0 + kTile);
    cp_async_commit();
  }
  const float mu0 = (m.red[l0] + m.red[kTile + l0]) * (1.f / kC);
  const float mu1 = (m.red[l1] + m.red[kTile + l1]) * (1.f / kC);
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int i = 0; i < kC / 16; ++i) {
    x[4 * i] -= mu0;
    x[4 * i + 1] -= mu0;
    x[4 * i + 2] -= mu1;
    x[4 * i + 3] -= mu1;
    v0 += x[4 * i] * x[4 * i] + x[4 * i + 1] * x[4 * i + 1];
    v1 += x[4 * i + 2] * x[4 * i + 2] + x[4 * i + 3] * x[4 * i + 3];
  }
  v0 += __shfl_xor_sync(kFullMask, v0, 1);
  v0 += __shfl_xor_sync(kFullMask, v0, 2);
  v1 += __shfl_xor_sync(kFullMask, v1, 1);
  v1 += __shfl_xor_sync(kFullMask, v1, 2);
  if (tig == 0) {
    m.red[(2 + wg) * kTile + l0] = v0;
    m.red[(2 + wg) * kTile + l1] = v1;
  }
  if (kSecond) cp_async_wait<0>();  // pe, once more
  __syncthreads();  // also: every product that read the (keys + pe) tile is done
  const float rs0 = rsqrtf((m.red[2 * kTile + l0] + m.red[3 * kTile + l0]) * (1.f / kC) + kEps);
  const float rs1 = rsqrtf((m.red[2 * kTile + l1] + m.red[3 * kTile + l1]) * (1.f / kC) + kEps);
  const float* lnw = kSecond ? m.ln1w : m.ln0w;
  const float* lnb = kSecond ? m.ln1b : m.ln0b;
#pragma unroll
  for (int i = 0; i < kC / 16; ++i) {
    const int c = c0 + 8 * i + 2 * tig;
    const float w0 = lnw[c], w1 = lnw[c + 1], bb0 = lnb[c], bb1 = lnb[c + 1];
    const uint32_t y0 = pack_bf16(x[4 * i] * rs0 * w0 + bb0, x[4 * i + 1] * rs0 * w1 + bb1);
    const uint32_t y1 = pack_bf16(x[4 * i + 2] * rs1 * w0 + bb0, x[4 * i + 3] * rs1 * w1 + bb1);
    uint32_t* kp0 = reinterpret_cast<uint32_t*>(m.kp + cm256(l0, c));
    uint32_t* kp1 = reinterpret_cast<uint32_t*>(m.kp + cm256(l1, c));
    const uint32_t pe0 = *kp0, pe1 = *kp1;
    *reinterpret_cast<uint32_t*>(m.keys + cm256(l0, c)) = y0;
    *reinterpret_cast<uint32_t*>(m.keys + cm256(l1, c)) = y1;
    *kp0 = pack_bf16(bf16_lo(y0) + bf16_lo(pe0), bf16_hi(y0) + bf16_hi(pe0));
    *kp1 = pack_bf16(bf16_lo(y1) + bf16_lo(pe1), bf16_hi(y1) + bf16_hi(pe1));
  }
  fence_proxy_async();
  __syncthreads();
}

// The column fold of one tile: logits (keys + pe) @ E / 4 of the tile's rows
// below `end` (-inf for the others), the running maxima and sums of the 64
// columns, and u = u * alpha + ex^T @ keys (this warpgroup's 128 channels).
// While the logits run, pass B copies the tile's keys2 to device memory, in
// 16-byte rows; once they have read the (keys + pe) tile, the next tile's pe
// is prefetched into it. One barrier of the warpgroup and one of the block.
template <bool kB>
__device__ __forceinline__ void wg_fold(const Params& p, const PassSmem& m, int b, int tile0,
                                        int end, float (&u)[kC / 4], float (&run_max)[8],
                                        float (&run_sum)[8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3, wg = warp >> 2, wl = warp & 3;
  const int l0 = wl * 16 + g, l1 = l0 + 8;
  const bool ok0 = tile0 + l0 < end, ok1 = tile0 + l1 < end;
  float lt[kJ / 4];  // columns 32 wg + 8 i + 2 tig + e
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kC / 16; ++kk)
    wgmma_ss<kJ / 2>(lt, wgmma_desc(m.kp, 128, kRowGroup) + 16 * kk,
                     wgmma_desc(m.et + core_offset(32 * wg, 0, kCc), 128, kRowGroup) + 16 * kk,
                     kk > 0);
  wgmma_commit();
  if (kB) {
    bf16* keys2 = static_cast<bf16*>(p.keys2) + (long long)b * p.t * kC;
#pragma unroll
    for (int k = 0; k < kTile * kCc / 256; ++k) {
      const int i = threadIdx.x + 256 * k, r = i / kCc, ch = i % kCc;
      if (tile0 + r < end)
        *reinterpret_cast<uint4*>(keys2 + (long long)(tile0 + r) * kC + ch * 8) =
            *reinterpret_cast<const uint4*>(m.keys + core_offset(r, ch, kCc));
    }
  }
  wgmma_wait<0>();
  fence_regs(lt);
  // the warp's column maxima over its 16 rows
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      lt[4 * i + e] = ok0 ? lt[4 * i + e] * kScale : -INFINITY;
      lt[4 * i + 2 + e] = ok1 ? lt[4 * i + 2 + e] * kScale : -INFINITY;
      float mx = fmaxf(lt[4 * i + e], lt[4 * i + 2 + e]);
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 16));
      if (g == 0) m.wred[wl * kJ + wg * 32 + 8 * i + 2 * tig + e] = mx;
    }
  }
  named_barrier(1 + wg, 128);
  // new running maxima; ex = exp(logit - maximum), rounded, into ex^T
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = wg * 32 + 8 * i + 2 * tig + e;
      float mx = run_max[2 * i + e];
#pragma unroll
      for (int q = 0; q < 4; ++q) mx = fmaxf(mx, m.wred[q * kJ + j]);
      // the tile's first row is valid, so mx is finite
      const float alpha = __expf(run_max[2 * i + e] - mx);
      run_max[2 * i + e] = mx;
      const float ex0 = __expf(lt[4 * i + e] - mx), ex1 = __expf(lt[4 * i + 2 + e] - mx);
      run_sum[2 * i + e] = run_sum[2 * i + e] * alpha + ex0 + ex1;
      if (wl == 0 && g == 0) m.alphas[j] = alpha;
      m.ext[core_offset(j, l0 >> 3, kTile / 8) + (l0 & 7)] = __float2bfloat16(ex0);
      m.ext[core_offset(j, l1 >> 3, kTile / 8) + (l1 & 7)] = __float2bfloat16(ex1);
    }
  }
  fence_proxy_async();
  __syncthreads();  // ex^T and alphas of all 64 columns; the logits are done
  if (tile0 + kTile < end) {  // the next tile's pe
    prefetch_rows(m.kp, p.pe, p.t, tile0 + kTile);
    cp_async_commit();
  }
  // u = u * alpha + ex^T @ keys: this thread's rows of u are the columns
  // j = 16 wl + g and j + 8
  const float a0 = m.alphas[l0], a1 = m.alphas[l1];
#pragma unroll
  for (int i = 0; i < kC / 16; ++i) {
    u[4 * i] *= a0;
    u[4 * i + 1] *= a0;
    u[4 * i + 2] *= a1;
    u[4 * i + 3] *= a1;
  }
  const bf16* keys = m.keys + core_offset(0, wg * (kC / 2) >> 3, kCc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_ss_tb<kC / 2>(u, wgmma_desc(m.ext, 128, (kTile / 8) * 128) + 16 * kk,
                        wgmma_desc(keys + core_offset(16 * kk, 0, kCc), kRowGroup, 128), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(u);
}

template <bool kB>
__global__ void __launch_bounds__(256, 1) pass_wgmma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PassSmem m(smem, kB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3, wg = warp >> 2, wl = warp & 3;
  const int b = blockIdx.y, split = blockIdx.x;
  stage_rows(m.vrow0, slot<bf16>(p, b, VROW0));
  stage_transposed(m.et, slot<bf16>(p, b, kB ? EF : E1));
  if (kB) {
    stage_rows(m.vrow1, slot<bf16>(p, b, VROW1));
    stage_transposed(m.f1t, slot<bf16>(p, b, F1));
    const float* bq = p.partials + (long long)b * partial_stride(p) +
                      (long long)p.splits * kPart + kNP * kC;
    if (tid < kJ) m.brow[tid] = bq[tid];
  }
  {
    const bf16* kt = static_cast<const bf16*>(p.ktok0) + (long long)b * kNP * kD;
    for (int i = tid; i < kNP * (kD / 8); i += 256) {
      const int r = i / (kD / 8), ch = i % (kD / 8);
      *reinterpret_cast<uint4*>(m.kt0 + r * kLdKt + ch * 8) =
          *reinterpret_cast<const uint4*>(kt + r * kD + ch * 8);
    }
  }
  for (int i = tid; i < kC; i += 256) {
    m.ln0w[i] = vec(p, N40W)[i];
    m.ln0b[i] = vec(p, N40B)[i];
    m.ln1w[i] = vec(p, N41W)[i];
    m.ln1b[i] = vec(p, N41B)[i];
  }
  if (tid < kNP) m.maskb[tid] = p.maskb[tid];
  fence_proxy_async();

  float u[kC / 4];  // rows j = 16 wl + {g, g + 8}, this warpgroup's channels
#pragma unroll
  for (int i = 0; i < kC / 4; ++i) u[i] = 0.f;
  // running maximum and this thread's share of the sum of its 8 columns
  // j = 32 wg + 8 i + 2 tig + e, at [2 i + e]
  float run_max[8], run_sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    run_max[i] = -INFINITY;
    run_sum[i] = 0.f;
  }

  const int begin = split * p.rows_per_split;
  const int end = min(p.t, begin + p.rows_per_split);
  prefetch_qimg(p, m, begin);
  if (m.k0s) prefetch_rows(m.k0s, p.keys0, p.t, begin);
  prefetch_rows(m.kp, p.pe, p.t, begin);
  cp_async_commit();
#pragma unroll 1
  for (int tile0 = begin; tile0 < end; tile0 += kTile) {
    cp_async_wait<0>();  // this tile's prefetched rows
    __syncthreads();     // (everyone's); the previous tile has been read
    wg_rows<false>(p, m, tile0, end);  // keys1
    if (kB) wg_rows<true>(p, m, tile0, end);  // keys2, from keys1
    wg_fold<kB>(p, m, b, tile0, end, u, run_max, run_sum);
  }

  // the block's partial: maxima, sums and the product
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = wg * 32 + 8 * i + 2 * tig + e;
      float s = run_sum[2 * i + e];
      s += __shfl_xor_sync(kFullMask, s, 4);
      s += __shfl_xor_sync(kFullMask, s, 8);
      s += __shfl_xor_sync(kFullMask, s, 16);
      if (g == 0) {
        m.wred[wl * kJ + j] = s;
        if (wl == 0) m.mfin[j] = run_max[2 * i + e];
      }
    }
  }
  __syncthreads();
  float* part = p.partials + (long long)b * partial_stride(p) + (long long)split * kPart;
  if (tid < kJ) {
    part[tid] = m.mfin[tid];
    part[kJ + tid] = m.wred[tid] + m.wred[kJ + tid] + m.wred[2 * kJ + tid] + m.wred[3 * kJ + tid];
  }
  const int j0 = wl * 16 + g;
#pragma unroll
  for (int i = 0; i < kC / 16; ++i) {
    const int c = wg * (kC / 2) + 8 * i + 2 * tig;
    float* o = part + 2 * kJ + j0 * kC + c;
    *reinterpret_cast<float2*>(o) = make_float2(u[4 * i], u[4 * i + 1]);
    *reinterpret_cast<float2*>(o + 8 * kC) = make_float2(u[4 * i + 2], u[4 * i + 3]);
  }
}

// ---------------------------------------------------------------- launches

// Queues the chain's kernels and counts in `*queued` those that were queued,
// so that the caller can tell a refusal before any work from a failure
// part-way, and can report how many launches one call is.
template <typename T>
cudaError_t run_chain(const Params& p, cudaStream_t s, int* queued) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const dim3 per_prompt(p.batch);
  const dim3 pass_grid(p.splits, p.batch);
  const auto count = [queued](cudaError_t e) {
    if (e == cudaSuccess) ++*queued;
    return e;
  };
  cudaError_t err = count(launch<prep_kernel<T>>(per_prompt, kTokThreads, kTokSmemBytes, s, p));
  if (err != cudaSuccess) return err;
  for (int second = 0; second < 2; ++second) {
    if constexpr (kBf16) {
      err = count(second ? launch<pass_wgmma_kernel<true>>(pass_grid, 256, PassSmem::bytes(true),
                                                           s, p)
                         : launch<pass_wgmma_kernel<false>>(pass_grid, 256,
                                                            PassSmem::bytes(false), s, p));
    } else {
      err = count(second ? launch<pass_simt_kernel<true>>(pass_grid, 256,
                                                          simt_pass_smem_bytes(true), s, p)
                         : launch<pass_simt_kernel<false>>(pass_grid, 256,
                                                           simt_pass_smem_bytes(false), s, p));
    }
    if (err != cudaSuccess) return err;
    err = count(second ? launch<final_kernel<T>>(per_prompt, kTokThreads, kTokSmemBytes, s, p)
                       : launch<mid_kernel<T>>(per_prompt, kTokThreads, kTokSmemBytes, s, p));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The operands of one call, all contiguous and 16-byte aligned, in float32
// (is_bf16 = 0) or bfloat16 (1): ktok0 and vtok0 (B, 8, 128), q1 and qpe
// (B, 8, 256), keys0 and pe (T, 256), qimg0 (T, 128); maskb (8) float32;
// `weights` a table of 40 device pointers in the wrapper's WKEYS order,
// matrices (in, out) in the compute type, except that in bfloat16 the
// twelve that are B operands of the token kernels' products (the wrapper's
// TRANSPOSED) are (out, in); vectors float32. keys2 (B, T, 256)
// and qout (B, 8, 256) are the results; `scratch` holds (B, 5, 16384) values
// of the compute type and `partials` (B, splits * 16512 + 2112) float32.
// The passes give each of `splits` blocks per prompt `rows_per_split` rows
// (a multiple of 64; every block has a row). Queues the chain's five
// kernels on `stream` and writes to `*queued` how many it queued (0 when it
// refused the sizes or B or T is 0, fewer than five when a later launch
// failed). Returns a cudaError_t: cudaErrorInvalidValue for sizes the
// kernels are not built for.
int two_way_launch(const void* ktok0, const void* vtok0, const void* q1,
                   const void* qpe, const void* keys0, const void* pe,
                   const void* qimg0, const float* maskb, const void* const* weights,
                   void* keys2, void* qout, void* scratch, float* partials,
                   int batch, int t, int mlp, int rows_per_split, int splits,
                   int is_bf16, void* stream, int* queued) {
  *queued = 0;
  if (batch <= 0 || t <= 0) return cudaSuccess;
  const bool mlp_ok = mlp == 256 || mlp == 512 || mlp == 1024 || mlp == 2048;
  if (!mlp_ok || batch > 65535 || splits < 1 || splits > 255 ||
      rows_per_split % kTile || (long long)(splits - 1) * rows_per_split >= t ||
      (long long)splits * rows_per_split < t)
    return cudaErrorInvalidValue;
  Params p;
  p.ktok0 = ktok0;
  p.vtok0 = vtok0;
  p.q1 = q1;
  p.qpe = qpe;
  p.keys0 = keys0;
  p.pe = pe;
  p.qimg0 = qimg0;
  p.maskb = maskb;
  for (int i = 0; i < kWeights; ++i) p.w[i] = weights[i];
  p.keys2 = keys2;
  p.qout = qout;
  p.scratch = scratch;
  p.partials = partials;
  p.batch = batch;
  p.t = t;
  p.mlp = mlp;
  p.rows_per_split = rows_per_split;
  p.splits = splits;
  const cudaStream_t s = (cudaStream_t)stream;
  return is_bf16 ? run_chain<__nv_bfloat16>(p, s, queued) : run_chain<float>(p, s, queued);
}

const char* two_way_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
