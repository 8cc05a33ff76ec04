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
// row-local work with reductions over all T rows, so one call is seven
// launches on one stream:
//   1. prep    per prompt: vrow0, E1                      (token kernel)
//   2. rows 0  per 64 rows: keys1 -> device memory
//   3. cols    per block of tiles: partial column softmax and ex^T @ keys1
//   4. mid     per prompt: merge the partials; token work; F1, browi, vrow1, Ef
//   5. rows 1  per 64 rows: keys2 -> device memory
//   6. cols    as 3, over keys2 with Ef
//   7. final   per prompt: merge; queries_out
// keys1 is stored and read back (by 3 and 5) rather than recomputed.
//
// What bounds it on an H100: about 1 GFLOP per prompt against one 2 MB write
// of keys2, so the tensor cores bound it (0.065 ms at 64 prompts); this
// version also moves keys1 once out and twice in and keys2 once more in,
// ~5 x 134 MB at 64 prompts, 0.2 ms of device memory time. Kernels:
//  * bfloat16: `rows_mma_kernel` and `cols_mma_kernel` on `mma.sync.m16n8k16`.
//    A warp owns 16 rows; the logits' accumulators are re-packed in registers
//    as the A fragments of the product with the value rows, and the 16 x 256
//    result is normalised in registers. The column pass keeps a (64, 256)
//    float32 product per block in registers (64 per thread), rescaled when a
//    column's running maximum moves.
//  * float32: `rows_simt_kernel` and `cols_simt_kernel` on the ordinary
//    float32 units (the tensor cores take float32 only as TF32).
//  * the three token kernels run on the ordinary units in both types: their
//    products have 8 rows.

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
  const void* w[kWeights];  // matrices (in, out) in the compute type; vectors float32
  void* keys1;         // (B, T, 256) scratch
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

// ys = xs (8, K) @ W (K, N): `epi(row, n, sum)` gets each float32 sum. The
// threads split N, and K as well when N is below the block's size; partial
// sums meet in `part`. Ends with a barrier.
template <typename T, typename Epi>
__device__ void matvec8(const float* xs, const T* w, int k_dim, int n_dim,
                        float* part, Epi epi) {
  const int tid = threadIdx.x;
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

// E[c][j] = sum over head h's 16 channels of W[c][h * 16 + d] * tok[d][n],
// j = h * 8 + n: the (C, D) projection folded with the block-diagonal
// embedding of the 8 tokens' (D) vectors. tok is [d][8] in shared memory.
template <typename T>
__device__ void fold_projection(const T* w, const float* tok, T* out) {
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
// + b_o[c] / H: the value rows with the out-projection folded in.
template <typename T>
__device__ void fold_values(const T* wo, const float* bo, const float* tok, T* out) {
  for (int i = threadIdx.x; i < kJ * kC; i += kTokThreads) {
    const int c = i % kC, j = i / kC, h = j / kNP, n = j % kNP;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < kHd; ++d)
      s = fmaf(tok[(h * kHd + d) * kNP + n], ldf(wo + (h * kHd + d) * kC + c), s);
    stf(out + i, s + bo[c] * (1.f / kH));
  }
}

// Merge the column passes' partials of prompt b into u = softmax_T(..)^T @
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
  for (int i = tid; i < kSlot; i += kTokThreads) {
    const int j = i / kC;
    float v = 0.f;
    for (int s = 0; s < p.splits; ++s)
      v = fmaf(wgt[s * kJ + j], base[(long long)s * kPart + 2 * kJ + i], v);
    us[i] = rnd<T>(v * inv[j]);
  }
  __syncthreads();
  {
    const int j = tid / kHd, d = tid % kHd, h = j / kNP, n = j % kNP;
    const T* w = weight<T>(p, wv) + h * kHd + d;
    float s = 0.f;
#pragma unroll 8
    for (int c = 0; c < kC; ++c) s = fmaf(us[j * kC + c], ldf(w + c * kD), s);
    mg[(h * kHd + d) * kNP + n] = rnd<T>(rnd<T>(s) + vec(p, bv)[h * kHd + d]);
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

// ------------------------------------------- row and column passes, float32
//
// `rows_simt_kernel<T, kSecond>`: 8 warps; a warp takes 4 rows at a time,
// lane l the columns j = l and l + 32 of the logits and the channels
// c = l + 32 i of the result. kSecond = false is layer 0's update (logits
// from qimg0 and the prompt's k tokens), true is layer 1's (logits from
// keys1 + pe through F1).

constexpr int kSimtRowsPerBlock = 256;
constexpr int kSimtWarpRows = 4;

template <bool kSecond>
constexpr size_t rows_simt_smem_bytes() {
  return sizeof(float) * (size_t)(kSlot + (kSecond ? kSlot + kJ : kNP * kD) + 2 * kC +
                                  8 * kSimtWarpRows * (kJ + (kSecond ? kC : 0)));
}

template <typename T, bool kSecond>
__global__ void __launch_bounds__(256, 1) rows_simt_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* vrow = reinterpret_cast<float*>(smem);        // [64][256]
  float* fs = vrow + kSlot;                            // [256][64] or ktok0 [8][128]
  float* brow = fs + (kSecond ? kSlot : kNP * kD);     // [64] (second pass)
  float* lnw = brow + (kSecond ? kJ : 0);
  float* lnb = lnw + kC;
  float* attn_all = lnb + kC;                          // per warp [4][64]
  float* kpe_all = attn_all + 8 * kSimtWarpRows * kJ;  // per warp [4][256] (second)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const T* vsrc = slot<T>(p, b, kSecond ? VROW1 : VROW0);
  for (int i = tid; i < kSlot; i += 256) vrow[i] = ldf(vsrc + i);
  if (kSecond) {
    const T* f = slot<T>(p, b, F1);
    for (int i = tid; i < kSlot; i += 256) fs[i] = ldf(f + i);
    const float* bq = p.partials + (long long)b * partial_stride(p) +
                      (long long)p.splits * kPart + kNP * kC;
    if (tid < kJ) brow[tid] = bq[tid];
  } else {
    const T* kt = static_cast<const T*>(p.ktok0) + (long long)b * kNP * kD;
    for (int i = tid; i < kNP * kD; i += 256) fs[i] = ldf(kt + i);
  }
  const float* gw = vec(p, kSecond ? N41W : N40W);
  const float* gb = vec(p, kSecond ? N41B : N40B);
  for (int i = tid; i < kC; i += 256) {
    lnw[i] = gw[i];
    lnb[i] = gb[i];
  }
  __syncthreads();

  float* attn = attn_all + warp * kSimtWarpRows * kJ;
  float* kpe = kpe_all + warp * kSimtWarpRows * kC;
  const T* kin = kSecond ? static_cast<const T*>(p.keys1) + (long long)b * p.t * kC
                         : static_cast<const T*>(p.keys0);
  T* kout = static_cast<T*>(kSecond ? p.keys2 : p.keys1) + (long long)b * p.t * kC;
  const T* pe = static_cast<const T*>(p.pe);
  const T* qimg = static_cast<const T*>(p.qimg0);
  const float mask0 = p.maskb[lane % kNP];  // columns l and l + 32 are one token

  const int block_row0 = blockIdx.x * kSimtRowsPerBlock;
  for (int it = 0; it < kSimtRowsPerBlock / (8 * kSimtWarpRows); ++it) {
    const int row0 = block_row0 + (it * 8 + warp) * kSimtWarpRows;
    if (row0 >= p.t) break;  // the same for the whole warp; no block barrier below
    float lg[kSimtWarpRows][2];
    if (kSecond) {
#pragma unroll
      for (int r = 0; r < kSimtWarpRows; ++r) {
        const int row = min(row0 + r, p.t - 1);
#pragma unroll
        for (int i = 0; i < kC / 32; ++i) {
          const int c = lane + 32 * i;
          kpe[r * kC + c] = rnd<T>(ldf(kin + (long long)row * kC + c) +
                                   ldf(pe + (long long)row * kC + c));
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
#pragma unroll
      for (int r = 0; r < kSimtWarpRows; ++r) {
        const int row = min(row0 + r, p.t - 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = lane + 32 * half, h = j / kNP, n = j % kNP;
          float s = 0.f;
#pragma unroll
          for (int d = 0; d < kHd; ++d)
            s = fmaf(ldf(qimg + (long long)row * kD + h * kHd + d),
                     fs[n * kD + h * kHd + d], s);
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
        for (int off = 1; off < kNP; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
        const float e = expf(l - mx);
        float sum = e;
#pragma unroll
        for (int off = 1; off < kNP; off <<= 1) sum += __shfl_xor_sync(kFullMask, sum, off);
        attn[r * kJ + lane + 32 * half] = rnd<T>(e / sum);
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
#pragma unroll
    for (int r = 0; r < kSimtWarpRows; ++r) {
      const int row = row0 + r;
      if (row >= p.t) break;  // uniform across the warp
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kC / 32; ++i) {
        x[r][i] += ldf(kin + (long long)row * kC + lane + 32 * i);
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
        stf(kout + (long long)row * kC + c, x[r][i] * rs * lnw[c] + lnb[c]);
      }
    }
    __syncwarp();  // attn and kpe are rewritten in the next round
  }
}

// `cols_simt_kernel<T>`: per (prompt, split), tiles of 32 rows. Thread c owns
// channel c of all 64 rows of the product ex^T @ keys (64 registers); threads
// 0..63 own the running maximum and sum of column j.

constexpr int kSimtColTile = 32;
constexpr size_t kColsSimtSmemBytes =
    sizeof(float) * (size_t)(kSlot + 8 * kSimtWarpRows * kC + kSimtColTile * kJ + kJ);

template <typename T>
__global__ void __launch_bounds__(256, 1) cols_simt_kernel(const Params p, int second) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* es = reinterpret_cast<float*>(smem);          // [256][64]
  float* kpe_all = es + kSlot;                         // per warp [4][256]
  float* ls = kpe_all + 8 * kSimtWarpRows * kC;        // [32][64] logits, then ex
  float* alphas = ls + kSimtColTile * kJ;              // [64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, split = blockIdx.x;
  const T* e = slot<T>(p, b, second ? EF : E1);
  for (int i = tid; i < kSlot; i += 256) es[i] = ldf(e + i);
  const T* keys = static_cast<const T*>(second ? p.keys2 : p.keys1) + (long long)b * p.t * kC;
  const T* pe = static_cast<const T*>(p.pe);
  float* kpe = kpe_all + warp * kSimtWarpRows * kC;

  float u[kJ];
#pragma unroll
  for (int j = 0; j < kJ; ++j) u[j] = 0.f;
  float run_max = -INFINITY, run_sum = 0.f;  // of column tid, threads 0..63

  const int begin = split * p.rows_per_split;
  const int end = min(p.t, begin + p.rows_per_split);
  for (int tile0 = begin; tile0 < end; tile0 += kSimtColTile) {
    __syncthreads();  // the previous tile has been read (and es is written)
    {
      const int row0 = tile0 + warp * kSimtWarpRows;
#pragma unroll
      for (int r = 0; r < kSimtWarpRows; ++r) {
        const int row = min(row0 + r, p.t - 1);
#pragma unroll
        for (int i = 0; i < kC / 32; ++i) {
          const int c = lane + 32 * i;
          kpe[r * kC + c] = rnd<T>(ldf(keys + (long long)row * kC + c) +
                                   ldf(pe + (long long)row * kC + c));
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
        float* l = ls + (warp * kSimtWarpRows + r) * kJ;
        l[lane] = valid ? lg[r][0] * kScale : -INFINITY;
        l[lane + 32] = valid ? lg[r][1] * kScale : -INFINITY;
      }
    }
    __syncthreads();
    if (tid < kJ) {
      float mx = run_max;
      for (int r = 0; r < kSimtColTile; ++r) mx = fmaxf(mx, ls[r * kJ + tid]);
      const float alpha = expf(run_max - mx);  // the tile's first row is valid
      float sum = 0.f;
      for (int r = 0; r < kSimtColTile; ++r) {
        const float ex = expf(ls[r * kJ + tid] - mx);
        sum += ex;
        ls[r * kJ + tid] = rnd<T>(ex);
      }
      run_sum = run_sum * alpha + sum;
      run_max = mx;
      alphas[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kJ; ++j) u[j] *= alphas[j];
    for (int r = 0; r < kSimtColTile; ++r) {
      if (tile0 + r >= end) break;
      const float kv = ldf(keys + (long long)(tile0 + r) * kC + tid);
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

// ------------------------------------------ row and column passes, bfloat16

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// bf16 pair (a + b), each sum rounded
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  return pack_bf16(bf16_lo(a) + bf16_lo(b), bf16_hi(a) + bf16_hi(b));
}

constexpr int kLdV = kC + 8;    // value rows [64][kLdV]; key tiles [rows][kLdV]
constexpr int kLdE = kJ + 8;    // folded projections [256][kLdE]; ex tiles
constexpr int kLdKt = kD + 8;   // layer 0's k tokens [8][kLdKt]
constexpr int kMmaRowsPerBlock = 256;

template <bool kSecond>
constexpr size_t rows_mma_smem_bytes() {
  return sizeof(bf16) * (size_t)(kJ * kLdV + (kSecond ? kC * kLdE : kNP * kLdKt)) +
         sizeof(float) * (size_t)(2 * kC + kJ + kNP);
}

// 4 warps of 16 rows; the block walks over tiles of 64 rows.
template <bool kSecond>
__global__ void __launch_bounds__(128, 2) rows_mma_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* vrow = reinterpret_cast<bf16*>(smem);              // [64][kLdV]
  bf16* fs = vrow + kJ * kLdV;                             // F1 [256][kLdE] or ktok0 [8][kLdKt]
  float* lnw = reinterpret_cast<float*>(fs + (kSecond ? kC * kLdE : kNP * kLdKt));
  float* lnb = lnw + kC;
  float* brow = lnb + kC;                                  // [64]
  float* maskb = brow + kJ;                                // [8]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int lrow = lane & 7, lmat = (lane >> 3) & 1;
  const int b = blockIdx.y;
  {
    const bf16* v = slot<bf16>(p, b, kSecond ? VROW1 : VROW0);
    for (int i = tid; i < kJ * (kC / 8); i += 128) {
      const int r = i / (kC / 8), ch = i % (kC / 8);
      *reinterpret_cast<uint4*>(vrow + r * kLdV + ch * 8) =
          *reinterpret_cast<const uint4*>(v + r * kC + ch * 8);
    }
    if (kSecond) {
      const bf16* f = slot<bf16>(p, b, F1);
      for (int i = tid; i < kC * (kJ / 8); i += 128) {
        const int r = i / (kJ / 8), ch = i % (kJ / 8);
        *reinterpret_cast<uint4*>(fs + r * kLdE + ch * 8) =
            *reinterpret_cast<const uint4*>(f + r * kJ + ch * 8);
      }
      const float* bq = p.partials + (long long)b * partial_stride(p) +
                        (long long)p.splits * kPart + kNP * kC;
      if (tid < kJ) brow[tid] = bq[tid];
    } else {
      const bf16* kt = static_cast<const bf16*>(p.ktok0) + (long long)b * kNP * kD;
      for (int i = tid; i < kNP * (kD / 8); i += 128) {
        const int r = i / (kD / 8), ch = i % (kD / 8);
        *reinterpret_cast<uint4*>(fs + r * kLdKt + ch * 8) =
            *reinterpret_cast<const uint4*>(kt + r * kD + ch * 8);
      }
    }
    const float* gw = vec(p, kSecond ? N41W : N40W);
    const float* gb = vec(p, kSecond ? N41B : N40B);
    for (int i = tid; i < kC; i += 128) {
      lnw[i] = gw[i];
      lnb[i] = gb[i];
    }
    if (tid < kNP) maskb[tid] = p.maskb[tid];
  }
  __syncthreads();

  const bf16* kin = kSecond ? static_cast<const bf16*>(p.keys1) + (long long)b * p.t * kC
                            : static_cast<const bf16*>(p.keys0);
  bf16* kout = static_cast<bf16*>(kSecond ? p.keys2 : p.keys1) + (long long)b * p.t * kC;
  const bf16* pe = static_cast<const bf16*>(p.pe);
  const bf16* qimg = static_cast<const bf16*>(p.qimg0);
  const float mk0 = maskb[2 * tig], mk1 = maskb[2 * tig + 1];

  const int block_row0 = blockIdx.x * kMmaRowsPerBlock;
#pragma unroll 1
  for (int tile = 0; tile < kMmaRowsPerBlock / 64; ++tile) {
    const int r0 = block_row0 + tile * 64 + warp * 16 + g, r1 = r0 + 8;
    if (block_row0 + tile * 64 + warp * 16 >= p.t) break;  // per warp; no barrier below
    // rows past T are computed on row T - 1 and not stored
    const long long q0 = min(r0, p.t - 1), q1 = min(r1, p.t - 1);

    // logits (16 rows x 64 columns): n-tile h holds head h's 8 tokens
    float lg[kH][4];
#pragma unroll
    for (int h = 0; h < kH; ++h) lg[h][0] = lg[h][1] = lg[h][2] = lg[h][3] = 0.f;
    if (kSecond) {
#pragma unroll 2
      for (int kk = 0; kk < kC / 16; ++kk) {
        const int c = kk * 16 + 2 * tig;
        uint32_t a[4];
        a[0] = add_bf16x2(*reinterpret_cast<const uint32_t*>(kin + q0 * kC + c),
                          *reinterpret_cast<const uint32_t*>(pe + q0 * kC + c));
        a[1] = add_bf16x2(*reinterpret_cast<const uint32_t*>(kin + q1 * kC + c),
                          *reinterpret_cast<const uint32_t*>(pe + q1 * kC + c));
        a[2] = add_bf16x2(*reinterpret_cast<const uint32_t*>(kin + q0 * kC + c + 8),
                          *reinterpret_cast<const uint32_t*>(pe + q0 * kC + c + 8));
        a[3] = add_bf16x2(*reinterpret_cast<const uint32_t*>(kin + q1 * kC + c + 8),
                          *reinterpret_cast<const uint32_t*>(pe + q1 * kC + c + 8));
#pragma unroll
        for (int h = 0; h < kH; ++h) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, fs + (kk * 16 + lmat * 8 + lrow) * kLdE + h * 8);
          mma_bf16(lg[h], a, b0, b1);
        }
      }
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const float bq0 = brow[h * 8 + 2 * tig], bq1 = brow[h * 8 + 2 * tig + 1];
        lg[h][0] += bq0;
        lg[h][1] += bq1;
        lg[h][2] += bq0;
        lg[h][3] += bq1;
      }
    } else {
#pragma unroll
      for (int h = 0; h < kH; ++h) {
        const int c = h * kHd + 2 * tig;
        uint32_t a[4];
        a[0] = *reinterpret_cast<const uint32_t*>(qimg + q0 * kD + c);
        a[1] = *reinterpret_cast<const uint32_t*>(qimg + q1 * kD + c);
        a[2] = *reinterpret_cast<const uint32_t*>(qimg + q0 * kD + c + 8);
        a[3] = *reinterpret_cast<const uint32_t*>(qimg + q1 * kD + c + 8);
        // B[k = channel][n = token] = ktok0[token][channel]: pairs along k
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(fs + g * kLdKt + c);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(fs + g * kLdKt + c + 8);
        mma_bf16(lg[h], a, b0, b1);
      }
    }
    // softmax over each head's 8 tokens: the 4 threads of a quad hold 2 each
    uint32_t pa[kH / 2][4];
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      float l0 = lg[h][0] * kScale + mk0, l1 = lg[h][1] * kScale + mk1;
      float l2 = lg[h][2] * kScale + mk0, l3 = lg[h][3] * kScale + mk1;
      float ma = fmaxf(l0, l1), mb = fmaxf(l2, l3);
      ma = fmaxf(ma, __shfl_xor_sync(kFullMask, ma, 1));
      ma = fmaxf(ma, __shfl_xor_sync(kFullMask, ma, 2));
      mb = fmaxf(mb, __shfl_xor_sync(kFullMask, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(kFullMask, mb, 2));
      l0 = __expf(l0 - ma);
      l1 = __expf(l1 - ma);
      l2 = __expf(l2 - mb);
      l3 = __expf(l3 - mb);
      float sa = l0 + l1, sb = l2 + l3;
      sa += __shfl_xor_sync(kFullMask, sa, 1);
      sa += __shfl_xor_sync(kFullMask, sa, 2);
      sb += __shfl_xor_sync(kFullMask, sb, 1);
      sb += __shfl_xor_sync(kFullMask, sb, 2);
      const float ia = 1.f / sa, ib = 1.f / sb;
      // heads 2k and 2k + 1 are k-step k of the product with the value rows
      pa[h >> 1][(h & 1) * 2] = pack_bf16(l0 * ia, l1 * ia);
      pa[h >> 1][(h & 1) * 2 + 1] = pack_bf16(l2 * ib, l3 * ib);
    }
    // x = attn @ vrow (16 x 256), + keys_in
    float x[kC / 8][4];
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt) x[nt][0] = x[nt][1] = x[nt][2] = x[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kJ / 16; ++kc) {
#pragma unroll
      for (int nt = 0; nt < kC / 8; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vrow + (kc * 16 + lmat * 8 + lrow) * kLdV + nt * 8);
        mma_bf16(x[nt], pa[kc], b0, b1);
      }
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const uint32_t k0 = *reinterpret_cast<const uint32_t*>(kin + q0 * kC + c);
      const uint32_t k1 = *reinterpret_cast<const uint32_t*>(kin + q1 * kC + c);
      x[nt][0] += bf16_lo(k0);
      x[nt][1] += bf16_hi(k0);
      x[nt][2] += bf16_lo(k1);
      x[nt][3] += bf16_hi(k1);
      s0 += x[nt][0] + x[nt][1];
      s1 += x[nt][2] + x[nt][3];
    }
    s0 += __shfl_xor_sync(kFullMask, s0, 1);
    s0 += __shfl_xor_sync(kFullMask, s0, 2);
    s1 += __shfl_xor_sync(kFullMask, s1, 1);
    s1 += __shfl_xor_sync(kFullMask, s1, 2);
    const float mu0 = s0 * (1.f / kC), mu1 = s1 * (1.f / kC);
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt) {
      x[nt][0] -= mu0;
      x[nt][1] -= mu0;
      x[nt][2] -= mu1;
      x[nt][3] -= mu1;
      v0 += x[nt][0] * x[nt][0] + x[nt][1] * x[nt][1];
      v1 += x[nt][2] * x[nt][2] + x[nt][3] * x[nt][3];
    }
    v0 += __shfl_xor_sync(kFullMask, v0, 1);
    v0 += __shfl_xor_sync(kFullMask, v0, 2);
    v1 += __shfl_xor_sync(kFullMask, v1, 1);
    v1 += __shfl_xor_sync(kFullMask, v1, 2);
    const float rs0 = rsqrtf(v0 * (1.f / kC) + kEps), rs1 = rsqrtf(v1 * (1.f / kC) + kEps);
#pragma unroll
    for (int nt = 0; nt < kC / 8; ++nt) {
      const int c = nt * 8 + 2 * tig;
      const float w0 = lnw[c], w1 = lnw[c + 1], bb0 = lnb[c], bb1 = lnb[c + 1];
      if (r0 < p.t)
        *reinterpret_cast<uint32_t*>(kout + (long long)r0 * kC + c) =
            pack_bf16(x[nt][0] * rs0 * w0 + bb0, x[nt][1] * rs0 * w1 + bb1);
      if (r1 < p.t)
        *reinterpret_cast<uint32_t*>(kout + (long long)r1 * kC + c) =
            pack_bf16(x[nt][2] * rs1 * w0 + bb0, x[nt][3] * rs1 * w1 + bb1);
    }
  }
}

// 8 warps; tiles of 128 rows. Warp w owns 16 rows of the logits and, of the
// (64, 256) product ex^T @ keys, the channels w * 32 .. w * 32 + 31.
constexpr int kColTile = 128;
constexpr size_t kColsMmaSmemBytes =
    sizeof(bf16) * (size_t)(kC * kLdE + kColTile * kLdV + kColTile * kLdE) +
    sizeof(float) * (size_t)(8 * kJ + 2 * kJ);

__global__ void __launch_bounds__(256, 1) cols_mma_kernel(const Params p, int second) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* es = reinterpret_cast<bf16*>(smem);                // [256][kLdE]
  bf16* ks = es + kC * kLdE;                               // [128][kLdV]
  bf16* exs = ks + kColTile * kLdV;                        // [128][kLdE]
  float* wred = reinterpret_cast<float*>(exs + kColTile * kLdE);  // [8][64]
  float* alphas = wred + 8 * kJ;                           // [64]
  float* mfin = alphas + kJ;                               // [64]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int lrow = lane & 7, lmat = (lane >> 3) & 1;
  const int b = blockIdx.y, split = blockIdx.x;
  {
    const bf16* e = slot<bf16>(p, b, second ? EF : E1);
    for (int i = tid; i < kC * (kJ / 8); i += 256) {
      const int r = i / (kJ / 8), ch = i % (kJ / 8);
      *reinterpret_cast<uint4*>(es + r * kLdE + ch * 8) =
          *reinterpret_cast<const uint4*>(e + r * kJ + ch * 8);
    }
  }
  const bf16* keys = static_cast<const bf16*>(second ? p.keys2 : p.keys1) +
                     (long long)b * p.t * kC;
  const bf16* pe = static_cast<const bf16*>(p.pe);

  float u[4][4][4];  // [m-tile of 16 columns j][n-tile of 8 channels][4]
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) u[mt][nt][0] = u[mt][nt][1] = u[mt][nt][2] = u[mt][nt][3] = 0.f;
  // running maximum and this thread's share of the sum, of its 16 columns
  // j = nt * 8 + 2 * tig + e
  float run_max[8][2], run_sum[8][2];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    run_max[nt][0] = run_max[nt][1] = -INFINITY;
    run_sum[nt][0] = run_sum[nt][1] = 0.f;
  }

  const int begin = split * p.rows_per_split;
  const int end = min(p.t, begin + p.rows_per_split);
#pragma unroll 1
  for (int tile0 = begin; tile0 < end; tile0 += kColTile) {
    __syncthreads();  // the previous tile has been read (and es is written)
    for (int i = tid; i < kColTile * (kC / 8); i += 256) {
      const int r = i / (kC / 8), ch = i % (kC / 8);
      uint4 t = make_uint4(0u, 0u, 0u, 0u);
      if (tile0 + r < end)
        t = *reinterpret_cast<const uint4*>(keys + (long long)(tile0 + r) * kC + ch * 8);
      *reinterpret_cast<uint4*>(ks + r * kLdV + ch * 8) = t;
    }
    __syncthreads();

    // logits of this warp's 16 rows: (keys + pe) @ E
    const int lr0 = warp * 16 + g, lr1 = lr0 + 8;      // rows within the tile
    const bool ok0 = tile0 + lr0 < end, ok1 = tile0 + lr1 < end;
    const long long p0 = min(tile0 + lr0, p.t - 1), p1 = min(tile0 + lr1, p.t - 1);
    float lt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) lt[nt][0] = lt[nt][1] = lt[nt][2] = lt[nt][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kC / 16; ++kk) {
      const int c = kk * 16 + 2 * tig;
      uint32_t a[4];
      a[0] = add_bf16x2(*reinterpret_cast<const uint32_t*>(ks + lr0 * kLdV + c),
                        *reinterpret_cast<const uint32_t*>(pe + p0 * kC + c));
      a[1] = add_bf16x2(*reinterpret_cast<const uint32_t*>(ks + lr1 * kLdV + c),
                        *reinterpret_cast<const uint32_t*>(pe + p1 * kC + c));
      a[2] = add_bf16x2(*reinterpret_cast<const uint32_t*>(ks + lr0 * kLdV + c + 8),
                        *reinterpret_cast<const uint32_t*>(pe + p0 * kC + c + 8));
      a[3] = add_bf16x2(*reinterpret_cast<const uint32_t*>(ks + lr1 * kLdV + c + 8),
                        *reinterpret_cast<const uint32_t*>(pe + p1 * kC + c + 8));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, es + (kk * 16 + lmat * 8 + lrow) * kLdE + nt * 8);
        mma_bf16(lt[nt], a, b0, b1);
      }
    }
    // the warp's column maxima
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        lt[nt][e] = ok0 ? lt[nt][e] * kScale : -INFINITY;
        lt[nt][2 + e] = ok1 ? lt[nt][2 + e] * kScale : -INFINITY;
        float mx = fmaxf(lt[nt][e], lt[nt][2 + e]);
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 16));
        if (g == 0) wred[warp * kJ + nt * 8 + 2 * tig + e] = mx;
      }
    }
    __syncthreads();
    // new running maxima; ex = exp(logit - maximum) to shared memory
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float ex[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * tig + e;
        float mx = run_max[nt][e];
#pragma unroll
        for (int w = 0; w < 8; ++w) mx = fmaxf(mx, wred[w * kJ + j]);
        // the tile's first row is valid, so mx is finite
        const float alpha = __expf(run_max[nt][e] - mx);
        run_max[nt][e] = mx;
        ex[e] = __expf(lt[nt][e] - mx);
        ex[2 + e] = __expf(lt[nt][2 + e] - mx);
        run_sum[nt][e] = run_sum[nt][e] * alpha + ex[e] + ex[2 + e];
        if (warp == 0 && g == 0) alphas[j] = alpha;
      }
      const int j0 = nt * 8 + 2 * tig;
      *reinterpret_cast<uint32_t*>(exs + lr0 * kLdE + j0) = pack_bf16(ex[0], ex[1]);
      *reinterpret_cast<uint32_t*>(exs + lr1 * kLdE + j0) = pack_bf16(ex[2], ex[3]);
    }
    __syncthreads();
    // u = u * alpha + ex^T @ keys, this warp's 32 channels
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      const float a0 = alphas[mt * 16 + g], a1 = alphas[mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        u[mt][nt][0] *= a0;
        u[mt][nt][1] *= a0;
        u[mt][nt][2] *= a1;
        u[mt][nt][3] *= a1;
      }
    }
#pragma unroll 2
    for (int kr = 0; kr < kColTile / 16; ++kr) {
      uint32_t bfrag[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        ldmatrix_x2_trans(bfrag[nt][0], bfrag[nt][1],
                          ks + (kr * 16 + lmat * 8 + lrow) * kLdV + warp * 32 + nt * 8);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4];
        const int mi = lane >> 3;  // matrix this lane addresses
        ldmatrix_x4_trans(a, exs + (kr * 16 + (mi >> 1) * 8 + lrow) * kLdE + mt * 16 +
                                 (mi & 1) * 8);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(u[mt][nt], a, bfrag[nt][0], bfrag[nt][1]);
      }
    }
  }

  // the block's partial: maxima, sums and the product
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = run_sum[nt][e];
      s += __shfl_xor_sync(kFullMask, s, 4);
      s += __shfl_xor_sync(kFullMask, s, 8);
      s += __shfl_xor_sync(kFullMask, s, 16);
      if (g == 0) {
        wred[warp * kJ + nt * 8 + 2 * tig + e] = s;
        if (warp == 0) mfin[nt * 8 + 2 * tig + e] = run_max[nt][e];
      }
    }
  }
  __syncthreads();
  float* part = p.partials + (long long)b * partial_stride(p) + (long long)split * kPart;
  if (tid < kJ) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += wred[w * kJ + tid];
    part[tid] = mfin[tid];
    part[kJ + tid] = s;
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int c = warp * 32 + nt * 8 + 2 * tig;
      float* o = part + 2 * kJ + (mt * 16 + g) * kC + c;
      *reinterpret_cast<float2*>(o) = make_float2(u[mt][nt][0], u[mt][nt][1]);
      *reinterpret_cast<float2*>(o + 8 * kC) = make_float2(u[mt][nt][2], u[mt][nt][3]);
    }
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
  const dim3 cols_grid(p.splits, p.batch);
  const auto count = [queued](cudaError_t e) {
    if (e == cudaSuccess) ++*queued;
    return e;
  };
  cudaError_t err = count(launch<prep_kernel<T>>(per_prompt, kTokThreads, kTokSmemBytes, s, p));
  if (err != cudaSuccess) return err;
  for (int second = 0; second < 2; ++second) {
    if constexpr (kBf16) {
      const dim3 grid((p.t + kMmaRowsPerBlock - 1) / kMmaRowsPerBlock, p.batch);
      err = count(second
                      ? launch<rows_mma_kernel<true>>(grid, 128, rows_mma_smem_bytes<true>(), s, p)
                      : launch<rows_mma_kernel<false>>(grid, 128, rows_mma_smem_bytes<false>(), s, p));
      if (err != cudaSuccess) return err;
      err = count(launch<cols_mma_kernel>(cols_grid, 256, kColsMmaSmemBytes, s, p, second));
    } else {
      const dim3 grid((p.t + kSimtRowsPerBlock - 1) / kSimtRowsPerBlock, p.batch);
      err = count(second ? launch<rows_simt_kernel<T, true>>(grid, 256,
                                                             rows_simt_smem_bytes<true>(), s, p)
                         : launch<rows_simt_kernel<T, false>>(grid, 256,
                                                              rows_simt_smem_bytes<false>(), s, p));
      if (err != cudaSuccess) return err;
      err = count(launch<cols_simt_kernel<T>>(cols_grid, 256, kColsSimtSmemBytes, s, p, second));
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
// matrices (in, out) in the compute type, vectors float32. keys1 (B, T, 256)
// is scratch; keys2 (B, T, 256) and qout (B, 8, 256) are the results;
// `scratch` holds (B, 5, 16384) values of the compute type and `partials`
// (B, splits * 16512 + 2112) float32. The column passes give each of
// `splits` blocks per prompt `rows_per_split` rows (a multiple of 128; every
// block has a row). Queues the chain's kernels on `stream` and writes to
// `*queued` how many it queued (0 when it refused the sizes or B or T is 0,
// fewer than the whole chain when a later launch failed). Returns a
// cudaError_t: cudaErrorInvalidValue for sizes the kernels are not built for.
int two_way_launch(const void* ktok0, const void* vtok0, const void* q1,
                   const void* qpe, const void* keys0, const void* pe,
                   const void* qimg0, const float* maskb, const void* const* weights,
                   void* keys1, void* keys2, void* qout, void* scratch, float* partials,
                   int batch, int t, int mlp, int rows_per_split, int splits,
                   int is_bf16, void* stream, int* queued) {
  *queued = 0;
  if (batch <= 0 || t <= 0) return cudaSuccess;
  const bool mlp_ok = mlp == 256 || mlp == 512 || mlp == 1024 || mlp == 2048;
  if (!mlp_ok || batch > 65535 || splits < 1 || splits > 255 ||
      rows_per_split % kColTile || (long long)(splits - 1) * rows_per_split >= t ||
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
  p.keys1 = keys1;
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
