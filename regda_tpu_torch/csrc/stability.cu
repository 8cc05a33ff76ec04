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
// Each sum is `dot_taps`'s (band.cuh): the taps in index order with fused
// multiply-adds.
//
// What bounds it on an H100: a composed half-pixel resize matrix has at most
// four adjacent non-zeros a row, so the function is a separable interpolation
// of up to 4 + 4 taps per output pixel and a count: 128 KB read per candidate
// at 512^2 from bfloat16, where the dense products of the TPU kernels are
// 201 MFLOP. The matrices arrive in band form (first source index and four
// weights per output row, see ops/kernels/_band.py) and no dense product is
// formed. On the main path's composed matrices two of the four taps are zero
// in almost every row and column, so the work is about 2 + 2 taps a pixel and
// device memory bounds it (0.03 ms for 768 candidates); the instructions a
// pixel (two taps, two conversions from bf16, two compares and counts) and
// their latency set the pace.
//
// The design: one block owns one candidate and walks its frame in strips of
// up to 32 output rows.
//  * Source rows: the strip's source rows (at most kSrcRowsMax, fewer output
//    rows when a strip would need more) are copied into shared memory by
//    16-byte `cp.async`s while the previous strip is resized, two buffers in
//    turn. The blocked layout is read in place, a source row being four
//    plane rows of w values (full-res pixel (4y + 2dy + gy, 4x + 2dx + gx)
//    sits at row (dy*8 + dx*4 + gy*2 + gx)*h + y, column x); staged, a row is
//    plane-major: position p = (c % 4) * w + c / 4 for column c.
//  * Row resize: lane l of every warp is output row l of the strip; a warp
//    takes 16-byte chunks of positions, reads them from its row's source rows
//    (rows padded so that lanes on different rows hit different banks) and
//    writes Y1, rounded to X's type, transposed: Y1t[position][row].
//  * Column resize: each thread owns output columns for the whole frame and
//    keeps, in registers, their four taps and the shared addresses of the
//    four Y1t columns those taps read (blocked: planes padded by one
//    position, so that neighbouring columns fall in different banks). A
//    16-byte read of Y1t is 8 rows of one source column (4 in float32).
//  * Zero taps: a row or column whose taps end in zeros adds exact zeros to
//    a finite sum, so each warp uses only as many taps as the most any of
//    its rows (columns) needs; the order of the sum is kept for the rest.
// Counts are whole numbers below 2^24, exact in float32, and each block
// writes its own two: no atomics, the same result in every run. A candidate
// whose gate flag is 0 costs one block that writes two zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "band.cuh"
#include "mma.cuh"

namespace {

// Y1 is rounded to the logits' type
template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// n / d for n < 2^16 and 1 <= d < 2^16, given magic = ceil(2^32 / d) (0 for d = 1)
__device__ __forceinline__ int div_small(int n, int d, uint32_t magic) {
  return d == 1 ? n : (int)__umulhi((uint32_t)n, magic);
}
__device__ __forceinline__ uint32_t div_magic(int d) {
  return d == 1 ? 0u : 0xffffffffu / (uint32_t)d + 1u;
}

// shared-memory layout, in elements of T
template <typename T>
struct StabSmem {
  static constexpr int kE = 16 / sizeof(T);          // elements per 16-byte chunk
  static constexpr int kPitchT = kStripRows + kE;    // Y1t column: the strip's rows
  int pitch_s;       // staged row: sw rounded up to a chunk, + one chunk
  int columns;       // Y1t columns
  int src_rows;      // staged rows per buffer
  __host__ __device__ StabSmem(int sw, int src) {
    pitch_s = (sw + kE - 1) / kE * kE + kE;
    columns = pitch_s + 4;
    src_rows = src;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(T) * ((size_t)2 * src_rows * pitch_s + (size_t)columns * kPitchT);
  }
};

template <typename T, bool kBlocked>
__global__ void __launch_bounds__(kThreads, 3)
stability_kernel(const T* __restrict__ x, const int* __restrict__ active,
                 const int* __restrict__ h_start, const float4* __restrict__ h_taps,
                 const int* __restrict__ w_start, const float4* __restrict__ w_taps,
                 float* __restrict__ out, int sh, int sw, int ch, int cw, float offset,
                 int src_rows, int vec) {
  using S = StabSmem<T>;
  constexpr int kE = S::kE;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_counts[kWarps][2];
  const S lay(sw, src_rows);
  T* const stage0 = reinterpret_cast<T*>(smem);                 // two staging buffers
  T* const stage1 = stage0 + (size_t)src_rows * lay.pitch_s;
  T* const y1t = stage1 + (size_t)src_rows * lay.pitch_s;       // [columns][kPitchT]

  const int m = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (active != nullptr && active[m] == 0) {
    if (tid == 0) out[2 * m] = out[2 * m + 1] = 0.f;
    return;
  }
  const T* xm = x + (long long)m * sh * sw;
  const int h = sh >> 2, w = sw >> 2;        // the blocked layout's plane size
  const uint32_t w_magic = div_magic(w);
  const int chunks = lay.pitch_s / kE - 1;    // 16-byte chunks of a staged row

  // element p of source row r, p in staged order
  const auto source = [&](int r, int p) -> const T* {
    if (!kBlocked) return xm + (long long)r * sw + p;
    const int cp = div_small(p, w, w_magic);
    const int plane = ((r >> 1) & 1) * 8 + (cp >> 1) * 4 + (r & 1) * 2 + (cp & 1);
    return xm + ((long long)plane * h + (r >> 2)) * w + (p - cp * w);
  };
  // Source rows of a strip into a staging buffer, a warp a row: 16-byte
  // cp.asyncs when rows (blocked: plane rows) are whole chunks, else plain
  // loads (and zeros past sw); one commit group either way
  const auto load = [&](const Strip& st, T* buf) {
    for (int rr = warp; rr < st.span; rr += kWarps) {
      T* dst = buf + rr * lay.pitch_s;
      if (vec) {
        for (int q = lane; q < chunks; q += 32)
          cp_async16(dst + q * kE, source(st.lo + rr, q * kE), 16);
      } else {
        for (int p = lane; p < chunks * kE; p += 32)
          dst[p] = p < sw ? *source(st.lo + rr, p) : T(0.f);
      }
    }
    cp_async_commit();
  };

  int inter = 0, uni = 0;
  // this thread's output columns: the shared addresses of the four Y1t
  // columns their taps read, and the four taps
  const uint32_t y1t_addr = smem_addr(y1t);
  uint32_t caddr[kCols][kTaps];
  float4 ctap[kCols];
  int cn[kCols];   // taps the warp's columns use, the most of its lanes
  const auto load_columns = [&](int v0) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int v = v0 + tid + k * kThreads;
      const int c = v < cw ? w_start[v] : 0;
      ctap[k] = v < cw ? w_taps[v] : make_float4(0.f, 0.f, 0.f, 0.f);
      cn[k] = __reduce_max_sync(kFullMask, used_taps(ctap[k]));
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
        const int ci = c + i;
        const int col = kBlocked ? (ci & 3) * (w + 1) + (ci >> 2) : ci;
        caddr[k][i] = y1t_addr + col * (S::kPitchT * (int)sizeof(T));
      }
    }
  };
  // the counts of one column over rows [0, n) of the strip, with its first
  // `taps` taps (rows: all kStripRows when `full`)
  const auto count_column = [&](int k, int n, auto taps, auto full) {
    constexpr int kN = decltype(taps)::value;
#pragma unroll
    for (int r0 = 0; r0 < kStripRows; r0 += kE) {
      if (!decltype(full)::value && r0 >= n) break;
      float v[kTaps][kE];
#pragma unroll
      for (int i = 0; i < kN; ++i)
        Elem<T>::unpack(lds128(caddr[k][i] + r0 * (int)sizeof(T)), v[i]);
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float tv[kTaps] = {v[0][e], kN > 1 ? v[1][e] : 0.f, kN > 2 ? v[2][e] : 0.f,
                                 kN > 3 ? v[3][e] : 0.f};
        const float y = dot_taps<kN>(ctap[k], tv);
        if (decltype(full)::value || r0 + e < n) {
          inter += y > offset;
          uni += y > -offset;
        }
      }
    }
  };
  const auto count_rows = [&](int k, int n, auto full) {
    switch (cn[k]) {
      case 1: count_column(k, n, std::integral_constant<int, 1>(), full); break;
      case 2: count_column(k, n, std::integral_constant<int, 2>(), full); break;
      case 3: count_column(k, n, std::integral_constant<int, 3>(), full); break;
      default: count_column(k, n, std::integral_constant<int, 4>(), full);
    }
  };
  const bool resident = cw <= kThreads * kCols;
  if (resident) load_columns(0);

  Strip cur = plan_strip(h_start, 0, ch, src_rows, lane);
  load(cur, stage0);
#pragma unroll 1
  for (int k = 0;; ++k) {
    const int un = cur.u0 + cur.n;
    const Strip nxt = un < ch ? plan_strip(h_start, un, ch, src_rows, lane) : Strip{ch, 0, 0, 0};
    cp_async_wait<0>();
    __syncthreads();   // cur is staged; Y1t and the other buffer are free
    if (nxt.n > 0) load(nxt, (k & 1) ? stage0 : stage1);

    // row resize: lane = output row of the strip
    {
      const T* buf = (k & 1) ? stage1 : stage0;
      const bool on = lane < cur.n;
      const int r0 = on ? h_start[cur.u0 + lane] - cur.lo : 0;
      const float4 t = on ? h_taps[cur.u0 + lane] : make_float4(0.f, 0.f, 0.f, 0.f);
      const T* src = buf + r0 * lay.pitch_s;
      const auto resize_rows = [&](auto taps) {
        constexpr int kN = decltype(taps)::value;
#pragma unroll 4
        for (int q = warp; q < chunks; q += kWarps) {
          const int p = q * kE;
          float v[kTaps][kE];
#pragma unroll
          for (int i = 0; i < kN; ++i)
            Elem<T>::unpack(*reinterpret_cast<const uint4*>(src + i * lay.pitch_s + p), v[i]);
          if (!on) continue;
          const int col0 = kBlocked ? p + div_small(p, w, w_magic) : p;
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const float tv[kTaps] = {v[0][e], kN > 1 ? v[1][e] : 0.f, kN > 2 ? v[2][e] : 0.f,
                                     kN > 3 ? v[3][e] : 0.f};
            const T y = round_to<T>(dot_taps<kN>(t, tv));
            if (vec) {
              y1t[(col0 + e) * S::kPitchT + lane] = y;
            } else if (p + e < sw) {
              const int col = kBlocked ? p + e + div_small(p + e, w, w_magic) : p + e;
              y1t[col * S::kPitchT + lane] = y;
            }
          }
        }
      };
      // the taps the warp's rows use, the most of its lanes
      switch (__reduce_max_sync(kFullMask, used_taps(t))) {
        case 1: resize_rows(std::integral_constant<int, 1>()); break;
        case 2: resize_rows(std::integral_constant<int, 2>()); break;
        case 3: resize_rows(std::integral_constant<int, 3>()); break;
        default: resize_rows(std::integral_constant<int, 4>());
      }
    }
    __syncthreads();

    // column resize from Y1t and the two counts
    for (int v0 = 0; v0 < cw; v0 += kThreads * kCols) {
      if (!resident) load_columns(v0);
#pragma unroll
      for (int kc = 0; kc < kCols; ++kc) {
        if (v0 + tid + kc * kThreads >= cw) break;
        if (cur.n == kStripRows)
          count_rows(kc, kStripRows, std::true_type());
        else
          count_rows(kc, cur.n, std::false_type());
      }
    }
    if (nxt.n == 0) break;
    cur = nxt;
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
  if (tid == 0) {
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
  constexpr int kE = StabSmem<T>::kE;
  // whole 16-byte chunks along a row (blocked: a plane row), from an aligned start
  const bool vec = (kBlocked ? (sw / 4) % kE == 0 : sw % kE == 0) &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  // as many staged rows as fit, up to kSrcRowsMax (a strip of one output row
  // needs kTaps)
  const StabSmem<T> one(sw, 1);
  const size_t y1t_bytes = one.bytes() - sizeof(T) * 2 * one.pitch_s;
  const size_t per_row = sizeof(T) * 2 * one.pitch_s;
  if (y1t_bytes + kTaps * per_row > (size_t)kSmemMax) return cudaErrorInvalidValue;
  const int src_rows =
      (int)min((size_t)kSrcRowsMax, ((size_t)kSmemMax - y1t_bytes) / per_row);
  const size_t smem = StabSmem<T>(sw, src_rows).bytes();
  return launch<stability_kernel<T, kBlocked>>(
      dim3((unsigned)m), kThreads, smem, stream, (const T*)x, active, h_start,
      (const float4*)h_taps, w_start, (const float4*)w_taps, out, sh, sw, ch, cw, offset,
      src_rows, (int)vec);
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
