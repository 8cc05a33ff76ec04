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
// Each sum is `dot_taps`'s (band.cuh): the taps in index order with fused
// multiply-adds.
//
// What bounds it on an H100: the matrices have at most four adjacent
// non-zeros a row, and on the main path's composed matrices two in almost
// every row and column, so the work is about 2 + 2 taps per output pixel
// against 128 KB (bfloat16 logits) read and 32 KB of bits written per slot at
// 512^2: bytes bound it (0.013 ms for 256 slots). The instructions a pixel and
// their latency set the pace. The design, that of stability.cu with a float32
// intermediate: one block owns one slot and walks its frame in strips of up
// to 32 output rows.
//  * Source rows: the strip's source rows (at most kSrcRowsMax, fewer output
//    rows when a strip would need more) are copied into shared memory by
//    16-byte `cp.async`s while the previous strip is resized, two buffers in
//    turn.
//  * Row resize: lane l of every warp is output row l of the strip; a warp
//    takes 16-byte chunks of a row, reads them from its row's source rows
//    (rows padded so that lanes on different rows hit different banks) and
//    writes Y1 in float32, transposed: Y1t[column][row].
//  * Column resize: each thread owns output columns for the whole frame and
//    keeps, in registers, their four taps and the shared addresses of the
//    four Y1t columns those taps read. A 16-byte read of Y1t is 4 rows of one
//    source column.
//  * Zero taps: each warp uses only as many taps as the most any of its rows
//    (columns) needs.
//  * Bits: a warp owns 32 consecutive columns, so `__ballot_sync` over its
//    lanes at one row is 32 bits of the packed row, which lane r keeps for
//    row r of the strip; reversed within each byte, it is one 32-bit word in
//    numpy.packbits order. The strip's packed rows gather in shared memory,
//    laid out as in device memory, and go out as 16-byte stores while the
//    next strip is resized. The area is the words' population count, a row
//    is in the box when its word is not 0, and the OR of a warp's words
//    gives its columns in the box.
// Each block writes its own slot: no atomics, the same result in every run.
// The TPU kernel's packing product (0/1 times powers of two), its int32
// output and its padding of the frame to (8, 128) tiles answer that chip's
// compiler and are not carried over. A slot whose gate flag is 0 costs no
// resize: its bits, box and area are written as zeros, so that whoever
// gathers such a slot paints nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "band.cuh"
#include "mma.cuh"

namespace {

constexpr int kBlocksPerSm = 3;
// a block's share of the SM's 228 KB when kBlocksPerSm blocks sit on it: each
// block also holds 1 KB that the card reserves, and s_part
constexpr int kSmemShare = 233472 / kBlocksPerSm - 1024 - 256;

// shared-memory layout, in bytes: Y1t, two staging buffers, a strip's bits
template <typename T>
struct StatsSmem {
  static constexpr int kE = 16 / sizeof(T);         // elements per 16-byte chunk
  static constexpr int kPitchT = kStripRows + 4;    // floats in a Y1t column
  int columns;       // Y1t columns: sw rounded up to a chunk
  int pitch_s;       // staged row, elements: columns + one chunk
  int src_rows;      // staged rows per buffer
  int bits_bytes;    // a strip's packed rows, with room to align them
  __host__ __device__ StatsSmem(int sw, int cwb, int src) {
    columns = (sw + kE - 1) / kE * kE;
    pitch_s = columns + kE;
    src_rows = src;
    bits_bytes = (kStripRows * cwb + 16 + 15) / 16 * 16;
  }
  __host__ __device__ size_t y1t_bytes() const {
    return sizeof(float) * (size_t)columns * kPitchT;
  }
  __host__ __device__ size_t stage_bytes() const {
    return sizeof(T) * (size_t)src_rows * pitch_s;
  }
  __host__ __device__ size_t bytes() const {
    return y1t_bytes() + 2 * stage_bytes() + bits_bytes;
  }
};

// Bytes [0, n) of src (shared memory, src + i and dst + i equal mod 16; null:
// zeros) to dst in device memory, 16 bytes a store where aligned; all the
// block's threads take part
__device__ void store_bytes(uint8_t* dst, int n, const uint8_t* src) {
  const int head = min(n, (int)((16u - ((uintptr_t)dst & 15u)) & 15u));
  const int body = (n - head) >> 4;
  for (int i = threadIdx.x; i < head; i += kThreads) dst[i] = src ? src[i] : 0;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  const uint4* s4 = src ? reinterpret_cast<const uint4*>(src + head) : nullptr;
  for (int i = threadIdx.x; i < body; i += kThreads)
    d4[i] = s4 ? s4[i] : make_uint4(0u, 0u, 0u, 0u);
  for (int i = head + 16 * body + threadIdx.x; i < n; i += kThreads)
    dst[i] = src ? src[i] : 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
mask_stats_kernel(const T* __restrict__ x, const int* __restrict__ active,
                  const int* __restrict__ h_start, const float4* __restrict__ h_taps,
                  const int* __restrict__ w_start, const float4* __restrict__ w_taps,
                  uint8_t* __restrict__ bits, float* __restrict__ boxes,
                  float* __restrict__ areas, int sh, int sw, int ch, int cw, int src_rows,
                  int vec) {
  using S = StatsSmem<T>;
  constexpr int kE = S::kE;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_part[kWarps][5];          // area, y0, y1, x0, x1 per warp
  const int cwb = (cw + 7) >> 3;             // bytes in a packed row
  const S lay(sw, cwb, src_rows);
  float* const y1t = reinterpret_cast<float*>(smem);                  // [columns][kPitchT]
  T* const stage0 = reinterpret_cast<T*>(smem + lay.y1t_bytes());     // two staging buffers
  T* const stage1 = stage0 + (size_t)src_rows * lay.pitch_s;
  uint8_t* const sbits = reinterpret_cast<uint8_t*>(smem + lay.y1t_bytes() + 2 * lay.stage_bytes());

  const int m = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  uint8_t* const bm = bits + (long long)m * ch * cwb;
  if (active != nullptr && active[m] == 0) {
    store_bytes(bm, ch * cwb, nullptr);
    if (tid < 4) boxes[4 * m + tid] = 0.f;
    if (tid == 0) areas[m] = 0.f;
    return;
  }
  const T* xm = x + (long long)m * sh * sw;
  const int chunks = lay.columns / kE;       // 16-byte chunks of a staged row

  // Source rows of a strip into a staging buffer, a warp a row: 16-byte
  // cp.asyncs when rows are whole chunks, else plain loads (and zeros past
  // sw); one commit group either way
  const auto load = [&](const Strip& st, T* buf) {
    for (int rr = warp; rr < st.span; rr += kWarps) {
      T* dst = buf + rr * lay.pitch_s;
      const T* src = xm + (long long)(st.lo + rr) * sw;
      if (vec) {
        for (int q = lane; q < chunks; q += 32) cp_async16(dst + q * kE, src + q * kE, 16);
      } else {
        for (int p = lane; p < chunks * kE; p += 32) dst[p] = p < sw ? src[p] : T(0.f);
      }
    }
    cp_async_commit();
  };
  // where a strip's packed rows gather: aligned as their place in `bits`
  const auto strip_bits = [&](const Strip& st) {
    return sbits + ((uintptr_t)(bm + (long long)st.u0 * cwb) & 15u);
  };
  const auto flush = [&](const Strip& st) {
    store_bytes(bm + (long long)st.u0 * cwb, st.n * cwb, strip_bits(st));
  };

  int area = 0, y_lo = INT_MAX, y_hi = -1;   // this lane's rows
  int x_lo = INT_MAX, x_hi = -1;             // the same in every lane of a warp
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
      for (int i = 0; i < kTaps; ++i)
        caddr[k][i] = y1t_addr + (c + i) * (S::kPitchT * (int)sizeof(float));
    }
  };
  // The mask bits of this warp's k-th group of 32 columns over rows [0, n)
  // of the strip (all kStripRows when `full`), with the first `taps` taps:
  // lane r gets row r's 32 bits, bit i for column i of the group. A column
  // past cw has zero taps and a row past n is masked, so their bits are 0.
  const auto column_bits = [&](int k, int n, auto taps, auto full) -> uint32_t {
    constexpr int kN = decltype(taps)::value;
    uint32_t word = 0u;
#pragma unroll
    for (int r0 = 0; r0 < kStripRows; r0 += 4) {
      if (!decltype(full)::value && r0 >= n) break;
      float v[kTaps][4];
#pragma unroll
      for (int i = 0; i < kN; ++i)
        Elem<float>::unpack(lds128(caddr[k][i] + r0 * (int)sizeof(float)), v[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float tv[kTaps] = {v[0][e], kN > 1 ? v[1][e] : 0.f, kN > 2 ? v[2][e] : 0.f,
                                 kN > 3 ? v[3][e] : 0.f};
        bool on = dot_taps<kN>(ctap[k], tv) > 0.f;
        if (!decltype(full)::value) on = on && r0 + e < n;
        const uint32_t ballot = __ballot_sync(kFullMask, on);
        if (lane == r0 + e) word = ballot;
      }
    }
    return word;
  };
  const auto group_bits = [&](int k, int n, auto full) -> uint32_t {
    switch (cn[k]) {
      case 1: return column_bits(k, n, std::integral_constant<int, 1>(), full);
      case 2: return column_bits(k, n, std::integral_constant<int, 2>(), full);
      case 3: return column_bits(k, n, std::integral_constant<int, 3>(), full);
      default: return column_bits(k, n, std::integral_constant<int, 4>(), full);
    }
  };
  const bool resident = cw <= kThreads * kCols;
  const bool whole_words = (cwb & 3) == 0;   // then every word is 4-byte aligned
  if (resident) load_columns(0);

  Strip cur = plan_strip(h_start, 0, ch, src_rows, lane);
  Strip prv{0, 0, 0, 0};
  load(cur, stage0);
#pragma unroll 1
  for (int k = 0;; ++k) {
    const int un = cur.u0 + cur.n;
    const Strip nxt = un < ch ? plan_strip(h_start, un, ch, src_rows, lane) : Strip{ch, 0, 0, 0};
    cp_async_wait<0>();
    __syncthreads();   // cur is staged; Y1t, the other buffer and the bits are free
    if (nxt.n > 0) load(nxt, (k & 1) ? stage0 : stage1);
    if (prv.n > 0) flush(prv);

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
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const float tv[kTaps] = {v[0][e], kN > 1 ? v[1][e] : 0.f, kN > 2 ? v[2][e] : 0.f,
                                     kN > 3 ? v[3][e] : 0.f};
            y1t[(p + e) * S::kPitchT + lane] = dot_taps<kN>(t, tv);
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

    // column resize from Y1t: the strip's packed rows, area and box
    uint8_t* const sb = strip_bits(cur);
    bool row_on = false;
    for (int v0 = 0; v0 < cw; v0 += kThreads * kCols) {
      if (!resident) load_columns(v0);
#pragma unroll
      for (int kc = 0; kc < kCols; ++kc) {
        const int vg = v0 + warp * 32 + kc * kThreads;   // the group's first column
        if (vg >= cw) break;                             // the same in the whole warp
        const uint32_t word = cur.n == kStripRows ? group_bits(kc, kStripRows, std::true_type())
                                                  : group_bits(kc, cur.n, std::false_type());
        const uint32_t any = __reduce_or_sync(kFullMask, word);
        if (any) {
          x_lo = min(x_lo, vg + __ffs(any) - 1);
          x_hi = max(x_hi, vg + 31 - __clz(any));
        }
        area += __popc(word);
        row_on |= word != 0u;
        if (lane < cur.n) {
          // bit i of `word` is column vg + i; a packed byte wants its first
          // pixel in the top bit
          const uint32_t packed = __byte_perm(__brev(word), 0u, 0x0123);
          const int b0 = vg >> 3;                        // its first byte in the row
          uint8_t* dst = sb + lane * cwb + b0;
          if (whole_words) {
            *reinterpret_cast<uint32_t*>(dst) = packed;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (b0 + j < cwb) dst[j] = (uint8_t)(packed >> (8 * j));
          }
        }
      }
    }
    if (row_on) {
      y_lo = min(y_lo, cur.u0 + lane);
      y_hi = max(y_hi, cur.u0 + lane);
    }
    if (nxt.n == 0) break;
    prv = cur;
    cur = nxt;
  }

  area = __reduce_add_sync(kFullMask, area);
  y_lo = __reduce_min_sync(kFullMask, y_lo);
  y_hi = __reduce_max_sync(kFullMask, y_hi);
  if (lane == 0) {
    s_part[warp][0] = area;
    s_part[warp][1] = y_lo;
    s_part[warp][2] = y_hi;
    s_part[warp][3] = x_lo;
    s_part[warp][4] = x_hi;
  }
  __syncthreads();
  flush(cur);
  if (tid == 0) {
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
  constexpr int kE = StatsSmem<T>::kE;
  // whole 16-byte chunks along a row, from an aligned start
  const bool vec = sw % kE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const StatsSmem<T> none(sw, (cw + 7) / 8, 0);
  const size_t fixed = none.bytes();                 // Y1t and the bits
  const size_t per_row = 2 * sizeof(T) * none.pitch_s;
  // as many staged rows as let kBlocksPerSm blocks share an SM, up to
  // kSrcRowsMax; where that leaves fewer than a strip of 16 output rows
  // needs at 343 of 256, as many as fit one block (a strip whose source rows
  // do not fit is cut in halves, down to one output row of kTaps rows)
  size_t rows = fixed < (size_t)kSmemShare ? ((size_t)kSmemShare - fixed) / per_row : 0;
  if (rows < 16) {
    if (fixed + kTaps * per_row > (size_t)kSmemMax) return cudaErrorInvalidValue;
    rows = ((size_t)kSmemMax - fixed) / per_row;
  }
  const int src_rows = (int)min(rows, (size_t)kSrcRowsMax);
  const size_t smem = StatsSmem<T>(sw, (cw + 7) / 8, src_rows).bytes();
  return launch<mask_stats_kernel<T>>(
      dim3((unsigned)m), kThreads, smem, stream, (const T*)x, active, h_start,
      (const float4*)h_taps, w_start, (const float4*)w_taps, bits, boxes, areas, sh, sw, ch,
      cw, src_rows, (int)vec);
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
