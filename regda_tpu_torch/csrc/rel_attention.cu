// SAM ViT attention with the decomposed relative-position bias fused in.
//
// Replaces the Pallas TPU kernel `attention_with_rel_bias`
// (regda_tpu/models/sam/pallas_attention.py:136, pallas_call at :176). Per
// (batch, head), for N = kh * kw tokens in row-major (h, w) order:
//
//   logits[q, k] = (q[q] * scale) . k[k] + rh[q, k / kw] + rw[q, k % kw]
//   out          = softmax(logits) @ v
//
// rh (B, H, N, kh) and rw (B, H, N, kw) are the q-contracted bias tables the
// caller computes. The rounding points are those of the TPU kernel and of
// `rel_attention_plain`: q * scale in float32 then rounded to the storage
// type, bias values in the storage type, float32 logits and softmax, the
// probabilities rounded to the storage type before the product with v,
// float32 accumulation, and the division by the softmax sum last.
//
// What does not carry over from the TPU kernel: its 0/1 expansion matrices
// and the widened logits product existed to put the bias add on the matrix
// unit, and its whole (rows, N) logits block lived in fast memory. Here the
// bias is two indexed loads per logit from a per-block copy of the query
// rows' tables, and the keys are walked in tiles of 64 with a running
// maximum and sum (the logits never exist outside registers), so N = 4096
// needs no more shared memory than N = 196. Ragged edges (N = 196 is no
// multiple of 64) are masked: keys past N get a logit of -inf and zero K/V
// rows, query rows past N are computed on zeros and not stored.
//
// What bounds it on an H100: 4 * N^2 * D operations per (batch, head)
// against 4 * N * D elements moved, so at N = 4096 the tensor cores bound it
// and at N = 196 it sits near the balance point. Two kernels:
//  * bfloat16: `rel_attn_mma_kernel`. One block of 4 warps owns 64 query
//    rows; each warp holds its 16 rows of Q as `mma.sync.m16n8k16` A
//    fragments for the whole key loop, takes K and V fragments from shared
//    memory with `ldmatrix` (V transposed by `ldmatrix.trans`), and reuses
//    the logits' accumulator registers as the A fragments of the P @ V
//    product, so probabilities never touch shared memory.
//  * float32: `rel_attn_simt_kernel`, on the ordinary float32 units, since
//    the tensor cores offer float32 inputs only as TF32, which would not
//    hold float32 agreement. 256 threads own 64 query rows and a 4 x 4
//    register tile of each 64 x 64 logits block.
// q, k and v are read through strides, so the permuted view of the qkv
// projection's output is taken as it is; the output goes out through strides
// too, so the caller can have it in (B, N, H, D) order with no transpose.

#include <math.h>

#include "mma.cuh"

namespace {

constexpr int kTile = 64;  // query rows per block and keys per tile

struct Args {
  const void* q;  // element (b, h, n, d) at q + b*sb + h*sh + n*sn + d
  const void* k;
  const void* v;
  long long sb, sh, sn;
  const void* rh;  // (B, H, N, kh) contiguous
  const void* rw;  // (B, H, N, kw) contiguous
  void* out;       // element (b, h, n, d) at out + b*ob + h*oh + n*on + d
  long long ob, oh, on;
  int heads, n, kh, kw;
  float scale;
};

// ---------------------------------------------------------------- bfloat16

// row stride, in elements, of a bias table in shared memory: an odd number
// of 32-bit words, so the 8 query rows a warp reads at once hit 8 banks
__host__ __device__ inline int bias_stride(int k) {
  int words = (k + 1) / 2;
  if ((words & 1) == 0) ++words;
  return 2 * words;
}

template <int D>
__global__ void __launch_bounds__(128) rel_attn_mma_kernel(const Args a) {
  static_assert(D % 16 == 0, "head dim must be a multiple of the mma depth");
  constexpr int kLd = D + 8;       // padded row: ldmatrix rows on 8 bank groups
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int kKSteps = D / 16;  // mma depth steps over the head dim
  constexpr int kDTiles = D / 8;   // 8-wide output column tiles
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kTile * kLd;
  bf16* vs = ks + kTile * kLd;
  const int ldh = bias_stride(a.kh), ldw = bias_stride(a.kw);
  bf16* rhs = vs + kTile * kLd;
  bf16* rws = rhs + kTile * ldh;
  short2* idx = reinterpret_cast<short2*>(rws + kTile * ldw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kTile;
  const long long base = (long long)b * a.sb + (long long)h * a.sh;
  const bf16* qp = static_cast<const bf16*>(a.q) + base;
  const bf16* kp = static_cast<const bf16*>(a.k) + base;
  const bf16* vp = static_cast<const bf16*>(a.v) + base;

  // Q tile: scale in float32, round to bfloat16; rows past N are zeros
  for (int c = tid; c < kTile * kChunks; c += 128) {
    const int r = c / kChunks, ch = c % kChunks;
    uint4 t = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < a.n) {
      t = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + r) * a.sn + ch * 8);
      uint32_t* w = reinterpret_cast<uint32_t*>(&t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = pack_bf16(__uint_as_float(w[i] << 16) * a.scale,
                         __uint_as_float(w[i] & 0xffff0000u) * a.scale);
    }
    *reinterpret_cast<uint4*>(qs + r * kLd + ch * 8) = t;
  }
  // the block's rows of both bias tables
  {
    const long long row0 = (long long)bh * a.n + q0;
    const bf16* rh = static_cast<const bf16*>(a.rh) + row0 * a.kh;
    const bf16* rw = static_cast<const bf16*>(a.rw) + row0 * a.kw;
    const int rows = min(kTile, a.n - q0);
    for (int i = tid; i < kTile * a.kh; i += 128) {
      const int r = i / a.kh, j = i % a.kh;
      rhs[r * ldh + j] = r < rows ? rh[i] : __float2bfloat16(0.f);
    }
    for (int i = tid; i < kTile * a.kw; i += 128) {
      const int r = i / a.kw, j = i % a.kw;
      rws[r * ldw + j] = r < rows ? rw[i] : __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  const int wrow = warp * 16;  // this warp's first row within the tile
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const bf16* p = qs + (wrow + g) * kLd + kk * 16 + 2 * tig;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLd + 8);
  }

  float o[kDTiles][4];
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt)
    o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums

  const bf16* rh0 = rhs + (wrow + g) * ldh;
  const bf16* rh1 = rh0 + 8 * ldh;
  const bf16* rw0 = rws + (wrow + g) * ldw;
  const bf16* rw1 = rw0 + 8 * ldw;
  const int lrow = lane & 7, lmat = (lane >> 3) & 1;  // ldmatrix row, matrix

  for (int key0 = 0; key0 < a.n; key0 += kTile) {
    __syncthreads();  // the previous tile has been read
    for (int c = tid; c < kTile * kChunks; c += 128) {
      const int r = c / kChunks, ch = c % kChunks;
      uint4 tk = make_uint4(0u, 0u, 0u, 0u), tv = tk;
      if (key0 + r < a.n) {
        const long long off = (long long)(key0 + r) * a.sn + ch * 8;
        tk = *reinterpret_cast<const uint4*>(kp + off);
        tv = *reinterpret_cast<const uint4*>(vp + off);
      }
      *reinterpret_cast<uint4*>(ks + r * kLd + ch * 8) = tk;
      *reinterpret_cast<uint4*>(vs + r * kLd + ch * 8) = tv;
    }
    if (tid < kTile) {
      const int key = key0 + tid;
      idx[tid] = key < a.n ? make_short2((short)(key / a.kw), (short)(key % a.kw))
                           : make_short2(0, 0);
    }
    __syncthreads();

    // logits of 16 rows x 64 keys: 8 column tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, ks + (nt * 8 + lrow) * kLd + kk * 16 + lmat * 8);
        mma_bf16(s[nt], qa[kk], b0, b1);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * tig + e;
        const short2 ij = idx[col];
        const bool valid = key0 + col < a.n;
        float t0 = s[nt][e] + __bfloat162float(rh0[ij.x]);
        t0 += __bfloat162float(rw0[ij.y]);
        float t1 = s[nt][2 + e] + __bfloat162float(rh1[ij.x]);
        t1 += __bfloat162float(rw1[ij.y]);
        s[nt][e] = valid ? t0 : -INFINITY;
        s[nt][2 + e] = valid ? t1 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
    // every tile holds a valid key, so the new maxima are finite
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = __expf(m0 - n0), alpha1 = __expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int dt = 0; dt < kDTiles; ++dt) {
      o[dt][0] *= alpha0;
      o[dt][1] *= alpha0;
      o[dt][2] *= alpha1;
      o[dt][3] *= alpha1;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m0);
      s[nt][1] = __expf(s[nt][1] - m0);
      s[nt][2] = __expf(s[nt][2] - m1);
      s[nt][3] = __expf(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];  // the sum takes the unrounded values
      l1 += s[nt][2] + s[nt][3];
    }

    // out += P @ V, 16 keys at a time: two logits tiles make one A fragment
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < kDTiles; ++dt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1,
                          vs + (kc * 16 + lmat * 8 + lrow) * kLd + dt * 8);
        mma_bf16(o[dt], pa, b0, b1);
      }
    }
  }

  l0 += __shfl_xor_sync(kFullMask, l0, 1);
  l0 += __shfl_xor_sync(kFullMask, l0, 2);
  l1 += __shfl_xor_sync(kFullMask, l1, 1);
  l1 += __shfl_xor_sync(kFullMask, l1, 2);
  bf16* op = static_cast<bf16*>(a.out) + (long long)b * a.ob + (long long)h * a.oh;
  const int r0 = q0 + wrow + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < kDTiles; ++dt) {
    const int col = dt * 8 + 2 * tig;
    if (r0 < a.n)
      *reinterpret_cast<uint32_t*>(op + (long long)r0 * a.on + col) =
          pack_bf16(o[dt][0] / l0, o[dt][1] / l0);
    if (r1 < a.n)
      *reinterpret_cast<uint32_t*>(op + (long long)r1 * a.on + col) =
          pack_bf16(o[dt][2] / l1, o[dt][3] / l1);
  }
}

template <int D>
size_t mma_smem_bytes(int kh, int kw) {
  return sizeof(__nv_bfloat16) *
             (size_t)(3 * kTile * (D + 8) + kTile * bias_stride(kh) +
                      kTile * bias_stride(kw)) +
         sizeof(short2) * kTile;
}

// ----------------------------------------------------------------- float32

template <int D>
__global__ void __launch_bounds__(256) rel_attn_simt_kernel(const Args a) {
  static_assert(D % 16 == 0, "16 threads share a row of the head dim");
  constexpr int kLd = kTile + 1;  // Q and K keep the head dim major: [d][row]
  constexpr int kCols = D / 16;   // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [D][kLd]
  float* ks = qs + D * kLd;                    // [D][kLd]
  float* vs = ks + D * kLd;                    // [kTile][D]
  float* ps = vs + kTile * D;                  // [kTile][kLd]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kTile;
  const long long base = (long long)b * a.sb + (long long)h * a.sh;
  const float* qp = static_cast<const float*>(a.q) + base;
  const float* kp = static_cast<const float*>(a.k) + base;
  const float* vp = static_cast<const float*>(a.v) + base;
  const float* rh = static_cast<const float*>(a.rh) + (long long)bh * a.n * a.kh;
  const float* rw = static_cast<const float*>(a.rw) + (long long)bh * a.n * a.kw;

  for (int i = tid; i < kTile * D; i += 256) {
    const int r = i / D, d = i % D;
    qs[d * kLd + r] =
        q0 + r < a.n ? qp[(long long)(q0 + r) * a.sn + d] * a.scale : 0.f;
  }

  // this thread's rows are ty + 16 i, its key columns tx + 16 j and its
  // output columns tx + 16 c
  float o[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[i][c] = 0.f;
  }

  for (int key0 = 0; key0 < a.n; key0 += kTile) {
    __syncthreads();  // the previous tile has been read (and Q is written)
    for (int i = tid; i < kTile * D; i += 256) {
      const int r = i / D, d = i % D;
      const bool valid = key0 + r < a.n;
      const long long off = (long long)(key0 + r) * a.sn + d;
      ks[d * kLd + r] = valid ? kp[off] : 0.f;
      vs[r * D + d] = valid ? vp[off] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[d * kLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[d * kLd + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + tx + 16 * j;
      const bool valid = key < a.n;
      const int kd = valid ? key / a.kw : 0, km = valid ? key % a.kw : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = min(q0 + ty + 16 * i, a.n - 1);
        float t = s[i][j] + __ldg(rh + (long long)row * a.kh + kd);
        t += __ldg(rw + (long long)row * a.kw + km);
        s[i][j] = valid ? t : -INFINITY;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)  // the 16 threads of this row
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float mn = fmaxf(m[i], mx);  // finite: the tile holds a valid key
      const float alpha = expf(m[i] - mn);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kCols; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        l[i] += p;
        ps[(ty + 16 * i) * kLd + tx + 16 * j] = p;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < kTile; ++k) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kLd + k];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[k * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) o[i][c] = fmaf(pv[i], vv[c], o[i][c]);
    }
  }

  float* op = static_cast<float*>(a.out) + (long long)b * a.ob + (long long)h * a.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      sum += __shfl_xor_sync(kFullMask, sum, off);
    const int row = q0 + ty + 16 * i;
    if (row < a.n) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        op[(long long)row * a.on + tx + 16 * c] = o[i][c] / sum;
    }
  }
}

template <int D>
size_t simt_smem_bytes() {
  return sizeof(float) * (size_t)(2 * D * (kTile + 1) + kTile * D + kTile * (kTile + 1));
}

// ---------------------------------------------------------------- launches

template <int D>
cudaError_t launch_for_type(const Args& a, int batch, int is_bf16,
                            cudaStream_t stream) {
  const dim3 grid((a.n + kTile - 1) / kTile, batch * a.heads);
  return is_bf16 ? launch<rel_attn_mma_kernel<D>>(grid, 128, mma_smem_bytes<D>(a.kh, a.kw),
                                                  stream, a)
                 : launch<rel_attn_simt_kernel<D>>(grid, 256, simt_smem_bytes<D>(), stream, a);
}

}  // namespace

extern "C" {

// qkv: q, k and v share the strides (sb, sh, sn), in elements, of the
// (B, H, N) axes; the head dim is contiguous and every row 16-byte aligned.
// rh (B, H, N, kh) and rw (B, H, N, kw) are contiguous; out is written
// through (ob, oh, on). All are float32 (is_bf16 = 0) or bfloat16 (1).
// N = kh * kw, kh and kw below 32768, B * H at most 65535 (the wrapper
// checks). Launches on `stream`; returns a cudaError_t:
// cudaErrorInvalidValue for a head dim the kernels are not built for (32, 64
// and 80 are) or a bias table too long for a block's shared memory.
int rel_attention_launch(const void* q, const void* k, const void* v,
                         long long sb, long long sh, long long sn,
                         const void* rh, const void* rw, void* out,
                         long long ob, long long oh, long long on, int batch,
                         int heads, int n, int d, int kh, int kw, float scale,
                         int is_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || n <= 0) return cudaSuccess;
  if (kh * kw != n || batch * heads > 65535) return cudaErrorInvalidValue;
  const Args a = {q, k, v, sb, sh, sn, rh, rw, out, ob, oh, on,
                  heads, n, kh, kw, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {  // the ViT head dims: vit_t; vit_b and vit_l; vit_h
    case 32: return launch_for_type<32>(a, batch, is_bf16, s);
    case 64: return launch_for_type<64>(a, batch, is_bf16, s);
    case 80: return launch_for_type<80>(a, batch, is_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rel_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
