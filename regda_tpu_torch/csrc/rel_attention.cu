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
// bias added as (q.k + rh) + rw, the probabilities rounded to the storage
// type before the product with v, float32 accumulation, and the division by
// the softmax sum last.
//
// What does not carry over from the TPU kernel: its 0/1 expansion matrices
// and the widened logits product existed to put the bias add on the matrix
// unit, and its whole (rows, N) logits block lived in fast memory. Here the
// keys are walked in tiles of 64 with a running maximum and sum, so the
// logits never leave registers and N = 4096 needs no more shared memory than
// N = 196.
//
// What bounds it on an H100: 4 * N^2 * D operations per (batch, head)
// against 4 * N * D elements moved, so at N = 4096 (D = 64) the tensor cores
// bound it and at N = 196 the bytes do. Per logit the tensor cores do 2 * 64
// multiply-adds while the other units do an exponential and some six float32
// operations, so beside the products the exponentials (16 an SM a clock)
// take as long as the tensor cores at D = 64. Two kernels:
//  * bfloat16: `rel_attn_wgmma_kernel`. A block owns 128 query rows, two
//    warpgroups of 64. Q, scaled and rounded, sits in shared memory for the
//    whole loop; K and V tiles arrive by `cp.async` into a ring of three
//    stages (two at D = 80), so the copies of the next two tiles overlap
//    this tile's work, with one barrier a tile. S = Q K^T is
//    `wgmma.m64n64k16` from shared memory; the probabilities, rounded, are
//    re-packed in registers as the A operand of `wgmma.m64nDk16` against V
//    (read N-major from the same tile layout). Two blocks share an SM at
//    D <= 64, so one block's softmax overlaps the other's products.
//    The bias takes no gather in the inner loop: keys are laid out in the
//    tile by image row, each row padded to kPt = 16, 32 or 64 slots (the
//    least that holds kw; for kw > 64, a tile is a 64-wide piece of one
//    row). A key's column within its row is then fixed by its place in the
//    tile, so each thread keeps the rw values of its 16 columns in
//    registers for the whole loop (-inf where a padded slot holds no key),
//    and rh adds one value per row and image row of the tile (-inf past
//    kh). At the global layers kw = 64 is the tile: one rh value per row a
//    tile and no padding; at the windowed layers (14 x 14) a tile holds 4
//    image rows of 16 slots, 2 of them empty.
//  * float32: `rel_attn_simt_kernel`, on the ordinary float32 units, since
//    the tensor cores offer float32 inputs only as TF32, which would not
//    hold float32 agreement. 256 threads own 64 query rows and a 4 x 4
//    register tile of each 64 x 64 logits block; the bias takes two loads
//    per logit.
// q, k and v are read through strides, so the permuted view of the qkv
// projection's output is taken as it is; the output goes out through strides
// too, so the caller can have it in (B, N, H, D) order with no transpose.
// Ragged edges are masked: key slots that hold no key get a logit of -inf
// and zero K/V rows, query rows past N are computed on zeros and not stored.

#include <math.h>

#include "mma.cuh"

namespace {

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

constexpr int kRows = 128;  // query rows per block: two warpgroups of 64
constexpr int kKeys = 64;   // keys per tile

template <int D>
__host__ __device__ constexpr int kv_stages() {  // two blocks an SM at D <= 64, one at 80
  return D <= 64 ? 3 : 2;
}

// Where the 64 key slots of tile j lie on the (kh, kw) grid: 64 / kPt image
// rows of kPt slots (kPt = 16, 32 or 64, the least that holds kw), or for
// kw > 64 a 64-wide piece of one image row, `tpr` pieces a row. Slot s is
// image row y0 + s / kPt, column x0 + s % kPt; slots past kw or kh hold no
// key.
struct TileOrigin {
  int y0, x0;
};
template <int kPt>
__device__ __forceinline__ TileOrigin tile_origin(int j, int tpr) {
  return {(j / tpr) * (kKeys / kPt), (j % tpr) * kKeys};
}

template <int D, int kPt>
__global__ void __launch_bounds__(256, D <= 64 ? 2 : 1)
    rel_attn_wgmma_kernel(const Args a, int tpr, int tiles) {
  static_assert(D % 16 == 0, "head dim must be a multiple of the mma depth");
  constexpr int kC = D / 8;  // 16-byte chunks per row
  constexpr int kStages = kv_stages<D>();
  constexpr int kTileElems = kKeys * D;
  constexpr int kGroups = kKeys / kPt;  // image rows per tile
  static_assert((2 * kKeys * kC) % 256 == 0 && (kRows * kC) % 256 == 0,
                "every thread copies as many chunks");
  constexpr float kLog2e = 1.4426950408889634f;
  using bf16 = __nv_bfloat16;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // 128 rows, core matrices
  bf16* kvs = qs + kRows * D;                // [stage][K, V] 64 rows, core matrices
  bf16* rhs = kvs + kStages * 2 * kTileElems;  // [128][kh]
  bf16* rws = rhs + kRows * a.kh;              // [128][kw]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3, wg = warp >> 2;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * kRows;
  const long long base = (long long)b * a.sb + (long long)h * a.sh;
  const bf16* qp = static_cast<const bf16*>(a.q) + base;
  const bf16* kp = static_cast<const bf16*>(a.k) + base;
  const bf16* vp = static_cast<const bf16*>(a.v) + base;

  // the block's rows of both bias tables, each one contiguous run of
  // memory: copied by 4-byte words with tile 0's group when kh and kw are
  // even (rows past N get zeros), else by ordinary loads
  {
    const long long row0 = (long long)bh * a.n + q0;
    const int rows = min(kRows, a.n - q0);
    const bf16* rh = static_cast<const bf16*>(a.rh) + row0 * a.kh;
    const bf16* rw = static_cast<const bf16*>(a.rw) + row0 * a.kw;
    if (((a.kh | a.kw) & 1) == 0) {
      for (int w = tid; w < kRows * a.kh / 2; w += 256)
        cp_async4(rhs + 2 * w, rh + (w < rows * a.kh / 2 ? 2 * w : 0),
                  w < rows * a.kh / 2 ? 4 : 0);
      for (int w = tid; w < kRows * a.kw / 2; w += 256)
        cp_async4(rws + 2 * w, rw + (w < rows * a.kw / 2 ? 2 * w : 0),
                  w < rows * a.kw / 2 ? 4 : 0);
    } else {
      for (int i = tid; i < kRows * a.kh; i += 256)
        rhs[i] = i < rows * a.kh ? rh[i] : __float2bfloat16(0.f);
      for (int i = tid; i < kRows * a.kw; i += 256)
        rws[i] = i < rows * a.kw ? rw[i] : __float2bfloat16(0.f);
    }
  }

  // K and V of tile j into stage j % kStages as one commit group (an empty
  // group past the last tile keeps the count); slots without a key get zeros
  const auto load_tile = [&](int j) {
    if (j < tiles) {
      const TileOrigin o = tile_origin<kPt>(j, tpr);
      bf16* dst = kvs + (j % kStages) * 2 * kTileElems;
#pragma unroll
      for (int i = 0; i < 2 * kKeys * kC / 256; ++i) {
        const int it = tid + 256 * i;
        const int v = it / (kKeys * kC), rem = it % (kKeys * kC);
        const int row = ((rem >> 3) / kC) * 8 + (rem & 7), chunk = (rem >> 3) % kC;
        const int y = o.y0 + row / kPt, x = o.x0 + row % kPt;
        const bool ok = x < a.kw && y < a.kh;
        const bf16* src = (v ? vp : kp) + (ok ? (long long)(y * a.kw + x) * a.sn + chunk * 8 : 0);
        cp_async16(dst + v * kTileElems + core_offset(row, chunk, kC), src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) load_tile(j);

  // Q: scale in float32, round to bfloat16; rows past N are zeros
#pragma unroll
  for (int i = 0; i < kRows * kC / 256; ++i) {
    const int it = tid + 256 * i;
    const int row = ((it >> 3) / kC) * 8 + (it & 7), chunk = (it >> 3) % kC;
    uint4 t = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + row < a.n) {
      t = *reinterpret_cast<const uint4*>(qp + (long long)(q0 + row) * a.sn + chunk * 8);
      uint32_t* w = reinterpret_cast<uint32_t*>(&t);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = pack_bf16(__uint_as_float(w[e] << 16) * a.scale,
                         __uint_as_float(w[e] & 0xffff0000u) * a.scale);
    }
    *reinterpret_cast<uint4*>(qs + core_offset(row, chunk, kC)) = t;
  }
  // this thread's rows of the block: r0 and r0 + 8
  const int r0 = wg * 64 + (warp & 3) * 16 + g;
  const bf16* rh0 = rhs + r0 * a.kh;
  const bf16* rh1 = rh0 + 8 * a.kh;
  const bf16* rw0 = rws + r0 * a.kw;
  const bf16* rw1 = rw0 + 8 * a.kw;
  const uint64_t qdesc = wgmma_desc(qs + wg * 64 * D, 128, kC * 128);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0 and r0 + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the sums
  // rw of this thread's 16 columns for a tile at column x0, as bfloat16
  // pairs (columns 8 i + 2 tig and + 1 at [i]); -inf where the slot holds no
  // key. Loaded once unless kw > 64.
  uint32_t rwp0[8], rwp1[8];
  int rw_x0 = -1;

#pragma unroll 1
  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile j (and of Q)
    fence_proxy_async();
    __syncthreads();  // everyone's copies; the stage of tile j - 1 is free
    load_tile(j + kStages - 1);

    const bf16* ks = kvs + (j % kStages) * 2 * kTileElems;
    const bf16* vs = ks + kTileElems;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<64>(s, qdesc + 16 * kk, wgmma_desc(ks, 128, kC * 128) + 16 * kk, kk > 0);
    wgmma_commit();

    // while the product runs: the tile's bias values
    const TileOrigin org = tile_origin<kPt>(j, tpr);
    if (org.x0 != rw_x0) {  // the same for the whole block
      rw_x0 = org.x0;
      const uint32_t kNoKey = 0xff80u;  // bfloat16 -inf
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int x = org.x0 + (8 * i + 2 * tig) % kPt;
        const uint32_t lo0 = x < a.kw ? __bfloat16_as_ushort(rw0[x]) : kNoKey;
        const uint32_t hi0 = x + 1 < a.kw ? __bfloat16_as_ushort(rw0[x + 1]) : kNoKey;
        const uint32_t lo1 = x < a.kw ? __bfloat16_as_ushort(rw1[x]) : kNoKey;
        const uint32_t hi1 = x + 1 < a.kw ? __bfloat16_as_ushort(rw1[x + 1]) : kNoKey;
        rwp0[i] = lo0 | (hi0 << 16);
        rwp1[i] = lo1 | (hi1 << 16);
      }
    }
    float rhv0[kGroups], rhv1[kGroups];
#pragma unroll
    for (int gr = 0; gr < kGroups; ++gr) {
      const int y = org.y0 + gr;
      rhv0[gr] = y < a.kh ? __bfloat162float(rh0[y]) : -INFINITY;
      rhv1[gr] = y < a.kh ? __bfloat162float(rh1[y]) : -INFINITY;
    }
    wgmma_wait<0>();
    fence_regs(s);

    // logits: (s + rh) + rw in float32, as the plain version adds them
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      constexpr int kPer = kPt / 8;  // 8-column groups per image row
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gr = i / kPer;
        const float w0 = __uint_as_float(e ? rwp0[i] & 0xffff0000u : rwp0[i] << 16);
        const float w1 = __uint_as_float(e ? rwp1[i] & 0xffff0000u : rwp1[i] << 16);
        s[4 * i + e] = (s[4 * i + e] + rhv0[gr]) + w0;
        s[4 * i + 2 + e] = (s[4 * i + 2 + e] + rhv1[gr]) + w1;
        mx0 = fmaxf(mx0, s[4 * i + e]);
        mx1 = fmaxf(mx1, s[4 * i + 2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFullMask, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFullMask, mx1, 2));
    // every tile holds a key, so the new maxima are finite
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = ex2((m0 - n0) * kLog2e), alpha1 = ex2((m1 - n1) * kLog2e);
    m0 = n0;
    m1 = n1;
    l0 *= alpha0;
    l1 *= alpha1;
    const float b0 = -n0 * kLog2e, b1 = -n1 * kLog2e;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s[4 * i] = ex2(fmaf(s[4 * i], kLog2e, b0));
      s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], kLog2e, b0));
      s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], kLog2e, b1));
      s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], kLog2e, b1));
      l0 += s[4 * i] + s[4 * i + 1];  // the sum takes the unrounded values
      l1 += s[4 * i + 2] + s[4 * i + 3];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
    // out += P @ V: the probabilities, rounded, are the A operand in
    // registers, 16 keys a step
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pa[kc][0] = pack_bf16(s[8 * kc], s[8 * kc + 1]);
      pa[kc][1] = pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      wgmma_rs_tb<D>(o, pa[kc], wgmma_desc(vs + kc * 2 * kC * 64, kC * 128, 128));
    wgmma_commit();
    wgmma_wait<0>();  // before o is rescaled and the stage is refilled
    fence_regs(o);
  }

  l0 += __shfl_xor_sync(kFullMask, l0, 1);
  l0 += __shfl_xor_sync(kFullMask, l0, 2);
  l1 += __shfl_xor_sync(kFullMask, l1, 1);
  l1 += __shfl_xor_sync(kFullMask, l1, 2);
  bf16* op = static_cast<bf16*>(a.out) + (long long)b * a.ob + (long long)h * a.oh;
  const int n0 = q0 + r0, n1 = n0 + 8;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = i * 8 + 2 * tig;
    if (n0 < a.n)
      *reinterpret_cast<uint32_t*>(op + (long long)n0 * a.on + col) =
          pack_bf16(o[4 * i] / l0, o[4 * i + 1] / l0);
    if (n1 < a.n)
      *reinterpret_cast<uint32_t*>(op + (long long)n1 * a.on + col) =
          pack_bf16(o[4 * i + 2] / l1, o[4 * i + 3] / l1);
  }
}

template <int D>
size_t wgmma_smem_bytes(int kh, int kw) {
  return sizeof(__nv_bfloat16) * ((size_t)kRows * D + (size_t)kv_stages<D>() * 2 * kKeys * D +
                                  (size_t)kRows * (kh + kw));
}

// ----------------------------------------------------------------- float32

constexpr int kTile = 64;  // query rows per block and keys per tile

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
cudaError_t launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  const int pt = a.kw <= 16 ? 16 : a.kw <= 32 ? 32 : kKeys;
  const int tpr = pt < kKeys ? 1 : (a.kw + kKeys - 1) / kKeys;
  const int rows = kKeys / pt;  // image rows a tile
  const int tiles = pt < kKeys ? (a.kh + rows - 1) / rows : a.kh * tpr;
  const dim3 grid((a.n + kRows - 1) / kRows, batch * a.heads);
  const size_t smem = wgmma_smem_bytes<D>(a.kh, a.kw);
  switch (pt) {
    case 16: return launch<rel_attn_wgmma_kernel<D, 16>>(grid, 256, smem, stream, a, tpr, tiles);
    case 32: return launch<rel_attn_wgmma_kernel<D, 32>>(grid, 256, smem, stream, a, tpr, tiles);
    default: return launch<rel_attn_wgmma_kernel<D, 64>>(grid, 256, smem, stream, a, tpr, tiles);
  }
}

template <int D>
cudaError_t launch_for_type(const Args& a, int batch, int is_bf16, cudaStream_t stream) {
  if (is_bf16) return launch_bf16<D>(a, batch, stream);
  const dim3 grid((a.n + kTile - 1) / kTile, batch * a.heads);
  return launch<rel_attn_simt_kernel<D>>(grid, 256, simt_smem_bytes<D>(), stream, a);
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
