// Per-region class histogram, the hot op of local-region homogenizing (LRH).
//
// Replaces the Pallas TPU kernel `segment_hist_labels_pallas`
// (regda_tpu/ops/pallas/segment_hist.py:61, pallas_call at :82), which
// rewrote the scatter as one-hot matmuls for the MXU. This kernel computes
// the same thing directly as a scatter into shared memory:
//
//   out[b, r, c] = #{n : regions[b, n] == r and labels[b, n] == c}
//
// counting a pixel only when 0 <= label < C and 0 <= region < R (ignored
// labels are negative, over-budget region ids fall outside [0, R)). Counts
// are integers below 2^24, exact in uint32 and in float32.
//
// What bounds it on an H100: device memory, 8 bytes read per pixel (two int32
// ids) and one (B, R, C) float32 histogram written once: 16.8 MB read at
// B = 8, N = 512^2, 5 us at 3.35 TB/s. What the design does about it:
//  * One thread-block cluster of kCluster blocks per image: each block counts
//    its share of the image's pixels into an R*C uint32 histogram in its own
//    shared memory. (Clusters of 16 are slower at B = 8: an H100 holds 7 of
//    them at one block an SM, and at two an SM they gain nothing.)
//  * Loads before atomics: each thread issues kBatch 16-byte loads of both
//    arrays, neighbouring threads on neighbouring addresses, before it adds
//    any of them, and the first batch goes out before the block clears its
//    histogram. A scalar head and tail handle a share whose start is not
//    16-byte aligned and pixel counts not divisible by 4.
//  * Atomic contention in shared memory: SAM regions are large and mostly
//    carry one pseudo-label, so many pixels of a warp hit the same bin. A
//    warp whose 128 pixels all share one bin adds them with one atomic from
//    lane 0; otherwise each thread run-length-merges its 4 pixels before its
//    atomics.
//  * The reduction across the cluster: after a cluster barrier each block
//    sums its 1/kCluster slice of the bins over the histograms of all blocks
//    of its cluster through distributed shared memory, and writes them with
//    plain stores. Every bin is written exactly once: no global atomics, no
//    zeroed output (the caller need not clear it), and the same result in
//    every run.
// A call is one launch; the shared-memory opt-in is made once per device
// (`launch` in mma.cuh), and the caller checks R * C against
// segment_hist_max_bins() once per device.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kBatch = 2;          // int4 pairs a thread loads before its atomics
constexpr int kCluster = 8;        // blocks per image

__device__ __forceinline__ int bin_of(int label, int region, int num_classes,
                                      int num_regions) {
  return ((unsigned)label < (unsigned)num_classes &&
          (unsigned)region < (unsigned)num_regions)
             ? region * num_classes + label
             : -1;
}

// four pixels' bins of one thread into the block's histogram; every lane of
// the warp takes part
__device__ __forceinline__ void add4(unsigned* hist, const int (&k)[4], int lane) {
  const int k0 = __shfl_sync(kFullMask, k[0], 0);
  const bool same = k[0] == k0 && k[1] == k0 && k[2] == k0 && k[3] == k0;
  if (__all_sync(kFullMask, same)) {
    if (lane == 0 && k0 >= 0) atomicAdd(&hist[k0], 128u);
    return;
  }
  int cur = k[0];
  unsigned cnt = 1u;
#pragma unroll
  for (int j = 1; j < 4; ++j) {
    if (k[j] == cur) {
      ++cnt;
    } else {
      if (cur >= 0) atomicAdd(&hist[cur], cnt);
      cur = k[j];
      cnt = 1u;
    }
  }
  if (cur >= 0) atomicAdd(&hist[cur], cnt);
}

// Grid: kCluster blocks per image, one cluster each; block `rank` of image b
// counts pixels [rank * chunk, (rank + 1) * chunk) of it (chunk a multiple of
// 4; the last blocks may get none).
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
segment_hist_kernel(const int* __restrict__ labels, const int* __restrict__ regions,
                    float* __restrict__ out, int n, int num_regions, int num_classes,
                    int chunk) {
  extern __shared__ unsigned int hist[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / kCluster;
  const int bins = num_regions * num_classes;
  const int tid = threadIdx.x, lane = tid & 31;

  const size_t row = (size_t)b * (size_t)n;
  const int* lab = labels + row;
  const int* reg = regions + row;
  const int start = min(rank * chunk, n);
  const int end = min(start + chunk, n);
  // labels and regions are both 16-byte aligned at their base (the caller
  // checks), so one head length aligns both
  const int head =
      min(end - start, (int)(((16u - ((uintptr_t)(lab + start) & 15u)) & 15u) >> 2));
  const int vstart = start + head;
  const int nvec = (end - vstart) >> 2;
  const int vend = vstart + 4 * nvec;
  const int4* lab4 = reinterpret_cast<const int4*>(lab + vstart);
  const int4* reg4 = reinterpret_cast<const int4*>(reg + vstart);
  int4 l[kBatch], r[kBatch];
  const auto load = [&](int v0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int v = v0 + j * kThreads + tid;
      if (v < nvec) {
        l[j] = __ldg(lab4 + v);
        r[j] = __ldg(reg4 + v);
      } else {
        l[j] = make_int4(-1, -1, -1, -1);
        r[j] = l[j];
      }
    }
  };
  // the first batch's loads go out before the histogram is cleared
  load(0);
  for (int i = tid; i < bins; i += kThreads) hist[i] = 0u;
  __syncthreads();

  for (int i = start + tid; i < vstart; i += kThreads) {
    const int k = bin_of(lab[i], reg[i], num_classes, num_regions);
    if (k >= 0) atomicAdd(&hist[k], 1u);
  }
  for (int i = vend + tid; i < end; i += kThreads) {
    const int k = bin_of(lab[i], reg[i], num_classes, num_regions);
    if (k >= 0) atomicAdd(&hist[k], 1u);
  }
  // the trip count is the same in every thread, so the warp votes in add4
  // see all 32 lanes
  for (int v0 = 0;;) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k[4] = {bin_of(l[j].x, r[j].x, num_classes, num_regions),
                        bin_of(l[j].y, r[j].y, num_classes, num_regions),
                        bin_of(l[j].z, r[j].z, num_classes, num_regions),
                        bin_of(l[j].w, r[j].w, num_classes, num_regions)};
      add4(hist, k, lane);
    }
    v0 += kBatch * kThreads;
    if (v0 >= nvec) break;
    load(v0);
  }

  cluster.sync();   // every block of the cluster has counted its pixels
  const int slice = (bins + kCluster - 1) / kCluster;
  const int lo = rank * slice, hi = min(lo + slice, bins);
  float* dst = out + (size_t)b * (size_t)bins;
  for (int i = lo + tid; i < hi; i += kThreads) {
    unsigned s = 0u;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += *cluster.map_shared_rank(hist + i, q);
    dst[i] = (float)s;
  }
  cluster.sync();   // no block leaves while another still reads its histogram
}

}  // namespace

extern "C" {

// Largest R * C one block's shared memory can hold on the current device,
// or a negative CUDA error code.
int segment_hist_max_bins(void) {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return err == cudaSuccess ? bytes / (int)sizeof(unsigned) : -(int)err;
}

// labels, regions: (batch, n) int32, 16-byte aligned; out: (batch, R, C)
// float32, every entry written (it need not be zeroed). Launches one kernel
// on `stream`; returns a cudaError_t (cudaErrorInvalidValue when R * C
// exceeds segment_hist_max_bins()).
int segment_hist_labels_launch(const void* labels, const void* regions,
                               void* out, int batch, int n, int num_regions,
                               int num_classes, void* stream) {
  if (batch <= 0 || n <= 0) return cudaSuccess;
  if (num_regions <= 0 || num_classes <= 0 ||
      (long long)num_regions * num_classes > INT_MAX / (int)sizeof(unsigned) ||
      batch > INT_MAX / kCluster)
    return cudaErrorInvalidValue;
  // chunks a multiple of 4 pixels, so that only a block whose share starts
  // off a 16-byte boundary (N not a multiple of 4) has a head
  int chunk = (n + kCluster - 1) / kCluster;
  chunk = (chunk + 3) & ~3;
  return launch<segment_hist_kernel>(
      dim3(batch * kCluster), kThreads, (size_t)num_regions * num_classes * sizeof(unsigned),
      (cudaStream_t)stream, (const int*)labels, (const int*)regions, (float*)out, n,
      num_regions, num_classes, chunk);
}

const char* segment_hist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
