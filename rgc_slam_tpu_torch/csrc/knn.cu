// Brute-force k-nearest-neighbour search for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel rgc_slam_tpu/ops/pallas/knn_kernel.py::knn_pallas
// (body _knn_kernel).  It computes what that kernel computes, not how:
// squared distances |q|^2 + |p|^2 - 2 q.p in float32 on coordinates centred
// on the query mean, masked points at +inf, ties to the lower index,
// distances clamped at 0 on output.
//
// Design (first version: simple and right).  One thread owns one query;
// 128 threads per block.  The block streams the points through shared
// memory in tiles of TILE float4s (centred xyz and |p|^2, or +inf when
// masked), and each thread keeps a sorted top-K in registers, K a template
// parameter (1..24).  Points are scanned in ascending index order and a
// candidate is inserted on the lexicographic key (d, idx), starting from
// (+inf, INT_MAX) entries.  That one rule gives XLA top_k semantics: ties go
// to the lower index, and when fewer than K points are unmasked the unfilled
// slots take the lowest-index masked columns, so every index is in range.
//
// What bounds it: per query-point pair it does 3 FMAs for the dot product,
// an add and one compare, plus an insertion on the rare hits; it is
// compute-bound on those FMAs and compares.  The plain version writes and
// re-reads the [Q, N] float32 distance matrix and sorts it: at the mapping
// association's surf call (Q=2048, N=32768) that is 256 MB per call.  Here
// the distance matrix never leaves registers; device memory traffic is the
// point cloud once per block plus the [Q, K] outputs.  Thread-per-query
// leaves most of the 132 SMs idle at Q=512 (4 blocks); splitting N across
// blocks with a merge pass is left for a later version.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // points per shared-memory tile: 16 KB of float4

__device__ __forceinline__ bool key_less(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ queries, const float* __restrict__ points,
           const uint8_t* __restrict__ mask, const float* __restrict__ center,
           int nq, int n, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  const float cx = center[0], cy = center[1], cz = center[2];
  const int qid = blockIdx.x * kThreads + threadIdx.x;
  const bool active = qid < nq;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = queries[3 * qid + 0] - cx;
    qy = queries[3 * qid + 1] - cy;
    qz = queries[3 * qid + 2] - cz;
  }
  // |q|^2 summed in the plain version's order: (x*x + y*y) + z*z
  const float q2 = __fadd_rn(__fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy)),
                             __fmul_rn(qz, qz));

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0x7fffffff;
  }

  for (int base = 0; base < n; base += kTile) {
    const int count = min(kTile, n - base);
    __syncthreads();  // the previous tile is no longer read
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const int p = base + j;
      const float px = points[3 * p + 0] - cx;
      const float py = points[3 * p + 1] - cy;
      const float pz = points[3 * p + 2] - cz;
      const float p2 = __fadd_rn(__fadd_rn(__fmul_rn(px, px), __fmul_rn(py, py)),
                                 __fmul_rn(pz, pz));
      tile[j] = make_float4(px, py, pz, mask[p] ? p2 : INFINITY);
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < count; ++j) {
      const float4 pt = tile[j];
      const float dot = fmaf(qx, pt.x, fmaf(qy, pt.y, __fmul_rn(qz, pt.z)));
      const float d = __fsub_rn(__fadd_rn(q2, pt.w), 2.0f * dot);
      const int idx = base + j;
      if (!key_less(d, idx, bd[K - 1], bi[K - 1])) continue;
      // insertion into the sorted list, from the back; each position reads
      // its own old entry before it is overwritten
#pragma unroll
      for (int s = K - 1; s >= 0; --s) {
        if (key_less(d, idx, bd[s], bi[s])) {
          if (s > 0 && key_less(d, idx, bd[s - 1], bi[s - 1])) {
            bd[s] = bd[s - 1];
            bi[s] = bi[s - 1];
          } else {
            bd[s] = d;
            bi[s] = idx;
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[qid * K + s] = fmaxf(bd[s], 0.f);
      out_i[qid * K + s] = bi[s];
    }
  }
}

template <int K>
cudaError_t launch(const float* q, const float* p, const uint8_t* m, const float* c,
                   int nq, int n, float* od, int* oi, cudaStream_t stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(q, p, m, c, nq, n, od, oi);
  return cudaGetLastError();
}

}  // namespace

// queries [nq, 3] f32, points [n, 3] f32, mask [n] bool (1 byte), center [3]
// f32, all contiguous on the device; out_d [nq, k] f32, out_i [nq, k] i32.
// Launches on `stream` and returns cudaGetLastError() (cudaErrorInvalidValue
// for k outside 1..24 or empty inputs).
extern "C" int rgc_knn_launch(const void* queries, const void* points, const void* mask,
                              const void* center, int nq, int n, int k, void* out_d,
                              void* out_i, void* stream) {
  if (nq <= 0 || n <= 0) return cudaErrorInvalidValue;
  const float* q = static_cast<const float*>(queries);
  const float* p = static_cast<const float*>(points);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const float* c = static_cast<const float*>(center);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define RGC_KNN_CASE(KK) \
    case KK: return launch<KK>(q, p, m, c, nq, n, od, oi, s);
    RGC_KNN_CASE(1) RGC_KNN_CASE(2) RGC_KNN_CASE(3) RGC_KNN_CASE(4)
    RGC_KNN_CASE(5) RGC_KNN_CASE(6) RGC_KNN_CASE(7) RGC_KNN_CASE(8)
    RGC_KNN_CASE(9) RGC_KNN_CASE(10) RGC_KNN_CASE(11) RGC_KNN_CASE(12)
    RGC_KNN_CASE(13) RGC_KNN_CASE(14) RGC_KNN_CASE(15) RGC_KNN_CASE(16)
    RGC_KNN_CASE(17) RGC_KNN_CASE(18) RGC_KNN_CASE(19) RGC_KNN_CASE(20)
    RGC_KNN_CASE(21) RGC_KNN_CASE(22) RGC_KNN_CASE(23) RGC_KNN_CASE(24)
#undef RGC_KNN_CASE
    default: return cudaErrorInvalidValue;
  }
}
