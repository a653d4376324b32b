// Brute-force k-nearest-neighbour search for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel rgc_slam_tpu/ops/pallas/knn_kernel.py::knn_pallas
// (body _knn_kernel).  It computes what that kernel computes, not how:
// squared distances |q|^2 + |p|^2 - 2 q.p in float32 on coordinates centred
// on the query mean, masked points at +inf, ties to the lower index,
// distances clamped at 0 on output.  A candidate enters a sorted list on
// the lexicographic key (d, idx), the list starting from empty slots that
// rank after every distance, +inf and NaN included.  That one rule gives
// XLA top_k semantics: ties go to the lower index, and when fewer than K
// points are unmasked the unfilled slots take the lowest-index masked
// columns, so every index is in range.
//
// NaN, as the JAX function returns it on the CPU (and knn_plain): a masked
// point is +inf whatever its coordinates (it is stored as (0, 0, 0, +inf));
// a NaN distance (a NaN point, or every unmasked point of a search whose
// centre a NaN query has made NaN) ranks after +inf and before an empty
// slot, NaN distances tied and ordered by index; the clamp keeps NaN.  The
// scan pass below never marks a NaN distance (d <= gate fails), so the hot
// loop is the one without NaN handling; a list that still has an empty slot
// after it, which happens only when the chunk holds fewer than K points
// with a number for a distance, takes its NaN entries in a second pass.
//
// What bounds it.  Per (query, point) pair: one multiply and two FMAs for
// the dot product, then an add, a multiply by 2 and a subtract, 8 float32
// operations (the compare is not counted).  The mapping association's surf
// call (2048 queries x 32768 points) is 537 MFLOP, 8.0 us at the H100's
// 67 TFLOP/s outside the tensor cores, against 0.16 us for its 0.53 MB at
// 3.35 TB/s: compute-bound.  The distance matrix never leaves registers.
//
// Design.
// - Split of the point axis.  The grid is (query blocks) x S point chunks;
//   a thread owns one query.  Block (b, s) keeps the top-K of its queries
//   over the contiguous chunk s and writes it to a workspace [B, S, Q, K];
//   knn_merge_kernel merges the S sorted lists of each query and clamps.
//   With S = 1 the first kernel writes the clamped output itself.  Because
//   the key is a total order the result does not depend on the split.  The
//   split puts enough warps on all 132 SMs where one block per 128 queries
//   filled 16 of them; split_plan (ops/cuda/knn.py) chooses S.
// - Insertions in rounds.  A top-K list refills at each chunk start, where
//   most points enter some list of the warp, and an insertion taken by one
//   lane stalls the other 31.  So a thread first computes the distances of
//   32 points against its current K-th distance and marks the ones that
//   pass (8 float32 operations, a compare and an OR a pair, 32 independent
//   chains), then inserts only those, recomputing each distance bit for bit:
//   a warp runs as many insertions as its busiest lane needs, not one for
//   every point that any lane needs.
// - Keys as unsigned integers.  A distance's float bits map to an unsigned
//   key of the same order (d is never -0: it is a difference of a sum of
//   squares and twice a dot product), every NaN to 0xfffffffe, after +inf,
//   and an empty slot is 0xffffffff, after NaN.  A list then compares one
//   integer where (d, idx) took three compares: candidates arrive in ascending index within a chunk and in
//   ascending chunk in the merge, so an equal key always loses to the entry
//   already held, and insertion is K independent selects.
// - Merge by warps.  A warp merges one query: each lane holds the lists of
//   chunks lane, lane + 32, ...; then K rounds of a warp-wide argmin on
//   (key, idx) over the lanes' heads emit the output in order.
// - Tile overlap.  The point tile is double-buffered in shared memory and
//   the next tile's raw points are fetched into registers before the
//   current tile is scanned, so their load latency hides behind the scan.
//   This was chosen over a prepared float4 point array copied with
//   cp.async because it needs no third launch and no extra device buffer:
//   centring a point costs a handful of operations against the 32 to 128
//   pairs it then feeds.
// - Batch lanes.  A fleet of B robots searches B independent (queries,
//   points, mask) triples of one shape; the grid's z axis is the lane, so
//   one launch serves them all.  A lane stride of 0 lets every lane read one
//   shared tensor.  Each lane is centred on its own query mean, which a
//   first small kernel sums in an order fixed by Q alone, so a lane's
//   result is bit-identical to a launch of that lane alone.
// - One query per thread.  Owning 2 or 4 queries a thread (one shared-memory
//   read of a point for several pairs) was built and timed, and was slower
//   at every shape tried: the insertions, not the reads, cost the time, and
//   a thread with R lists runs R lanes' worth of them.
// - No tensor cores.  The dot product has depth 3, and TF32 or 3xTF32
//   would change the per-pair rounding, so near-ties would order
//   differently from the plain version.  Every distance here is computed
//   by the same float32 sequence as the first version of this kernel
//   (__fmul_rn / __fadd_rn / fmaf), bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 128;      // threads per block: 32, 64 or 128
constexpr int kPointsPerThread = 4;   // raw points each thread fetches per tile
constexpr int kMaxTile = kPointsPerThread * kMaxThreads;
constexpr int kRound = 32;            // points marked before their insertions
constexpr int kMergeThreads = 128;    // 4 queries per merge block
constexpr int kCenterThreads = 256;   // one block per batch lane
constexpr int kMaxChunks = 65535;     // gridDim.y
constexpr int kMaxLanes = 65535;      // gridDim.z
constexpr unsigned kEmpty = 0xffffffffu;
constexpr unsigned kNan = 0xfffffffeu;   // every NaN distance: after +inf (0xff800000)

// Elements from one batch lane's queries, points and mask to the next's: the
// lane's own extent, or 0 where every lane reads the same tensor.
struct LaneStrides {
  long long queries, points, mask;
};

// The key of a distance that is not NaN.
__device__ __forceinline__ unsigned order_key(float d) {
  const unsigned b = __float_as_uint(d);
  return b ^ (static_cast<unsigned>(static_cast<int>(b) >> 31) | 0x80000000u);
}

// The distance of a key that is not kNan (the scan pass's gate).
__device__ __forceinline__ float key_value(unsigned u) {
  return u == kEmpty ? INFINITY
                     : __uint_as_float((u & 0x80000000u) ? (u ^ 0x80000000u) : ~u);
}

// The output distance of any key, clamped at 0 with NaN kept (fmaxf would
// turn NaN into 0).
__device__ __forceinline__ float out_value(unsigned u) {
  const float d = u == kNan ? __uint_as_float(0x7fc00000u) : key_value(u);
  return d < 0.f ? 0.f : d;
}

// Insertion of (u, idx) into the sorted list (bk, bi) when it ranks before
// the last entry; an equal key ranks after the entries held.  Each slot
// reads its own and its predecessor's old entry before either changes.
template <int K>
__device__ __forceinline__ bool insert(unsigned (&bk)[K], int (&bi)[K], unsigned u, int idx) {
  if (!(u < bk[K - 1])) return false;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const bool shift = u < bk[s - 1];
    const bool here = u < bk[s];
    bk[s] = shift ? bk[s - 1] : (here ? u : bk[s]);
    bi[s] = shift ? bi[s - 1] : (here ? idx : bi[s]);
  }
  if (u < bk[0]) {
    bk[0] = u;
    bi[0] = idx;
  }
  return true;
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  // summed in the plain version's order: (x*x + y*y) + z*z
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float q2, float4 pt) {
  const float dot = fmaf(qx, pt.x, fmaf(qy, pt.y, __fmul_rn(qz, pt.z)));
  return __fsub_rn(__fadd_rn(q2, pt.w), 2.0f * dot);
}

// Batch lane blockIdx.x's query mean, summed in an order that depends on nq
// alone: thread t adds queries t, t + 256, ... in ascending order, then a
// fixed tree halves the 256 partial sums.  So a lane's centre, and with it
// every distance, is the same bits whatever the number of lanes.
__global__ void __launch_bounds__(kCenterThreads)
knn_center_kernel(const float* __restrict__ queries, long long lane_q, int nq,
                  float* __restrict__ center) {
  __shared__ float part[3][kCenterThreads];
  const float* q = queries + blockIdx.x * lane_q;
  float s[3] = {0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < nq; i += kCenterThreads) {
#pragma unroll
    for (int c = 0; c < 3; ++c) s[c] = __fadd_rn(s[c], q[3 * i + c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) part[c][threadIdx.x] = s[c];
  __syncthreads();
  for (int half = kCenterThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        part[c][threadIdx.x] = __fadd_rn(part[c][threadIdx.x], part[c][threadIdx.x + half]);
    }
    __syncthreads();
  }
  if (threadIdx.x < 3)
    center[3 * blockIdx.x + threadIdx.x] =
        __fdiv_rn(part[threadIdx.x][0], static_cast<float>(nq));
}

// Start the loads of one tile's raw points into registers.
__device__ __forceinline__ void fetch_tile(const float* __restrict__ points,
                                           const uint8_t* __restrict__ mask, int base, int end,
                                           float (&rx)[kPointsPerThread],
                                           float (&ry)[kPointsPerThread],
                                           float (&rz)[kPointsPerThread],
                                           bool (&rm)[kPointsPerThread]) {
#pragma unroll
  for (int j = 0; j < kPointsPerThread; ++j) {
    const int p = base + j * blockDim.x + threadIdx.x;
    if (p < end) {
      rx[j] = points[3 * p + 0];
      ry[j] = points[3 * p + 1];
      rz[j] = points[3 * p + 2];
      rm[j] = mask[p] != 0;
    }
  }
}

// Block (blockIdx.x, blockIdx.y, blockIdx.z): batch lane blockIdx.z, its
// queries [blockIdx.x * T, +T), points of chunk blockIdx.y, [blockIdx.y *
// chunk, +chunk) cut at n.  Writes the chunk's [nq, K] keys and indices into
// the batch lane's workspace or, when S = 1, its clamped [nq, K] output.
template <int K>
__global__ void __launch_bounds__(kMaxThreads)
knn_chunk_kernel(const float* __restrict__ queries, const float* __restrict__ points,
                 const uint8_t* __restrict__ mask, const float* __restrict__ center,
                 int nq, int n, int chunk, LaneStrides ls, unsigned* __restrict__ ws_key,
                 int* __restrict__ ws_idx, float* __restrict__ out_d, int* __restrict__ out_i) {
  __shared__ float4 tile[2][kMaxTile];
  const size_t batch = blockIdx.z;
  queries += batch * ls.queries;
  points += batch * ls.points;
  mask += batch * ls.mask;
  center += batch * 3;
  out_d += batch * nq * K;
  out_i += batch * nq * K;
  const int threads = blockDim.x;
  const int tile_len = kPointsPerThread * threads;
  const float cx = center[0], cy = center[1], cz = center[2];
  const int begin = blockIdx.y * chunk;
  const int end = min(n, begin + chunk);
  const int qid = blockIdx.x * threads + threadIdx.x;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qid < nq) {
    qx = queries[3 * qid + 0] - cx;
    qy = queries[3 * qid + 1] - cy;
    qz = queries[3 * qid + 2] - cz;
  }
  const float q2 = sq_norm(qx, qy, qz);
  unsigned bk[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bk[s] = kEmpty;
    bi[s] = 0x7fffffff;
  }
  float gate = INFINITY;   // the K-th entry's distance: a point above it cannot enter

  float rx[kPointsPerThread], ry[kPointsPerThread], rz[kPointsPerThread];
  bool rm[kPointsPerThread];
  fetch_tile(points, mask, begin, end, rx, ry, rz, rm);
  int buf = 0;
  for (int base = begin; base < end; base += tile_len, buf ^= 1) {
    // tile[buf] was last read two tiles ago, before the previous barrier
#pragma unroll
    for (int j = 0; j < kPointsPerThread; ++j) {
      const int p = base + j * threads + threadIdx.x;
      if (p < end) {
        const float px = rx[j] - cx, py = ry[j] - cy, pz = rz[j] - cz;
        tile[buf][j * threads + threadIdx.x] =
            rm[j] ? make_float4(px, py, pz, sq_norm(px, py, pz))
                  : make_float4(0.f, 0.f, 0.f, INFINITY);
      }
    }
    __syncthreads();
    if (base + tile_len < end) fetch_tile(points, mask, base + tile_len, end, rx, ry, rz, rm);

    const float4* t = tile[buf];
    const int count = min(tile_len, end - base);
    for (int j0 = 0; j0 < count; j0 += kRound) {
      unsigned hits = 0u;
      if (j0 + kRound <= count) {
#pragma unroll
        for (int u = 0; u < kRound; ++u)
          hits |= (sq_dist(qx, qy, qz, q2, t[j0 + u]) <= gate ? 1u : 0u) << u;
      } else {
        for (int u = 0; j0 + u < count; ++u)
          hits |= (sq_dist(qx, qy, qz, q2, t[j0 + u]) <= gate ? 1u : 0u) << u;
      }
      while (hits) {             // in ascending index
        const int u = __ffs(hits) - 1;
        hits &= hits - 1;
        const float d = sq_dist(qx, qy, qz, q2, t[j0 + u]);
        if (insert<K>(bk, bi, order_key(d), base + j0 + u)) gate = key_value(bk[K - 1]);
      }
    }
  }

  // The NaN pass: with an empty slot left, every point whose distance is a
  // number is in the list, so the chunk's NaN distances follow in ascending
  // index, recomputed bit for bit from the points as the tile held them.  A
  // NaN query (its lane's centre, and so all its queries, NaN) made every
  // distance NaN above: its masked points enter here, at +inf.
  if (bk[K - 1] == kEmpty) {
    const bool qnan = q2 != q2;
    for (int p = begin; p < end; ++p) {
      const bool m = mask[p] != 0;
      const float px = points[3 * p + 0] - cx, py = points[3 * p + 1] - cy,
                  pz = points[3 * p + 2] - cz;
      const float4 pt = m ? make_float4(px, py, pz, sq_norm(px, py, pz))
                          : make_float4(0.f, 0.f, 0.f, INFINITY);
      const float d = sq_dist(qx, qy, qz, q2, pt);
      if (d == d) continue;        // entered in the scan pass
      insert<K>(bk, bi, (qnan && !m) ? order_key(INFINITY) : kNan, p);
    }
  }

  if (qid < nq) {
    if (gridDim.y == 1) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_d[qid * K + s] = out_value(bk[s]);
        out_i[qid * K + s] = bi[s];
      }
    } else {
      const size_t off = ((batch * gridDim.y + blockIdx.y) * nq + qid) * K;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        ws_key[off + s] = bk[s];
        ws_idx[off + s] = bi[s];
      }
    }
  }
}

// One warp per query of batch lane blockIdx.y: lane l of the warp merges
// the lists of chunks l, l + 32, ... in ascending chunk order; then K rounds
// of a warp-wide argmin on (key, idx) over the lanes' heads pop the next
// output entry from the lane that holds it (each index lies in one chunk,
// so exactly one lane).
template <int K>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge_kernel(const unsigned* __restrict__ ws_key, const int* __restrict__ ws_idx, int nq,
                 int chunks, float* __restrict__ out_d, int* __restrict__ out_i) {
  const int q = blockIdx.x * (kMergeThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (q >= nq) return;                       // the whole warp
  const size_t stride = static_cast<size_t>(nq) * K;   // one chunk's lists to the next
  const size_t batch = blockIdx.y;
  ws_key += batch * chunks * stride;
  ws_idx += batch * chunks * stride;
  out_d += batch * stride;
  out_i += batch * stride;
  const unsigned* lk = ws_key + static_cast<size_t>(q) * K;
  const int* li = ws_idx + static_cast<size_t>(q) * K;
  unsigned bk[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bk[s] = kEmpty;
    bi[s] = 0x7fffffff;
  }
  for (int c = lane; c < chunks; c += 32) {
    unsigned ek[K];
    int ei[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      ek[j] = lk[c * stride + j];
      ei[j] = li[c * stride + j];
    }
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (!insert<K>(bk, bi, ek[j], ei[j])) break;    // the list is sorted
  }
  unsigned mine_k = kEmpty;
  int mine_i = 0x7fffffff;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    unsigned wk = bk[0];
    int wi = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned ok = __shfl_xor_sync(0xffffffffu, wk, off);
      const int oi = __shfl_xor_sync(0xffffffffu, wi, off);
      if (ok < wk || (ok == wk && oi < wi)) {
        wk = ok;
        wi = oi;
      }
    }
    if (bk[0] == wk && bi[0] == wi) {        // this lane's head went out
#pragma unroll
      for (int s = 0; s < K - 1; ++s) {
        bk[s] = bk[s + 1];
        bi[s] = bi[s + 1];
      }
      bk[K - 1] = kEmpty;
      bi[K - 1] = 0x7fffffff;
    }
    if (lane == t) {
      mine_k = wk;
      mine_i = wi;
    }
  }
  if (lane < K) {
    out_d[static_cast<size_t>(q) * K + lane] = out_value(mine_k);
    out_i[static_cast<size_t>(q) * K + lane] = mine_i;
  }
}

struct Args {
  const float* q;
  const float* p;
  const uint8_t* m;
  float* c;
  int lanes, nq, n, threads, chunks, chunk;
  LaneStrides ls;
  unsigned* ws_key;
  int* ws_idx;
  float* od;
  int* oi;
  cudaStream_t stream;
};

template <int K>
cudaError_t launch(const Args& a) {
  knn_center_kernel<<<a.lanes, kCenterThreads, 0, a.stream>>>(a.q, a.ls.queries, a.nq, a.c);
  const dim3 grid((a.nq + a.threads - 1) / a.threads, a.chunks, a.lanes);
  knn_chunk_kernel<K><<<grid, a.threads, 0, a.stream>>>(a.q, a.p, a.m, a.c, a.nq, a.n, a.chunk,
                                                        a.ls, a.ws_key, a.ws_idx, a.od, a.oi);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.chunks == 1) return err;
  const int per_block = kMergeThreads / 32;
  const dim3 merge_grid((a.nq + per_block - 1) / per_block, a.lanes);
  knn_merge_kernel<K><<<merge_grid, kMergeThreads, 0, a.stream>>>(
      a.ws_key, a.ws_idx, a.nq, a.chunks, a.od, a.oi);
  return cudaGetLastError();
}

}  // namespace

// `lanes` independent searches in one launch.  Lane b reads queries [nq, 3]
// f32 at queries + b * lane_q, points [n, 3] f32 at points + b * lane_p, mask
// [n] bool (1 byte) at mask + b * lane_m (strides in elements, each the
// lane's extent or 0), and writes its query mean to center [lanes, 3] f32
// (a first kernel) and its results to out_d [lanes, nq, k] f32 and out_i
// [lanes, nq, k] i32; every lane's block is contiguous on the device.  Blocks of `threads` (32, 64 or 128) queries; the points are cut
// into `chunks` chunks of `chunk` points, the last one ragged, none empty.
// With chunks > 1, ws_key / ws_idx hold lanes * chunks * nq * k 32-bit entries
// of workspace and a second kernel merges.  Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments outside these
// rules, or k outside 1..24).
extern "C" int rgc_knn_launch(const void* queries, const void* points, const void* mask,
                              void* center, int lanes, long long lane_q,
                              long long lane_p, long long lane_m, int nq, int n, int k,
                              int threads, int chunks, int chunk, void* ws_key, void* ws_idx,
                              void* out_d, void* out_i, void* stream) {
  if (lanes <= 0 || lanes > kMaxLanes || nq <= 0 || n <= 0 || chunk <= 0 || chunks <= 0 ||
      chunks > kMaxChunks)
    return cudaErrorInvalidValue;
  if (lane_q < 0 || lane_p < 0 || lane_m < 0) return cudaErrorInvalidValue;
  if (threads != 32 && threads != 64 && threads != 128) return cudaErrorInvalidValue;
  if (static_cast<long long>(chunks) * chunk < n ||
      static_cast<long long>(chunks - 1) * chunk >= n)
    return cudaErrorInvalidValue;
  if (chunks > 1 && (ws_key == nullptr || ws_idx == nullptr)) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(queries), static_cast<const float*>(points),
               static_cast<const uint8_t*>(mask),  static_cast<float*>(center),
               lanes, nq, n, threads, chunks, chunk, LaneStrides{lane_q, lane_p, lane_m},
               static_cast<unsigned*>(ws_key), static_cast<int*>(ws_idx),
               static_cast<float*>(out_d), static_cast<int*>(out_i),
               static_cast<cudaStream_t>(stream)};
  switch (k) {
#define RGC_KNN_CASE(KK) \
    case KK: return launch<KK>(a);
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
