// k nearest neighbours of 3-D points, coordinate form (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/grouping.py:_knn_kernel (wrapper
// knn_indices_pallas; its wide feature-space sibling _knn_kernel_wide is
// csrc/knn_wide.cu). Contract:
//   query (B, M, 3) f32, ref (B, N, 3) f32, 1 <= k <= min(N, 64);
//   idx[b, i, :] = the k refs nearest to query i, ascending by distance,
//   ties to the smaller index (B, M, k) int64.
// The distance is the diff form ((qx-rx)^2 + (qy-ry)^2) + (qz-rz)^2 rounded
// op by op (__fsub_rn/__fmul_rn/__fadd_rn: no FMA contraction), exactly as
// the plain PyTorch version ops/grouping.py:_knn_plain computes it, so both
// select identical indices. The TPU kernel packed the index into the low
// bits of the distance and so selected at 2^-(23-idx_bits) relative; that
// is an economy of its sort, not part of the contract.
//
// What bounds it on this card: instruction issue on the CUDA cores. A pair
// costs 3 sub, 3 mul and 2 add (none fuses under the contract) and the
// compare against the query's k-th distance: the floor is 9 instructions a
// pair at 132 SMs x 128 lanes a clock, 0.081 ms at (32, 3072)^2 and 1.98
// GHz. The clouds are a few MB, so bytes do not bound it, and with 3
// channels a tensor-core product would be almost all padding (and rounds
// the expansion form, not this one).
//
// Design.
// - Distances. A block of 128 threads owns 128 P queries of one cloud
//   (thread t: queries i0 + t + 128 u, u < P; P is the plan's, 1, or 2 at
//   K <= 16 where the cloud's queries still fill the card) and one part of
//   its refs. The query coordinates live in registers; the refs stream
//   through shared memory in tiles of kTile, staged as float4 (x, y, z,
//   unused) by cp.async into a double buffer (the next tile lands while
//   this one is used) and read by broadcast, one read serving P queries.
//   Slots past the part's end hold +inf: their distance is inf or NaN, and
//   neither passes a compare.
// - Selection (the thread queues of Johnson, Douze and Jegou,
//   "Billion-scale similarity search with GPUs", 2017, as in
//   csrc/knn_wide.cu). Each query keeps its sorted top-K list (distance,
//   index) in registers, K the compile-time bucket 4, 8, 16, 24, 32 or 64
//   >= k, and a threshold thr, the list's k-th distance as of its last
//   merge. A thread takes kBatch / P refs at a time for each of its
//   queries; a distance below thr goes into the query's queue (two batches
//   of (distance, index) slots in a column of shared memory) by one
//   predicated store and one predicated add of the cursor. When some lane
//   of the warp could overflow on the next batch (__any_sync), every lane
//   merges its queues into its lists by sorted insertion with strict < (3
//   instructions a step), and thr is read again. So the warp pays the
//   K-step insertion once per hit of its slowest lane between merges, not
//   once per hit of any lane, as the previous kernel did (it inserted at
//   once, in a warp whose lanes hit at different refs). A warp-cooperative
//   (bitonic) merge was not built: with a query a lane, it would merge the
//   warp's 32 queries one by one, about 6 shuffle stages of ~8
//   instructions for each, some 1.5k instructions a lane a merge, where the
//   insertions of the slowest lane's at most 32 hits cost about 32 x 3 K
//   (2.3k at K 24, but ~9 hits a merge on average at VRCNet's shapes).
//   A part of at most kDirectRefs refs with a list of 4 (ECG's 64-point
//   three_nn) skips the queue and inserts each distance at once, as the
//   previous kernel did: a queue's first batches all enter the list, and
//   so few refs never amortise them.
// - Ties. Refs reach a query's queue in ascending index, a queue merges in
//   its order, and the list holds only refs of earlier batches: so an entry
//   of the list that ties an arriving one always has the smaller index,
//   and strict < puts the arrival behind it. A stale thr (the list has
//   improved since) only admits extra hits, which the insertion then
//   places at or beyond position k; it never drops a true neighbour, since
//   a ref at or above the old k-th distance is at or above the new one,
//   and one equal to it has the larger index.
// - Launch plan (the wrapper's, ops/grouping.py:_knn_plan). Grid (query
//   blocks, B, parts). Where the blocks would leave SMs idle (VRCNet's
//   384-point pk, ECG's 256-point pooling, the three_nn of small levels),
//   the refs split into parts of consecutive indices, at least k each;
//   every part writes its first k (distance, index) to scratch, and
//   knn_merge_kernel inserts the parts' lists in part order with the same
//   strict <, stopping at a part's first entry that does not beat the
//   k-th. Every index of a later part exceeds every index of an earlier
//   one, so the tie rule holds across parts. A part pays its own start
//   (its first refs all enter its list) and the merge a launch, so parts
//   stay at 512 refs or more (256 where K is 4). Clouds of at most 256
//   refs and fewer than 64 queries (get_uniform_loss's thousands of balls
//   of 4-24 points) are packed:
//   knn_packed_kernel gives each (cloud, query) row a lane, 128 rows a
//   block across clouds, reads the cloud's refs from global memory (L1)
//   and inserts at once. Its grid is one-dimensional, so it takes any
//   B * M below 2^31; the entry still asks B < 65536, as the other grid
//   does.
//
// Variants timed side by side by scripts/time_knn_variants.py (PERF.md has
// the readings, NVIDIA H100 80GB HBM3 at 700 W): the plan's queries a
// thread, blocks an SM and least part, 8 pairs a batch, the refs read as
// 16 bytes or as 8 + 4, no K 24 bucket, lists of 4 always queued, a
// variant that never queues a hit (the distance loop alone), and the
// queue's store and load written in C++, which the compiler branched
// around (a reconvergence point and the slot's address recomputed for
// every pair).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;         // threads a block
constexpr int kTile = 512;            // refs a shared-memory tile
constexpr int kBatch = 16;            // pairs a thread takes at once
constexpr int kQueueBatches = 2;      // a query's queue holds this many
constexpr int kTwoMaxK = 16;          // two queries a thread up to this K
// a part of at most kDirectRefs refs inserts at once into lists this short
constexpr int kDirectMaxK = 4;
constexpr int kDirectRefs = 128;

// refs a thread takes at once for each of its P queries
__host__ __device__ constexpr int sub_of(int P) { return kBatch / P; }

// Blocks an SM must hold (at least two): the register lists take 2 K P.
__host__ __device__ constexpr int min_blocks(int K, int P) {
  return 2 * K * P >= 128 ? 2 : 2 * K * P >= 64 ? 3 : 4;
}

__device__ __forceinline__ float sqdist(float qx, float qy, float qz,
                                        float rx, float ry, float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int K>
__device__ __forceinline__ void list_init(float (&d)[K], int (&j)[K]) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    d[t] = INFINITY;
    j[t] = 0;
  }
}

// Sorted insertion into the top-K list; an equal entry stays ahead.
template <int K>
__device__ __forceinline__ void insert(float x, int jx, float (&d)[K],
                                       int (&j)[K]) {
  if (!(x < d[K - 1])) return;
#pragma unroll
  for (int t = K - 1; t > 0; --t) {
    // d[t] and d[t - 1] still hold their old values here
    if (x < d[t]) {
      const bool up = x < d[t - 1];
      d[t] = up ? d[t - 1] : x;
      j[t] = up ? j[t - 1] : jx;
    }
  }
  if (x < d[0]) {
    d[0] = x;
    j[0] = jx;
  }
}

// The list's k-th distance (k <= K).
template <int K>
__device__ __forceinline__ float kth(const float (&d)[K], int k) {
  float v = d[0];
#pragma unroll
  for (int t = 1; t < K; ++t) v = t == k - 1 ? d[t] : v;
  return v;
}

// The list's first k entries: to out when the refs are one part, else to
// the part's slot of the scratch lists.
template <int K>
__device__ __forceinline__ void finish(const float (&d)[K], const int (&j)[K],
                                       int k, size_t row, size_t rows,
                                       long long* out, float* part_d,
                                       int* part_j) {
  if (gridDim.z == 1) {
    long long* op = out + row * k;
#pragma unroll
    for (int t = 0; t < K; ++t)
      if (t < k) op[t] = j[t];
  } else {
    const size_t base = ((size_t)blockIdx.z * rows + row) * k;
#pragma unroll
    for (int t = 0; t < K; ++t)
      if (t < k) {
        part_d[base + t] = d[t];
        part_j[base + t] = j[t];
      }
  }
}

// A hit (x < thr) into the queue at cursor qp, a shared-window address that
// then moves to the next slot. Predicated PTX: written in C++, the compiler
// branched around each store (a reconvergence point and the slot's address
// recomputed per pair). The queue is only ever touched by these statements
// and take(), all volatile, so they keep their order.
__device__ __forceinline__ void push(float x, float thr, int jx,
                                     unsigned& qp) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.lt.f32 p, %1, %2;\n\t"
      "@p st.shared.v2.b32 [%0], {%3, %4};\n\t"
      "@p add.u32 %0, %0, %5;\n\t}"
      : "+r"(qp)
      : "f"(x), "f"(thr), "r"(__float_as_uint(x)), "r"(jx),
        "n"(kThreads * 8));
}

// The queue slot at address a: (distance, index).
__device__ __forceinline__ void take(unsigned a, float& x, int& jx) {
  unsigned xb;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];"
               : "=r"(xb), "=r"(jx)
               : "r"(a));
  x = __uint_as_float(xb);
}

// Every query's queue (slots from qbase up to the cursor qp) into its
// list, in queue order; thr read again.
template <int K, int P>
__device__ __forceinline__ void merge(const unsigned (&qbase)[P], int k,
                                      float (&d)[P][K], int (&j)[P][K],
                                      unsigned (&qp)[P], float (&thr)[P]) {
#pragma unroll
  for (int u = 0; u < P; ++u) {
    for (unsigned a = qbase[u]; a < qp[u]; a += kThreads * 8) {
      float x;
      int jx;
      take(a, x, jx);
      insert<K>(x, jx, d[u], j[u]);
    }
    qp[u] = qbase[u];
    thr[u] = kth<K>(d[u], k);
  }
}

template <int K, int P, bool kDirect>
__global__ void __launch_bounds__(kThreads, min_blocks(K, P))
knn_kernel(const float* __restrict__ query, const float* __restrict__ ref,
           int m, int n, int len, int k, long long* __restrict__ out,
           float* __restrict__ part_d, int* __restrict__ part_j) {
  constexpr int S = sub_of(P), Q = kQueueBatches * S;
  static_assert(kTile % S == 0 && Q >= 2 * S, "tile and queue");
  __shared__ float4 tiles[2][kTile];
  // queue slot s of a thread's query u: (distance, index bits)
  __shared__ float2 queue[P][Q][kThreads];

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * (kThreads * P) + threadIdx.x;
  const int jb = blockIdx.z * len, je = min(n, jb + len);
  const float* rp = ref + (size_t)b * n * 3;

  float qx[P], qy[P], qz[P], thr[P];
  float d[P][K];
  int j[P][K];
  // the queue column's first slot and the write cursor, shared-window
  // addresses; a batch may start while the cursor is at most qfull
  unsigned qbase[P], qp[P];
  constexpr unsigned qfull = (Q - S) * kThreads * 8;
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const float* q =
        query + ((size_t)b * m + min(i0 + u * kThreads, m - 1)) * 3;
    qx[u] = q[0];
    qy[u] = q[1];
    qz[u] = q[2];
    list_init<K>(d[u], j[u]);
    thr[u] = INFINITY;
    qbase[u] = static_cast<unsigned>(
        __cvta_generic_to_shared(&queue[u][0][threadIdx.x]));
    qp[u] = qbase[u];
  }

  // refs [j0, j0 + kTile) of the part into buffer t & 1, slots past it +inf
  auto stage = [&](int t) {
    const int j0 = jb + t * kTile;
    float* dst = reinterpret_cast<float*>(tiles[t & 1]);
    for (int e = threadIdx.x; e < 3 * kTile; e += kThreads) {
      const int r = e / 3;
      if (j0 + r < je)
        __pipeline_memcpy_async(dst + e + r, rp + (size_t)j0 * 3 + e, 4);
      else
        dst[e + r] = INFINITY;
    }
    __pipeline_commit();
  };

  const int ntiles = (je - jb + kTile - 1) / kTile;
  stage(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles)
      stage(t + 1);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float4* tile = tiles[t & 1];
    const int j0 = jb + t * kTile;
    const int tlen = min(kTile, je - j0);
    for (int s0 = 0; s0 < tlen; s0 += S) {
      float4 w[S];
#pragma unroll
      for (int r = 0; r < S; ++r) w[r] = tile[s0 + r];
      if constexpr (kDirect) {
#pragma unroll
        for (int u = 0; u < P; ++u)
#pragma unroll
          for (int r = 0; r < S; ++r)
            insert<K>(sqdist(qx[u], qy[u], qz[u], w[r].x, w[r].y, w[r].z),
                      j0 + s0 + r, d[u], j[u]);
      } else {
        bool full = false;
#pragma unroll
        for (int u = 0; u < P; ++u) {
#pragma unroll
          for (int r = 0; r < S; ++r)
            push(sqdist(qx[u], qy[u], qz[u], w[r].x, w[r].y, w[r].z),
                 thr[u], j0 + s0 + r, qp[u]);
          full |= qp[u] - qbase[u] > qfull;
        }
        if (__any_sync(0xffffffffu, full))
          merge<K, P>(qbase, k, d, j, qp, thr);
      }
    }
    __syncthreads();  // buffer t & 1 is refilled by stage(t + 2)
  }
  merge<K, P>(qbase, k, d, j, qp, thr);
#pragma unroll
  for (int u = 0; u < P; ++u) {
    const int i = i0 + u * kThreads;
    if (i < m)
      finish<K>(d[u], j[u], k, (size_t)b * m + i, (size_t)gridDim.y * m, out,
                part_d, part_j);
  }
}

// Packed clouds: a lane per (cloud, query) row, rows = b * m.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_packed_kernel(const float* __restrict__ query,
                  const float* __restrict__ ref, int rows, int m, int n,
                  int k, long long* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  const float* qp = query + (size_t)row * 3;
  const float qx = qp[0], qy = qp[1], qz = qp[2];
  const float* rp = ref + (size_t)(row / m) * n * 3;
  float d[K];
  int j[K];
  list_init<K>(d, j);
  for (int jj = 0; jj < n; ++jj)
    insert<K>(sqdist(qx, qy, qz, rp[3 * jj], rp[3 * jj + 1], rp[3 * jj + 2]),
              jj, d, j);
  long long* op = out + (size_t)row * k;
#pragma unroll
  for (int t = 0; t < K; ++t)
    if (t < k) op[t] = j[t];
}

// The parts' lists of each (cloud, query) row, in part order, into one.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part_d,
                 const int* __restrict__ part_j, size_t rows, int parts,
                 int k, long long* __restrict__ out) {
  const size_t row = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  float d[K];
  int j[K];
  list_init<K>(d, j);
#pragma unroll
  for (int t = 0; t < K; ++t)  // part 0's list is sorted: taken as it is
    if (t < k) {
      d[t] = part_d[row * k + t];
      j[t] = part_j[row * k + t];
    }
  float thr = kth<K>(d, k);
  for (int p = 1; p < parts; ++p) {
    const size_t base = ((size_t)p * rows + row) * k;
    // a part's list is sorted: once an entry does not beat the k-th, no
    // later one of the part does (an equal one has the larger index)
    for (int t = 0; t < k && part_d[base + t] < thr; ++t) {
      insert<K>(part_d[base + t], part_j[base + t], d, j);
      thr = kth<K>(d, k);
    }
  }
  long long* op = out + row * k;
#pragma unroll
  for (int t = 0; t < K; ++t)
    if (t < k) op[t] = j[t];
}

struct Args {
  const float* query;
  const float* ref;
  int b, m, n, k, len, parts, per;
  long long* out;
  float* part_d;
  int* part_j;
  cudaStream_t s;
};

template <int K, int P>
void launch_search(const Args& a) {
  const dim3 grid((a.m + kThreads * P - 1) / (kThreads * P), a.b, a.parts);
  // a queue's first batches all enter the list; few refs never amortise it
  if constexpr (K <= kDirectMaxK) {
    if (min(a.len, a.n) <= kDirectRefs) {
      knn_kernel<K, P, true><<<grid, kThreads, 0, a.s>>>(
          a.query, a.ref, a.m, a.n, a.len, a.k, a.out, a.part_d, a.part_j);
      return;
    }
  }
  knn_kernel<K, P, false><<<grid, kThreads, 0, a.s>>>(
      a.query, a.ref, a.m, a.n, a.len, a.k, a.out, a.part_d, a.part_j);
}

template <int K>
cudaError_t launch(const Args& a) {
  if (a.per == 0) {
    const int rows = a.b * a.m;
    knn_packed_kernel<K><<<(rows + kThreads - 1) / kThreads, kThreads, 0,
                           a.s>>>(a.query, a.ref, rows, a.m, a.n, a.k, a.out);
    return cudaGetLastError();
  }
  if constexpr (K <= kTwoMaxK) {
    if (a.per == 2)
      launch_search<K, 2>(a);
    else
      launch_search<K, 1>(a);
  } else {
    launch_search<K, 1>(a);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.parts == 1) return err;
  const size_t rows = (size_t)a.b * a.m;
  knn_merge_kernel<K>
      <<<static_cast<unsigned>((rows + kThreads - 1) / kThreads), kThreads, 0,
         a.s>>>(a.part_d, a.part_j, rows, a.parts, a.k, a.out);
  return cudaGetLastError();
}

}  // namespace

// Largest k the kernel takes.
extern "C" int houv_knn_max_k() { return 64; }

// query: (b, m, 3) f32, ref: (b, n, 3) f32, out: (b, m, k) int64;
// 1 <= k <= min(n, houv_knn_max_k()), 1 <= b < 65536, m >= 1.
// The wrapper's plan: per, the queries a thread (1, or 2 at k <= 16), or 0
// for packed clouds (a lane per (cloud, query) row, one part, b * m <
// 2^31); len, the refs a part; with more than one part, scratch holds
// 2 * parts * b * m * k words (the parts' distances, then indices).
extern "C" int houv_knn(const float* query, const float* ref, int b, int m,
                        int n, int k, int per, int len, void* scratch,
                        long long* out, void* stream) {
  if (k < 1 || k > n || b < 1 || b > 65535 || m < 1 || len < 1 ||
      per < 0 || per > (k <= kTwoMaxK ? 2 : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = (n + len - 1) / len;
  if (parts > 65535 || (parts > 1 && (scratch == nullptr || len < k)) ||
      (per == 0 && (parts > 1 || (long long)b * m > 0x7fffffffLL)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_d = static_cast<float*>(scratch);
  int* part_j = parts > 1 ? reinterpret_cast<int*>(
                                part_d + (size_t)parts * b * m * k)
                          : nullptr;
  const Args a{query, ref, b, m, n, k, len, parts, per, out, part_d, part_j,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (k <= 4)
    err = launch<4>(a);
  else if (k <= 8)
    err = launch<8>(a);
  else if (k <= 16)
    err = launch<16>(a);
  else if (k <= 24)
    err = launch<24>(a);
  else if (k <= 32)
    err = launch<32>(a);
  else if (k <= 64)
    err = launch<64>(a);
  return static_cast<int>(err);
}
