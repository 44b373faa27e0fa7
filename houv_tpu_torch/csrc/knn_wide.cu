// k nearest neighbours in feature space, any channel count (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/grouping.py:_knn_kernel_wide (wrapper
// knn_indices_pallas, which took it for C > 8; here it serves every C other
// than 3, which goes to csrc/knn.cu). Contract:
//   query (B, M, C) f32, ref (B, N, C) f32, C >= 1, 1 <= k <= min(N, 64);
//   idx[b, i, :] = the k refs nearest to query i, ascending by distance,
//   ties to the smaller index (B, M, k) int64.
//
// Arithmetic: the diff form d = sum_c (q_c - r_c)^2, accumulated in
// ascending c from +0 and rounded op by op (__fsub_rn/__fmul_rn/__fadd_rn:
// no FMA contraction), exactly as the plain PyTorch version computes it, so
// both select identical indices and a point's distance to itself is exactly
// 0. One thread owns a pair's whole sum: splitting its channels over threads
// would change the rounding. The TPU kernel took |q|^2 - 2 q.r + |r|^2 from
// its matrix unit and clamped at 0; that form is an economy of that unit,
// not part of the contract, and is not carried over.
//
// Floor: 3 f32 instructions per (pair, channel), none an FMA, at 132 SMs x
// 128 lanes a clock: (32, 3072, 256)^2 is 6.93 ms at 1.98 GHz, (32, 3072,
// 24)^2 0.65 ms. It stays on the CUDA cores: a tensor-core product needs the
// expansion form, whose rounding the plain version would have to copy, and a
// TF32 or bf16 candidate pass can drop a true neighbour before an exact
// re-rank. Besides the ALU, a thread reads each ref value it uses from
// shared memory: at one query a thread that is one read per 3
// instructions, and halving them pays at 256 channels (11.1 ms at one query
// a thread, 10.0 at two: scripts/time_knn_wide_variants.py, NVIDIA H100
// 80GB HBM3 at 700 W).
//
// Distances. Reference rows go through shared memory by cp.async into a
// double buffer (the next tile lands while this one is used) and are read
// by broadcast, four channels per 16-byte read.
// - C in {24, 48, 64} (ECG's DenseConv, VRCNet's second EFExpansion), k <=
//   16: one query per thread, 128 a block; the query row lives in
//   registers; a tile holds 64 refs of all C channels; a thread sums 16
//   refs at a time (8 above 24 channels), channel by channel, the sums side
//   by side.
// - C = 256 (VRCNet's first EFExpansion), k <= 16, and every other C or k
//   (run-time C): two queries per thread, 128 a block, so each ref value
//   read serves two sums; a tile is 32 refs; the channels come in chunks of
//   16, the block's 128 query rows and the tile's 32 ref rows of a chunk
//   staged together (query rows padded to 20 floats: conflict-free 16-byte
//   reads; channels past C staged as 0 on both sides add exactly +0); a
//   thread keeps its 2 x 32 partial sums in registers across the chunks.
// Either way no distance goes through shared memory unless it enters the
// selection. (Two queries a thread on the register path cost more
// registers than they save reads: slower at every path width in the
// variants tried.)
//
// Selection (after the thread queues of Johnson, Douze and Jegou,
// "Billion-scale similarity search with GPUs", 2017). Each thread keeps a
// query's sorted top-K list in registers (K, a compile-time bucket >= k) and
// tests each finished distance against the list's last entry, the threshold.
// On the register path a hit goes into the query's queue, twice the refs
// summed at once, in a column of shared memory; the queue is merged into the
// list (sorted insertion, strict <) when some lane of the warp may overflow
// on the next refs, so a merge serves many hits. On the chunk path a hit is
// inserted at once: at its path's shape, 256 channels and k 4, a pair costs
// 768 instructions and an insertion a few.
// Refs reach a thread in ascending index, and every entry of the list came
// from an earlier insertion, so an entry that ties an arriving one always
// has the smaller index: strict < keeps ties to the smaller index, and a
// stale threshold drops only refs that cannot enter the top k.
//
// Launch plan (the wrapper's, ops/grouping.py:_wide_plan). Grid (query
// tiles, B, parts): where B * ceil(M / 128) blocks would leave SMs idle
// (ECG's 256- and 64-point levels), the refs split into parts of consecutive
// indices, at least k and a multiple of 16 each; every part writes its
// top-k (distance, index) list to scratch, and a merge kernel inserts the
// parts' lists in part order with the same strict <. Every index of a later
// part exceeds every index of an earlier one, so the tie rule holds across
// parts too. The dynamic shared-memory limit is raised once per device.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kQueries = 128;         // queries per block
// register path: one query per thread
constexpr int kTile = 64;             // refs per tile
// refs a thread sums at once; its queue holds twice as many
__host__ __device__ constexpr int sub_of(int c) { return c <= 24 ? 16 : 8; }
// chunk path: two queries per thread, i0 + t and i0 + t + kCThreads
constexpr int kPer = 2;
constexpr int kCThreads = kQueries / kPer;
constexpr int kCTile = 32;            // refs per tile
constexpr int kGroup = 16;            // refs read at once
constexpr int kChunk = 16;            // channels per chunk
constexpr int kQStride = kChunk + 4;  // padded query row of a chunk
static_assert(kTile % 16 == 0 && kCTile % kGroup == 0, "tile sizes");

__device__ __forceinline__ float lane(const float4& w, int e) {
  return e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
}

__device__ __forceinline__ float add_sq(float acc, float q, float r) {
  const float d = __fsub_rn(q, r);
  return __fadd_rn(acc, __fmul_rn(d, d));
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

// qd, qj: a query's queue column (slot s at s * kQueries)
template <int K>
__device__ __forceinline__ void push(float x, int jx, bool ok, float* qd,
                                     int* qj, int& qn, const float (&d)[K]) {
  if (ok && x < d[K - 1]) {
    qd[qn * kQueries] = x;
    qj[qn * kQueries] = jx;
    ++qn;
  }
}

template <int K>
__device__ __forceinline__ void flush(const float* qd, const int* qj, int qn,
                                      float (&d)[K], int (&j)[K]) {
  for (int s = 0; s < qn; ++s) insert<K>(qd[s * kQueries], qj[s * kQueries],
                                         d, j);
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

// The query row in registers, C a multiple of 4, 16-byte aligned rows; one
// query per thread.
template <int K, int C>
__global__ void __launch_bounds__(kQueries, 4)
knn_wide_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                int m, int n, int len, int k, long long* __restrict__ out,
                float* __restrict__ part_d, int* __restrict__ part_j) {
  static_assert(C % 4 == 0, "rows of whole float4s");
  constexpr int V = C / 4;
  constexpr int S = sub_of(C), Q = 2 * S;
  extern __shared__ float4 smem[];
  float4* tiles = smem;                                  // [2][kTile][V]
  float* queue = reinterpret_cast<float*>(tiles + 2 * kTile * V);
  float* qd = queue + threadIdx.x;                       // [Q][kQueries]
  int* qj = reinterpret_cast<int*>(queue + Q * kQueries) + threadIdx.x;

  const int b = blockIdx.y;
  const int i = blockIdx.x * kQueries + threadIdx.x;
  const int jb = blockIdx.z * len, je = min(n, jb + len);
  const float4* r4 = reinterpret_cast<const float4*>(ref + (size_t)b * n * C);

  float q[C];
  {
    const float4* q4 = reinterpret_cast<const float4*>(
        query + ((size_t)b * m + min(i, m - 1)) * C);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 w = q4[v];
      q[4 * v] = w.x;
      q[4 * v + 1] = w.y;
      q[4 * v + 2] = w.z;
      q[4 * v + 3] = w.w;
    }
  }
  float d[K];
  int j[K];
  list_init<K>(d, j);
  int qn = 0;

  // refs [j0, j0 + kTile) of the part into buffer t & 1, rows past it as 0
  auto stage = [&](int t) {
    const int j0 = jb + t * kTile;
    float4* dst = tiles + (t & 1) * kTile * V;
    for (int e = threadIdx.x; e < kTile * V; e += kQueries) {
      const bool ok = j0 + e / V < je;
      __pipeline_memcpy_async(dst + e, ok ? r4 + (size_t)j0 * V + e : r4,
                              16, ok ? 0 : 16);
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
    const float4* tile = tiles + (t & 1) * kTile * V;
    const int j0 = jb + t * kTile;
    const int tlen = min(kTile, je - j0);
    for (int s0 = 0; s0 < tlen; s0 += S) {
      float acc[S];
#pragma unroll
      for (int r = 0; r < S; ++r) acc[r] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float4 w[S];
#pragma unroll
        for (int r = 0; r < S; ++r) w[r] = tile[(s0 + r) * V + v];
        // channel by channel, the S independent sums side by side
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < S; ++r)
            acc[r] = add_sq(acc[r], q[4 * v + e], lane(w[r], e));
      }
#pragma unroll
      for (int r = 0; r < S; ++r)
        push<K>(acc[r], j0 + s0 + r, s0 + r < tlen, qd, qj, qn, d);
      if (__any_sync(0xffffffffu, qn > Q - S)) {
        flush<K>(qd, qj, qn, d, j);
        qn = 0;
      }
    }
    __syncthreads();  // buffer t & 1 is refilled by stage(t + 2)
  }
  flush<K>(qd, qj, qn, d, j);
  if (i < m)
    finish<K>(d, j, k, (size_t)b * m + i, (size_t)gridDim.y * m, out, part_d,
              part_j);
}

// Channels in chunks. C > 0: rows of whole, 16-byte aligned float4s, copied
// 16 bytes at a time; C == 0: the channel count c_rt at run time, copied 4
// bytes at a time. Thread t holds queries i0 + t and i0 + t + kCThreads.
template <int K, int C>
__global__ void __launch_bounds__(kCThreads)
knn_wide_chunk_kernel(const float* __restrict__ query,
                      const float* __restrict__ ref, int m, int n, int c_rt,
                      int len, int k, long long* __restrict__ out,
                      float* __restrict__ part_d, int* __restrict__ part_j) {
  static_assert(C % 4 == 0, "rows of whole float4s");
  const int c = C > 0 ? C : c_rt;
  extern __shared__ float4 smem[];
  float* sq = reinterpret_cast<float*>(smem);   // [2][kQueries][kQStride]
  float* sr = sq + 2 * kQueries * kQStride;     // [2][kCTile][kChunk]

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kQueries;
  const int jb = blockIdx.z * len, je = min(n, jb + len);
  const float* qp = query + (size_t)b * m * c;
  const float* rp = ref + (size_t)b * n * c;
  const int nch = (c + kChunk - 1) / kChunk;
  const int ntiles = (je - jb + kCTile - 1) / kCTile;
  const int nstages = ntiles * nch;

  // stage s: tile s / nch, channels from (s % nch) * kChunk, into buffer s & 1
  auto stage = [&](int s) {
    const int t = s / nch;
    const int c0 = (s - t * nch) * kChunk;
    const int j0 = jb + t * kCTile;
    float* dq = sq + (s & 1) * kQueries * kQStride;
    float* dr = sr + (s & 1) * kCTile * kChunk;
    if (C > 0) {
      constexpr int W = kChunk / 4;
      for (int e = threadIdx.x; e < kQueries * W; e += kCThreads) {
        const int row = e / W, col = c0 + 4 * (e % W);
        const bool ok = i0 + row < m && col < c;
        __pipeline_memcpy_async(dq + row * kQStride + 4 * (e % W),
                                ok ? qp + (size_t)(i0 + row) * c + col : qp,
                                16, ok ? 0 : 16);
      }
      for (int e = threadIdx.x; e < kCTile * W; e += kCThreads) {
        const int row = e / W, col = c0 + 4 * (e % W);
        const bool ok = j0 + row < je && col < c;
        __pipeline_memcpy_async(dr + row * kChunk + 4 * (e % W),
                                ok ? rp + (size_t)(j0 + row) * c + col : rp,
                                16, ok ? 0 : 16);
      }
    } else {
      for (int e = threadIdx.x; e < kQueries * kChunk; e += kCThreads) {
        const int row = e / kChunk, col = c0 + e % kChunk;
        const bool ok = i0 + row < m && col < c;
        __pipeline_memcpy_async(dq + row * kQStride + e % kChunk,
                                ok ? qp + (size_t)(i0 + row) * c + col : qp,
                                4, ok ? 0 : 4);
      }
      for (int e = threadIdx.x; e < kCTile * kChunk; e += kCThreads) {
        const int row = e / kChunk, col = c0 + e % kChunk;
        const bool ok = j0 + row < je && col < c;
        __pipeline_memcpy_async(dr + e,
                                ok ? rp + (size_t)(j0 + row) * c + col : rp,
                                4, ok ? 0 : 4);
      }
    }
    __pipeline_commit();
  };

  float d[kPer][K];
  int j[kPer][K];
#pragma unroll
  for (int u = 0; u < kPer; ++u) list_init<K>(d[u], j[u]);
  float acc[kPer][kCTile];

  stage(0);
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages)
      stage(s + 1);
    else
      __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const int t = s / nch;
    const int ch = s - t * nch;
    if (ch == 0) {
#pragma unroll
      for (int u = 0; u < kPer; ++u)
#pragma unroll
        for (int r = 0; r < kCTile; ++r) acc[u][r] = 0.f;
    }
    const float* qrow = sq + (s & 1) * kQueries * kQStride +
                        threadIdx.x * kQStride;
    const float4* rt =
        reinterpret_cast<const float4*>(sr + (s & 1) * kCTile * kChunk);
#pragma unroll
    for (int v = 0; v < kChunk / 4; ++v) {
      float4 qv[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        qv[u] = reinterpret_cast<const float4*>(
            qrow + u * kCThreads * kQStride)[v];
#pragma unroll
      for (int r0 = 0; r0 < kCTile; r0 += kGroup) {
        float4 w[kGroup];
#pragma unroll
        for (int r = 0; r < kGroup; ++r)
          w[r] = rt[(r0 + r) * (kChunk / 4) + v];
        // channel by channel, the kPer * kGroup independent sums side by side
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < kPer; ++u)
#pragma unroll
            for (int r = 0; r < kGroup; ++r)
              acc[u][r0 + r] =
                  add_sq(acc[u][r0 + r], lane(qv[u], e), lane(w[r], e));
      }
    }
    __syncthreads();  // buffer s & 1 is refilled by stage(s + 2)
    if (ch == nch - 1) {
      const int j0 = jb + t * kCTile;
#pragma unroll
      for (int u = 0; u < kPer; ++u)
#pragma unroll
        for (int r = 0; r < kCTile; ++r)
          if (j0 + r < je) insert<K>(acc[u][r], j0 + r, d[u], j[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = i0 + u * kCThreads + threadIdx.x;
    if (i < m)
      finish<K>(d[u], j[u], k, (size_t)b * m + i, (size_t)gridDim.y * m, out,
                part_d, part_j);
  }
}

// The parts' lists of each (cloud, query) row, in part order, into one.
template <int K>
__global__ void __launch_bounds__(kQueries)
knn_wide_merge_kernel(const float* __restrict__ part_d,
                      const int* __restrict__ part_j, size_t rows, int parts,
                      int k, long long* __restrict__ out) {
  const size_t row = (size_t)blockIdx.x * kQueries + threadIdx.x;
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
  for (int p = 1; p < parts; ++p) {
    const size_t base = ((size_t)p * rows + row) * k;
    for (int t = 0; t < k; ++t) insert<K>(part_d[base + t], part_j[base + t],
                                          d, j);
  }
  long long* op = out + row * k;
#pragma unroll
  for (int t = 0; t < K; ++t)
    if (t < k) op[t] = j[t];
}

// A block above 48 KB of shared memory needs the kernel's limit raised:
// once per device, so that a launch makes no runtime call but its own.
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes,
                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

struct Args {
  const float* query;
  const float* ref;
  int b, m, n, c, k, len, parts;
  long long* out;
  float* part_d;
  int* part_j;
  cudaStream_t s;
};

dim3 grid_of(const Args& a) {
  return dim3((a.m + kQueries - 1) / kQueries, a.b, a.parts);
}

template <int K, int C>
cudaError_t launch_reg(const Args& a) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem =
      2 * kTile * C * sizeof(float) + 2 * sub_of(C) * kQueries * 8;
  const cudaError_t err = allow_smem(knn_wide_kernel<K, C>, smem, done);
  if (err != cudaSuccess) return err;
  knn_wide_kernel<K, C><<<grid_of(a), kQueries, smem, a.s>>>(
      a.query, a.ref, a.m, a.n, a.len, a.k, a.out, a.part_d, a.part_j);
  return cudaGetLastError();
}

template <int K, int C>
cudaError_t launch_chunk(const Args& a) {
  static std::atomic<unsigned long long> done{0};
  const size_t smem =
      2 * (kQueries * kQStride + kCTile * kChunk) * sizeof(float);
  const cudaError_t err =
      allow_smem(knn_wide_chunk_kernel<K, C>, smem, done);
  if (err != cudaSuccess) return err;
  knn_wide_chunk_kernel<K, C><<<grid_of(a), kCThreads, smem, a.s>>>(
      a.query, a.ref, a.m, a.n, a.c, a.len, a.k, a.out, a.part_d, a.part_j);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const Args& a) {
  const bool vec = a.c % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.query) |
                     reinterpret_cast<uintptr_t>(a.ref)) & 15) == 0;
  cudaError_t err;
  // the paths' widths at the paths' k, compiled; everything else at run time
  if constexpr (K <= 16) {
    if (vec && a.c == 24)
      err = launch_reg<K, 24>(a);
    else if (vec && a.c == 48)
      err = launch_reg<K, 48>(a);
    else if (vec && a.c == 64)
      err = launch_reg<K, 64>(a);
    else if (vec && a.c == 256)
      err = launch_chunk<K, 256>(a);
    else
      err = launch_chunk<K, 0>(a);
  } else {
    err = launch_chunk<K, 0>(a);
  }
  if (err != cudaSuccess || a.parts == 1) return err;
  const size_t rows = (size_t)a.b * a.m;
  knn_wide_merge_kernel<K>
      <<<static_cast<unsigned>((rows + kQueries - 1) / kQueries),
         kQueries, 0, a.s>>>(a.part_d, a.part_j, rows, a.parts, a.k, a.out);
  return cudaGetLastError();
}

}  // namespace

// Largest k the kernel takes.
extern "C" int houv_knn_wide_max_k() { return 64; }

// query: (b, m, c) f32, ref: (b, n, c) f32, out: (b, m, k) int64;
// c >= 1, 1 <= k <= min(n, houv_knn_wide_max_k()), 1 <= b < 65536, m >= 1.
// len: refs per part (the wrapper's plan); with more than one part, scratch
// holds 2 * parts * b * m * k words (the parts' distances, then indices).
extern "C" int houv_knn_wide(const float* query, const float* ref, int b,
                             int m, int n, int c, int k, int len,
                             void* scratch, long long* out, void* stream) {
  if (k < 1 || k > n || c < 1 || b < 1 || b > 65535 || m < 1 || len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int parts = (n + len - 1) / len;
  if (parts > 65535 || (parts > 1 && (scratch == nullptr || len < k)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_d = static_cast<float*>(scratch);
  int* part_j = parts > 1 ? reinterpret_cast<int*>(
                                part_d + (size_t)parts * b * m * k)
                          : nullptr;
  const Args a{query, ref, b, m, n, c, k, len, parts, out, part_d, part_j,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err = cudaErrorInvalidValue;
  if (k <= 4)
    err = launch<4>(a);
  else if (k <= 8)
    err = launch<8>(a);
  else if (k <= 16)
    err = launch<16>(a);
  else if (k <= 32)
    err = launch<32>(a);
  else if (k <= 64)
    err = launch<64>(a);
  return static_cast<int>(err);
}
