// k nearest neighbours in feature space, any channel count (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/grouping.py:_knn_kernel_wide (wrapper
// knn_indices_pallas, which took it for C > 8; here it serves every C other
// than 3, which goes to csrc/knn.cu). Contract:
//   query (B, M, C) f32, ref (B, N, C) f32, C >= 1, 1 <= k <= min(N, 64);
//   idx[b, i, :] = the k refs nearest to query i, ascending by distance,
//   ties to the smaller index (B, M, k) int64.
//
// Selection arithmetic: the diff form d = sum_c (q_c - r_c)^2, accumulated in
// ascending c and rounded op by op (__fsub_rn/__fmul_rn/__fadd_rn: no FMA
// contraction), exactly as the plain PyTorch version computes it, so both
// select identical indices and a point's distance to itself is exactly 0.
// The TPU kernel took |q|^2 - 2 q.r + |r|^2 from its matrix unit and clamped
// the cancellation error at 0; that form is an economy of that unit, not part
// of the contract, and is not carried over.
//
// What bounds it on this card: f32 ALU work, 3 operations per (pair, channel)
// on the CUDA cores; the clouds are a few MB. (The diff form has no
// tensor-core form.)
//
// Design: one thread per query, 128 queries per block. For a tile of TR
// reference rows the thread keeps TR partial distances in registers and walks
// the channels in chunks of 16: the block stages the chunk of its 128 queries
// (padded rows, conflict-free) and of the TR references (read by broadcast,
// four channels per 16-byte read) in shared memory. Channels past C are
// staged as 0 on both sides and add exactly +0. The finished distances go
// through a thread-private column of shared memory into the sorted top-K
// insertion of csrc/knn.cu (K a compile-time bucket >= k, list in registers),
// so the insertion code exists once rather than once per row of the tile.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;      // queries per block
constexpr int kChunk = 16;         // channels per shared-memory chunk
constexpr int kQPad = kChunk + 1;  // padded query row: conflict-free reads

__device__ __forceinline__ float add_sq(float acc, float q, float r) {
  const float d = __fsub_rn(q, r);
  return __fadd_rn(acc, __fmul_rn(d, d));
}

template <int K, int TR>
__global__ void __launch_bounds__(kThreads)
knn_wide_kernel(const float* __restrict__ query, const float* __restrict__ ref,
                int m, int n, int c, int k, long long* __restrict__ out) {
  __shared__ float sq[kThreads * kQPad];
  __shared__ __align__(16) float sr[TR * kChunk];
  __shared__ float sd[TR * kThreads];

  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kThreads;
  const int i = i0 + threadIdx.x;
  const float* qp = query + (size_t)b * m * c;
  const float* rp = ref + (size_t)b * n * c;

  float dist[K];
  int idx[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    dist[t] = INFINITY;
    idx[t] = 0;
  }

  for (int j0 = 0; j0 < n; j0 += TR) {
    float acc[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[r] = 0.f;

    for (int c0 = 0; c0 < c; c0 += kChunk) {
      __syncthreads();  // the previous chunk is consumed
      for (int t = threadIdx.x; t < kThreads * kChunk; t += kThreads) {
        const int row = t / kChunk, col = t % kChunk;
        const bool ok = i0 + row < m && c0 + col < c;
        sq[row * kQPad + col] =
            ok ? qp[(size_t)(i0 + row) * c + c0 + col] : 0.f;
      }
      for (int t = threadIdx.x; t < TR * kChunk; t += kThreads) {
        const int row = t / kChunk, col = t % kChunk;
        const bool ok = j0 + row < n && c0 + col < c;
        sr[t] = ok ? rp[(size_t)(j0 + row) * c + c0 + col] : 0.f;
      }
      __syncthreads();

      float q[kChunk];
#pragma unroll
      for (int v = 0; v < kChunk; ++v) q[v] = sq[threadIdx.x * kQPad + v];
      const float4* r4 = reinterpret_cast<const float4*>(sr);
#pragma unroll
      for (int r = 0; r < TR; ++r) {
#pragma unroll
        for (int v = 0; v < kChunk / 4; ++v) {
          const float4 w = r4[r * (kChunk / 4) + v];
          acc[r] = add_sq(acc[r], q[4 * v], w.x);
          acc[r] = add_sq(acc[r], q[4 * v + 1], w.y);
          acc[r] = add_sq(acc[r], q[4 * v + 2], w.z);
          acc[r] = add_sq(acc[r], q[4 * v + 3], w.w);
        }
      }
    }

    // a column of sd belongs to one thread: no barrier around it
#pragma unroll
    for (int r = 0; r < TR; ++r) sd[r * kThreads + threadIdx.x] = acc[r];
    const int len = min(TR, n - j0);
    for (int r = 0; r < len; ++r) {
      const float d = sd[r * kThreads + threadIdx.x];
      if (d < dist[K - 1]) {
        const int j = j0 + r;
#pragma unroll
        for (int t = K - 1; t > 0; --t) {
          // dist[t] and dist[t - 1] still hold their old values here
          if (d < dist[t]) {
            const bool up = d < dist[t - 1];
            dist[t] = up ? dist[t - 1] : d;
            idx[t] = up ? idx[t - 1] : j;
          }
        }
        if (d < dist[0]) {
          dist[0] = d;
          idx[0] = j;
        }
      }
    }
  }

  if (i < m) {
    long long* op = out + ((size_t)b * m + i) * k;
#pragma unroll
    for (int t = 0; t < K; ++t)
      if (t < k) op[t] = idx[t];
  }
}

template <int K, int TR>
int launch(const float* query, const float* ref, int b, int m, int n, int c,
           int k, long long* out, cudaStream_t s) {
  const dim3 grid((m + kThreads - 1) / kThreads, b);
  knn_wide_kernel<K, TR><<<grid, kThreads, 0, s>>>(query, ref, m, n, c, k,
                                                   out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Largest k the kernel takes.
extern "C" int houv_knn_wide_max_k() { return 64; }

// query: (b, m, c) f32, ref: (b, n, c) f32, out: (b, m, k) int64;
// c >= 1, 1 <= k <= min(n, houv_knn_wide_max_k()), b < 65536.
extern "C" int houv_knn_wide(const float* query, const float* ref, int b,
                             int m, int n, int c, int k, long long* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > n || c < 1 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k <= 4) return launch<4, 32>(query, ref, b, m, n, c, k, out, s);
  if (k <= 8) return launch<8, 32>(query, ref, b, m, n, c, k, out, s);
  if (k <= 16) return launch<16, 32>(query, ref, b, m, n, c, k, out, s);
  if (k <= 32) return launch<32, 16>(query, ref, b, m, n, c, k, out, s);
  if (k <= 64) return launch<64, 16>(query, ref, b, m, n, c, k, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
