// Batched scatter-add in a fixed order (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/scatter.py:_scatter_kernel (wrapper
// scatter_add_matmul). Contract:
//   idx (B, N) int64, vals (B, N, C) f32, C <= 8  ->  out (B, M, C) f32
//   out[b, r, :] = sum over { i : idx[b, i] == r } of vals[b, i, :]
// An index < 0 or >= M matches no row and is dropped. Every output row is
// written (rows without a match hold 0), so the caller need not clear out.
//
// The TPU kernel builds one-hot tiles and contracts them on the matrix unit
// because a scatter serialises there; its bf16 rounding of vals is an economy
// of that unit, not part of the contract. Here the sum is f32 and is taken in
// ascending i, starting from 0: the result has no run-to-run difference (no
// atomics) and equals, bit for bit, a plain version that adds in that order.
//
// What bounds it on this card: the B*N*M index compares of the owner scan
// (integer ALU and shared-memory reads), not bytes: idx, vals and out are
// each read or written once and total a few MB.
//
// Design:
// - One thread owns one output row (b, r) and keeps its C sums in registers;
//   a block owns kThreads consecutive rows of one batch entry.
// - The batch entry's indices stream through shared memory in tiles of
//   kTile, narrowed to int32 (anything outside [0, M) becomes -1). All
//   threads of a warp read the same shared word at once (a broadcast), four
//   indices per 16-byte read.
// - A thread reads vals from global memory only on a match; over a batch
//   entry that is N reads in all, whatever M is.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;   // indices per shared-memory tile (8 KB)
constexpr int kMaxC = 8;

__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ idx,
               const float* __restrict__ vals, int n, int m, int c,
               float* __restrict__ out) {
  __shared__ __align__(16) int sidx[kTile];
  const int b = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const long long* bidx = idx + (size_t)b * n;
  const float* bvals = vals + (size_t)b * n * c;

  float acc[kMaxC];
#pragma unroll
  for (int j = 0; j < kMaxC; ++j) acc[j] = 0.0f;

  for (int i0 = 0; i0 < n; i0 += kTile) {
    const int len = min(kTile, n - i0);
    const int padded = (len + 3) & ~3;
    for (int t = threadIdx.x; t < padded; t += kThreads) {
      long long v = t < len ? bidx[i0 + t] : -1;
      sidx[t] = (v >= 0 && v < m) ? (int)v : -1;
    }
    __syncthreads();
    const int4* s4 = reinterpret_cast<const int4*>(sidx);
    for (int t = 0; t < padded; t += 4) {
      const int4 q = s4[t >> 2];
      if (q.x == row || q.y == row || q.z == row || q.w == row) {
        const int hit[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (hit[u] == row) {
            const float* v = bvals + (size_t)(i0 + t + u) * c;
#pragma unroll
            for (int j = 0; j < kMaxC; ++j)
              if (j < c) acc[j] += v[j];
          }
        }
      }
    }
    __syncthreads();
  }

  if (row < m) {
    float* o = out + ((size_t)b * m + row) * c;
#pragma unroll
    for (int j = 0; j < kMaxC; ++j)
      if (j < c) o[j] = acc[j];
  }
}

}  // namespace

extern "C" int houv_scatter_max_channels() { return kMaxC; }

// idx (b, n) int64, vals (b, n, c) f32, out (b, m, c) f32; b, n, m >= 1.
extern "C" int houv_scatter_add(const long long* idx, const float* vals,
                                int b, int n, int m, int c, float* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // grid.y carries the batch (at most 65535 per launch)
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int nb = b - b0 < 65535 ? b - b0 : 65535;
    const dim3 grid((m + kThreads - 1) / kThreads, nb);
    scatter_kernel<<<grid, kThreads, 0, s>>>(
        idx + (size_t)b0 * n, vals + (size_t)b0 * n * c, n, m, c,
        out + (size_t)b0 * m * c);
  }
  return static_cast<int>(cudaGetLastError());
}
