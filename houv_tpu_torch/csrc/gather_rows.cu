// Batched row gather (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/scatter.py:_gather_kernel (wrapper
// gather_rows_matmul). Contract:
//   src (B, M, C) f32, idx (B, N) int64  ->  out (B, N, C) f32
//   out[b, i, :] = src[b, idx[b, i], :], an exact copy;
//   an index < 0 or >= M gives a row of zeros.
// The TPU kernel contracts an f32 one-hot tile with src on its matrix unit
// because a row gather serialises there; an index that matches no column
// (its padding is -1) leaves the row 0, which is the out-of-range rule kept
// here. The C <= 8 limit was the one-hot product's lane padding and is gone.
//
// What bounds it on this card: bytes. idx is read once and out written once
// (src is small and stays in L2); there is no arithmetic but addressing, so
// the addressing must stay cheap: no division wider than 32 bits, and none
// per element. (The first version of this kernel ran one thread per output
// element, with two 64-bit divisions each and every index word read C
// times.)
//
// Design: blockIdx.y is the batch entry; a warp owns two groups of 32
// consecutive rows. Each lane loads one row's index of each group at once
// (coalesced 8-byte words, both in flight). A group's 32 * C output floats
// are contiguous: the warp writes them 32 at a time, coalesced, whatever C
// is; the lane that writes element e takes the index of row e / C from its
// owner by __shfl_sync. Row and channel of e are advanced by constant
// steps, so the loop has no division.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kGroups = 2;      // groups of 32 rows a warp

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ src,
                   const long long* __restrict__ idx, int m, int n, int c,
                   float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long w0 =
      ((long long)blockIdx.x * kThreads + (threadIdx.x & ~31)) * kGroups;
  if (w0 >= n) return;                          // the whole warp
  const size_t b = blockIdx.y;
  const float* bsrc = src + b * m * (size_t)c;
  int mine[kGroups];                            // all index loads in flight
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long i = w0 + g * 32 + lane;
    const long long j = i < n ? idx[b * n + i] : -1;
    mine[g] = (j >= 0 && j < m) ? (int)j : -1;
  }
  // element e = 32 * step + lane of a group's rows * c floats
  const int row0 = lane / c, ch0 = lane - row0 * c;
  const int drow = 32 / c, dch = 32 - drow * c;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const long long i0 = w0 + g * 32;
    if (i0 >= n) break;
    const int rows = n - i0 < 32 ? (int)(n - i0) : 32;
    float* o = out + (b * n + i0) * (size_t)c;
    const long long total = (long long)rows * c;
    int row = row0, ch = ch0;
#pragma unroll 4
    for (long long e = lane; e - lane < total; e += 32) {
      const int r = __shfl_sync(~0u, mine[g], row < 32 ? row : 31);
      if (e < total) o[e] = r >= 0 ? bsrc[(size_t)r * c + ch] : 0.f;
      row += drow;
      ch += dch;
      if (ch >= c) {
        ch -= c;
        ++row;
      }
    }
  }
}

}  // namespace

// src (b, m, c) f32, idx (b, n) int64, out (b, n, c) f32; b, n, c >= 1.
extern "C" int houv_gather_rows(const float* src, const long long* idx, int b,
                                int m, int n, int c, float* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>(((long long)n + kThreads * kGroups - 1) /
                            (kThreads * kGroups));
  // grid.y carries the batch (at most 65535 per launch)
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int nb = b - b0 < 65535 ? b - b0 : 65535;
    gather_rows_kernel<<<dim3(blocks, nb), kThreads, 0, s>>>(
        src + (size_t)b0 * m * c, idx + (size_t)b0 * n, m, n, c,
        out + (size_t)b0 * n * c);
  }
  return static_cast<int>(cudaGetLastError());
}
