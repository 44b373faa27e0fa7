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
// (src is small and stays in L2); no arithmetic.
//
// Design: one thread per output element, so a warp writes 128 consecutive
// bytes; the C threads of a row read the same index word.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ src,
                   const long long* __restrict__ idx, int m, int n, int c,
                   size_t total, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const size_t row = e / c;           // b * n + i
  const int ch = (int)(e - row * c);
  const size_t b = row / n;
  const long long j = idx[row];
  out[e] = (j >= 0 && j < m) ? src[(b * m + (size_t)j) * c + ch] : 0.f;
}

}  // namespace

// src (b, m, c) f32, idx (b, n) int64, out (b, n, c) f32; b, n, c >= 1.
extern "C" int houv_gather_rows(const float* src, const long long* idx, int b,
                                int m, int n, int c, float* out,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)b * n * c;
  const size_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffull) return static_cast<int>(cudaErrorInvalidValue);
  gather_rows_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(src, idx, m, n, c,
                                                           total, out);
  return static_cast<int>(cudaGetLastError());
}
