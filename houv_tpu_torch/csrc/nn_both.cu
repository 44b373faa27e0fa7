// Fused dual-direction nearest-neighbour search, emitting indices (Hopper,
// sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/chamfer.py:_nn_both_kernel (wrapper
// _nn_both_pallas). Contract, shared-query layout included:
//   a (Bq, N, 3) f32 queries, b (Bk, M, 3) f32 references, Bk % Bq == 0;
//   batch row r of b is served by query cloud r / (Bk / Bq);
//   i1[r, i] = argmin_j d(a_i, b_j)   (Bk, N) int64
//   i2[r, j] = argmin_i d(a_i, b_j)   (Bk, M) int64
// with ties to the smaller index, d rounded op by op, exactly as the plain
// PyTorch version ops/chamfer.py:_nn_both_plain computes it; 0 where no
// distance compared (NaN input). A NaN distance never wins, here and there
// (csrc/nn_search.cuh).
//
// The search, what bounds it and its design are csrc/nn_search.cuh's,
// shared with csrc/nn_select.cu (which writes the winners' coordinates).
// This file is its index epilogue: a block that owns a whole direction
// writes the winners' indices directly as int64; a direction split over
// blocks merges in its own output by 64-bit keys (distance bits << 32 |
// index), filled with ~0 first and unpacked in place after.

#include "nn_search.cuh"

namespace {

__device__ __forceinline__ void put(long long* out, bool direct, float d,
                                    long long idx) {
  if (direct)
    *out = idx;
  else
    atomicMin(reinterpret_cast<unsigned long long*>(out), pack(d, idx));
}

// nn_search's epilogue for K1: the winner's index, 0 where there is none
struct Indices {
  long long* i1;
  long long* i2;

  __device__ __forceinline__ void row(size_t at, bool direct, float v,
                                      int found, long long j_lo, const float*,
                                      const float*, const float*) const {
    if (found != kNone)
      put(i1 + at, direct, v, j_lo + found);
    else if (direct)
      i1[at] = 0;  // no comparable distance (NaN input)
  }

  __device__ __forceinline__ void col(size_t at, bool direct, float v,
                                      int found, long long q_lo,
                                      const float*) const {
    if (found != kNone)
      put(i2 + at, direct, v, q_lo + found);
    else if (direct)
      i2[at] = 0;
  }
};

__global__ void __launch_bounds__(kThreads, 3)
nn_both_kernel(const float* __restrict__ a, const float* __restrict__ b,
               int n, int m, int share, int qlen, int rlen, int qparts,
               int rparts, Indices out) {
  nn_search(a, b, n, m, share, qlen, rlen, qparts, rparts, out);
}

// A key merged by atomicMin becomes its index; one never reached, 0.
__global__ void __launch_bounds__(256)
nn_both_unpack_kernel(long long* __restrict__ keys, size_t total) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const unsigned long long k = (unsigned long long)keys[t];
  keys[t] = k == kEmpty ? 0 : (long long)(k & 0xffffffffull);
}

}  // namespace

// i1: (bk, n) int64 out; i2: (bk, m) int64 out. qlen and rlen: queries and
// references a block owns (nn_grid). A direction split over blocks is
// merged in its own output by 64-bit keys, filled with ~0 first and
// unpacked after.
extern "C" int houv_nn_both(const float* a, const float* b, int bq, int bk,
                            int n, int m, int qlen, int rlen, long long* i1,
                            long long* i2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nn_run(nn_both_kernel, Indices{i1, i2}, a, b, bq, bk, n, m, qlen,
                rlen, i1, i2, s, [&](bool cols) {
                  const size_t total = (size_t)bk * (cols ? m : n);
                  return nn_pass(nn_both_unpack_kernel, total, s,
                                 cols ? i2 : i1, total);
                });
}

extern "C" const char* houv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
