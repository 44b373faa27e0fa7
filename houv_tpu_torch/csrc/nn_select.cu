// Dual-direction nearest-neighbour search that emits the matched neighbour's
// coordinates instead of its index (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/chamfer.py:_nn_select_kernel (wrapper
// nn_select_pallas). Contract, shared-query layout as in csrc/nn_both.cu:
//   a (Bq, N, 3) f32 queries, b (Bk, M, 3) f32 references, Bk % Bq == 0;
//   batch row r of b is served by query cloud r / (Bk / Bq);
//   c1[r, i, :] = b[r, i1[r, i], :]           (Bk, N, 3) f32
//   c2[r, j, :] = a[r / share, i2[r, j], :]   (Bk, M, 3) f32
// where i1 and i2 are exactly the indices csrc/nn_both.cu returns (ties to
// the smaller index, distances rounded op by op, 0 where no distance
// compared), so the coordinates are exact copies, equal bit for bit to the
// plain version ops/chamfer.py:_nn_select_plain, NaN points included
// (csrc/nn_search.cuh). (The TPU kernel
// selects by a one-hot product on its matrix unit, with hi/lo bf16 planes, a
// 16-bit index field and batch blocks of 8; those are economies of that unit
// and not carried over.)
//
// What bounds it on this card, and the search itself: csrc/nn_search.cuh,
// the one search K1 and K3 share (instruction issue, 8 f32 instructions a
// pair). This file is its coordinate epilogue, which adds 12 bytes a point
// each way to what the search reads:
// - rows, when a block owns all of a row's references (the plan keeps them
//   whole up to 3072): the winner's coordinates come from the block's
//   shared reference planes rx, ry, rz[s], the values as loaded, so the copy
//   is exact; no comparable distance copies slot 0, row 0 of b[r];
// - columns, when a block owns all of the queries (the plan at the solver's
//   1024 and 6400 rows): the winner's row of a, re-read where the rescan
//   just read it (L1); none copies row 0;
// - a direction the plan splits over blocks (M > 3072; the queries at 32 or
//   64 rows) merges (distance bits << 32 | index) by a 64-bit atomicMin into
//   key scratch of that direction alone, filled with ~0 first; a short pass
//   then copies the named rows (a key never reached: row 0, as K1's unpack
//   writes index 0).
// At the solver's shapes both directions are direct: one launch, no memset,
// no scratch, no atomics.

#include "nn_search.cuh"

namespace {

__device__ __forceinline__ void copy3(float* o, float x, float y, float z) {
  o[0] = x;
  o[1] = y;
  o[2] = z;
}

// nn_search's epilogue for K3: the winner's coordinates, or its key
struct Coords {
  float* c1;
  float* c2;
  unsigned long long* key1;  // (bk, n) when the references split, else null
  unsigned long long* key2;  // (bk, m) when the queries split, else null

  __device__ __forceinline__ void row(size_t at, bool direct, float v,
                                      int found, long long j_lo,
                                      const float* rx, const float* ry,
                                      const float* rz) const {
    if (direct) {  // j_lo == 0: slot 0 is row 0 of b[r]
      const int s = found == kNone ? 0 : found;
      copy3(c1 + 3 * at, rx[s], ry[s], rz[s]);
    } else if (found != kNone) {
      atomicMin(key1 + at, pack(v, j_lo + found));
    }
  }

  __device__ __forceinline__ void col(size_t at, bool direct, float v,
                                      int found, long long q_lo,
                                      const float* ap) const {
    if (direct) {  // q_lo == 0: ap is a[r / share]
      const float* p = ap + 3 * (size_t)(found == kNone ? 0 : found);
      copy3(c2 + 3 * at, p[0], p[1], p[2]);
    } else if (found != kNone) {
      atomicMin(key2 + at, pack(v, q_lo + found));
    }
  }
};

__global__ void __launch_bounds__(kThreads, 3)
nn_select_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 int n, int m, int share, int qlen, int rlen, int qparts,
                 int rparts, Coords out) {
  nn_search(a, b, n, m, share, qlen, rlen, qparts, rparts, out);
}

// out[t, :] = src[(t / len) / share, index of keys[t], :]: a merged key
// becomes the row it names, one never reached row 0. One thread a key.
__global__ void __launch_bounds__(256)
nn_select_unpack_kernel(const unsigned long long* __restrict__ keys,
                        size_t total, int len, const float* __restrict__ src,
                        int pts, int share, float* __restrict__ out) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const unsigned long long k = keys[t];
  const size_t idx = k == kEmpty ? 0 : (size_t)(k & 0xffffffffull);
  const float* w = src + ((t / len / share) * pts + idx) * 3;
  copy3(out + 3 * t, w[0], w[1], w[2]);
}

}  // namespace

// c1: (bk, n, 3) f32 out, c2: (bk, m, 3) f32 out. qlen and rlen: queries
// and references a block owns (nn_grid, ops/chamfer.py:_nn_plan). key1:
// (bk, n) 64-bit scratch, needed only when the references split (m > rlen);
// key2: (bk, m), only when the queries split (n > qlen); null otherwise.
// nn_run fills a needed one with ~0 first.
extern "C" int houv_nn_select(const float* a, const float* b, int bq, int bk,
                              int n, int m, int qlen, int rlen, float* c1,
                              float* c2, unsigned long long* key1,
                              unsigned long long* key2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return nn_run(nn_select_kernel, Coords{c1, c2, key1, key2}, a, b, bq, bk, n,
                m, qlen, rlen, key1, key2, s, [&](bool cols) {
                  // columns: rows of a[r / share]; rows: rows of b[r]
                  return cols ? nn_pass(nn_select_unpack_kernel,
                                        (size_t)bk * m, s, key2,
                                        (size_t)bk * m, m, a, n, bk / bq, c2)
                              : nn_pass(nn_select_unpack_kernel,
                                        (size_t)bk * n, s, key1,
                                        (size_t)bk * n, n, b, m, 1, c1);
                });
}
