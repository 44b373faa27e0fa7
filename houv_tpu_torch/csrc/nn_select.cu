// Dual-direction nearest-neighbour search that emits the matched neighbour's
// coordinates instead of its index (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/chamfer.py:_nn_select_kernel (wrapper
// nn_select_pallas). Contract, shared-query layout as in csrc/nn_both.cu:
//   a (Bq, N, 3) f32 queries, b (Bk, M, 3) f32 references, Bk % Bq == 0;
//   batch row r of b is served by query cloud r / (Bk / Bq);
//   c1[r, i, :] = the row of b[r] nearest to a_i   (Bk, N, 3) f32
//   c2[r, j, :] = the row of a nearest to b[r]_j   (Bk, M, 3) f32
// exact f32 copies, ties to the smaller index, any Bk / Bq >= 1. The distance
// is (ax-bx)^2 + (ay-by)^2 + (az-bz)^2 rounded op by op (no FMA contraction),
// as the plain PyTorch version computes it, so both pick the same rows and
// the coordinates are equal bit for bit. (The TPU kernel selects by a one-hot
// product on its matrix unit, with hi/lo bf16 planes, a 16-bit index field
// and batch blocks of 8; those are economies of that unit and not carried
// over.)
//
// What bounds it on this card: f32 ALU work, about 8 operations for each of
// the Bk*N*M pairs; the clouds and the coordinates written are a few tens of
// MB.
//
// Design: the search of csrc/nn_both.cu. Grid (batch row, tile of 512
// queries); a thread owns 4 queries and their row minima in registers; tiles
// of 256 references stream through shared memory. The row direction writes
// its winners' coordinates at the end of the row loop. The column direction
// merges blocks by a 64-bit atomicMin on (distance bits << 32 | query index)
// in a scratch array; a second short kernel turns the winning indices into
// coordinates of a.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQpt = 4;                        // queries per thread
constexpr int kQueries = kThreads * kQpt;      // queries per block
constexpr int kTile = 256;                     // reference points per tile
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;

__global__ void __launch_bounds__(kThreads)
nn_select_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 int n, int m, int share, float* __restrict__ c1,
                 unsigned long long* __restrict__ key2) {
  __shared__ float sb[3 * kTile];
  __shared__ unsigned long long swarp[kWarps][kTile];

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * kQueries + threadIdx.x * kQpt;
  const float* ap = a + (size_t)(row / share) * n * 3;
  const float* bp = b + (size_t)row * m * 3;

  float qx[kQpt], qy[kQpt], qz[kQpt], best[kQpt];
  int bestj[kQpt];
#pragma unroll
  for (int q = 0; q < kQpt; ++q) {
    const bool ok = q0 + q < n;
    qx[q] = ok ? ap[3 * (q0 + q)] : 0.f;
    qy[q] = ok ? ap[3 * (q0 + q) + 1] : 0.f;
    qz[q] = ok ? ap[3 * (q0 + q) + 2] : 0.f;
    best[q] = INFINITY;
    bestj[q] = 0;
  }

  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int len = min(kTile, m - j0);
    __syncthreads();  // the previous tile's sb and swarp are consumed
    for (int t = threadIdx.x; t < 3 * len; t += kThreads)
      sb[t] = bp[(size_t)j0 * 3 + t];
    __syncthreads();

    for (int jj = 0; jj < len; ++jj) {
      const float bx = sb[3 * jj], by = sb[3 * jj + 1], bz = sb[3 * jj + 2];
      float tm = INFINITY;  // this thread's min over its queries
      int tq = 0;
#pragma unroll
      for (int q = 0; q < kQpt; ++q) {
        const float dx = __fsub_rn(qx[q], bx);
        const float dy = __fsub_rn(qy[q], by);
        const float dz = __fsub_rn(qz[q], bz);
        const float d =
            q0 + q < n ? __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz))
                       : INFINITY;
        if (d < best[q]) {  // strict: the first (smallest) j wins ties
          best[q] = d;
          bestj[q] = j0 + jj;
        }
        if (d < tm) {
          tm = d;
          tq = q;
        }
      }
      float wm = tm;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wm = fminf(wm, __shfl_xor_sync(kFull, wm, off));
      const unsigned ball = __ballot_sync(kFull, tm == wm);
      const int win = ball ? __ffs(ball) - 1 : 0;
      if (lane == win)
        swarp[warp][jj] =
            ball ? ((unsigned long long)__float_as_uint(wm) << 32) |
                       (unsigned)(q0 + tq)
                 : kEmpty;
    }
    __syncthreads();

    for (int t = threadIdx.x; t < len; t += kThreads) {
      unsigned long long k = swarp[0][t];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) k = swarp[w][t] < k ? swarp[w][t] : k;
      if ((k >> 32) < 0x7f800000ull)  // finite: some query of this block
        atomicMin(&key2[(size_t)row * m + j0 + t], k);
    }
  }

#pragma unroll
  for (int q = 0; q < kQpt; ++q) {
    if (q0 + q < n) {
      const float* w = bp + (size_t)bestj[q] * 3;
      float* o = c1 + ((size_t)row * n + q0 + q) * 3;
      o[0] = w[0];
      o[1] = w[1];
      o[2] = w[2];
    }
  }
}

// c2[r, j, :] = a[r / share, key2[r, j] & 0xffffffff, :], one thread per (r, j)
__global__ void __launch_bounds__(256)
nn_select_columns(const float* __restrict__ a,
                  const unsigned long long* __restrict__ key2, int n, int m,
                  int share, size_t total, float* __restrict__ c2) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const size_t row = t / m;
  // a column that no finite distance reached (NaN input) keeps the fill
  unsigned i = (unsigned)(key2[t] & 0xffffffffull);
  if (i >= (unsigned)n) i = 0;
  const float* w = a + ((row / share) * n + i) * 3;
  float* o = c2 + t * 3;
  o[0] = w[0];
  o[1] = w[1];
  o[2] = w[2];
}

}  // namespace

// c1: (bk, n, 3) f32 out, c2: (bk, m, 3) f32 out. key2: (bk, m) 64-bit
// scratch; this entry fills it with ~0 first. bk % bq == 0; n, m >= 1.
extern "C" int houv_nn_select(const float* a, const float* b, int bq, int bk,
                              int n, int m, float* c1, float* c2,
                              unsigned long long* key2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bq < 1 || bk % bq || n < 1 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(
      key2, 0xff, sizeof(unsigned long long) * (size_t)bk * m, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bk, (n + kQueries - 1) / kQueries);
  nn_select_kernel<<<grid, kThreads, 0, s>>>(a, b, n, m, bk / bq, c1, key2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t total = (size_t)bk * m;
  nn_select_columns<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      a, key2, n, m, bk / bq, total, c2);
  return static_cast<int>(cudaGetLastError());
}
