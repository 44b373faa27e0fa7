// Auction earth mover's distance, fixed epsilon (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/emd_kernel.py:_emd_kernel (wrapper
// emd_auction_pallas) with the contract of houv_tpu/ops/emd.py:
// _auction_single, one cloud pair per block:
//   x1 (B, N, 3) f32 bidders, x2 (B, M, 3) f32 items, eps > 0, iters >= 0
//   (M != N too: with more bidders than items some stay unassigned to the
//   round cap, as in the coarse stages of VRCNet's EMD training loss);
//   Jacobi rounds while a bidder is unassigned and fewer than `iters` ran:
//   every unassigned bidder i takes value v_ij = (-d_ij) - price_j, bids on
//   its best item (ties to the smaller item) an increment
//   (best - second best) + eps; each item goes to its largest bid (ties to
//   the smaller bidder), evicts its previous owner and raises its price by
//   the bid. Bidders still unassigned afterwards take their nearest item
//   (ties to the smaller item). Outputs: assignment (B, N) int64, its squared
//   distance (B, N) f32, and per pair the rounds run and the bids made
//   (B, 2) int64 (each bid scans M items).
// d is the diff form rounded op by op (__fsub_rn/__fmul_rn/__fadd_rn), as the
// plain PyTorch version computes it, so both run the same rounds to the same
// assignment. The TPU's epsilon scaling and compacted tail were Mosaic
// accelerations, not semantics, and are not carried over.
//
// What bounds it on this card: f32 ALU work, data dependent: each bid
// evaluates M values at about 10 flops each, while the clouds are 24 KB per
// pair. The bound is reckoned from the counted bids.
//
// Design: one block of 1024 threads per pair; x2, prices, owners, the
// bidder -> item map, the list of unassigned bidders and one 64-bit bid key
// per item live in shared memory (28 bytes per item, 8 per bidder). Per round:
//   A. each warp takes one unassigned bidder at a time; its lanes scan
//      strided items keeping a (best, index, second) triple, merged by
//      shuffles; lane 0 posts atomicMax(key[item], inc_bits << 32 | ~row).
//      A positive float orders like its bits, so the largest increment wins
//      and, among equal ones, the smallest row: exact, unlike the TPU's key,
//      which quantised the increment to make room for the index.
//   B. one thread per item reads its key, evicts the old owner, assigns the
//      winner and raises the price (winners own nothing and owners do not
//      bid, so these writes never collide).
//   C. the unassigned bidders are compacted into the list again
//      (warp-aggregated atomics; the order of the list does not matter, since
//      every bid is independent and the key decides ties).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBytesPerItem = 8 + 12 + 4 + 4;    // key, x2, price, owner
constexpr int kBytesPerBidder = 4 + 4;            // assign, ulist
constexpr int kMaxSmem = 232448 - 1024;  // opt-in limit, less static slack

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        const float* p) {
  const float dx = __fsub_rn(ax, p[0]);
  const float dy = __fsub_rn(ay, p[1]);
  const float dz = __fsub_rn(az, p[2]);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
emd_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int n,
           int m, float eps, int iters, float* __restrict__ dist_out,
           long long* __restrict__ assign_out, long long* __restrict__ stats) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;                       // m
  float* sx2 = reinterpret_cast<float*>(key + m);       // 3m
  float* price = sx2 + 3 * m;                           // m
  int* owner = reinterpret_cast<int*>(price + m);       // m
  int* assign = owner + m;                              // n
  int* ulist = assign + n;                              // n
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p1 = x1 + (size_t)blockIdx.x * n * 3;
  const float* p2 = x2 + (size_t)blockIdx.x * m * 3;

  for (int t = tid; t < 3 * m; t += kThreads) sx2[t] = p2[t];
  for (int t = tid; t < m; t += kThreads) {
    key[t] = 0ull;
    price[t] = 0.f;
    owner[t] = -1;
  }
  for (int t = tid; t < n; t += kThreads) {
    assign[t] = -1;
    ulist[t] = t;
  }
  if (tid == 0) s_count = n;
  __syncthreads();

  int rounds = 0;
  long long bids = 0;
  int u = n;
  while (rounds < iters && u > 0) {
    // A. bids
    for (int w = warp; w < u; w += kWarps) {
      const int i = ulist[w];
      const float ax = p1[3 * i], ay = p1[3 * i + 1], az = p1[3 * i + 2];
      float best = -INFINITY, second = -INFINITY;
      int bj = 0x7fffffff;
      for (int j = lane; j < m; j += 32) {
        const float v = __fsub_rn(-sqdist(ax, ay, az, sx2 + 3 * j), price[j]);
        if (v > best) {  // strict: a lane's smaller item wins ties
          second = best;
          best = v;
          bj = j;
        } else if (v > second) {
          second = v;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const float os = __shfl_xor_sync(kFull, second, off);
        const int oj = __shfl_xor_sync(kFull, bj, off);
        if (ob > best || (ob == best && oj < bj)) {
          second = fmaxf(best, os);
          best = ob;
          bj = oj;
        } else {
          second = fmaxf(second, ob);
        }
      }
      if (lane == 0) {
        const float inc = __fadd_rn(__fsub_rn(best, second), eps);
        atomicMax(&key[bj],
                  (static_cast<unsigned long long>(__float_as_uint(inc)) << 32) |
                      static_cast<unsigned>(~i));
      }
    }
    bids += u;
    __syncthreads();

    // B. each item takes its winning bid
    if (tid == 0) s_count = 0;
    for (int j = tid; j < m; j += kThreads) {
      const unsigned long long k = key[j];
      if (k) {
        key[j] = 0ull;
        const int w = static_cast<int>(~static_cast<unsigned>(k));
        const int prev = owner[j];
        if (prev >= 0) assign[prev] = -1;
        owner[j] = w;
        assign[w] = j;
        price[j] = __fadd_rn(price[j],
                             __uint_as_float(static_cast<unsigned>(k >> 32)));
      }
    }
    __syncthreads();

    // C. compact the unassigned bidders
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const bool un = i < n && assign[i] < 0;
      const unsigned ball = __ballot_sync(kFull, un);
      int base = 0;
      if (lane == 0 && ball) base = atomicAdd(&s_count, __popc(ball));
      base = __shfl_sync(kFull, base, 0);
      if (un) ulist[base + __popc(ball & ((1u << lane) - 1u))] = i;
    }
    __syncthreads();
    u = s_count;
    ++rounds;
  }

  // leftovers (the round cap was hit): nearest item
  for (int w = warp; w < u; w += kWarps) {
    const int i = ulist[w];
    const float ax = p1[3 * i], ay = p1[3 * i + 1], az = p1[3 * i + 2];
    float bd = INFINITY;
    int bj = m;
    for (int j = lane; j < m; j += 32) {
      const float d = sqdist(ax, ay, az, sx2 + 3 * j);
      if (d < bd) {
        bd = d;
        bj = j;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, bd, off);
      const int oj = __shfl_xor_sync(kFull, bj, off);
      if (od < bd || (od == bd && oj < bj)) {
        bd = od;
        bj = oj;
      }
    }
    if (lane == 0) assign[i] = bj < m ? bj : 0;
  }
  __syncthreads();

  const size_t row = (size_t)blockIdx.x * n;
  for (int i = tid; i < n; i += kThreads) {
    const int a = assign[i];
    dist_out[row + i] = sqdist(p1[3 * i], p1[3 * i + 1], p1[3 * i + 2],
                               sx2 + 3 * a);
    assign_out[row + i] = a;
  }
  if (tid == 0) {
    stats[2 * blockIdx.x] = rounds;
    stats[2 * blockIdx.x + 1] = bids;
  }
}

}  // namespace

// Shared-memory bytes the kernel needs for n bidders and m items, and the
// most it can have: a pair fits when the first is at most the second.
extern "C" int houv_emd_smem_bytes(int n, int m) {
  const long long need =
      (long long)kBytesPerItem * m + (long long)kBytesPerBidder * n;
  return need > 0x7fffffff ? 0x7fffffff : static_cast<int>(need);
}
extern "C" int houv_emd_max_smem_bytes() { return kMaxSmem; }

// x1: (b, n, 3), x2: (b, m, 3) f32; dist: (b, n) f32, assign: (b, n) int64
// and stats: (b, 2) int64 out. n, m >= 1, the pair fits (above), eps > 0.
extern "C" int houv_emd(const float* x1, const float* x2, int b, int n, int m,
                        float eps, int iters, float* dist, long long* assign,
                        long long* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1 || houv_emd_smem_bytes(n, m) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = houv_emd_smem_bytes(n, m);
  const cudaError_t e = cudaFuncSetAttribute(
      emd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  emd_kernel<<<b, kThreads, smem, s>>>(x1, x2, n, m, eps, iters, dist, assign,
                                       stats);
  return static_cast<int>(cudaGetLastError());
}
