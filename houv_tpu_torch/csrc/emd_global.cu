// Auction earth mover's distance for pairs above emd_large.cu's capacity
// (Hopper, sm_90a): the global-memory design, the route for the pairs that
// neither emd.cu (one block's shared memory, about 6428 x 6428) nor
// emd_large.cu (a cluster's shared memory, houv_emd_large_smem_bytes(n, m)
// <= houv_emd_max_smem_bytes(); about 17000 x 17000) holds.
//
// Replaces the TPU kernel houv_tpu/ops/emd_kernel.py:_emd_kernel (wrapper
// emd_auction_pallas) for those pairs. Same contract as emd.cu and
// ops/emd.py:_auction_plain:
//   x1 (B, N, 3) f32 bidders, x2 (B, M, 3) f32 items, eps > 0, iters >= 0;
//   Jacobi rounds while a bidder is unassigned and fewer than `iters` ran:
//   every unassigned bidder i takes v_ij = (-d_ij) - price_j, bids on its
//   best item (ties to the smaller item) (best - second best) + eps; each
//   item goes to its largest bid (ties to the smaller bidder), evicts its
//   owner and raises its price by the bid; bidders still unassigned take
//   their nearest item (ties to the smaller item). Outputs: assignment
//   (B, N) int64, its squared distance (B, N) f32, per pair the rounds run
//   and the bids made (B, 2) int64. d is the diff form rounded op by op, so
//   the rounds and the assignment equal the plain version's. It takes any
//   N and M.
//
// What bounds it on this card: f32 ALU work, data dependent, as emd.cu: each
// bid evaluates M values at about 11 flops each. Here every bid also reads
// the M items from L2, and in the long tail of rounds with a few bidders
// one SM scans while the cluster's others wait at its barriers.
//
// Design: emd.cu's rounds with the pair's state in global memory (the
// wrapper's scratch): the items as float4 {x, y, z, price}, one 64-bit bid
// key, one owner per item, two lists of bidders, the item each listed
// bidder bid on, and the lists' lengths. A pair runs on a cluster of C
// blocks (1, 2, 4 or 8: the plan ops/emd.py:_emd_global_plan), which deal
// the bidders out by list position (t mod C); cluster barriers order the
// two phases of a round. Bids go to the keys by the native 64-bit atomicMax
// on global memory (emd.cu needs a compare-and-swap loop only for
// distributed shared memory). Mutable state is read with ld.global.cg (L2;
// another SM of the cluster writes it), the clouds through the read-only
// path.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;  // an item no lane holds
// Variant switch (scripts/time_large_variants.py): kScan 0 drops the item
// scan (bidder i bids eps on item i mod M, and the rounds run to `iters`
// with whatever bidders are left: wrong assignments, a round's fixed cost
// alone, the latency floor).
constexpr int kScan = 1;

struct Triple {
  float best, second;
  int idx;
};

// One pair's state in global memory.
struct State {
  float4* items;             // m: x, y, z, price
  unsigned long long* key;   // m
  int* owner;                // m
  unsigned* list;            // 2 n: the current and the next list of rows
  int* item;                 // n: the item the bidder at a position bid on
  int* cnt;                  // 2: the lists' lengths
};

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float4 p) {
  const float dx = __fsub_rn(ax, p.x);
  const float dy = __fsub_rn(ay, p.y);
  const float dz = __fsub_rn(az, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// One item into a lane's top-2, the lane's items in increasing order: a
// value equal to the best goes to second and keeps the smaller item.
template <bool kPrice>
__device__ __forceinline__ void take(Triple& t, float4 it, float ax,
                                     float ay, float az, int j) {
  const float d = sqdist(ax, ay, az, it);
  const float v = kPrice ? __fsub_rn(-d, it.w) : -d;
  t.second = fmaxf(t.second, fminf(v, t.best));
  t.idx = v > t.best ? j : t.idx;
  t.best = fmaxf(t.best, v);
}

// Items start, start + stride, ... < m; with kPrice the value, else -d.
template <bool kPrice>
__device__ __forceinline__ Triple scan(const float4* items, int m, int start,
                                       int stride, float ax, float ay,
                                       float az) {
  Triple t{-INFINITY, -INFINITY, start < m ? start : kNone};
  int j = start;
  for (; j + 3 * stride < m; j += 4 * stride) {
    const float4 a = __ldcg(items + j);
    const float4 b = __ldcg(items + j + stride);
    const float4 c = __ldcg(items + j + 2 * stride);
    const float4 d = __ldcg(items + j + 3 * stride);
    take<kPrice>(t, a, ax, ay, az, j);
    take<kPrice>(t, b, ax, ay, az, j + stride);
    take<kPrice>(t, c, ax, ay, az, j + 2 * stride);
    take<kPrice>(t, d, ax, ay, az, j + 3 * stride);
  }
  for (; j < m; j += stride) take<kPrice>(t, __ldcg(items + j), ax, ay, az, j);
  return t;
}

// Another part's triple into t: the larger best, on a tie the smaller item;
// second is the largest value left at any other item.
__device__ __forceinline__ void merge(Triple& t, float ob, int oj, float os) {
  if (ob > t.best || (ob == t.best && oj < t.idx)) {
    t.second = fmaxf(t.best, os);
    t.best = ob;
    t.idx = oj;
  } else {
    t.second = fmaxf(t.second, ob);
  }
}

// Merge over aligned groups of `width` lanes (a power of two up to 32).
__device__ __forceinline__ void merge_lanes(Triple& t, int width) {
  for (int off = width >> 1; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, t.best, off);
    const float os = __shfl_xor_sync(kFull, t.second, off);
    const int oj = __shfl_xor_sync(kFull, t.idx, off);
    merge(t, ob, oj, os);
  }
}

template <int C>
__device__ __forceinline__ void sync_all() {
  if constexpr (C == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// The bidders at this block's positions t = rank + C k of the current list
// (u long), S threads a bidder (the largest power of two with uc S <= 1024):
// with kPrice each one's bid, else each one's nearest item written out (the
// leftovers at the cap).
template <int C, bool kPrice>
__device__ __forceinline__ void bid(const float* __restrict__ p1, State st,
                                    int n, int m, float eps, int u, int cur,
                                    int rank, volatile Triple* slots,
                                    int* arrive, float* __restrict__ dist_out,
                                    long long* __restrict__ assign_out) {
  const int uc = u > rank ? (u - rank + C - 1) / C : 0;
  if (uc == 0) return;
  const int s_log = uc >= kThreads ? 0 : 31 - __clz(kThreads / uc);
  const int s = 1 << s_log;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid & (s - 1);
  const unsigned* list = st.list + cur * n;
  for (int k0 = 0; k0 < uc; k0 += kThreads >> s_log) {
    const int k = k0 + (tid >> s_log);
    const bool active = k < uc;
    const int t = rank + C * k;
    const unsigned i = active ? __ldcg(list + t) : 0u;
    float ax = 0.f, ay = 0.f, az = 0.f;
    if (active) {
      ax = __ldg(p1 + 3 * i);
      ay = __ldg(p1 + 3 * i + 1);
      az = __ldg(p1 + 3 * i + 2);
    }
    Triple tr{-INFINITY, -INFINITY, kNone};
    if (kScan || !kPrice) {
      tr = scan<kPrice>(st.items, m, active ? sub : m, s, ax, ay, az);
    } else if (active && sub == 0) {
      tr = Triple{0.f, 0.f, static_cast<int>(i % m)};
    }
    merge_lanes(tr, s < 32 ? s : 32);
    bool post = active && sub == 0;
    if (s > 32) {  // G = s / 32 warps a bidder: the last to arrive merges
      const int g = s >> 5;
      const int group = tid >> s_log;
      int old = 0;
      if (lane == 0 && active) {
        slots[warp].best = tr.best;
        slots[warp].second = tr.second;
        slots[warp].idx = tr.idx;
        __threadfence_block();
        old = atomicAdd(&arrive[group], 1);
      }
      old = __shfl_sync(kFull, old, 0);
      post = false;
      if (active && old == g - 1) {
        __threadfence_block();
        tr = Triple{-INFINITY, -INFINITY, kNone};
        if (lane < g) {
          const int w = group * g + lane;
          tr = Triple{slots[w].best, slots[w].second, slots[w].idx};
        }
        merge_lanes(tr, g);
        post = lane == 0;
        if (post) arrive[group] = 0;
      }
    }
    if (post) {
      if (kPrice) {
        const float inc = __fadd_rn(__fsub_rn(tr.best, tr.second), eps);
        if (inc == inc)  // all values -inf (one item, priced at inf): no bid
          atomicMax(st.key + tr.idx,
                    (static_cast<unsigned long long>(__float_as_uint(inc))
                     << 32) | (~i));
        st.item[t] = tr.idx;
      } else {
        assign_out[i] = tr.idx;
        dist_out[i] = -tr.best;
      }
    }
  }
}

// This block's positions of the current list: seat the winners, and put
// the evicted owners and the losers on the next list.
__device__ __forceinline__ void resolve(State st, int n, int u, int cur,
                                        int rank, int c) {
  const int uc = u > rank ? (u - rank + c - 1) / c : 0;
  const int lane = threadIdx.x & 31;
  const unsigned* list = st.list + cur * n;
  unsigned* next = st.list + (cur ^ 1) * n;
  for (int k0 = 0; k0 < uc; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    int push = -1;
    if (k < uc) {
      const int t = rank + c * k;
      const unsigned i = __ldcg(list + t);
      const int j = __ldcg(st.item + t);
      const unsigned long long key = __ldcg(st.key + j);
      if (static_cast<unsigned>(key) == ~i) {  // a loser sees ~winner or 0
        st.key[j] = 0ull;
        push = __ldcg(st.owner + j);
        st.owner[j] = static_cast<int>(i);
        float* price = &st.items[j].w;
        *price = __fadd_rn(__ldcg(price),
                           __uint_as_float(static_cast<unsigned>(key >> 32)));
      } else {
        push = static_cast<int>(i);
      }
    }
    const unsigned ball = __ballot_sync(kFull, push >= 0);
    int base = 0;
    if (lane == 0 && ball) base = atomicAdd(st.cnt + (cur ^ 1), __popc(ball));
    base = __shfl_sync(kFull, base, 0);
    if (push >= 0) next[base + __popc(ball & ((1u << lane) - 1u))] = push;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
emd_global_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  int n, int m, float eps, int iters, float4* items,
                  unsigned long long* key, int* owner, unsigned* list,
                  int* item, int* cnt, float* __restrict__ dist_out,
                  long long* __restrict__ assign_out,
                  long long* __restrict__ stats) {
  __shared__ Triple slots[kWarps];
  __shared__ int arrive[kWarps];

  const int pair = blockIdx.x / C;
  int rank = 0;
  if constexpr (C > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const float* p1 = x1 + (size_t)pair * n * 3;
  const float* p2 = x2 + (size_t)pair * m * 3;
  const State st{items + (size_t)pair * m, key + (size_t)pair * m,
                 owner + (size_t)pair * m, list + (size_t)pair * 2 * n,
                 item + (size_t)pair * n, cnt + 2 * pair};
  dist_out += (size_t)pair * n;
  assign_out += (size_t)pair * n;
  stats += 2 * pair;

  for (int j = rank * kThreads + threadIdx.x; j < m; j += C * kThreads) {
    st.items[j] = make_float4(p2[3 * j], p2[3 * j + 1], p2[3 * j + 2], 0.f);
    st.key[j] = 0ull;
    st.owner[j] = -1;
  }
  for (int t = rank * kThreads + threadIdx.x; t < n; t += C * kThreads)
    st.list[t] = t;
  if (rank == 0 && threadIdx.x == 0) {
    st.cnt[0] = n;
    st.cnt[1] = 0;
  }
  if (threadIdx.x < kWarps) arrive[threadIdx.x] = 0;
  __threadfence();
  sync_all<C>();

  int rounds = 0, u = n, cur = 0;
  long long bids = 0;
  while (rounds < iters && (u > 0 || !kScan)) {
    if (rank == 0 && threadIdx.x == 0) st.cnt[cur ^ 1] = 0;
    bid<C, true>(p1, st, n, m, eps, u, cur, rank, slots, arrive, nullptr,
                 nullptr);
    __threadfence();
    sync_all<C>();
    resolve(st, n, u, cur, rank, C);
    __threadfence();
    sync_all<C>();
    bids += u;
    ++rounds;
    cur ^= 1;
    u = __ldcg(st.cnt + cur);
  }
  // the leftovers' nearest items, then the owners' items
  bid<C, false>(p1, st, n, m, 0.f, u, cur, rank, slots, arrive, dist_out,
                assign_out);
  for (int j = rank * kThreads + threadIdx.x; j < m; j += C * kThreads) {
    const int o = __ldcg(st.owner + j);
    if (o >= 0) {
      assign_out[o] = j;
      dist_out[o] = sqdist(p1[3 * o], p1[3 * o + 1], p1[3 * o + 2],
                           __ldcg(st.items + j));
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    stats[0] = rounds;
    stats[1] = bids;
  }
}

template <int C>
cudaLaunchConfig_t cluster_config(int b, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int C>
cudaError_t launch(const float* x1, const float* x2, int b, int n, int m,
                   float eps, int iters, float4* items,
                   unsigned long long* key, int* owner, unsigned* list,
                   int* item, int* cnt, float* dist, long long* assign,
                   long long* stats, cudaStream_t s) {
  if constexpr (C == 1) {
    emd_global_kernel<1><<<b, kThreads, 0, s>>>(x1, x2, n, m, eps, iters,
                                                 items, key, owner, list,
                                                 item, cnt, dist, assign,
                                                 stats);
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<C>(b, s, &attr);
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, emd_global_kernel<C>, x1, x2, n, m, eps, iters, items, key,
        owner, list, item, cnt, dist, assign, stats);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

template <int C>
int max_clusters() {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<C>(1, nullptr, &attr);
  int count = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&count, emd_global_kernel<C>, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : count;
}

}  // namespace

// The most clusters of c = 2, 4 or 8 blocks the card holds at once (the
// launch plan's input), or minus a CUDA error.
extern "C" int houv_emd_global_max_clusters(int c) {
  switch (c) {
    case 2: return max_clusters<2>();
    case 4: return max_clusters<4>();
    case 8: return max_clusters<8>();
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// x1: (b, n, 3), x2: (b, m, 3) f32; scratch, each per pair: items (b, m, 4)
// f32, key (b, m) u64, owner (b, m) i32, list (b, 2 n) u32, item (b, n) i32,
// cnt (b, 2) i32; dist: (b, n) f32, assign: (b, n) int64 and stats: (b, 2)
// int64 out. n, m >= 1, eps > 0, clusters 1, 2, 4 or 8 blocks a pair.
extern "C" int houv_emd_global(const float* x1, const float* x2, int b, int n,
                               int m, float eps, int iters, int clusters,
                               float* items, long long* key, int* owner,
                               int* list, int* item, int* cnt, float* dist,
                               long long* assign, long long* stats,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1 || b < 1) return static_cast<int>(cudaErrorInvalidValue);
  float4* it = reinterpret_cast<float4*>(items);
  auto* k = reinterpret_cast<unsigned long long*>(key);
  auto* l = reinterpret_cast<unsigned*>(list);
  switch (clusters) {
    case 1:
      return launch<1>(x1, x2, b, n, m, eps, iters, it, k, owner, l, item,
                       cnt, dist, assign, stats, s);
    case 2:
      return launch<2>(x1, x2, b, n, m, eps, iters, it, k, owner, l, item,
                       cnt, dist, assign, stats, s);
    case 4:
      return launch<4>(x1, x2, b, n, m, eps, iters, it, k, owner, l, item,
                       cnt, dist, assign, stats, s);
    case 8:
      return launch<8>(x1, x2, b, n, m, eps, iters, it, k, owner, l, item,
                       cnt, dist, assign, stats, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
