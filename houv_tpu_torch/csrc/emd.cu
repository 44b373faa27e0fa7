// Auction earth mover's distance, fixed epsilon (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/emd_kernel.py:_emd_kernel (wrapper
// emd_auction_pallas) with the contract of houv_tpu/ops/emd.py:
// _auction_single, one cloud pair per block or per cluster of blocks:
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
// plain PyTorch version ops/emd.py:_auction_plain computes it, so both run
// the same rounds to the same assignment. The TPU's epsilon scaling and
// compacted tail were Mosaic accelerations, not semantics, and are not
// carried over.
//
// What bounds it on this card: f32 ALU work, data dependent: each bid
// evaluates M values at about 11 flops each, while the clouds are 24 KB per
// pair. The bound is reckoned from the counted bids. A pair's rounds form a
// chain: the first few hold hundreds of bidders (bound by throughput), the
// thousands after them one to a few (bound by latency).
//
// Design. Shared memory per block: the items as float4 {x, y, z, price},
// one 64-bit bid key and one owner per item, and two lists of bidders
// (28 bytes an item, 8 a bidder). A round:
//   A. the u unassigned bidders of the current list are dealt out, S
//      threads to a bidder, S the largest power of two with u S <= 1024
//      (one thread each from 1024 bidders up, all 32 warps for the last
//      one). A thread scans items sub, sub + S, ... with one 16-byte load
//      each and a branch-free top-2 that keeps the smaller item on ties;
//      the S threads merge their (best, item, second) by shuffles and, past
//      a warp, through per-warp slots, the warp that arrives last merging
//      them (no barrier). The merge is associative, so the split does not
//      change the result. The bidder posts max(key[item], inc_bits << 32 |
//      ~row) (atomicMax, or a compare-and-swap loop across a cluster): a
//      positive float orders like its bits, so the largest increment wins
//      and, among equal ones, the smallest row.
//      It overwrites its list entry with (item << 16 | row).
//   B. each entry of the list reads its item's key: the bidder whose row
//      is in it won; it clears the key, takes the item from its owner and
//      raises the price. The evicted owner, or the bidder that lost, goes
//      onto the next list (warp-aggregated atomics; its order changes
//      nothing, since every bid is independent and the key decides ties).
// A round is O(u) apart from the scans: no pass over all items or all
// bidders, and two barriers.
// More SMs a pair (the plan ops/emd.py:_emd_plan, C 2 or 3): a cluster of C blocks, each holding every item, deals the bidders out by
// list position (t mod C) and posts to the keys, owners and lists of block
// 0 through distributed shared memory; a winner writes its new price into
// every block's copy, and cluster barriers take the block barriers' place.
// Once kSolo or fewer bidders are left, the other blocks leave and block 0
// runs the tail alone on block barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;                 // an item no lane holds
constexpr int kBytesPerItem = 16 + 8 + 4;         // item, key, owner
constexpr int kBytesPerBidder = 4 + 4;            // two lists
constexpr int kMaxSmem = 232448 - 1024;  // opt-in limit, less static slack
// A cluster hands the tail to block 0 at kSolo or fewer bidders
// (scripts/time_emd_variants.py times other values).
constexpr int kSolo = 16;

struct Triple {
  float best, second;
  int idx;
};

// Rank 0's arrays: local in one block, distributed shared memory in a
// cluster.
struct State {
  unsigned long long* key;  // m
  int* owner;               // m
  unsigned* list;           // 2 n: the current and the next list
  int* cnt;                 // 2: their lengths
};

// Every block's items, whose prices a winner raises.
template <int C>
struct Copies {
  float4* p[C];
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
    const float4 a = items[j];
    const float4 b = items[j + stride];
    const float4 c = items[j + 2 * stride];
    const float4 d = items[j + 3 * stride];
    take<kPrice>(t, a, ax, ay, az, j);
    take<kPrice>(t, b, ax, ay, az, j + stride);
    take<kPrice>(t, c, ax, ay, az, j + 2 * stride);
    take<kPrice>(t, d, ax, ay, az, j + 3 * stride);
  }
  for (; j < m; j += stride) take<kPrice>(t, items[j], ax, ay, az, j);
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

// key = max(key, bid). In a block's own shared memory one atomicMax; in
// block 0's through distributed shared memory a compare-and-swap loop:
// nvcc lowers a 64-bit max there (atomicMax, or atom.shared::cluster in
// PTX) to ATOM.E.MAX.64 with a CAS spin (ATOMS.CAST.SPIN.64) for shared
// addresses, and on an H100 with CUDA 12.8 the larger key is lost when
// other blocks of the cluster post it, while a 32-bit max and a CAS loop
// keep it (scripts/emd_dsmem_atomic.cu).
template <int C>
__device__ __forceinline__ void raise_key(unsigned long long* key,
                                          unsigned long long bid) {
  if constexpr (C == 1) {
    atomicMax(key, bid);
  } else {
    unsigned long long seen =
        *reinterpret_cast<volatile unsigned long long*>(key);
    while (seen < bid) {
      const unsigned long long old = atomicCAS(key, seen, bid);
      if (old == seen) break;
      seen = old;
    }
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
// (u long): with kPrice each one's bid (phase A), else each one's nearest
// item written out (the leftovers at the cap).
template <int C, bool kPrice>
__device__ __forceinline__ void bid(const float* __restrict__ p1,
                                    const float4* items, State st, int n,
                                    int m, float eps, int u, int cur, int rank,
                                    volatile Triple* slots, int* arrive,
                                    float* __restrict__ dist_out,
                                    long long* __restrict__ assign_out) {
  const int uc = u > rank ? (u - rank + C - 1) / C : 0;
  if (uc == 0) return;
  const int s_log = uc >= kThreads ? 0 : 31 - __clz(kThreads / uc);
  const int s = 1 << s_log;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid & (s - 1);
  unsigned* list = st.list + cur * n;
  for (int k0 = 0; k0 < uc; k0 += kThreads >> s_log) {
    const int k = k0 + (tid >> s_log);
    const bool active = k < uc;
    const int t = rank + C * k;
    const unsigned i = active ? list[t] : 0u;
    float ax = 0.f, ay = 0.f, az = 0.f;
    if (active) {
      ax = __ldg(p1 + 3 * i);
      ay = __ldg(p1 + 3 * i + 1);
      az = __ldg(p1 + 3 * i + 2);
    }
    Triple tr = scan<kPrice>(items, m, active ? sub : m, s, ax, ay, az);
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
          raise_key<C>(st.key + tr.idx,
                       (static_cast<unsigned long long>(__float_as_uint(inc))
                        << 32) | (~i));
        list[t] = (static_cast<unsigned>(tr.idx) << 16) | i;
      } else {
        assign_out[i] = tr.idx;
        dist_out[i] = -tr.best;
      }
    }
  }
}

// Phase B for this block's positions of the current list: seat the
// winners, and put the evicted owners and the losers on the next list.
template <int C>
__device__ __forceinline__ void resolve(State st, Copies<C> copies,
                                        const float4* items, int n, int u,
                                        int cur, int rank) {
  const int uc = u > rank ? (u - rank + C - 1) / C : 0;
  const int lane = threadIdx.x & 31;
  const unsigned* list = st.list + cur * n;
  unsigned* next = st.list + (cur ^ 1) * n;
  for (int k0 = 0; k0 < uc; k0 += kThreads) {
    const int k = k0 + threadIdx.x;
    int push = -1;
    if (k < uc) {
      const unsigned rec = list[rank + C * k];
      const int j = static_cast<int>(rec >> 16);
      const unsigned i = rec & 0xffffu;
      const unsigned long long key =
          *reinterpret_cast<volatile unsigned long long*>(st.key + j);
      if (static_cast<unsigned>(key) == ~i) {  // a loser sees ~winner or 0
        st.key[j] = 0ull;
        push = st.owner[j];
        st.owner[j] = static_cast<int>(i);
        const float price = __fadd_rn(
            items[j].w, __uint_as_float(static_cast<unsigned>(key >> 32)));
#pragma unroll
        for (int c = 0; c < C; ++c) copies.p[c][j].w = price;
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

// Rounds while fewer than iters ran and more than `stop` bidders are left.
template <int C>
__device__ __forceinline__ void run(
    const float* __restrict__ p1, const float4* items, Copies<C> copies,
    State st, int n, int m, float eps, int iters, int rank, int stop,
    volatile Triple* slots, int* arrive, int& rounds, long long& bids, int& u,
    int& cur) {
  while (rounds < iters && u > stop) {
    if (rank == 0 && threadIdx.x == 0) st.cnt[cur ^ 1] = 0;
    bid<C, true>(p1, items, st, n, m, eps, u, cur, rank, slots, arrive,
                 nullptr, nullptr);
    sync_all<C>();
    resolve<C>(st, copies, items, n, u, cur, rank);
    sync_all<C>();
    bids += u;
    ++rounds;
    cur ^= 1;
    u = *reinterpret_cast<volatile int*>(st.cnt + cur);
  }
}

// The outputs: the leftovers' nearest items, the owners' items, the stats.
template <int C>
__device__ __forceinline__ void finish(
    const float* __restrict__ p1, const float4* items, State st, int n, int m,
    int rank, int u, int cur, int rounds, long long bids,
    volatile Triple* slots, int* arrive, float* __restrict__ dist_out,
    long long* __restrict__ assign_out, long long* __restrict__ stats) {
  bid<C, false>(p1, items, st, n, m, 0.f, u, cur, rank, slots, arrive,
                dist_out, assign_out);
  for (int j = rank * kThreads + threadIdx.x; j < m; j += C * kThreads) {
    const int o = st.owner[j];
    if (o >= 0) {
      assign_out[o] = j;
      dist_out[o] = sqdist(p1[3 * o], p1[3 * o + 1], p1[3 * o + 2], items[j]);
    }
  }
  if (rank == 0 && threadIdx.x == 0) {
    stats[0] = rounds;
    stats[1] = bids;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
emd_kernel(const float* __restrict__ x1, const float* __restrict__ x2, int n,
           int m, float eps, int iters, float* __restrict__ dist_out,
           long long* __restrict__ assign_out,
           long long* __restrict__ stats) {
  extern __shared__ float4 smem[];
  float4* items = smem;                                           // m
  auto* key = reinterpret_cast<unsigned long long*>(items + m);   // m
  int* owner = reinterpret_cast<int*>(key + m);                   // m
  auto* list = reinterpret_cast<unsigned*>(owner + m);            // 2 n
  __shared__ int cnt[2];
  __shared__ Triple slots[kWarps];
  __shared__ int arrive[kWarps];

  const int pair = blockIdx.x / C;
  int rank = 0;
  if constexpr (C > 1) rank = static_cast<int>(cg::this_cluster().block_rank());
  const float* p1 = x1 + (size_t)pair * n * 3;
  const float* p2 = x2 + (size_t)pair * m * 3;
  dist_out += (size_t)pair * n;
  assign_out += (size_t)pair * n;
  stats += 2 * pair;

  for (int j = threadIdx.x; j < m; j += kThreads)
    items[j] = make_float4(p2[3 * j], p2[3 * j + 1], p2[3 * j + 2], 0.f);
  if (rank == 0) {
    for (int j = threadIdx.x; j < m; j += kThreads) {
      key[j] = 0ull;
      owner[j] = -1;
    }
    for (int t = threadIdx.x; t < n; t += kThreads) list[t] = t;
    if (threadIdx.x == 0) {
      cnt[0] = n;
      cnt[1] = 0;
    }
  }
  if (threadIdx.x < kWarps) arrive[threadIdx.x] = 0;
  sync_all<C>();

  const State local{key, owner, list, cnt};
  const Copies<1> own{{items}};
  int rounds = 0, u = n, cur = 0;
  long long bids = 0;
  if constexpr (C == 1) {
    run<1>(p1, items, own, local, n, m, eps, iters, 0, 0, slots, arrive,
           rounds, bids, u, cur);
    finish<1>(p1, items, local, n, m, 0, u, cur, rounds, bids, slots, arrive,
              dist_out, assign_out, stats);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    const State st{cluster.map_shared_rank(key, 0),
                   cluster.map_shared_rank(owner, 0),
                   cluster.map_shared_rank(list, 0),
                   cluster.map_shared_rank(cnt, 0)};
    Copies<C> copies;
#pragma unroll
    for (int c = 0; c < C; ++c)
      copies.p[c] = cluster.map_shared_rank(items, c);
    run<C>(p1, items, copies, st, n, m, eps, iters, rank, kSolo, slots,
           arrive, rounds, bids, u, cur);
    if (rounds < iters && u > 0) {
      // the tail on block 0 alone; the last cluster barrier ordered every
      // access to the other blocks, and none reads block 0 from here on
      if (rank != 0) return;
      run<1>(p1, items, own, local, n, m, eps, iters, 0, 0, slots, arrive,
             rounds, bids, u, cur);
      finish<1>(p1, items, local, n, m, 0, u, cur, rounds, bids, slots,
                arrive, dist_out, assign_out, stats);
      return;
    }
    finish<C>(p1, items, st, n, m, rank, u, cur, rounds, bids, slots, arrive,
              dist_out, assign_out, stats);
    cluster.sync();  // block 0's shared memory outlives the others' reads
  }
}

template <int C>
cudaError_t set_smem(int smem) {
  return cudaFuncSetAttribute(emd_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int C>
cudaLaunchConfig_t cluster_config(int b, int smem, cudaStream_t s,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
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
                   float eps, int iters, float* dist, long long* assign,
                   long long* stats, cudaStream_t s) {
  const int smem = kBytesPerItem * m + kBytesPerBidder * n;
  cudaError_t e = set_smem<C>(smem);
  if (e != cudaSuccess) return e;
  if constexpr (C == 1) {
    emd_kernel<1><<<b, kThreads, smem, s>>>(x1, x2, n, m, eps, iters, dist,
                                            assign, stats);
  } else {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config<C>(b, smem, s, &attr);
    e = cudaLaunchKernelEx(&cfg, emd_kernel<C>, x1, x2, n, m, eps, iters,
                           dist, assign, stats);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

template <int C>
int max_clusters(int smem) {
  cudaError_t e = set_smem<C>(smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<C>(C, smem, nullptr, &attr);
  int count = 0;
  e = cudaOccupancyMaxActiveClusters(&count, emd_kernel<C>, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : count;
}

}  // namespace

// Shared-memory bytes a block needs for n bidders and m items, and the
// most it can have: a pair fits when the first is at most the second.
extern "C" int houv_emd_smem_bytes(int n, int m) {
  const long long need =
      (long long)kBytesPerItem * m + (long long)kBytesPerBidder * n;
  return need > 0x7fffffff ? 0x7fffffff : static_cast<int>(need);
}
extern "C" int houv_emd_max_smem_bytes() { return kMaxSmem; }

// The most clusters of c = 2 or 3 blocks the card holds at once for n
// bidders and m items (the launch plan's input), or minus a CUDA error.
extern "C" int houv_emd_max_clusters(int n, int m, int c) {
  const int smem = houv_emd_smem_bytes(n, m);
  if (n < 1 || m < 1 || smem > kMaxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  switch (c) {
    case 2: return max_clusters<2>(smem);
    case 3: return max_clusters<3>(smem);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// x1: (b, n, 3), x2: (b, m, 3) f32; dist: (b, n) f32, assign: (b, n) int64
// and stats: (b, 2) int64 out. n, m >= 1, the pair fits (above), eps > 0,
// clusters in 1..3 blocks a pair.
extern "C" int houv_emd(const float* x1, const float* x2, int b, int n, int m,
                        float eps, int iters, int clusters, float* dist,
                        long long* assign, long long* stats, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || m < 1 || houv_emd_smem_bytes(n, m) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (clusters) {
    case 1:
      return launch<1>(x1, x2, b, n, m, eps, iters, dist, assign, stats, s);
    case 2:
      return launch<2>(x1, x2, b, n, m, eps, iters, dist, assign, stats, s);
    case 3:
      return launch<3>(x1, x2, b, n, m, eps, iters, dist, assign, stats, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
