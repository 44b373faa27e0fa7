// Variants of houv_tpu_torch/csrc/emd_large.cu that
// scripts/time_large_variants.py builds and times ("_source"), not part of
// the package: the package's design (kAsync 1, kCompact 1) and the
// exchanges measured against it and not kept (PERF.md). kAsync 0 waits at a
// cluster barrier after phase A in place of the partials' st.async bytes
// completing each peer's mbarrier; kCompact 0 takes the next list's
// positions from rank 0's count by a remote atomicAdd, then a cluster
// barrier and a remote read of the count, in place of each position's push
// sent to every block and compacted there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;        // an item no lane holds
constexpr int kMaxSmem = 232448 - 1024;  // opt-in limit, less static slack
// Bidders a chunk of phase A, and the fewest items a thread scans: 32 keeps
// a tail bidder on one warp at 8 blocks of 1024 items (its merge all
// shuffles, no slots); of 1, 4, 16 and 32 the fastest at (2, 8192)^2 and
// level with the others at the larger shapes (PERF.md).
constexpr int kChunk = 128;
constexpr int kItems = 32;
// Variant switch (scripts/time_large_variants.py): kScan 0 drops the item
// scan (bidder i bids eps on item i mod M, and the rounds run to `iters`
// with whatever bidders are left: wrong assignments, a round's fixed cost
// alone, the latency floor).
constexpr int kScan = 1;
// kAsync 1 writes the partial triples with st.async, whose bytes complete
// the peer's mbarrier (the chunk's expected bytes are known to every block),
// in place of a cluster barrier after phase A.
constexpr int kAsync = 1;
// kCompact 1: phase B sends each position's push (the evicted owner, the
// loser, or none) from its item's home block into every block's next list
// at the position, by st.async into the round's mbarrier, and every block
// compacts its copy in position order (the same list everywhere, no count
// to share); 0 takes positions from rank 0's count by a remote atomicAdd,
// then a cluster barrier and a remote read of the count.
constexpr int kCompact = 1;
constexpr unsigned kEmpty = 0xffffffffu;  // a position that pushes no one

struct Triple {
  float best, second;
  int idx;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The same offset in another block of the cluster.
__device__ __forceinline__ unsigned peer_addr(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void stc_f4(unsigned a, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ void sta_f4(unsigned a, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(a),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void sta_u32(unsigned a, unsigned v,
                                        unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(a),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned a, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned a, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   a),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned a, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void stc_u32(unsigned a, unsigned v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(a), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned ldc_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned atomc_add(unsigned a, unsigned v) {
  unsigned old;
  asm volatile("atom.shared::cluster.add.u32 %0, [%1], %2;"
               : "=r"(old)
               : "r"(a), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

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

// Items start, start + stride, ... < m of the slice; with kPrice the value,
// else -d.
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

// A block's shared memory: items, keys, owners of its slice, both lists,
// the partial triples of both parities. Offsets in bytes.
struct Layout {
  int mb;
  size_t key, owner, list, part, total;
};

__host__ __device__ inline Layout layout(int n, int m, int c) {
  Layout l;
  l.mb = (m + c - 1) / c;
  l.key = 16 * (size_t)l.mb;
  l.owner = l.key + 8 * (size_t)l.mb;
  l.list = l.owner + 4 * (size_t)l.mb;
  l.part = (l.list + 8 * (size_t)n + 15) / 16 * 16;
  l.total = l.part + 2 * (size_t)kChunk * c * 16;
  return l;
}

// Phase A for the chunk of q bidders at positions k0.. of the current list:
// each thread group scans this block's slice and the group's partial goes
// to slot [parity][position][rank] of every peer.
template <bool kPrice>
__device__ __forceinline__ void scan_chunk(
    const float* __restrict__ p1, const float4* items, const unsigned* list,
    int mine, int base, int k0, int q, int c, int rank, unsigned part_at,
    unsigned bar_at, int par, volatile Triple* slots, int* arrive) {
  int cap = 1;  // threads a bidder: every bidder in one pass, kItems each
  while (2 * cap * kItems <= mine && 2 * cap * q <= kThreads) cap *= 2;
  const int s = cap;
  const int s_log = 31 - __clz(s);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = tid & (s - 1);
  const int pos = tid >> s_log;
  const bool active = pos < q;
  if (warp * 32 >= q * s) return;  // whole warps past the chunk's groups
  const unsigned i = active ? list[k0 + pos] : 0u;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (active) {
    ax = __ldg(p1 + 3 * i);
    ay = __ldg(p1 + 3 * i + 1);
    az = __ldg(p1 + 3 * i + 2);
  }
  Triple tr{-INFINITY, -INFINITY, kNone};
  if (kScan || !kPrice) {  // (the floor's bids are made after the merge)
    tr = scan<kPrice>(items, mine, active ? sub : mine, s, ax, ay, az);
    if (tr.idx != kNone) tr.idx += base;
  }
  merge_lanes(tr, s < 32 ? s : 32);
  bool post = active && sub == 0;
  if (s > 32) {  // G = s / 32 warps a bidder: the last to arrive merges
    const int g = s >> 5;
    int old = 0;
    if (lane == 0 && active) {
      slots[warp].best = tr.best;
      slots[warp].second = tr.second;
      slots[warp].idx = tr.idx;
      __threadfence_block();
      old = atomicAdd(&arrive[pos], 1);
    }
    old = __shfl_sync(kFull, old, 0);
    post = false;
    if (active && old == g - 1) {
      __threadfence_block();
      tr = Triple{-INFINITY, -INFINITY, kNone};
      if (lane < g) {
        const int w = pos * g + lane;
        tr = Triple{slots[w].best, slots[w].second, slots[w].idx};
      }
      merge_lanes(tr, g);
      post = lane == 0;
      if (post) arrive[pos] = 0;
    }
  }
  if (post) {
    const float4 v = make_float4(tr.best, tr.second, __int_as_float(tr.idx),
                                 0.f);
    const unsigned at = part_at + 16 * ((par * kChunk + pos) * c + rank);
    for (int r = 0; r < c; ++r) {
      if constexpr (kAsync) {
        sta_f4(peer_addr(at, r), v, peer_addr(bar_at + 8 * par, r));
      } else {
        stc_f4(peer_addr(at, r), v);
      }
    }
  }
}

// Every peer's partials of the chunk in this block: the mbarrier of the
// chunk's parity once its q C triples have landed (kAsync), else a cluster
// barrier.
__device__ __forceinline__ void chunk_sync(unsigned bar_at, int phase, int q,
                                           int c) {
  if constexpr (kAsync) {
    const unsigned bar = bar_at + 8 * (phase & 1);
    if (threadIdx.x == 0) mbar_expect(bar, 16 * q * c);
    mbar_wait(bar, (phase >> 1) & 1);
  } else {
    cluster_sync();
  }
}

template <bool kPrice>
__device__ __forceinline__ Triple merged(const float4* part, int par, int pos,
                                         int c) {
  Triple t{-INFINITY, -INFINITY, kNone};
  for (int r = 0; r < c; ++r) {
    const float4 v = part[(par * kChunk + pos) * c + r];
    merge(t, v.x, __float_as_int(v.z), v.y);
  }
  return t;
}

// The first u entries of a list without the kEmpty ones, in order, in
// place; returns how many are left (the same in every block).
__device__ __forceinline__ int compact(unsigned* list, int u, int* sums) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int total = 0;
  for (int k0 = 0; k0 < u; k0 += kThreads) {
    const int k = k0 + tid;
    const unsigned v = k < u ? list[k] : kEmpty;
    const unsigned ball = __ballot_sync(kFull, v != kEmpty);
    if (lane == 0) sums[warp] = __popc(ball);
    __syncthreads();  // (every read of the chunk before any write)
    int incl = sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    const int before = __shfl_sync(kFull, incl, warp) - sums[warp];
    const int all = __shfl_sync(kFull, incl, 31);
    if (v != kEmpty)
      list[total + before + __popc(ball & ((1u << lane) - 1u))] = v;
    total += all;
    __syncthreads();
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
emd_large_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                 int n, int m, float eps, int iters, int c,
                 float* __restrict__ dist_out,
                 long long* __restrict__ assign_out,
                 long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Triple slots[kWarps];
  __shared__ int arrive[kWarps];
  __shared__ unsigned cnt[2];  // rank 0's: the lists' lengths
  __shared__ __align__(8) unsigned long long bars[2];  // the chunks' (kAsync)
  __shared__ __align__(8) unsigned long long pushes[2];  // rounds' (kCompact)
  __shared__ int sums[kWarps];

  const Layout lay = layout(n, m, c);
  auto* items = reinterpret_cast<float4*>(smem);
  auto* key = reinterpret_cast<unsigned long long*>(smem + lay.key);
  auto* owner = reinterpret_cast<int*>(smem + lay.owner);
  auto* lists = reinterpret_cast<unsigned*>(smem + lay.list);
  auto* part = reinterpret_cast<float4*>(smem + lay.part);

  const int rank = static_cast<int>(cluster_rank());
  const int pair = blockIdx.x / c;
  const int mb = lay.mb;
  const int base = rank * mb;
  const int mine = max(0, min(mb, m - base));
  const int tid = threadIdx.x;
  const float* p1 = x1 + (size_t)pair * n * 3;
  const float* p2 = x2 + (size_t)pair * m * 3 + 3 * (size_t)base;
  dist_out += (size_t)pair * n;
  assign_out += (size_t)pair * n;
  stats += 2 * pair;

  for (int j = tid; j < mine; j += kThreads) {
    items[j] = make_float4(p2[3 * j], p2[3 * j + 1], p2[3 * j + 2], 0.f);
    key[j] = 0ull;
    owner[j] = -1;
  }
  for (int t = tid; t < n; t += kThreads) lists[t] = t;
  if (tid < kWarps) arrive[tid] = 0;
  if (tid == 0) {
    cnt[0] = n;
    cnt[1] = 0;
    if (kAsync || kCompact) {
      mbar_init(smem_addr(bars), 1);
      mbar_init(smem_addr(bars) + 8, 1);
      mbar_init(smem_addr(pushes), 1);
      mbar_init(smem_addr(pushes) + 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  cluster_sync();

  const unsigned part_at = smem_addr(part);
  const unsigned lists_at = smem_addr(lists);
  const unsigned cnt0 = peer_addr(smem_addr(cnt), 0);
  const unsigned bars_at = smem_addr(bars);
  const unsigned pushes_at = smem_addr(pushes);
  int rounds = 0, u = n, cur = 0, phase = 0;
  long long bids = 0;
  while (rounds < iters && (u > 0 || !kScan)) {
    unsigned* list = lists + cur * n;
    for (int k0 = 0; k0 < u; k0 += kChunk) {
      const int q = min(kChunk, u - k0);
      const int par = phase & 1;
      scan_chunk<true>(p1, items, list, mine, base, k0, q, c, rank, part_at,
                       bars_at, par, slots, arrive);
      chunk_sync(bars_at, phase, q, c);
      if (tid < q) {
        Triple t = merged<true>(part, par, tid, c);
        const unsigned i = list[k0 + tid];
        if (!kScan) t = Triple{0.f, 0.f, static_cast<int>(i % m)};
        const float inc = __fadd_rn(__fsub_rn(t.best, t.second), eps);
        if (inc == inc && t.idx / mb == rank)  // else no bid: a loser
          atomicMax(key + (t.idx - base),
                    (static_cast<unsigned long long>(__float_as_uint(inc))
                     << 32) | (~i));
        list[k0 + tid] = (static_cast<unsigned>(t.idx) << 16) | i;
      }
      // the chunk's slots read before any thread posts the next chunk's
      // (a peer may then fill this parity again); B reads the keys
      __syncthreads();
      ++phase;
    }
    // phase B: the entries whose item this block holds
    const unsigned next_at = lists_at + 4 * (cur ^ 1) * n;
    const unsigned bar = pushes_at + 8 * (rounds & 1);
    if (kCompact && tid == 0) mbar_expect(bar, 4 * u);
    const int lane = tid & 31;
    for (int k0 = 0; k0 < u; k0 += kThreads) {
      const int k = k0 + tid;
      int push = -1;
      bool home = false;
      if (k < u) {
        const unsigned rec = list[k];
        const int j = static_cast<int>(rec >> 16);
        const unsigned i = rec & 0xffffu;
        home = j / mb == rank;
        if (home) {
          const int jl = j - base;
          const unsigned long long kj = key[jl];
          if (static_cast<unsigned>(kj) == ~i) {  // a loser sees ~winner or 0
            key[jl] = 0ull;
            push = owner[jl];
            owner[jl] = static_cast<int>(i);
            items[jl].w = __fadd_rn(
                items[jl].w, __uint_as_float(static_cast<unsigned>(kj >> 32)));
          } else {
            push = static_cast<int>(i);
          }
        }
      }
      if constexpr (kCompact) {
        if (home) {
          const unsigned v = push >= 0 ? static_cast<unsigned>(push) : kEmpty;
          for (int r = 0; r < c; ++r)
            sta_u32(peer_addr(next_at + 4 * k, r), v, peer_addr(bar, r));
        }
      } else {
        const unsigned ball = __ballot_sync(kFull, push >= 0);
        unsigned at = 0;
        if (lane == 0 && ball)
          at = atomc_add(cnt0 + 4 * (cur ^ 1), __popc(ball));
        at = __shfl_sync(kFull, at, 0);
        if (push >= 0) {
          const unsigned to =
              next_at + 4 * (at + __popc(ball & ((1u << lane) - 1u)));
          for (int r = 0; r < c; ++r)
            stc_u32(peer_addr(to, r), static_cast<unsigned>(push));
        }
      }
    }
    bids += u;
    if constexpr (kCompact) {
      // every position's push in, then this block's copy of the next list;
      // the block barrier keeps thread 0 from completing this parity again
      // (two rounds on, with no bidder left and so no other barrier) while
      // a thread still waits on it
      mbar_wait(bar, (rounds >> 1) & 1);
      __syncthreads();
      u = compact(lists + (cur ^ 1) * n, u, sums);
      ++rounds;
      cur ^= 1;
    } else {
      // this list's count, read by every block before its first partials
      // of the round, serves the round after next (the pushes come after
      // the barrier)
      if (rank == 0 && tid == 0) cnt[cur] = 0;
      cluster_sync();
      ++rounds;
      cur ^= 1;
      u = static_cast<int>(ldc_u32(cnt0 + 4 * cur));
    }
  }
  // the leftovers' nearest items (rank 0 writes them), then the owners'
  const unsigned* list = lists + cur * n;
  for (int k0 = 0; k0 < u; k0 += kChunk) {
    const int q = min(kChunk, u - k0);
    const int par = phase & 1;
    scan_chunk<false>(p1, items, list, mine, base, k0, q, c, rank, part_at,
                      bars_at, par, slots, arrive);
    chunk_sync(bars_at, phase, q, c);
    if (rank == 0 && tid < q) {
      const Triple t = merged<false>(part, par, tid, c);
      const unsigned i = list[k0 + tid];
      assign_out[i] = t.idx;
      dist_out[i] = -t.best;
    }
    __syncthreads();
    ++phase;
  }
  for (int j = tid; j < mine; j += kThreads) {
    const int o = owner[j];
    if (o >= 0) {
      assign_out[o] = base + j;
      dist_out[o] = sqdist(p1[3 * o], p1[3 * o + 1], p1[3 * o + 2], items[j]);
    }
  }
  if (rank == 0 && tid == 0) {
    stats[0] = rounds;
    stats[1] = bids;
  }
  // no block leaves while a peer may still read or write its memory
  cluster_sync();
}

cudaError_t configure(int b, int n, int m, int c, cudaStream_t s,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const size_t smem = layout(n, m, c).total;
  const cudaError_t e = cudaFuncSetAttribute(
      emd_large_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  *cfg = {};
  cfg->gridDim = dim3(b * c);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

bool valid(int n, int m, int c) {
  return n >= 1 && m >= 1 && n < 65536 && m <= 65536 &&
         (c == 1 || c == 2 || c == 4 || c == 8) &&
         layout(n, m, c).total <= static_cast<size_t>(kMaxSmem);
}

}  // namespace

// Shared-memory bytes a block of a cluster of c needs for n bidders and m
// items (INT_MAX past the packed entries' 16 bits); a pair fits when it is
// at most houv_emd_max_smem_bytes().
extern "C" int houv_emd_large_smem_bytes(int n, int m, int c) {
  if (n < 1 || m < 1 || c < 1 || n >= 65536 || m > 65536) return 0x7fffffff;
  const size_t need = layout(n, m, c).total;
  return need > 0x7fffffff ? 0x7fffffff : static_cast<int>(need);
}

// The most clusters of c blocks the card holds at once for pairs of n
// bidders and m items (the launch plan's input), or minus a CUDA error.
extern "C" int houv_emd_large_max_clusters(int n, int m, int c) {
  if (!valid(n, m, c)) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = configure(1, n, m, c, nullptr, &attr, &cfg);
  int count = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&count, emd_large_kernel, &cfg);
  return e != cudaSuccess ? -static_cast<int>(e) : count;
}

// x1: (b, n, 3), x2: (b, m, 3) f32; dist: (b, n) f32, assign: (b, n) int64
// and stats: (b, 2) int64 out. eps > 0; clusters 1, 2, 4 or 8 blocks a
// pair whose state fits (houv_emd_large_smem_bytes).
extern "C" int houv_emd_large(const float* x1, const float* x2, int b, int n,
                              int m, float eps, int iters, int clusters,
                              float* dist, long long* assign,
                              long long* stats, void* stream) {
  if (b < 1 || !valid(n, m, clusters))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = configure(b, n, m, clusters,
                            static_cast<cudaStream_t>(stream), &attr, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, emd_large_kernel, x1, x2, n, m, eps, iters,
                         clusters, dist, assign, stats);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
