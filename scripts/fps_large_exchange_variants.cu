// Variants of houv_tpu_torch/csrc/fps_large.cu that
// scripts/time_large_variants.py builds and times ("_source"), not part of
// the package: the package's design (kBlockFirst 1, kMbar 2) and the
// exchanges measured against it and not kept (PERF.md). kBlockFirst 0 has
// every warp write its winner to every peer (C W slots a step); kMbar 0
// waits at a cluster barrier (barrier.cluster.arrive.release /
// wait.acquire), 1 on an mbarrier completed by the peers' remote arrives, 2
// on one completed by the bytes of their st.async (block-first only).

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // an index no point has
constexpr int kMaxWarps = 32;
// Points a block keeps in registers: fps.cu's cap (256 threads of 32).
constexpr int kBlockPoints = 8192;
// Blocks a cluster may have on every card; 16 needs the card's consent.
constexpr int kPortable = 8;
// Variant switches (scripts/time_large_variants.py): kPass 0 drops the
// distance pass and reduces keys made from the last winner's coordinates
// (wrong picks: the chain alone, the latency floor). kBlockFirst 0 has
// every warp write its winner to every peer (C W slots a step); kMbar 0
// waits at a cluster barrier (barrier.cluster.arrive.release /
// wait.acquire), 1 on an mbarrier completed by the peers' remote arrives,
// 2 on one completed by the bytes of their st.async (block-first only).
constexpr int kPass = 1;
constexpr int kBlockFirst = 1;
constexpr int kMbar = 2;
static_assert(kMbar != 2 || kBlockFirst, "st.async needs one slot a block");

// The most threads a block of PER points a thread may have (fps.cu's).
template <int PER>
constexpr int max_threads() {
  return PER >= 32 ? 256 : PER >= 8 ? 512 : 1024;
}

// Shared memory by 32-bit address, kept in a register (fps.cu's reason).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("mov.b32 %0, %0;" : "+r"(a));
  return a;
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

__device__ __forceinline__ float4 lds_f4(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint4 lds_u4(unsigned a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float lds_f32(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void stc_u4(unsigned a, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void stc_f32(unsigned a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(a), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned a, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(a), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_remote(unsigned a) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(a)
      : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned a, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   a),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void sta_u4(unsigned a, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(a),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void sta_f32(unsigned a, float v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(a),
      "f"(v), "r"(bar)
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

// Whether slot b beats slot a: a larger key, or the same and a smaller
// index.
__device__ __forceinline__ bool beats(uint4 b, uint4 a) {
  return b.x > a.x || (b.x == a.x && b.y < a.y);
}

// The warp's largest key, then the smallest index among the lanes that
// hold it: two redux.sync.
__device__ __forceinline__ void warp_argmax(unsigned key, unsigned idx,
                                            unsigned& wkey, unsigned& widx) {
  wkey = __reduce_max_sync(kFull, key);
  widx = __reduce_min_sync(kFull, key == wkey ? idx : kNone);
}

// Shared memory of a block: its slice's float4 copy (T PER points), then
// the slots {key, index, x, y} and z of both parities (2 C W each).
__host__ __device__ constexpr size_t smem_bytes(int threads, int per, int c) {
  return 16 * (size_t)threads * per + 2 * (size_t)c * (threads / 32) * 20;
}

template <int PER>
__global__ void __launch_bounds__(max_threads<PER>())
fps_large_kernel(const float* __restrict__ pts, int n, int k, int c, int nb,
                 long long* __restrict__ out) {
  extern __shared__ __align__(16) float4 spts[];  // T PER, then the slots
  __shared__ __align__(8) unsigned long long mbar[2];
  __shared__ __align__(16) uint4 wslot_a[2][kMaxWarps];
  __shared__ float wslot_z[2][kMaxWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  const int slots = c * warps;
  const int rank = static_cast<int>(cluster_rank());
  const int cloud = blockIdx.x / c;
  const int base = rank * nb;
  const float* p = pts + (size_t)cloud * n * 3;
  uint4* slot_a = reinterpret_cast<uint4*>(spts + threads * PER);
  float* slot_z = reinterpret_cast<float*>(slot_a + 2 * slots);

  float x[PER], y[PER], z[PER], mind[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int j = q * threads + t;  // in the slice
    const int i = base + j;         // in the cloud
    const bool ok = j < nb && i < n;
    x[q] = ok ? p[3 * i] : 0.f;
    y[q] = ok ? p[3 * i + 1] : 0.f;
    z[q] = ok ? p[3 * i + 2] : 0.f;
    mind[q] = ok ? 1e10f : 0.f;  // padding: key 0, never the first largest
    spts[j] = make_float4(x[q], y[q], z[q], 0.f);
  }
  long long* o = out + (size_t)cloud * k;
  if (rank == 0 && t == 0) o[0] = 0;
  const unsigned mbar_at = smem_addr(mbar);
  if (kMbar && t == 0) {
    // arrivals a phase: every peer's warps' or blocks' (kMbar 1), or the
    // local expect_tx alone (kMbar 2: the bytes complete the phase)
    const unsigned count = kMbar == 2 ? 1 : kBlockFirst ? c : slots;
    mbar_init(mbar_at, count);
    mbar_init(mbar_at + 8, count);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every slice and barrier in place before any block writes to a peer
  cluster_sync();

  const unsigned pts_at = smem_addr(spts);
  const unsigned a_at = smem_addr(slot_a);
  const unsigned z_at = smem_addr(slot_z);
  const unsigned peer = lane < c ? lane : 0;
  const unsigned a_peer = peer_addr(a_at, peer);
  const unsigned z_peer = peer_addr(z_at, peer);
  const unsigned mbar_peer = peer_addr(mbar_at, peer);
  const int mine = rank * warps + warp;
  float lx = __ldg(p), ly = __ldg(p + 1), lz = __ldg(p + 2);
  for (int step = 1; step < k; ++step) {
    unsigned key, idx;
    if constexpr (kPass) {
      float v[PER];
      int id[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const float dx = __fsub_rn(x[q], lx);
        const float dy = __fsub_rn(y[q], ly);
        const float dz = __fsub_rn(z[q], lz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        mind[q] = fminf(mind[q], d);
        v[q] = mind[q];
        id[q] = q;
      }
#pragma unroll
      for (int s = 1; s < PER; s <<= 1) {
#pragma unroll
        for (int q = 0; q + s < PER; q += 2 * s) {
          if (v[q + s] > v[q]) {  // strict: the lower index keeps a tie
            v[q] = v[q + s];
            id[q] = id[q + s];
          }
        }
      }
      key = __float_as_uint(v[0]);
      const int j = id[0] * threads + t;
      idx = j < nb && base + j < n ? static_cast<unsigned>(base + j) : kNone;
    } else {
      key = (__float_as_uint(lx) ^ __float_as_uint(ly)) +
            0x9e3779b9u * (rank * threads + t);
      idx = base + t < n ? static_cast<unsigned>(base + t) : kNone;
    }
    unsigned wkey, widx;
    warp_argmax(key, idx, wkey, widx);
    const int par = step & 1;
    int exchanged;  // the slots of this step to reduce
    if constexpr (kBlockFirst) {
      // the block's winner first: its warps' winners in local slots, a
      // block barrier, and warp 0 writes the block's winner to every peer
      if (lane == 0) {
        const float4 w = widx != kNone ? lds_f4(pts_at + 16 * (widx - base))
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        wslot_a[par][warp] = make_uint4(wkey, widx, __float_as_uint(w.x),
                                        __float_as_uint(w.y));
        wslot_z[par][warp] = w.z;
      }
      __syncthreads();
      if (warp == 0) {
        const uint4 v = lane < warps ? wslot_a[par][lane]
                                     : make_uint4(0u, kNone, 0u, 0u);
        const float vz = lane < warps ? wslot_z[par][lane] : 0.f;
        unsigned bkey, bidx;
        warp_argmax(v.x, v.y, bkey, bidx);
        const int src = __ffs(__ballot_sync(kFull, v.y == bidx)) - 1;
        const uint4 win = make_uint4(bkey, bidx, __shfl_sync(kFull, v.z, src),
                                     __shfl_sync(kFull, v.w, src));
        const float wz = __shfl_sync(kFull, vz, src);
        if (lane < c) {
          const int at = par * c + rank;
          if constexpr (kMbar == 2) {
            sta_u4(a_peer + 16 * at, win, mbar_peer + 8 * par);
            sta_f32(z_peer + 4 * at, wz, mbar_peer + 8 * par);
          } else {
            stc_u4(a_peer + 16 * at, win);
            stc_f32(z_peer + 4 * at, wz);
            if constexpr (kMbar == 1) mbar_arrive_remote(mbar_peer + 8 * par);
          }
        }
      }
      exchanged = c;
    } else {
      if (lane < c) {
        // the warp's winner, coordinates and all, into every peer's slots
        const float4 w = widx != kNone ? lds_f4(pts_at + 16 * (widx - base))
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
        const int at = par * slots + mine;
        stc_u4(a_peer + 16 * at, make_uint4(wkey, widx, __float_as_uint(w.x),
                                            __float_as_uint(w.y)));
        stc_f32(z_peer + 4 * at, w.z);
        if constexpr (kMbar == 1) mbar_arrive_remote(mbar_peer + 8 * par);
      }
      exchanged = slots;
    }
    if constexpr (kMbar == 2) {
      if (t == 0) mbar_expect(mbar_at + 8 * par, 20 * c);
    }
    if constexpr (kMbar != 0) {
      mbar_wait(mbar_at + 8 * par, ((step - 1) >> 1) & 1);
    } else {
      cluster_sync();
    }
    // the exchanged slots: each lane its own ones, then the warp
    uint4 best = make_uint4(0u, kNone, 0u, 0u);
    float bz = 0.f;
    for (int s = lane; s < exchanged; s += 32) {
      const uint4 v = lds_u4(a_at + 16 * (par * exchanged + s));
      const float vz = lds_f32(z_at + 4 * (par * exchanged + s));
      if (beats(v, best)) {
        best = v;
        bz = vz;
      }
    }
    warp_argmax(best.x, best.y, wkey, widx);
    const int src = __ffs(__ballot_sync(kFull, best.y == widx)) - 1;
    lx = __shfl_sync(kFull, __uint_as_float(best.z), src);
    ly = __shfl_sync(kFull, __uint_as_float(best.w), src);
    lz = __shfl_sync(kFull, bz, src);
    if (rank == 0 && t == 0) o[step] = widx;
  }
  // no block leaves while a peer may still write to its slots
  cluster_sync();
}

template <int PER>
cudaError_t configure(int b, int c, int warps, cudaStream_t s,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  const size_t smem = smem_bytes(32 * warps, PER, c);
  cudaError_t e = cudaFuncSetAttribute(
      fps_large_kernel<PER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  if (c > kPortable) {
    e = cudaFuncSetAttribute(fps_large_kernel<PER>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  *cfg = {};
  cfg->gridDim = dim3(b * c);
  cfg->blockDim = dim3(32 * warps);
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

template <int PER>
int launch(const float* pts, int b, int n, int k, int c, int warps,
           long long* out, cudaStream_t s) {
  const int nb = (n + c - 1) / c;
  if (32 * warps > max_threads<PER>() || 32 * warps * PER < nb)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = configure<PER>(b, c, warps, s, &attr, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaLaunchKernelEx(&cfg, fps_large_kernel<PER>, pts, n, k, c, nb, out);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int held(int c, int warps) {
  if (32 * warps > max_threads<PER>())
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t e = configure<PER>(1, c, warps, nullptr, &attr, &cfg);
  int count = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&count, fps_large_kernel<PER>, &cfg);
  // a size the card does not admit holds no cluster
  if (e != cudaSuccess) {
    cudaGetLastError();
    return c > kPortable ? 0 : -static_cast<int>(e);
  }
  return count;
}

bool valid(int c, int warps) {
  return (c == 2 || c == 4 || c == 8 || c == 16) && warps >= 1 &&
         warps <= kMaxWarps;
}

}  // namespace

// Largest cloud the kernel takes: 8 blocks (the portable cluster) of 8192.
extern "C" int houv_fps_large_max_points() { return kPortable * kBlockPoints; }

// The most clusters of c blocks of `warps` warps and `per` points a thread
// the card holds at once (the launch plan's input; 0 for a size it does not
// admit), or minus a CUDA error.
extern "C" int houv_fps_large_max_clusters(int c, int warps, int per) {
  if (!valid(c, warps)) return -static_cast<int>(cudaErrorInvalidValue);
  switch (per) {
    case 1: return held<1>(c, warps);
    case 2: return held<2>(c, warps);
    case 4: return held<4>(c, warps);
    case 8: return held<8>(c, warps);
    case 16: return held<16>(c, warps);
    case 32: return held<32>(c, warps);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// pts: (b, n, 3) f32, out: (b, k) int64; 1 <= k, 1 <= n <= c 8192; c blocks
// a cloud (2, 4, 8 or 16) of `warps` warps and `per` points a thread
// (ops/sampling.py:_fps_cluster_plan: fps.cu's plan for ceil(n / c)).
extern "C" int houv_fps_large(const float* pts, int b, int n, int k, int c,
                              int warps, int per, long long* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || b < 1 || !valid(c, warps) ||
      (n + c - 1) / c > kBlockPoints)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (per) {
    case 1: return launch<1>(pts, b, n, k, c, warps, out, s);
    case 2: return launch<2>(pts, b, n, k, c, warps, out, s);
    case 4: return launch<4>(pts, b, n, k, c, warps, out, s);
    case 8: return launch<8>(pts, b, n, k, c, warps, out, s);
    case 16: return launch<16>(pts, b, n, k, c, warps, out, s);
    case 32: return launch<32>(pts, b, n, k, c, warps, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
