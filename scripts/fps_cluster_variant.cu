// A variant of houv_tpu_torch/csrc/fps.cu that scripts/time_fps_variants.py
// builds and times ("_source"; "_cluster": 2), not part of the package:
// each cloud on a cluster of 2 blocks (2 SMs). Block r of the pair owns the
// points 2 T q + r T + t and keeps the whole cloud in its shared memory; a
// step's warp winners go to the slots of both blocks (distributed shared
// memory), and one cluster barrier replaces the block's.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // an index no point has
constexpr int kMaxWarps = 32;
// Variant switch (scripts/time_fps_variants.py): kPass 0 drops the distance
// pass and reduces keys made from the last winner's coordinates (wrong
// picks: the chain alone, the latency floor).
constexpr int kPass = 1;
// Blocks of at most kScanWarps warps (up to 4) reduce the warps' slots by
// a scan in every thread (two 16-byte reads and a tree of 3) in place of
// two more redux.sync; 0 keeps the redux for every block.
constexpr int kScanWarps = 4;

// The most threads a block of PER points a thread may have: its registers
// (4 PER floats, the tree's PER keys and indices) within 65536 a block.
template <int PER>
constexpr int max_threads() {
  return PER >= 32 ? 256 : PER >= 8 ? 512 : 1024;
}

// Shared memory by 32-bit address, the address kept in a register: nvcc
// otherwise rebuilds a __shared__ array's address inside the step loop from
// SR_CgaCtaId (an S2R, tens of clocks), in the way of the chain.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("mov.b32 %0, %0;" : "+r"(a));
  return a;
}

__device__ __forceinline__ float4 lds_f4(unsigned a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint2 lds_u2(unsigned a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts_u2(unsigned a, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(a), "r"(v.x),
               "r"(v.y)
               : "memory");
}

__device__ __forceinline__ uint4 lds_u4(unsigned a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Whether slot b beats slot a: a larger key, or the same and a smaller
// index.
__device__ __forceinline__ bool beats(uint2 b, uint2 a) {
  return b.x > a.x || (b.x == a.x && b.y < a.y);
}

// The winning index among the first `warps` (2 to 4) slots at `at`; the
// slots past them are not read as candidates.
__device__ __forceinline__ unsigned best_slot(unsigned at, int warps) {
  const uint4 ab = lds_u4(at);
  const uint4 cd = lds_u4(at + 16);
  uint2 a = make_uint2(ab.x, ab.y);
  const uint2 b = make_uint2(ab.z, ab.w);
  uint2 c = warps > 2 ? make_uint2(cd.x, cd.y) : make_uint2(0u, kNone);
  const uint2 d = warps > 3 ? make_uint2(cd.z, cd.w) : make_uint2(0u, kNone);
  if (beats(b, a)) a = b;
  if (beats(d, c)) c = d;
  return beats(c, a) ? c.y : a.y;
}

// The warp's largest key, then the smallest index among the lanes that
// hold it: two redux.sync.
__device__ __forceinline__ void warp_argmax(unsigned key, unsigned idx,
                                            unsigned& wkey, unsigned& widx) {
  wkey = __reduce_max_sync(kFull, key);
  widx = __reduce_min_sync(kFull, key == wkey ? idx : kNone);
}

template <int PER, bool SCAN>
__global__ void __cluster_dims__(2, 1, 1)
__launch_bounds__(max_threads<PER>())
fps_kernel(const float* __restrict__ pts, int n, int k,
           long long* __restrict__ out) {
  extern __shared__ float4 spts[];          // the cloud, n points
  __shared__ __align__(16) uint2 slots[2][kMaxWarps];  // (key, index)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int stride = 2 * blockDim.x;
  const int t = rank * blockDim.x + threadIdx.x;  // the thread in the cloud
  const float* p = pts + (size_t)(blockIdx.x / 2) * n * 3;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    spts[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 0.f);

  float x[PER], y[PER], z[PER], mind[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = q * stride + t;
    const bool ok = i < n;
    x[q] = ok ? p[3 * i] : 0.f;
    y[q] = ok ? p[3 * i + 1] : 0.f;
    z[q] = ok ? p[3 * i + 2] : 0.f;
    mind[q] = ok ? 1e10f : 0.f;  // padding: key 0, never the first largest
  }
  long long* o = out + (size_t)(blockIdx.x / 2) * k;
  if (t == 0) o[0] = 0;
  cluster.sync();
  uint2* remote = cluster.map_shared_rank(&slots[0][0], rank ^ 1);

  const unsigned pts_at = smem_addr(spts);
  const unsigned slots_at = smem_addr(slots);
  float4 l = spts[0];
  for (int step = 1; step < k; ++step) {
    unsigned key, idx;
    if constexpr (kPass) {
      // the differences of all points first, then the rest: one warp a
      // scheduler (4-warp blocks) needs that independent work in order
      float dx[PER], dy[PER], dz[PER], v[PER];
      int id[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) dx[q] = __fsub_rn(x[q], l.x);
#pragma unroll
      for (int q = 0; q < PER; ++q) dy[q] = __fsub_rn(y[q], l.y);
#pragma unroll
      for (int q = 0; q < PER; ++q) dz[q] = __fsub_rn(z[q], l.z);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx[q], dx[q]), __fmul_rn(dy[q], dy[q])),
            __fmul_rn(dz[q], dz[q]));
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
      idx = static_cast<unsigned>(id[0] * stride + t);
    } else {
      key = (__float_as_uint(l.x) ^ __float_as_uint(l.y)) + 0x9e3779b9u * t;
      idx = t < n ? t : 0;
    }
    unsigned wkey, widx;
    warp_argmax(key, idx, wkey, widx);
    {
      const int slot = kMaxWarps * (step & 1) + rank * warps + warp;
      if (lane == 0) {
        const uint2 w = make_uint2(wkey, widx);
        sts_u2(slots_at + 8 * slot, w);
        remote[slot] = w;
      }
      cluster.sync();
      const unsigned at = slots_at + 8 * kMaxWarps * (step & 1);
      const uint2 s = lane < 2 * warps ? lds_u2(at + 8 * lane)
                                       : make_uint2(0u, kNone);
      warp_argmax(s.x, s.y, wkey, widx);
    }
    l = lds_f4(pts_at + 16 * widx);
    if (t == 0) o[step] = widx;
  }
}

template <int PER, bool SCAN>
int start(const float* pts, int b, int n, int k, int warps, long long* out,
          cudaStream_t s) {
  // the cloud's float4 copy passes the 48 KB default above 3072 points
  const size_t smem = sizeof(float4) * (size_t)n;
  const cudaError_t e = cudaFuncSetAttribute(
      fps_kernel<PER, SCAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fps_kernel<PER, SCAN><<<2 * b, 32 * warps, smem, s>>>(pts, n, k, out);
  return static_cast<int>(cudaGetLastError());
}

template <int PER>
int launch(const float* pts, int b, int n, int k, int warps, long long* out,
           cudaStream_t s) {
  if (32 * warps > max_threads<PER>() || 2 * 32 * warps * PER < n ||
      warps > kMaxWarps / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return start<PER, false>(pts, b, n, k, warps, out, s);
}

}  // namespace

// Largest cloud the kernel takes: 8 warps of 32 points a thread (also 16
// warps of 16).
extern "C" int houv_fps_max_points() { return 32 * max_threads<32>(); }

// pts: (b, n, 3) f32, out: (b, k) int64; 1 <= k, 1 <= n <=
// houv_fps_max_points(); warps and per from ops/sampling.py:_fps_plan (per
// a power of two up to 32, 32 warps per >= n, within the block's limit).
extern "C" int houv_fps(const float* pts, int b, int n, int k, int warps,
                        int per, long long* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || k < 1 || warps < 1 || warps > kMaxWarps ||
      n > houv_fps_max_points())
    return static_cast<int>(cudaErrorInvalidValue);
  switch (per) {
    case 1: return launch<1>(pts, b, n, k, warps, out, s);
    case 2: return launch<2>(pts, b, n, k, warps, out, s);
    case 4: return launch<4>(pts, b, n, k, warps, out, s);
    case 8: return launch<8>(pts, b, n, k, warps, out, s);
    case 16: return launch<16>(pts, b, n, k, warps, out, s);
    case 32: return launch<32>(pts, b, n, k, warps, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
