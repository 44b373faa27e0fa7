// Furthest-point sampling for clouds above fps_large.cu's capacity
// (Hopper, sm_90a): the global-memory design, the route for N >
// houv_fps_large_max_points() (65536).
//
// Replaces the TPU kernel houv_tpu/ops/sampling.py:_fps_kernel (wrapper
// _fps_pallas_prim) for the clouds that neither fps.cu (<= 8192 points, a
// block's registers) nor fps_large.cu (<= 65536, a cluster's registers)
// holds. Same contract: points (B, N, 3) f32 -> (B, K) int64; the first
// index is 0, each next one the point furthest from the selected set, ties
// to the first occurrence; the distance ((x-lx)^2 + (y-ly)^2) + (z-lz)^2
// rounded op by op, as ops/sampling.py:_fps_plain computes it, so the
// picks equal the plain version's index for index. It takes any N.
//
// What bounds it on this card: latency, as fps.cu. A cloud is a chain of
// K-1 steps, each a pass over the cloud and a block-wide argmax; the bytes
// (the cloud read once, K indices written) are a few microseconds. Here
// the pass itself is long: every step reads and writes the cloud's minima
// through L1/L2, 16 points a thread at 16384.
//
// Design: one block of 1024 threads per cloud; thread t owns points
// t + 1024 q in ascending q. The cloud and its running minima live in global
// memory as float4 {x, y, z, min} (the wrapper's scratch, (B, N, 4) f32),
// each point read and written by its owner only, so no step needs more
// than the block's barrier. A thread keeps its first largest minimum
// (strictly larger replaces), the warp takes the largest key and then the
// smallest index holding it (two redux.sync: the bits of a non-negative
// float order like unsigned ints), one barrier a step publishes the 32
// warps' winners in slots alternated by the step's parity, and every warp
// reduces the slots by the same two redux.sync. The winner's coordinates
// come from the input cloud.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // an index no point has
// Variant switch (scripts/time_large_variants.py): kPass 0 drops the
// distance pass and reduces keys made from the last winner's coordinates
// (wrong picks: the chain alone, the latency floor).
constexpr int kPass = 1;

__device__ __forceinline__ void warp_argmax(unsigned key, unsigned idx,
                                            unsigned& wkey, unsigned& widx) {
  wkey = __reduce_max_sync(kFull, key);
  widx = __reduce_min_sync(kFull, key == wkey ? idx : kNone);
}

__global__ void __launch_bounds__(kThreads)
fps_global_kernel(const float* __restrict__ pts, int n, int k,
                  float4* __restrict__ work, long long* __restrict__ out) {
  __shared__ uint2 slots[2][kWarps];  // (key, index)

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* p = pts + (size_t)blockIdx.x * n * 3;
  float4* w = work + (size_t)blockIdx.x * n;
  long long* o = out + (size_t)blockIdx.x * k;

  for (int i = t; i < n; i += kThreads)
    w[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], 1e10f);
  if (t == 0) o[0] = 0;

  float lx = p[0], ly = p[1], lz = p[2];
  for (int step = 1; step < k; ++step) {
    unsigned key = 0u, idx = kNone;
    if constexpr (kPass) {
      for (int i = t; i < n; i += kThreads) {
        float4 v = w[i];
        const float dx = __fsub_rn(v.x, lx);
        const float dy = __fsub_rn(v.y, ly);
        const float dz = __fsub_rn(v.z, lz);
        const float d = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        const float m = fminf(v.w, d);
        if (m != v.w) w[i].w = m;
        const unsigned b = __float_as_uint(m);
        if (b > key || idx == kNone) {  // strict: the lower index keeps a tie
          key = b;
          idx = static_cast<unsigned>(i);
        }
      }
    } else {
      key = (__float_as_uint(lx) ^ __float_as_uint(ly)) + 0x9e3779b9u * t;
      idx = t < n ? t : 0;
    }
    unsigned wkey, widx;
    warp_argmax(key, idx, wkey, widx);
    if (lane == 0) slots[step & 1][warp] = make_uint2(wkey, widx);
    __syncthreads();
    const uint2 s = slots[step & 1][lane];
    warp_argmax(s.y == kNone ? 0u : s.x, s.y, wkey, widx);
    lx = __ldg(p + 3 * widx);
    ly = __ldg(p + 3 * widx + 1);
    lz = __ldg(p + 3 * widx + 2);
    if (t == 0) o[step] = widx;
  }
}

}  // namespace

// pts: (b, n, 3) f32; work: (b, n, 4) f32 scratch; out: (b, k) int64;
// 1 <= k, 1 <= n.
extern "C" int houv_fps_global(const float* pts, int b, int n, int k,
                               float* work, long long* out, void* stream) {
  if (n < 1 || k < 1 || b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  fps_global_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, n, k, reinterpret_cast<float4*>(work), out);
  return static_cast<int>(cudaGetLastError());
}
