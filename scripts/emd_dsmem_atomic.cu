// Does a 64-bit atomicMax keep the larger key in another block's shared
// memory? csrc/emd.cu posts a round's bids to the keys of block 0 of a
// thread-block cluster through distributed shared memory (raise_key), with
// a compare-and-swap loop where a plain atomicMax would do. This program
// holds each way of posting against the maxima reckoned on the host:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/emd_dsmem_atomic scripts/emd_dsmem_atomic.cu
//   build/emd_dsmem_atomic
//   cuobjdump -sass build/emd_dsmem_atomic | grep -E 'ATOM|RED'
//
// A cluster of C blocks of 1024 threads runs kRounds rounds on kKeys keys
// in block 0's shared memory, as the kernel's rounds do: the keys are
// cleared by plain stores through the cluster's window (block j mod C
// clears key j, as the kernel's winners clear theirs), a cluster barrier,
// every thread posts kBids keys shaped as the kernel's (a positive float's
// bits above, the complement of a row below) on hashed keys, a cluster
// barrier, and block 0 writes the keys out. Ways of posting: 0 atomicMax
// on the pointer map_shared_rank gives, 1 the CAS loop of raise_key, 2 a
// 64-bit atomicMax in PTX on the shared::cluster window (mapa), 3 a 32-bit
// atomicMax on the high words alone (the low words left 0). Prints one line
// per way and cluster size: the keys that differ from the host's maxima.
// Needs an sm_90 card.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <vector>

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kKeys = 2048;
constexpr int kRounds = 64;
constexpr int kBids = 2;

__host__ __device__ inline uint64_t mix(uint64_t z) {
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// The k-th bid of thread t of block r in round q: (key index, value).
__host__ __device__ inline void bid_of(int q, int r, int t, int k,
                                       int* slot, uint64_t* value) {
  const uint64_t h = mix(((uint64_t)q << 40) ^ ((uint64_t)r << 24) ^
                         ((uint64_t)t << 8) ^ (uint64_t)k);
  *slot = static_cast<int>(h % kKeys);
  const uint32_t inc = 0x3a000000u + static_cast<uint32_t>((h >> 20) & 0xfffu);
  const uint32_t row = static_cast<uint32_t>(r * kThreads + t);
  *value = ((uint64_t)inc << 32) | (uint32_t)~row;
}

template <int kWay>
__global__ void __launch_bounds__(kThreads) rounds(uint64_t* out) {
  __shared__ uint64_t keys[kKeys];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = static_cast<int>(cluster.num_blocks());
  uint64_t* key0 = cluster.map_shared_rank(keys, 0);
  for (int q = 0; q < kRounds; ++q) {
    for (int j = rank * kThreads + threadIdx.x; j < kKeys; j += c * kThreads)
      key0[j] = 0ull;
    cluster.sync();
    for (int k = 0; k < kBids; ++k) {
      int slot;
      uint64_t v;
      bid_of(q, rank, threadIdx.x, k, &slot, &v);
      if constexpr (kWay == 0) {
        atomicMax(reinterpret_cast<unsigned long long*>(key0 + slot),
                  static_cast<unsigned long long>(v));
      } else if constexpr (kWay == 1) {
        auto* p = reinterpret_cast<unsigned long long*>(key0 + slot);
        unsigned long long seen = *reinterpret_cast<volatile uint64_t*>(p);
        while (seen < v) {
          const unsigned long long old = atomicCAS(p, seen, v);
          if (old == seen) break;
          seen = old;
        }
      } else if constexpr (kWay == 2) {
#ifndef NO_PTX_MAX  // for a toolkit that refuses the PTX form
        const uint32_t local =
            static_cast<uint32_t>(__cvta_generic_to_shared(keys + slot));
        uint32_t remote;
        asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                     : "=r"(remote) : "r"(local));
        uint64_t old;
        asm volatile("atom.shared::cluster.max.u64 %0, [%1], %2;"
                     : "=l"(old) : "r"(remote), "l"(v) : "memory");
#endif
      } else {
        atomicMax(reinterpret_cast<unsigned*>(key0 + slot) + 1,
                  static_cast<unsigned>(v >> 32));
      }
    }
    cluster.sync();
    if (rank == 0)
      for (int j = threadIdx.x; j < kKeys; j += kThreads)
        out[(size_t)q * kKeys + j] = keys[j];
    cluster.sync();
  }
}

template <int kWay>
int differing(int c) {
  uint64_t* out;
  cudaMalloc(&out, sizeof(uint64_t) * kRounds * kKeys);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, rounds<kWay>, out);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  if (e != cudaSuccess) {
    std::printf("way %d, cluster %d: %s\n", kWay, c, cudaGetErrorString(e));
    return -1;
  }
  std::vector<uint64_t> got(kRounds * kKeys);
  cudaMemcpy(got.data(), out, sizeof(uint64_t) * got.size(),
             cudaMemcpyDeviceToHost);
  cudaFree(out);
  std::vector<uint64_t> want(kRounds * kKeys, 0);
  for (int q = 0; q < kRounds; ++q)
    for (int r = 0; r < c; ++r)
      for (int t = 0; t < kThreads; ++t)
        for (int k = 0; k < kBids; ++k) {
          int slot;
          uint64_t v;
          bid_of(q, r, t, k, &slot, &v);
          if (kWay == 3) v = (v >> 32) << 32;
          uint64_t& w = want[(size_t)q * kKeys + slot];
          if (v > w) w = v;
        }
  int bad = 0;
  for (size_t i = 0; i < got.size(); ++i) bad += got[i] != want[i];
  return bad;
}

int main() {
  const char* names[] = {"atomicMax u64, generic pointer",
                         "CAS loop (raise_key)",
                         "atom.shared::cluster.max.u64",
                         "atomicMax u32, high words"};
  for (int c = 1; c <= 3; ++c) {
    const int bad[] = {differing<0>(c), differing<1>(c), differing<2>(c),
                       differing<3>(c)};
    for (int w = 0; w < 4; ++w)
      std::printf("{\"way\": \"%s\", \"cluster\": %d, \"keys\": %d, "
                  "\"differing\": %d}\n",
                  names[w], c, kRounds * kKeys, bad[w]);
  }
  return 0;
}
