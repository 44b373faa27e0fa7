// Batched scatter-add in a fixed order (Hopper, sm_90a).
//
// Replaces the TPU kernel houv_tpu/ops/scatter.py:_scatter_kernel (wrapper
// scatter_add_matmul). Contract:
//   idx (B, N) int64, vals (B, N, C) f32, C <= 8  ->  out (B, M, C) f32
//   out[b, r, :] = sum over { i : idx[b, i] == r } of vals[b, i, :]
// An index < 0 or >= M matches no row and is dropped. Every output row is
// written (rows without a match hold 0), so the caller need not clear out.
//
// The TPU kernel builds one-hot tiles and contracts them on the matrix unit
// because a scatter serialises there; its bf16 rounding of vals is an economy
// of that unit, not part of the contract. Here the sum is f32 and is taken in
// ascending i, starting from +0.0f: the result has no run-to-run difference
// (no float atomics) and equals, bit for bit, a plain version that adds in
// that order.
//
// What bounds it on this card: bytes at the solver's shapes (idx and vals
// read once, out written once), and at the train steps' small batches the
// latency of one block's chain: the loads, two radix passes of two block
// barriers each, then each row's adds one after another. The work per batch
// entry is O(N + M) times the number of row blocks, which is 1 while
// M * C <= 12288. (The first version of this kernel let one thread own one
// output row and compare it with every index: B*N*M compares.)
//
// Design: a stable sort of each chunk of indices by target row.
// - A block owns `rows` consecutive output rows of one batch entry; their
//   running sums stay in shared memory from +0.0f to the end, then go to out
//   coalesced. More rows than fit take more blocks, each reading the entry's
//   indices again.
// - The entry's indices stream through in ascending chunks of kChunk. A
//   chunk's vals rows are copied to shared memory asynchronously, while the
//   chunk is sorted; each index becomes an
//   item (row in the block, or `rows` for one outside it; its place in the
//   chunk) and the items are sorted by row with an LSD radix sort of 6-bit
//   digits (two passes up to 4095 rows), written by hand: per pass each warp
//   ranks its items in their order with six ballots (the lanes of one
//   digit, and the lower ones among them) and keeps its counts of the 64
//   digits two a lane; after one barrier every warp sums the block's counts
//   digit by digit, warp by warp, into its own first places, so every pass
//   is stable; a second barrier ends the pass.
// - Rows then lie in runs, each in ascending i. The thread at the head of a
//   run adds its vals rows in order onto the row's running sum, reading the
//   next item while it adds one.
// Chunks come in ascending order, so every row adds in ascending i.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                     // items a thread holds
constexpr int kChunk = kThreads * kPer;     // indices a chunk
constexpr int kIdBits = 11;                 // an item's place in its chunk
constexpr int kHist = kWarps + 1;           // padded row of the counts
constexpr int kMaxC = 8;
constexpr size_t kMaxSmem = 232448;         // a block's shared memory, sm_90
static_assert(kChunk == 1 << kIdBits, "an item's place fills kIdBits");

size_t smem_bytes(int rows, int c) {
  return 4 * ((size_t)(rows + kChunk) * c + kChunk + 64 * kHist);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const long long* __restrict__ idx,
               const float* __restrict__ vals, int n, int m, int rows,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* acc = smem;                                    // rows * C
  float* sval = acc + rows * C;                         // kChunk * C
  int* item = reinterpret_cast<int*>(sval + kChunk * C);  // kChunk
  int* hist = item + kChunk;                            // 64 * kHist
  const int r0 = blockIdx.x * rows;
  const int nr = min(rows, m - r0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int passes = (32 - __clz(nr) + 5) / 6;   // digits of keys 0..nr
  const long long* bidx = idx + (size_t)blockIdx.y * n;
  const float* bvals = vals + (size_t)blockIdx.y * n * C;

  for (int e = t; e < nr * C; e += kThreads) acc[e] = 0.0f;

  for (int i0 = 0, len; i0 < n; i0 += len) {
    len = min(kChunk, n - i0);
    // the vals rows arrive while the items are sorted
    for (int e = t; e < len * C; e += kThreads)
      __pipeline_memcpy_async(sval + e, bvals + (size_t)i0 * C + e, 4);
    __pipeline_commit();
    // items at places warp * 32 * kPer + s * 32 + lane, s < kPer
    int it[kPer];
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int l = (warp * kPer + s) * 32 + lane;
      const long long x = l < len ? bidx[i0 + l] : -1;
      const int key = (x >= r0 && x < r0 + nr) ? (int)(x - r0) : nr;
      it[s] = key << kIdBits | l;
    }
    for (int pass = 0; pass < passes; ++pass) {
      const int shift = kIdBits + 6 * pass;
      int off[kPer];
      int lo = 0, hi = 0;         // lane L: this warp's items of digit L, L+32
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int d = (it[s] >> shift) & 63;
        unsigned same = ~0u, mine = ~0u, top = 0;
#pragma unroll
        for (int bit = 0; bit < 6; ++bit) {
          const unsigned ones = __ballot_sync(~0u, (d >> bit) & 1);
          same &= (d >> bit) & 1 ? ones : ~ones;
          if (bit < 5) mine &= (lane >> bit) & 1 ? ones : ~ones;
          else top = ones;
        }
        const int before_lo = __shfl_sync(~0u, lo, d & 31);
        const int before_hi = __shfl_sync(~0u, hi, d & 31);
        off[s] = (d & 32 ? before_hi : before_lo) + __popc(same & lower);
        lo += __popc(mine & ~top);
        hi += __popc(mine & top);
      }
      hist[lane * kHist + warp] = lo;
      hist[(lane + 32) * kHist + warp] = hi;
      __syncthreads();
      // this warp's first place for digits L and L+32: every item of a
      // smaller digit, then those of the same digit in the warps before
      int tot_lo = 0, tot_hi = 0, base_lo = 0, base_hi = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int a = hist[lane * kHist + w];
        const int b = hist[(lane + 32) * kHist + w];
        if (w < warp) {
          base_lo += a;
          base_hi += b;
        }
        tot_lo += a;
        tot_hi += b;
      }
      int incl_lo = tot_lo, incl_hi = tot_hi;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y_lo = __shfl_up_sync(~0u, incl_lo, d);
        const int y_hi = __shfl_up_sync(~0u, incl_hi, d);
        if (lane >= d) {
          incl_lo += y_lo;
          incl_hi += y_hi;
        }
      }
      base_lo += incl_lo - tot_lo;
      base_hi += incl_hi - tot_hi + __shfl_sync(~0u, incl_lo, 31);
#pragma unroll
      for (int s = 0; s < kPer; ++s) {
        const int d = (it[s] >> shift) & 63;
        const int b_lo = __shfl_sync(~0u, base_lo, d & 31);
        const int b_hi = __shfl_sync(~0u, base_hi, d & 31);
        item[(d & 32 ? b_hi : b_lo) + off[s]] = it[s];
      }
      if (pass == passes - 1) __pipeline_wait_prior(0);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kPer; ++s)
        it[s] = item[(warp * kPer + s) * 32 + lane];
    }
    // the head of each run adds the run in order
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int q = (warp * kPer + s) * 32 + lane;
      const int key = it[s] >> kIdBits;
      if (key < nr && (q == 0 || item[q - 1] >> kIdBits != key)) {
        float sum[C];
#pragma unroll
        for (int j = 0; j < C; ++j) sum[j] = acc[key * C + j];
        for (int p = q, cur = it[s];; ++p) {
          // read the next item before adding this one
          const int next = p + 1 < kChunk ? item[p + 1] : -1;
          const float* v = sval + (cur & (kChunk - 1)) * C;
#pragma unroll
          for (int j = 0; j < C; ++j) sum[j] += v[j];
          if (next >> kIdBits != key) break;
          cur = next;
        }
#pragma unroll
        for (int j = 0; j < C; ++j) acc[key * C + j] = sum[j];
      }
    }
    __syncthreads();
  }

  float* o = out + ((size_t)blockIdx.y * m + r0) * C;
  for (int e = t; e < nr * C; e += kThreads) o[e] = acc[e];
}

// A block above 48 KB of shared memory needs the kernel's limit raised:
// once per device, to the card's limit, so that a launch makes no runtime
// call but its own (the train steps' host is part of their time).
template <int C>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(scatter_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int C>
int launch(const long long* idx, const float* vals, int b, int n, int m,
           int rows, float* out, cudaStream_t s) {
  const size_t smem = smem_bytes(rows, C);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem<C>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>(((long long)m + rows - 1) / rows);
  // grid.y carries the batch (at most 65535 per launch)
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const int nb = b - b0 < 65535 ? b - b0 : 65535;
    scatter_kernel<C><<<dim3(blocks, nb), kThreads, smem, s>>>(
        idx + (size_t)b0 * n, vals + (size_t)b0 * n * C, n, m, rows,
        out + (size_t)b0 * m * C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int houv_scatter_max_channels() { return kMaxC; }

// idx (b, n) int64, vals (b, n, c) f32, out (b, m, c) f32; b, n, m >= 1.
// rows: output rows per block (the wrapper's plan).
extern "C" int houv_scatter_add(const long long* idx, const float* vals,
                                int b, int n, int m, int c, int rows,
                                float* out, void* stream) {
  if (rows < 1 || rows > (1 << (31 - kIdBits)) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 1: return launch<1>(idx, vals, b, n, m, rows, out, s);
    case 2: return launch<2>(idx, vals, b, n, m, rows, out, s);
    case 3: return launch<3>(idx, vals, b, n, m, rows, out, s);
    case 4: return launch<4>(idx, vals, b, n, m, rows, out, s);
    case 5: return launch<5>(idx, vals, b, n, m, rows, out, s);
    case 6: return launch<6>(idx, vals, b, n, m, rows, out, s);
    case 7: return launch<7>(idx, vals, b, n, m, rows, out, s);
    case 8: return launch<8>(idx, vals, b, n, m, rows, out, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
