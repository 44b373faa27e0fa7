// The register-tiled nearest-neighbour search both ways (Hopper, sm_90a),
// shared by csrc/nn_both.cu (K1: the winners' indices) and csrc/nn_select.cu
// (K3: the winners' coordinates). Each includes this header, instantiates
// nn_search with its own epilogue, the type that says what a winner writes,
// and launches it through nn_run with its own unpack pass.
//
// Contract of the search, shared-query layout included:
//   a (Bq, N, 3) f32 queries, b (Bk, M, 3) f32 references, Bk % Bq == 0;
//   batch row r of b is served by query cloud r / (Bk / Bq) (the HOUV
//   solver's K restarts of one pair share its target cloud, which is read
//   once per pair and never broadcast);
//   row winner of query i:     argmin_j d(a_i, b_j)
//   column winner of ref j:    argmin_i d(a_i, b_j)
// with ties to the smaller index, like argmin, and
//   d = ((ax-bx)^2 + (ay-by)^2) + (az-bz)^2
// rounded op by op (__fsub_rn, __fmul_rn, __fadd_rn: no FMA contraction),
// exactly as the plain PyTorch version ops/chamfer.py:_nn_both_plain
// computes it. So the winners equal the plain version's index for index at
// every shape and for any input. A NaN distance never compares, so the
// search skips a NaN point among finite ones, as the plain version (which
// counts NaN as +inf) and the TPU kernel do. A point whose distances are
// all NaN has no winner on either side (the epilogue writes index 0, or
// copies row 0).
//
// What bounds it on this card: instruction issue. Each of the Bk*N*M pairs
// costs 3 sub, 3 mul and 2 add (8 f32 instructions, none of which fuses
// under the contract) plus a share of the minima for its row and its
// column; the clouds are a few MB. The floor is 8 instructions a pair at
// 132 SMs x 128 lanes a clock. It stays on the CUDA cores: with K = 3 a
// tensor-core product would be almost all padding, the expansion form a
// product gives rounds differently (and would break the contract), and the
// two min reductions, where the cost beyond the floor lies, would run on
// the CUDA cores anyway.
//
// Design (a register-tiled search, like a GEMM micro-kernel):
// - A block of 256 threads (16 x 16) owns a range of queries and a range of
//   at most kMaxRefs references of one batch row. Its references sit in
//   shared memory (x, y, z planes, padded with NaN to whole tiles) for the
//   whole block; its queries go through in tiles of 128 and its references
//   in tiles of 128. In each 128 x 128 tile, thread (ty, tx) owns queries
//   8ty..8ty+7 (in registers) and references 4tx..4tx+3 and 64+4tx..67+4tx
//   (two float4 reads per plane, conflict-free, shared by broadcast): 64
//   pairs from 6 shared-memory reads.
// - The minima run on the distances' bits as ints: squared distances are
//   >= 0, so their bits order like the floats, and NaN (the padding's
//   0x7fffffff, and what the card's arithmetic makes of a NaN input) orders
//   above +inf and drops out. That lets Hopper's three-way integer min
//   (__vimin3_s32, one DPX instruction) do the work: per 2 x 2 pairs, 4
//   distances and 4 three-way mins, two into the 2 queries' minima over the
//   thread's refs and two into the 2 refs' minima over its queries, so
//   9 instructions a pair in the loop where two fminf a pair cost 10 (8%
//   slower on the card).
// - Lazy indices. Only values are tracked per pair. Rows: per query, a
//   tile's minimum over the thread's 8 references replaces the thread's
//   running best only if strictly smaller, and then the tile number is
//   kept (__vibmin_s32: the min and whether the old value held). After the
//   last reference tile the 16 threads sharing a query put their (best,
//   tile) and the query in shared memory (buffers of their own, so one
//   barrier a query tile); one thread per query takes the smallest value
//   and rescans, for each thread that holds it (one, as a rule), that
//   thread's 8 references of its tile for the first equal distance
//   (recomputed with the same _rn operations, so equal bit for bit), and
//   keeps the smallest index, while the other threads go on to the next
//   query tile. Columns: per tile the 16 threads sharing a reference write
//   their minima to shared memory (two buffers, one barrier a tile), and
//   threads 0..127 merge one reference each while the others go on to the
//   next tile: the smallest value and the first thread row holding it
//   replace the block's running column best only if strictly smaller,
//   which keeps which thread's 8 queries held it; at the end one rescan
//   per reference finds the first equal query. Earlier tiles and smaller
//   thread rows and slots hold smaller indices, so the strict compares
//   keep the smallest index among equal distances.
// - Epilogues. A winner is handed to the epilogue once, after its rescan
//   has found the smallest equal index: Out::row(at, direct, v, found,
//   j_lo, rx, ry, rz) with found the winner's slot in the block's shared
//   reference planes, and Out::col(at, direct, v, found, q_lo, ap) with
//   found the winning query's offset from ap (kNone where no distance
//   compared). ``direct`` says the block owns the whole direction: the
//   epilogue writes its result; otherwise it merges (distance bits << 32 |
//   index) by a 64-bit atomicMin into keys (squared distances are >= 0, so
//   their bits order like the floats), which a short pass then unpacks.
// - Registers: capped at 80 (__launch_bounds__(256, 3)), so that 3 blocks,
//   24 warps, can share an SM; ptxas fits the tile in them without
//   spilling. Shared memory allows 3 up to 2048 references a block (75 KB
//   each) and 2 up to 3072.
// - Launch plan (ops/chamfer.py:_nn_plan): one block per batch row owns all
//   N queries and all M <= kMaxRefs references when the rows alone fill the
//   card (houv.yaml's 6400 rows, houv_fast's 1024). Then both directions
//   complete inside the block and are written directly. With few rows (the
//   train steps' 32 or 64) the queries split over blocks of a multiple of
//   128, and the columns merge across blocks by keys; M > kMaxRefs splits
//   the references and merges the rows the same way.
//
// Variants that lost, timed side by side by scripts/time_nn_both_variants.py
// on an H100 (PERF.md has the readings): every thread rescanning its own
// candidates and the 16 lanes merging (distance, index) by shuffles (~1100
// instructions a query tile, spilling registers); the row merge in the
// column buffers (three barriers a query tile); 2 blocks a SM (1% slower
// now; far slower beside that merge, at 128 registers with spills), 1
// without a register cap (166 registers) or 4 at 64 registers (spilling); a
// barrier every second tile with all threads merging columns (the merge
// then no longer overlaps the search); fminf in place of the three-way
// integer mins; the refs taken two at a time inside the tile (fewer
// registers, slower); queries split over more blocks at houv.yaml's
// and houv_fast's rows. On paper: a warp-wide column reduction per
// reference (5 shuffles and a ballot per reference, ~31 issue slots a
// pair), tracking both argmins eagerly (two compares and four selects a
// pair), and rescanning after every improving tile (some query of a warp
// improves in nearly every tile).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;                     // threads across references
constexpr int kTile = 128;                     // queries and refs a tile
constexpr int kQ = kTile / (kThreads / kLanes);  // queries a thread: 8
constexpr int kR = 8;                          // refs a thread: 2 x 4
constexpr int kMaxRefs = 3072;                 // refs a block holds
constexpr int kRows = kThreads / kLanes;       // threads across queries
constexpr int kRed = kRows * kTile;            // one column buffer
constexpr int kNone = 0x7fffffff;              // no index found
constexpr unsigned long long kEmpty = ~0ull;

static_assert(kQ == 8 && kLanes * 4 * 2 == kTile, "tile layout");

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// the tile slot of a thread's r-th reference, ascending in r
__device__ __forceinline__ int ref_slot(int tx, int r) {
  return r < 4 ? 4 * tx + r : 64 + 4 * tx + (r - 4);
}

__device__ __forceinline__ int dbits(float ax, float ay, float az, float bx,
                                     float by, float bz) {
  return __float_as_int(sqdist(ax, ay, az, bx, by, bz));
}

// the merge key of a winner: distance bits, then the smaller index
__device__ __forceinline__ unsigned long long pack(float d, long long idx) {
  return ((unsigned long long)__float_as_uint(d) << 32) |
         (unsigned long long)(unsigned)idx;
}

// Dynamic shared memory, rlen floats each: rx, ry, rz, cval, cwhere (int);
// then red[2][kRows][kTile]: the column minima of a tile (two buffers); then
// rows: the lanes' row minima and their tiles at the end of a query tile
// (2 x kRows x kTile) and the tile's query coordinates (3 x kTile).
inline size_t nn_smem_bytes(int rlen) {
  return (size_t)rlen * 5 * sizeof(float) +
         (4 * kRed + 3 * kTile) * sizeof(float);
}

// The entries' checks of the plan: qlen and rlen are the queries and
// references a block owns, multiples of 128, rlen <= 3072 (ops/chamfer.py:
// _nn_plan). Sets the parts of each direction and the blocks of the grid;
// returns a CUDA error code, 0 if the plan is taken.
inline int nn_grid(int bq, int bk, int n, int m, int qlen, int rlen,
                   int* qparts, int* rparts, unsigned* blocks) {
  if (bq < 1 || bk % bq || n < 1 || m < 1 || qlen < kTile ||
      qlen % kTile || rlen < kTile || rlen % kTile || rlen > kMaxRefs)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long qp = ((long long)n + qlen - 1) / qlen;
  const long long rp = ((long long)m + rlen - 1) / rlen;
  const long long total = (long long)bk * qp * rp;
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  *qparts = (int)qp;
  *rparts = (int)rp;
  *blocks = (unsigned)total;
  return 0;
}

// A pass of one thread an element over ``total`` elements (the unpack
// passes); returns a CUDA error code.
template <class... P, class... A>
int nn_pass(void (*kernel)(P...), size_t total, cudaStream_t s, A... args) {
  const size_t blocks = (total + 255) / 256;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<(unsigned)blocks, 256, 0, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The entries' launch, one copy for K1 and K3: check the plan; fill the keys
// of a direction split over blocks with ~0 (key1: rows, (bk, n); key2:
// columns, (bk, m); each needed only where that direction splits); run the
// search kernel with its epilogue ``out``; then unpack(false) for split
// rows and unpack(true) for split columns, each launching its pass and
// returning a CUDA error code. Returns a CUDA error code, 0 if all launched.
template <class Out, class Unpack>
int nn_run(void (*kernel)(const float*, const float*, int, int, int, int,
                          int, int, int, Out),
           const Out& out, const float* a, const float* b, int bq, int bk,
           int n, int m, int qlen, int rlen, void* key1, void* key2,
           cudaStream_t s, Unpack unpack) {
  int qparts, rparts;
  unsigned blocks;
  int e = nn_grid(bq, bk, n, m, qlen, rlen, &qparts, &rparts, &blocks);
  if (e) return e;
  if ((rparts > 1 && !key1) || (qparts > 1 && !key2))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = nn_smem_bytes(rlen);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && rparts > 1)
    err = cudaMemsetAsync(key1, 0xff, sizeof(kEmpty) * (size_t)bk * n, s);
  if (err == cudaSuccess && qparts > 1)
    err = cudaMemsetAsync(key2, 0xff, sizeof(kEmpty) * (size_t)bk * m, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, s>>>(a, b, n, m, bk / bq, qlen, rlen,
                                        qparts, rparts, out);
  if ((e = static_cast<int>(cudaGetLastError()))) return e;
  if (rparts > 1 && (e = unpack(false))) return e;
  if (qparts > 1 && (e = unpack(true))) return e;
  return 0;
}

// One block's search; see the header. Out: the epilogue (row and col).
template <class Out>
__device__ __forceinline__ void nn_search(const float* __restrict__ a,
                                          const float* __restrict__ b, int n,
                                          int m, int share, int qlen,
                                          int rlen, int qparts, int rparts,
                                          const Out& out) {
  extern __shared__ __align__(16) float smem[];
  float* rx = smem;
  float* ry = rx + rlen;
  float* rz = ry + rlen;
  float* cval = rz + rlen;
  int* cwhere = reinterpret_cast<int*>(cval + rlen);
  float* red = reinterpret_cast<float*>(cwhere + rlen);
  float* rows = red + 2 * kRed;

  const int tid = threadIdx.x;
  const int tx = tid % kLanes;
  const int ty = tid / kLanes;
  long long blk = blockIdx.x;
  const int rpart = (int)(blk % rparts);
  blk /= rparts;
  const int qpart = (int)(blk % qparts);
  const long long row = blk / qparts;
  const long long j_lo = (long long)rpart * rlen;
  const long long q_lo = (long long)qpart * qlen;
  const int rn = (int)min((long long)rlen, (long long)m - j_lo);
  const int qn = (int)min((long long)qlen, (long long)n - q_lo);
  const float* ap = a + ((size_t)(row / share) * n + q_lo) * 3;
  const float* bp = b + ((size_t)row * m + j_lo) * 3;
  const bool rows_direct = rparts == 1;
  const bool cols_direct = qparts == 1;
  const float nan = __int_as_float(0x7fffffff);
  const int ntr = (rn + kTile - 1) / kTile;
  const int ntq = (qn + kTile - 1) / kTile;

  for (int j = tid; j < ntr * kTile; j += kThreads) {
    const bool ok = j < rn;
    rx[j] = ok ? bp[3 * (size_t)j] : nan;
    ry[j] = ok ? bp[3 * (size_t)j + 1] : nan;
    rz[j] = ok ? bp[3 * (size_t)j + 2] : nan;
    cval[j] = INFINITY;
    cwhere[j] = 0;
  }
  __syncthreads();

  for (int qt = 0; qt < ntq; ++qt) {
    // this thread's queries 8ty..8ty+7 of the tile, NaN past the block's end
    float qx[kQ], qy[kQ], qz[kQ];
    int best[kQ], bt[kQ];  // distance bits, tile
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int qi = qt * kTile + ty * kQ + q;
      const bool ok = qi < qn;
      qx[q] = ok ? ap[3 * (size_t)qi] : nan;
      qy[q] = ok ? ap[3 * (size_t)qi + 1] : nan;
      qz[q] = ok ? ap[3 * (size_t)qi + 2] : nan;
      best[q] = 0x7f800000;  // +inf
      bt[q] = 0;
    }

    for (int rt = 0; rt < ntr; ++rt) {
      const int t0 = rt * kTile + 4 * tx;
      const float4 x0 = *reinterpret_cast<const float4*>(rx + t0);
      const float4 x1 = *reinterpret_cast<const float4*>(rx + t0 + 64);
      const float4 y0 = *reinterpret_cast<const float4*>(ry + t0);
      const float4 y1 = *reinterpret_cast<const float4*>(ry + t0 + 64);
      const float4 z0 = *reinterpret_cast<const float4*>(rz + t0);
      const float4 z1 = *reinterpret_cast<const float4*>(rz + t0 + 64);
      const float bx[kR] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float by[kR] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float bz[kR] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
      // per 2 x 2 pairs: 4 distances and 4 three-way mins, two into the
      // queries' minima over the thread's refs, two into the refs' minima
      // over its queries (on the bits: d >= 0, so they order as the floats,
      // and the NaN of the padding, 0x7fffffff, as the largest)
      int cm[kR];
#pragma unroll
      for (int q = 0; q < kQ; q += 2) {
        int rm0, rm1;
#pragma unroll
        for (int r = 0; r < kR; r += 2) {
          const int d00 = dbits(qx[q], qy[q], qz[q], bx[r], by[r], bz[r]);
          const int d01 = dbits(qx[q], qy[q], qz[q], bx[r + 1], by[r + 1],
                                bz[r + 1]);
          const int d10 = dbits(qx[q + 1], qy[q + 1], qz[q + 1], bx[r], by[r],
                                bz[r]);
          const int d11 = dbits(qx[q + 1], qy[q + 1], qz[q + 1], bx[r + 1],
                                by[r + 1], bz[r + 1]);
          rm0 = r ? __vimin3_s32(rm0, d00, d01) : min(d00, d01);
          rm1 = r ? __vimin3_s32(rm1, d10, d11) : min(d10, d11);
          cm[r] = q ? __vimin3_s32(cm[r], d00, d10) : min(d00, d10);
          cm[r + 1] = q ? __vimin3_s32(cm[r + 1], d01, d11) : min(d01, d11);
        }
        // the running best takes a tile's minimum only if strictly smaller:
        // on a tie the earlier tile, with the smaller indices, keeps it
        bool keep;
        best[q] = __vibmin_s32(best[q], rm0, &keep);
        bt[q] = keep ? bt[q] : rt;
        best[q + 1] = __vibmin_s32(best[q + 1], rm1, &keep);
        bt[q + 1] = keep ? bt[q + 1] : rt;
      }
      int* rb = reinterpret_cast<int*>(red) + (rt & 1) * kRed + ty * kTile;
      *reinterpret_cast<int4*>(rb + 4 * tx) =
          make_int4(cm[0], cm[1], cm[2], cm[3]);
      *reinterpret_cast<int4*>(rb + 64 + 4 * tx) =
          make_int4(cm[4], cm[5], cm[6], cm[7]);
      __syncthreads();
      if (tid < kTile) {  // one thread per reference of the tile
        const int* col =
            reinterpret_cast<const int*>(red) + (rt & 1) * kRed + tid;
        int c[kRows];
#pragma unroll
        for (int t = 0; t < kRows; ++t) c[t] = col[t * kTile];
        int v = c[0];
#pragma unroll
        for (int t = 1; t + 1 < kRows; t += 2)
          v = __vimin3_s32(v, c[t], c[t + 1]);
        v = min(v, c[kRows - 1]);
        int w = 0;
#pragma unroll
        for (int t = kRows - 1; t >= 0; --t)  // descending: the first equal
          if (c[t] == v) w = t;
        const int j = rt * kTile + tid;
        if (__int_as_float(v) < cval[j]) {  // strict: the earlier query tile
          cval[j] = __int_as_float(v);      // keeps a tie
          cwhere[j] = qt * kTile + w * kQ;
        }
      }
      // the next tile writes the other buffer: one barrier a tile
    }

    // rows: the 16 lanes' (best, tile) and the tile's queries go to shared
    // memory; one thread per query takes the smallest value and rescans
    // only the lanes that hold it, while the others go on to the next query
    // tile (whose first barrier comes after these reads)
    float* sv = rows + ty * kTile + tx;
    int* sj = reinterpret_cast<int*>(rows + kRed) + ty * kTile + tx;
    float* sq = rows + 2 * kRed;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      sv[q * kLanes] = __int_as_float(best[q]);
      sj[q * kLanes] = bt[q];
      if (tx == q) {
        sq[ty * kQ + q] = qx[q];
        sq[kTile + ty * kQ + q] = qy[q];
        sq[2 * kTile + ty * kQ + q] = qz[q];
      }
    }
    __syncthreads();
    if (tid < kTile && qt * kTile + tid < qn) {
      const float* pv = rows + tid * kLanes;
      const int* pj = reinterpret_cast<const int*>(rows + kRed) + tid * kLanes;
      float c[kLanes];
#pragma unroll
      for (int l = 0; l < kLanes; ++l) c[l] = pv[l];
      float v = c[0];
#pragma unroll
      for (int l = 1; l < kLanes; ++l) v = fminf(v, c[l]);
      unsigned lanes = 0;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) lanes |= (c[l] == v ? 1u : 0u) << l;
      const float x = sq[tid], y = sq[kTile + tid], z = sq[2 * kTile + tid];
      int found = kNone;
      while (lanes) {  // ties between lanes are rare: one pass, as a rule
        const int l = __ffs(lanes) - 1;
        lanes &= lanes - 1;
        const int base = pj[l] * kTile;
#pragma unroll
        for (int r = 0; r < kR; ++r) {  // the smallest equal index
          const int s = base + ref_slot(l, r);
          if (sqdist(x, y, z, rx[s], ry[s], rz[s]) == v) found = min(found, s);
        }
      }
      // only now, with the smallest equal slot known, the winner is written
      out.row((size_t)row * n + q_lo + qt * kTile + tid, rows_direct, v,
              found, j_lo, rx, ry, rz);
    }
  }

  // columns: rescan the winning thread's 8 queries per reference
  for (int j = tid; j < rn; j += kThreads) {
    const float v = cval[j];
    const int base = cwhere[j];
    int found = kNone;
#pragma unroll
    for (int q = kQ - 1; q >= 0; --q) {
      const int qi = base + q;
      if (qi < qn) {
        const float* p = ap + 3 * (size_t)qi;
        if (sqdist(p[0], p[1], p[2], rx[j], ry[j], rz[j]) == v) found = qi;
      }
    }
    out.col((size_t)row * m + j_lo + j, cols_direct, v, found, q_lo, ap);
  }
}

}  // namespace
