// Exact top-k of q . DB^T on Hopper: the scan and merge kernels shared by
// topk_f32.cu (kernel B1), topk_sq8.cu (kernel B2) and bench_variant.cu
// (kernel B4a). Kernels B3 (topk_masked.cu) and B4b (bench_dotonly.cu) have
// their own, on the tensor-core tile of mma_tile.cuh.
//
// What it computes (the TPU kernels' semantics, nafp_tpu/search/
// pallas_topk.py): for each query the k best rows by inner product, scores
// sorted descending, int32 row positions, -1 wherever the score is
// <= NEG/2 (masked rows, and the empty slots when k > N). The (Bq, N) score
// matrix never reaches device memory.
//
// Design. The TPU grid walks DB tiles in order on one core and carries a
// running top-k in VMEM scratch. Here CTAs run in parallel, so the work is
// split twice:
//   1. scan: grid (n_chunks, ceil(Bq/QB)). A CTA holds QB queries in shared
//      memory and streams its chunk of DB rows through shared memory in
//      tiles of RB rows. Each thread computes an 8-query x 2-row block of
//      scores with f32 FMAs (no tensor cores, no TF32; SQ8_I8: __dp4a into
//      s32), compares every score with its query's current k-th best (a
//      threshold held in shared memory) and appends the few survivors to a
//      per-query candidate list; the selection step then moves them into
//      the query's top-k (Select below). Once the lists are warm almost
//      every score fails the threshold compare, so selection costs one
//      compare per score. The chunk's top-k goes to a (Bq, n_chunks, k)
//      scratch.
//   2. merge: one CTA per query reduces its n_chunks * k candidates with the
//      same threshold-and-insert scheme and writes the sorted result.
// Order: (score, row) pairs compare by score, then by lower row, so results
// are deterministic and ties resolve as jax.lax.top_k resolves them.
//
// What bounds it on an H100 and what this simple design leaves: at the
// main path's shapes the work is compute-bound (B1: 81 GFLOP of f32 FMA per
// 512 x 619,500 x 128 launch against 67 TFLOP/s; the DB is 0.3 GB). The
// scores run on the CUDA cores from shared memory, with no cp.async/TMA
// pipelining and no tensor cores, so the kernel reaches a fraction of the
// f32 peak; B2 in particular could take its products on the bf16 tensor
// cores, as B3 and B4b do. That is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "limits.cuh"

namespace nafp {

constexpr int QB = 64;               // queries per scan CTA
constexpr int RB = 64;               // DB rows per scan tile
constexpr int THREADS = 256;         // scan CTA: 8 warps
constexpr int QPT = 8;               // queries per thread (one warp's share)
constexpr int MERGE_THREADS = 256;

// What a DB row is and how its score is formed:
//   F32:    f32 rows, every row below n valid;
//   SQ8:    int8 rows, (round_bf16(q) . row) * scales[row] + rmask[row];
//   SQ8_I8: int8 rows and int8 queries (quantised by the caller),
//           float(q8 . row) * scales[row] + rmask[row], the dot product an
//           exact s32 sum of __dp4a (|sum| <= 127 * 127 * d < 2^24 for
//           d <= MAX_D, so its float is exact too).
enum class Mode { F32, SQ8, SQ8_I8 };

// How the scan moves a tile's candidates into a query's running top-k:
//   INSERT: a sorted list, worst first; one thread per query inserts its
//           candidates in turn (B1, B2, and B4a's v0/v3 merge);
//   DRAIN:  an unsorted list whose worst entry is kept at slot 0; one warp
//           per query takes the best candidate and replaces the worst entry
//           until no candidate beats it (B4a's v2 merge, drain_lists).
// Slot 0 is the admission threshold either way.
enum class Select { INSERT, DRAIN };

// Sorted list of k entries, worst first: lv[0] is the admission threshold.
__device__ __forceinline__ void insert_sorted(float* lv, int* li, int k,
                                              float v, int i) {
  if (!better(v, i, lv[0], li[0])) return;
  int p = 0;
  while (p + 1 < k && better(v, i, lv[p + 1], li[p + 1])) {
    lv[p] = lv[p + 1];
    li[p] = li[p + 1];
    ++p;
  }
  lv[p] = v;
  li[p] = i;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Shared-memory bytes of one scan CTA. A staged query or DB row takes
// dp = d + 4 floats: 16-byte aligned rows and conflict-free float4 reads.
// SQ8_I8 stages its int8 values at the start of each such row, where int4
// reads are conflict-free at the same stride.
template <Mode MODE>
inline size_t scan_smem_bytes(int d, int k) {
  const int dp = d + 4;
  return sizeof(float) * (size_t)(QB * dp + RB * dp + 2 * RB)  // q, DB, sc/rm
         + (sizeof(float) + sizeof(int)) * (size_t)QB * k      // top-k lists
         + (sizeof(float) + sizeof(int)) * (size_t)QB * RB     // candidates
         + sizeof(int) * QB;                                   // counts
}

inline size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)(k + MERGE_THREADS)
         + sizeof(int);
}

// Stage queries q0 .. q0+QB-1 of q (Bq, d) into qs ([QB][d + 4]), zeros
// past bq: f32, rounded to bf16 for SQ8; int8 for SQ8_I8.
template <Mode MODE>
__device__ __forceinline__ void stage_queries(const void* __restrict__ q,
                                              int q0, int bq, int d,
                                              float* qs) {
  const int dp = d + 4;
  if constexpr (MODE == Mode::SQ8_I8) {
    const int d16 = d / 16;
    for (int e = threadIdx.x; e < QB * d16; e += THREADS) {
      const int r = e / d16, c = e % d16;
      int4 v = make_int4(0, 0, 0, 0);
      if (q0 + r < bq)
        v = reinterpret_cast<const int4*>(static_cast<const int8_t*>(q) +
                                          (size_t)(q0 + r) * d)[c];
      reinterpret_cast<int4*>(qs + r * dp)[c] = v;
    }
  } else {
    const int d4 = d / 4;
    for (int e = threadIdx.x; e < QB * d4; e += THREADS) {
      const int r = e / d4, c = e % d4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < bq)
        v = reinterpret_cast<const float4*>(static_cast<const float*>(q) +
                                            (size_t)(q0 + r) * d)[c];
      if (MODE != Mode::F32) {
        v.x = round_bf16(v.x); v.y = round_bf16(v.y);
        v.z = round_bf16(v.z); v.w = round_bf16(v.w);
      }
      *reinterpret_cast<float4*>(qs + r * dp + 4 * c) = v;
    }
  }
}

// Stage DB rows t0 .. t0+RB-1 into ds ([RB][d + 4]) as the mode's row type
// converts (exactly) to f32, or as int8 for SQ8_I8; zeros at and past
// row_end.
template <Mode MODE>
__device__ __forceinline__ void stage_rows(const void* __restrict__ db,
                                           int t0, int row_end, int d,
                                           float* ds) {
  const int dp = d + 4;
  if constexpr (MODE == Mode::SQ8_I8) {
    const int d16 = d / 16;
    for (int e = threadIdx.x; e < RB * d16; e += THREADS) {
      const int r = e / d16, c = e % d16;
      const int row = t0 + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (row < row_end)
        v = reinterpret_cast<const int4*>(static_cast<const int8_t*>(db) +
                                          (size_t)row * d)[c];
      reinterpret_cast<int4*>(ds + r * dp)[c] = v;
    }
  } else {
    const int d4 = d / 4;
    for (int e = threadIdx.x; e < RB * d4; e += THREADS) {
      const int r = e / d4, c = e % d4;
      const int row = t0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < row_end) {
        if (MODE == Mode::SQ8) {
          const char4 b = reinterpret_cast<const char4*>(
              static_cast<const int8_t*>(db) + (size_t)row * d)[c];
          v = make_float4((float)b.x, (float)b.y, (float)b.z, (float)b.w);
        } else {
          v = reinterpret_cast<const float4*>(
              static_cast<const float*>(db) + (size_t)row * d)[c];
        }
      }
      *reinterpret_cast<float4*>(ds + r * dp + 4 * c) = v;
    }
  }
}

// The products of one staged tile: acc[i][j] = the dot product of staged
// query row qp + i * dp with staged DB row dp0 (j = 0) or dp1 (j = 1). f32
// FMAs in a fixed order; SQ8_I8 sums __dp4a in s32 and converts the exact
// sum.
template <Mode MODE>
__device__ __forceinline__ void tile_products(const float* qp,
                                              const float* dp0,
                                              const float* dp1, int d, int dp,
                                              float (&acc)[QPT][2]) {
  if constexpr (MODE == Mode::SQ8_I8) {
    const int4* r0 = reinterpret_cast<const int4*>(dp0);
    const int4* r1 = reinterpret_cast<const int4*>(dp1);
    int ia[QPT][2];
#pragma unroll
    for (int i = 0; i < QPT; ++i) ia[i][0] = ia[i][1] = 0;
#pragma unroll 4
    for (int c = 0; c < d / 16; ++c) {
      const int4 b0 = r0[c];
      const int4 b1 = r1[c];
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int4 a = reinterpret_cast<const int4*>(qp + i * dp)[c];
        ia[i][0] = __dp4a(a.x, b0.x, ia[i][0]);
        ia[i][0] = __dp4a(a.y, b0.y, ia[i][0]);
        ia[i][0] = __dp4a(a.z, b0.z, ia[i][0]);
        ia[i][0] = __dp4a(a.w, b0.w, ia[i][0]);
        ia[i][1] = __dp4a(a.x, b1.x, ia[i][1]);
        ia[i][1] = __dp4a(a.y, b1.y, ia[i][1]);
        ia[i][1] = __dp4a(a.z, b1.z, ia[i][1]);
        ia[i][1] = __dp4a(a.w, b1.w, ia[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      acc[i][0] = (float)ia[i][0];
      acc[i][1] = (float)ia[i][1];
    }
  } else {
#pragma unroll
    for (int i = 0; i < QPT; ++i) acc[i][0] = acc[i][1] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; c += 4) {
      const float4 b0 = *reinterpret_cast<const float4*>(dp0 + c);
      const float4 b1 = *reinterpret_cast<const float4*>(dp1 + c);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qp + i * dp + c);
        acc[i][0] = fmaf(a.x, b0.x, acc[i][0]);
        acc[i][0] = fmaf(a.y, b0.y, acc[i][0]);
        acc[i][0] = fmaf(a.z, b0.z, acc[i][0]);
        acc[i][0] = fmaf(a.w, b0.w, acc[i][0]);
        acc[i][1] = fmaf(a.x, b1.x, acc[i][1]);
        acc[i][1] = fmaf(a.y, b1.y, acc[i][1]);
        acc[i][1] = fmaf(a.z, b1.z, acc[i][1]);
        acc[i][1] = fmaf(a.w, b1.w, acc[i][1]);
      }
    }
  }
}

// Warp-wide argmax / argmin of (v, i) pairs in the better() order; every
// lane ends with the pair (and, for the worst, a slot that holds it).
__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_worst(float& v, int& i, int& s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    const int os = __shfl_xor_sync(0xffffffffu, s, o);
    if (better(v, i, ov, oi)) { v = ov; i = oi; s = os; }
  }
}

// Select::DRAIN, the counterpart of the TPU's v2 merge (extras/
// bench_sq8_kernel.py, _merge_tile_v2): for each query, one warp takes the
// best of the tile's candidates and, while it beats the worst entry of the
// unsorted k-list (slot 0), writes it there and moves the new worst entry to
// slot 0. The TPU takes each step's argmax and argmin across its lanes;
// here they are warp shuffles (warp_best, warp_worst). A candidate that
// fails stops the drain: every later one is worse and the threshold only
// rises. Resets the query's candidate count.
__device__ __forceinline__ void drain_lists(float* lv, int* li,
                                            const float* cv, const int* ci,
                                            int* cnt, int k) {
  const int lane = threadIdx.x & 31;
  for (int qi = threadIdx.x >> 5; qi < QB; qi += THREADS / 32) {
    const int m = cnt[qi];
    if (m == 0) continue;
    float* L = lv + qi * k;
    int* LI = li + qi * k;
    // the lane's candidates (at most RB = 64 per query); -inf when taken
    float c0 = lane < m ? cv[qi * RB + lane] : -INFINITY;
    int i0 = lane < m ? ci[qi * RB + lane] : NO_ROW;
    float c1 = lane + 32 < m ? cv[qi * RB + lane + 32] : -INFINITY;
    int i1 = lane + 32 < m ? ci[qi * RB + lane + 32] : NO_ROW;
    while (true) {
      float bv = c0;
      int bi = i0;
      if (better(c1, i1, bv, bi)) { bv = c1; bi = i1; }
      warp_best(bv, bi);
      if (!better(bv, bi, L[0], LI[0])) break;
      if (i0 == bi) { c0 = -INFINITY; i0 = NO_ROW; }
      else if (i1 == bi) { c1 = -INFINITY; i1 = NO_ROW; }
      __syncwarp();
      if (lane == 0) { L[0] = bv; LI[0] = bi; }
      __syncwarp();
      float wv = INFINITY;
      int wi = -1, ws = 0;
      for (int s = lane; s < k; s += 32)
        if (better(wv, wi, L[s], LI[s])) { wv = L[s]; wi = LI[s]; ws = s; }
      warp_worst(wv, wi, ws);
      if (lane == 0 && ws != 0) {
        L[ws] = L[0]; LI[ws] = LI[0];
        L[0] = wv; LI[0] = wi;
      }
      __syncwarp();
    }
    if (lane == 0) cnt[qi] = 0;
  }
}

// Row-side inputs beyond the DB itself: SQ8 and SQ8_I8 read scales and
// rmask.
struct RowInputs {
  const float* scales;
  const float* rmask;
};

template <Mode MODE, Select SEL>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const void* __restrict__ q, const void* __restrict__ db,
            RowInputs rin, int bq, int n, int d, int k, int chunk_rows,
            int n_chunks, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = d + 4;  // row stride: 16-byte aligned, float4 reads conflict-free
  float* qs = reinterpret_cast<float*>(smem);  // [QB][dp]
  float* ds = qs + QB * dp;                    // [RB][dp]
  float* sc = ds + RB * dp;                    // [RB]
  float* rm = sc + RB;                         // [RB]
  float* lv = rm + RB;                         // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);
  float* cv = reinterpret_cast<float*>(li + QB * k);  // [QB][RB]
  int* ci = reinterpret_cast<int*>(cv + QB * RB);
  int* cnt = ci + QB * RB;                            // [QB]

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(n, row_begin + chunk_rows);
  constexpr bool SCALED = MODE == Mode::SQ8 || MODE == Mode::SQ8_I8;

  stage_queries<MODE>(q, q0, bq, d, qs);
  for (int e = tid; e < QB * k; e += THREADS) {
    lv[e] = NEG;
    li[e] = NO_ROW;
  }
  for (int e = tid; e < QB; e += THREADS) cnt[e] = 0;
  __syncthreads();

  const int tr = tid & 31;        // rows tr and tr + 32 of each tile
  const int tq = tid >> 5;        // queries tq*QPT .. tq*QPT + QPT-1
  const float* qp = qs + tq * QPT * dp;
  const float* dp0 = ds + tr * dp;
  const float* dp1 = ds + (tr + 32) * dp;

  for (int t0 = row_begin; t0 < row_end; t0 += RB) {
    stage_rows<MODE>(db, t0, row_end, d, ds);
    if (SCALED) {
      for (int r = tid; r < RB; r += THREADS) {
        const int row = t0 + r;
        sc[r] = row < row_end ? rin.scales[row] : 0.f;
        rm[r] = row < row_end ? rin.rmask[row] : NEG;
      }
    }
    __syncthreads();

    float acc[QPT][2];
    tile_products<MODE>(qp, dp0, dp1, d, dp, acc);

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = tr + 32 * j;
      const int row = t0 + r;
      if (row >= row_end) continue;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qi = tq * QPT + i;
        float s = acc[i][j];
        if (SCALED) s = s * sc[r] + rm[r];
        if (q0 + qi < bq && better(s, row, lv[qi * k], li[qi * k])) {
          const int slot = atomicAdd(&cnt[qi], 1);
          cv[qi * RB + slot] = s;
          ci[qi * RB + slot] = row;
        }
      }
    }
    __syncthreads();
    if constexpr (SEL == Select::INSERT) {
      if (tid < QB) {
        const int m = cnt[tid];
        for (int e = 0; e < m; ++e)
          insert_sorted(lv + tid * k, li + tid * k, k, cv[tid * RB + e],
                        ci[tid * RB + e]);
        cnt[tid] = 0;
      }
    } else {
      drain_lists(lv, li, cv, ci, cnt, k);
    }
    __syncthreads();
  }

  for (int e = tid; e < QB * k; e += THREADS) {
    const int qi = e / k, j = e % k;
    if (q0 + qi < bq) {
      const size_t o = ((size_t)(q0 + qi) * n_chunks + chunk) * k + j;
      part_v[o] = lv[e];
      part_i[o] = li[e];
    }
  }
}

// One CTA per query: reduce n_cand = n_chunks * k candidates to the sorted
// top-k; positions become -1 where the score is <= NEG/2.
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             int n_cand, int k, float* __restrict__ out_v,
             int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lv = reinterpret_cast<float*>(smem);       // [k]
  int* li = reinterpret_cast<int*>(lv + k);         // [k]
  float* cv = reinterpret_cast<float*>(li + k);     // [MERGE_THREADS]
  int* ci = reinterpret_cast<int*>(cv + MERGE_THREADS);
  int* cnt = ci + MERGE_THREADS;

  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * n_cand;
  for (int e = tid; e < k; e += MERGE_THREADS) {
    lv[e] = NEG;
    li[e] = NO_ROW;
  }
  if (tid == 0) *cnt = 0;
  __syncthreads();

  for (int c0 = 0; c0 < n_cand; c0 += MERGE_THREADS) {
    const int e = c0 + tid;
    if (e < n_cand) {
      const float v = part_v[base + e];
      const int i = part_i[base + e];
      if (better(v, i, lv[0], li[0])) {
        const int slot = atomicAdd(cnt, 1);
        cv[slot] = v;
        ci[slot] = i;
      }
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 0; j < *cnt; ++j) insert_sorted(lv, li, k, cv[j], ci[j]);
      *cnt = 0;
    }
    __syncthreads();
  }

  for (int j = tid; j < k; j += MERGE_THREADS) {
    const float v = lv[k - 1 - j];
    out_v[(size_t)blockIdx.x * k + j] = v;
    out_i[(size_t)blockIdx.x * k + j] = v <= NEG / 2 ? -1 : li[k - 1 - j];
  }
}

// Launch scan + merge on `stream`; returns cudaGetLastError() after each
// step (0 when both launches were accepted). The merge sorts whatever order
// the scan's lists are in.
template <Mode MODE, Select SEL = Select::INSERT>
int launch_topk(const void* q, const void* db, RowInputs rin, int bq,
                int n, int d, int k, int chunk_rows, int n_chunks,
                float* part_v, int* part_i, float* out_v, int* out_i,
                cudaStream_t stream) {
  cudaGetLastError();  // clear any stale error from earlier work
  const size_t scan_smem = scan_smem_bytes<MODE>(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<MODE, SEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, (bq + QB - 1) / QB);
  scan_kernel<MODE, SEL><<<grid, THREADS, scan_smem, stream>>>(
      q, db, rin, bq, n, d, k, chunk_rows, n_chunks, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<bq, MERGE_THREADS, merge_smem_bytes(k), stream>>>(
      part_v, part_i, n_chunks * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

// What limits the scan's residency at (d, k): info[0] its dynamic shared
// memory per CTA in bytes, info[1] the CTAs one SM holds at once, info[2]
// its registers per thread. Returns a CUDA error code (0 on success).
template <Mode MODE, Select SEL = Select::INSERT>
int scan_occupancy(int d, int k, int* info) {
  const size_t smem = scan_smem_bytes<MODE>(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<MODE, SEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, scan_kernel<MODE, SEL>);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scan_kernel<MODE, SEL>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)smem;
  info[1] = per_sm;
  info[2] = attr.numRegs;
  return 0;
}

}  // namespace nafp
