// Exact f32 top-k of q . DB^T on Hopper: the FMA scan and merge kernels of
// topk_f32.cu (kernel B1). The other top-k kernels run on the tensor-core
// tiles of mma_tile.cuh: B3 (topk_masked.cu), B4b (bench_dotonly.cu) and
// the sq8 scan of B2 and B4a (sq8_scan.cuh).
//
// What it computes (the TPU kernel's semantics, nafp_tpu/search/
// pallas_topk.py): for each query the k best rows by inner product, scores
// sorted descending, int32 row positions, -1 wherever the score is
// <= NEG/2 (the empty slots when k > N). The (Bq, N) score matrix never
// reaches device memory.
//
// Design. The TPU grid walks DB tiles in order on one core and carries a
// running top-k in VMEM scratch. Here CTAs run in parallel, so the work is
// split twice:
//   1. scan: grid (n_chunks, ceil(Bq/QB)). A CTA holds QB queries in shared
//      memory and streams its chunk of DB rows through shared memory in
//      tiles of RB rows. Each thread computes an 8-query x 2-row block of
//      scores with f32 FMAs (no tensor cores, no TF32), compares every
//      score with its query's current k-th best (a threshold held in shared
//      memory) and appends the few survivors to a per-query candidate
//      list; one thread per query then inserts them into the query's
//      sorted top-k. Once the lists are warm almost every score fails the
//      threshold compare, so selection costs one compare per score. The
//      chunk's top-k goes to a (Bq, n_chunks, k) scratch.
//   2. merge: one CTA per query reduces its n_chunks * k candidates with the
//      same threshold-and-insert scheme and writes the sorted result.
// Order: (score, row) pairs compare by score, then by lower row, so results
// are deterministic and ties resolve as jax.lax.top_k resolves them.
//
// What bounds it on an H100: at the main path's shape the work is
// compute-bound (81 GFLOP of f32 FMA per 512 x 619,500 x 128 launch against
// 67 TFLOP/s; the DB is 0.3 GB). The scores run on the CUDA cores from
// shared memory, with no cp.async pipelining, so the kernel reaches a
// fraction of the f32 peak; the tensor cores can take B1's products only
// through a split that keeps f32 accuracy (3xTF32 or bf16x3), with B3's
// selection. That is later work.
#pragma once

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

// Shared-memory bytes of one scan CTA. A staged query or DB row takes
// dp = d + 4 floats: 16-byte aligned rows and conflict-free float4 reads.
inline size_t scan_smem_bytes(int d, int k) {
  const int dp = d + 4;
  return sizeof(float) * (size_t)(QB * dp + RB * dp)         // q, DB
         + (sizeof(float) + sizeof(int)) * (size_t)QB * k    // top-k lists
         + (sizeof(float) + sizeof(int)) * (size_t)QB * RB   // candidates
         + sizeof(int) * QB;                                 // counts
}

inline size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)(k + MERGE_THREADS)
         + sizeof(int);
}

// Stage queries q0 .. q0+QB-1 of q (Bq, d) into qs ([QB][d + 4]), zeros
// past bq.
__device__ __forceinline__ void stage_queries(const float* __restrict__ q,
                                              int q0, int bq, int d,
                                              float* qs) {
  const int dp = d + 4;
  const int d4 = d / 4;
  for (int e = threadIdx.x; e < QB * d4; e += THREADS) {
    const int r = e / d4, c = e % d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < bq)
      v = reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * d)[c];
    *reinterpret_cast<float4*>(qs + r * dp + 4 * c) = v;
  }
}

// Stage DB rows t0 .. t0+RB-1 into ds ([RB][d + 4]); zeros at and past
// row_end.
__device__ __forceinline__ void stage_rows(const float* __restrict__ db,
                                           int t0, int row_end, int d,
                                           float* ds) {
  const int dp = d + 4;
  const int d4 = d / 4;
  for (int e = threadIdx.x; e < RB * d4; e += THREADS) {
    const int r = e / d4, c = e % d4;
    const int row = t0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < row_end)
      v = reinterpret_cast<const float4*>(db + (size_t)row * d)[c];
    *reinterpret_cast<float4*>(ds + r * dp + 4 * c) = v;
  }
}

// The products of one staged tile: acc[i][j] = the dot product of staged
// query row qp + i * dp with staged DB row dp0 (j = 0) or dp1 (j = 1). f32
// FMAs in a fixed order.
__device__ __forceinline__ void tile_products(const float* qp,
                                              const float* dp0,
                                              const float* dp1, int d, int dp,
                                              float (&acc)[QPT][2]) {
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

__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const float* __restrict__ db, int bq,
            int n, int d, int k, int chunk_rows, int n_chunks,
            float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = d + 4;  // row stride: 16-byte aligned, float4 reads conflict-free
  float* qs = reinterpret_cast<float*>(smem);  // [QB][dp]
  float* ds = qs + QB * dp;                    // [RB][dp]
  float* lv = ds + RB * dp;                    // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);
  float* cv = reinterpret_cast<float*>(li + QB * k);  // [QB][RB]
  int* ci = reinterpret_cast<int*>(cv + QB * RB);
  int* cnt = ci + QB * RB;                            // [QB]

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(n, row_begin + chunk_rows);

  stage_queries(q, q0, bq, d, qs);
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
    stage_rows(db, t0, row_end, d, ds);
    __syncthreads();

    float acc[QPT][2];
    tile_products(qp, dp0, dp1, d, dp, acc);

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = tr + 32 * j;
      const int row = t0 + r;
      if (row >= row_end) continue;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qi = tq * QPT + i;
        const float s = acc[i][j];
        if (q0 + qi < bq && better(s, row, lv[qi * k], li[qi * k])) {
          const int slot = atomicAdd(&cnt[qi], 1);
          cv[qi * RB + slot] = s;
          ci[qi * RB + slot] = row;
        }
      }
    }
    __syncthreads();
    if (tid < QB) {
      const int m = cnt[tid];
      for (int e = 0; e < m; ++e)
        insert_sorted(lv + tid * k, li + tid * k, k, cv[tid * RB + e],
                      ci[tid * RB + e]);
      cnt[tid] = 0;
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
// step (0 when both launches were accepted).
inline int launch_topk(const float* q, const float* db, int bq, int n, int d,
                       int k, int chunk_rows, int n_chunks, float* part_v,
                       int* part_i, float* out_v, int* out_i,
                       cudaStream_t stream) {
  cudaGetLastError();  // clear any stale error from earlier work
  const size_t scan_smem = scan_smem_bytes(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, (bq + QB - 1) / QB);
  scan_kernel<<<grid, THREADS, scan_smem, stream>>>(
      q, db, bq, n, d, k, chunk_rows, n_chunks, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<bq, MERGE_THREADS, merge_smem_bytes(k), stream>>>(
      part_v, part_i, n_chunks * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace nafp
