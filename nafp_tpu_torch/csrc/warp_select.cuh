// The selection shared by kernels B1 (topk_f32.cu), B3 (topk_masked.cu) and
// the sq8 scan of kernels B2 and B4a (sq8_scan.cuh): the warp-cooperative
// merge of a tile's candidates into a sorted k-list, the per-query
// admission bound that the chunk CTAs of one launch share, and the kernel
// that merges the chunks' lists.
//
// The shared bound. A chunk's list starts empty, so a chunked grid admits
// k (1 + ln(rows / k)) scores per chunk and query. Once a CTA's k-list
// holds k real entries, its k-th score is published, per query, into a
// (Bq,) f32 array with an atomic max; every CTA re-reads it once a tile and
// drops any score strictly below it, as the merge does. This is exact: any
// k real rows have a k-th score <= the global k-th best, and a member of
// the global top-k scores at least that, so it is never dropped; a score
// equal to the bound is kept, so the lower-row rule still holds.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "limits.cuh"

namespace nafp {
namespace sel {

constexpr int MERGE_WARPS = 8;       // merge: one warp per query

// *addr = max(*addr, v) for an f32 in device memory: non-negative floats
// order as signed ints, negative ones inversely as unsigned ints.
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
}

// One warp: L (lv, li; k entries, best first) becomes the best k of L and
// the m candidates (cv, ci; 1 <= m <= 64, unsorted, rows not in L, scores >
// NEG/2), best first. Each element's new slot is the number of elements of
// L and C better than it (all distinct in the better() order, except L's
// empty slots, which keep their order below every candidate).
__device__ __forceinline__ void warp_merge(float* lv, int* li,
                                           const float* cv, const int* ci,
                                           int m, int k) {
  const int lane = threadIdx.x & 31;
  // slots 0, 1: candidates lane, lane + 32; slots 2..5: list entries lane +
  // 32 j. An unused slot scores +inf: nothing is better, nothing written.
  float v[6];
  int id[6], r[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const int e = j < 2 ? lane + 32 * j : lane + 32 * (j - 2);
    const bool used = j < 2 ? e < m : e < k;
    v[j] = used ? (j < 2 ? cv[e] : lv[e]) : INFINITY;
    id[j] = used ? (j < 2 ? ci[e] : li[e]) : NO_ROW;
    r[j] = 0;
  }
  for (int f = 0; f < m; ++f) {  // candidates better than each slot's
    const float fv = cv[f];
    const int fi = ci[f];
#pragma unroll
    for (int j = 0; j < 6; ++j) r[j] += better(fv, fi, v[j], id[j]);
  }
  int pos[6];
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // a candidate: plus the list entries
    int lo = 0, hi = v[j] == INFINITY ? 0 : k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(lv[mid], li[mid], v[j], id[j])) lo = mid + 1;
      else hi = mid;
    }
    pos[j] = v[j] == INFINITY ? k : r[j] + lo;
  }
#pragma unroll
  for (int j = 2; j < 6; ++j)  // a list entry moves down by r; unmoved
    pos[j] = r[j] ? lane + 32 * (j - 2) + r[j] : k;  // entries stay put
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 6; ++j)
    if (pos[j] < k) {
      lv[pos[j]] = v[j];
      li[pos[j]] = id[j];
    }
  __syncwarp();
}

// One warp per query: the best k of its n_cand = n_chunks * k candidates,
// filtered against the shared bound, sorted best first; positions -1 where
// the score is <= NEG/2.
__global__ void __launch_bounds__(MERGE_WARPS * 32)
merge_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
             const float* __restrict__ bound, int bq, int n_cand, int k,
             float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ float s_lv[MERGE_WARPS][MAX_K];
  __shared__ int s_li[MERGE_WARPS][MAX_K];
  __shared__ float s_cv[MERGE_WARPS][64];
  __shared__ int s_ci[MERGE_WARPS][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = blockIdx.x * MERGE_WARPS + warp;
  if (qi >= bq) return;  // whole warps only; no CTA-wide barrier below
  float* L = s_lv[warp];
  int* LI = s_li[warp];
  for (int j = lane; j < k; j += 32) {
    L[j] = NEG;
    LI[j] = NO_ROW;
  }
  __syncwarp();
  const float floor_v = bound[qi];
  float tv = NEG;
  int tvi = NO_ROW;
  const size_t base = (size_t)qi * n_cand;
  const unsigned below = (1u << lane) - 1;
  for (int c0 = 0; c0 < n_cand; c0 += 64) {
    int m = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = c0 + lane + 32 * j;
      float v = NEG;
      int i = NO_ROW;
      if (e < n_cand) {
        v = part_v[base + e];
        i = part_i[base + e];
      }
      const bool take = v > NEG / 2 && v >= floor_v && better(v, i, tv, tvi);
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (take) {
        const int slot = m + __popc(mask & below);
        s_cv[warp][slot] = v;
        s_ci[warp][slot] = i;
      }
      m += __popc(mask);
    }
    __syncwarp();
    if (m) {
      warp_merge(L, LI, s_cv[warp], s_ci[warp], m, k);
      tv = L[k - 1];
      tvi = LI[k - 1];
    }
  }
  for (int j = lane; j < k; j += 32) {
    const float v = L[j];
    out_v[(size_t)qi * k + j] = v;
    out_i[(size_t)qi * k + j] = v <= NEG / 2 ? -1 : LI[j];
  }
}

// Launch merge_kernel on stream s for bq queries; returns
// cudaGetLastError().
inline cudaError_t launch_merge(const float* part_v, const int* part_i,
                                const float* bound, int bq, int n_cand, int k,
                                float* out_v, int* out_i, cudaStream_t s) {
  merge_kernel<<<(bq + MERGE_WARPS - 1) / MERGE_WARPS, MERGE_WARPS * 32, 0,
                 s>>>(part_v, part_i, bound, bq, n_cand, k, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace sel
}  // namespace nafp
