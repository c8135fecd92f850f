// Exact top-k of q . DB^T on Hopper: the scan and merge kernels shared by
// topk_f32.cu (kernel B1), topk_sq8.cu (kernel B2) and topk_masked.cu
// (kernel B3).
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
//      scores with f32 FMAs (no tensor cores, no TF32), compares every
//      score with its query's current k-th best (a threshold held in
//      shared memory) and appends the few survivors to a per-query
//      candidate list; one thread per query then inserts them into the
//      query's sorted top-k. Once the lists are warm almost every score
//      fails the threshold compare, so selection costs one compare per
//      score. The chunk's top-k goes to a (Bq, n_chunks, k) scratch.
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
// f32 peak; B2 and B3 in particular could take their products on the bf16
// tensor cores (wgmma), which this kernel does not use, and B3 could skip
// the tiles that no query of a CTA probes. Those are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nafp {

constexpr float NEG = -1e30f;        // additive mask value of the TPU kernels
constexpr int NO_ROW = 0x7fffffff;   // row of an empty top-k slot
constexpr int QB = 64;               // queries per scan CTA
constexpr int RB = 64;               // DB rows per scan tile
constexpr int THREADS = 256;         // scan CTA: 8 warps
constexpr int QPT = 8;               // queries per thread (one warp's share)
constexpr int MERGE_THREADS = 256;
constexpr int MAX_K = 128;
constexpr int MAX_D = 256;

// What a DB row is and how its score is formed:
//   F32:    f32 rows, every row below n valid;
//   SQ8:    int8 rows, (round_bf16(q) . row) * scales[row] + rmask[row];
//   MASKED: bf16 rows, (round_bf16(q) . row) + mask(ids[row]) +
//           bias[q][row / list_tile], mask 0 where ids[row] >= 0, else NEG.
enum class Mode { F32, SQ8, MASKED };

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

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

__device__ __forceinline__ float bf16_bits_to_float(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);  // exact
}

// Shared-memory bytes of one scan CTA.
template <Mode MODE>
inline size_t scan_smem_bytes(int d, int k) {
  const int dp = d + 4;
  return sizeof(float) * (size_t)(QB * dp + RB * dp + 2 * RB)  // q, DB, sc/rm
         + (sizeof(float) + sizeof(int)) * (size_t)QB * k      // top-k lists
         + (sizeof(float) + sizeof(int)) * (size_t)QB * RB     // candidates
         + sizeof(int) * QB                                    // counts
         + (MODE == Mode::MASKED ? sizeof(float) * QB : 0);    // tile bias
}

inline size_t merge_smem_bytes(int k) {
  return (sizeof(float) + sizeof(int)) * (size_t)(k + MERGE_THREADS)
         + sizeof(int);
}

// Row-side inputs beyond the DB itself: SQ8 reads scales and rmask,
// MASKED reads ids and bias (row-major (bq, n / list_tile)).
struct RowInputs {
  const float* scales;
  const float* rmask;
  const int* ids;
  const float* bias;
  int list_tile;
};

// MASKED: list_tile is a multiple of RB and every tile starts at a multiple
// of RB (chunk_rows is one), so a tile lies inside one list_tile subtile and
// takes a single bias value per query, staged in shared memory. Scores
// <= NEG/2 (masked ids, unprobed subtiles) are never candidates; their
// slots stay empty and come out as -1, as the TPU kernel reports them.
template <Mode MODE>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const void* __restrict__ db,
            RowInputs rin, int bq, int n, int d, int k, int chunk_rows,
            int n_chunks, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  constexpr bool QBF16 = MODE != Mode::F32;  // q rounded to bf16
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
  float* qbias = reinterpret_cast<float*>(cnt + QB);  // [QB], MASKED only

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(n, row_begin + chunk_rows);
  const int d4 = d / 4;

  for (int e = tid; e < QB * d4; e += THREADS) {
    const int r = e / d4, c = e % d4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < bq)
      v = reinterpret_cast<const float4*>(q + (size_t)(q0 + r) * d)[c];
    if (QBF16) {
      v.x = round_bf16(v.x); v.y = round_bf16(v.y);
      v.z = round_bf16(v.z); v.w = round_bf16(v.w);
    }
    *reinterpret_cast<float4*>(qs + r * dp + 4 * c) = v;
  }
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
    for (int e = tid; e < RB * d4; e += THREADS) {
      const int r = e / d4, c = e % d4;
      const int row = t0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < row_end) {
        if (MODE == Mode::SQ8) {
          const char4 b = reinterpret_cast<const char4*>(
              static_cast<const int8_t*>(db) + (size_t)row * d)[c];
          v = make_float4((float)b.x, (float)b.y, (float)b.z, (float)b.w);
        } else if (MODE == Mode::MASKED) {
          const ushort4 b = reinterpret_cast<const ushort4*>(
              static_cast<const unsigned short*>(db) + (size_t)row * d)[c];
          v = make_float4(bf16_bits_to_float(b.x), bf16_bits_to_float(b.y),
                          bf16_bits_to_float(b.z), bf16_bits_to_float(b.w));
        } else {
          v = reinterpret_cast<const float4*>(
              static_cast<const float*>(db) + (size_t)row * d)[c];
        }
      }
      *reinterpret_cast<float4*>(ds + r * dp + 4 * c) = v;
    }
    if (MODE == Mode::SQ8) {
      for (int r = tid; r < RB; r += THREADS) {
        const int row = t0 + r;
        sc[r] = row < row_end ? rin.scales[row] : 0.f;
        rm[r] = row < row_end ? rin.rmask[row] : NEG;
      }
    }
    if (MODE == Mode::MASKED) {
      for (int r = tid; r < RB; r += THREADS) {
        const int row = t0 + r;
        rm[r] = row < row_end && rin.ids[row] >= 0 ? 0.f : NEG;
      }
      const int n_sub = n / rin.list_tile;
      const int sub = t0 / rin.list_tile;
      for (int e = tid; e < QB; e += THREADS)
        qbias[e] = q0 + e < bq ? rin.bias[(size_t)(q0 + e) * n_sub + sub]
                               : NEG;
    }
    __syncthreads();

    float acc[QPT][2];
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

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = tr + 32 * j;
      const int row = t0 + r;
      if (row >= row_end) continue;
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qi = tq * QPT + i;
        float s = acc[i][j];
        if (MODE == Mode::SQ8) s = s * sc[r] + rm[r];
        if (MODE == Mode::MASKED) {
          s = s + rm[r] + qbias[qi];
          if (s <= NEG / 2) continue;
        }
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
template <Mode MODE>
int launch_topk(const float* q, const void* db, RowInputs rin, int bq,
                int n, int d, int k, int chunk_rows, int n_chunks,
                float* part_v, int* part_i, float* out_v, int* out_i,
                cudaStream_t stream) {
  cudaGetLastError();  // clear any stale error from earlier work
  const size_t scan_smem = scan_smem_bytes<MODE>(d, k);
  cudaError_t err = cudaFuncSetAttribute(
      scan_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)scan_smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_chunks, (bq + QB - 1) / QB);
  scan_kernel<MODE><<<grid, THREADS, scan_smem, stream>>>(
      q, db, rin, bq, n, d, k, chunk_rows, n_chunks, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<bq, MERGE_THREADS, merge_smem_bytes(k), stream>>>(
      part_v, part_i, n_chunks * k, k, out_v, out_i);
  return (int)cudaGetLastError();
}

}  // namespace nafp
