// The sq8 scan on the tensor cores (hand-written for Hopper, sm_90a): exact
// top-k of (q . row) * scales[row] + rmask[row] over an int8 store, the
// function of kernels B2 (topk_sq8.cu) and B4a (bench_variant.cu), which
// instantiate it.
//
// What it computes (nafp_tpu/search/pallas_topk.py, _kernel_sq8): for each
// query the k best rows, scores sorted descending, int32 row positions, -1
// wherever the score is <= NEG/2 (rmask is 0, or NEG on pad rows and
// tombstones anywhere in the store; such rows have scale 0). The products
// are summed first, then multiplied by the row's scale, then the mask is
// added, in f32 and in that order. Ties go to the lower row.
//
// Products, template switch PROD:
//   BF16: f32 queries rounded to bf16, their A fragments resident in
//         registers; each staged int8 tile is widened once per CTA into a
//         bf16 tile (exact) and multiplied on mma.sync.m16n8k16 (bf16
//         products are exact, summed in f32 in the tensor cores' order);
//   I8:   int8 queries (B4a's int8_dot; the wrapper quantises them and
//         scales the results) times the int8 rows straight from the ring on
//         mma.sync.m16n8k32 s8 x s8 -> s32: |sum| <= 127^2 * 256 < 2^24, so
//         the sum and its float are exact, and the scores equal the plain
//         version's bit for bit.
// Selection, template switch SEL (warp_select.cuh):
//   MERGE: each tile's candidates are merged into a sorted k-list by
//          warp_merge (B2, B4a's v0/v3);
//   DRAIN: the reference's filter-then-drain (extras/bench_sq8_kernel.py,
//          _merge_tile_v2; B4a's v2): one warp per query takes the best
//          candidate and puts it in place of the unsorted list's worst
//          entry, kept at slot 0, until no candidate beats it.
// Either way a score is a candidate only if it is > NEG/2, not below the
// query's bound shared by the chunk CTAs, and better than its k-th best.
//
// Design. 1. scan: grid (n_chunks, ceil(Bq / QB)), one wave of resident
// CTAs (the wrapper plans the chunks from the occupancy query). A CTA
// holds QB = 64 queries: each warp one 16-query M-tile and half of each
// 64-row tile (K extent 128 for d <= 128, else 256). The int8 rows and
// their scales and mask stream through a cp.async ring: a tile's copies
// start two tiles ahead; BF16 widens tile t + 1 while the warps merge tile
// t's candidates, so a tile costs two barriers. The epilogue scales and
// masks the accumulators and compares each score once with a gate (the
// query's k-th best, its shared bound, NEG/2); a warp whose lanes all fail
// skips the admission tests, and admitted scores go to per-query candidate
// lists. Then every warp selects for the queries among its QB / 8 that
// have candidates, and publishes a query's k-th score once its list holds
// k real entries. The shared bound is read a tile ahead, off the critical
// path. 2. merge: warp_select.cuh's merge_kernel, one warp per query.
//
// Bound on an H100 at B2's main shape (Bq 1024, N 620,544, d 128): 162.7
// GFLOP, 0.164 ms on the bf16 tensor cores (0.082 ms at the int8 rate),
// against 84 MB of rows, scales and mask (0.025 ms): bound by operations.
// What holds it above that: at 64 queries per CTA each 64-row tile's fixed
// work (staging, widen, scale-and-mask epilogue, two barriers) weighs as
// much as its mma.sync products, and a chunk's list admits about
// k ln(rows / k) scores, each a warp merge: the selection grows with k and
// with the chunk's rows.
#pragma once

#include <algorithm>
#include <type_traits>

#include "mma_tile.cuh"
#include "warp_select.cuh"

namespace nafp {
namespace sq8 {

using namespace nafp::mma;

enum class Prod { BF16, I8 };
enum class Sel { MERGE, DRAIN };

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NT = TILE_ROWS / 8 / 2;  // n-tiles per warp: half the tile
constexpr int SR_STAGES = 3;           // ring stages of scales and mask
// queries per CTA: one 16-query M-tile per warp pair (128, two M-tiles per
// warp and one CTA per SM, timed slower on an H100 at k 20 and 80)
constexpr int QB = 64;

// The shapes that follow from the products and the K extent DM.
template <Prod P, int DM>
struct Cfg {
  // int8 ring: I8 multiplies from it (three stages: one being read, two
  // in flight); BF16 reads a stage only to widen it (two)
  static constexpr int RAW_STAGES = P == Prod::I8 ? 3 : 2;
  static constexpr int LDR = P == Prod::I8 ? Tile8<DM>::LD : DM;
  static constexpr int RAW_BYTES = TILE_ROWS * LDR;
  static constexpr int BF_BYTES = P == Prod::I8 ? 0 : Tile<DM>::BYTES;
  static constexpr int KSTEPS =
      P == Prod::I8 ? Tile8<DM>::KSTEPS : Tile<DM>::KSTEPS;
  using Acc = std::conditional_t<P == Prod::I8, int, float>;
};

template <Prod P, int DM>
size_t scan_smem_bytes(int k) {
  using C = Cfg<P, DM>;
  return (size_t)C::RAW_STAGES * C::RAW_BYTES + C::BF_BYTES  // rows
         + sizeof(float) * 2 * SR_STAGES * TILE_ROWS          // scales, mask
         + (sizeof(float) + sizeof(int)) * (size_t)QB * k     // k-lists
         + (sizeof(float) + sizeof(int)) * (size_t)QB * TILE_ROWS  // cands
         + 6 * sizeof(float) * QB;  // cnt, thr_v, thr_i, bnd[2], pub
}

// Warp-wide best / worst of (v, i) pairs in the better() order; every lane
// ends with the pair (and, for the worst, a slot that holds it).
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

// Sel::DRAIN for one query, one warp: while the best of the m candidates
// (cv, ci; 1 <= m <= 64) beats the worst entry of the unsorted k-list
// (slot 0), it takes slot 0 and the new worst entry moves there. The TPU
// takes each step's argmax and argmin across its lanes; here they are warp
// shuffles. A candidate that fails stops the drain: every later one is
// worse and the worst entry only rises.
__device__ __forceinline__ void warp_drain(float* L, int* LI, const float* cv,
                                           const int* ci, int m, int k) {
  const int lane = threadIdx.x & 31;
  // the lane's candidates; -inf once taken
  float c0 = lane < m ? cv[lane] : -INFINITY;
  int i0 = lane < m ? ci[lane] : NO_ROW;
  float c1 = lane + 32 < m ? cv[lane + 32] : -INFINITY;
  int i1 = lane + 32 < m ? ci[lane + 32] : NO_ROW;
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
}

// Start the copies of the chunk's tile t: int8 rows into the ring's stage,
// scales and mask (zeros at and past row_end) into theirs.
template <Prod P, int DM, int CP>
__device__ __forceinline__ void stage_tile(int8_t* raw, float* sr,
                                           const int8_t* __restrict__ db,
                                           const float* __restrict__ scales,
                                           const float* __restrict__ rmask,
                                           int t, int row_begin, int row_end,
                                           int d) {
  using C = Cfg<P, DM>;
  const int row0 = row_begin + t * TILE_ROWS;
  load_raw<THREADS, DM, CP, C::LDR, true>(
      raw + (t % C::RAW_STAGES) * C::RAW_BYTES, db, row0, row_end, d);
  if (threadIdx.x < 2 * TILE_ROWS / 4) {  // 16 copies each, 4 rows a copy
    const int which = threadIdx.x / (TILE_ROWS / 4);
    const int r = 4 * (threadIdx.x % (TILE_ROWS / 4));
    const float* src = which ? rmask : scales;
    const int n_in = min(4, max(0, row_end - (row0 + r)));
    cp_async<16>(sr + ((t % SR_STAGES) * 2 + which) * TILE_ROWS + r,
                 n_in ? src + row0 + r : src, 4 * n_in);
  }
}

// Two CTAs per SM at K extent 128 (up to k 80); one otherwise.
template <Prod P, Sel S, int DM, int CP>
__global__ void __launch_bounds__(THREADS, DM == 128 ? 2 : 1)
sq8_scan_kernel(const void* __restrict__ q, const int8_t* __restrict__ db,
                const float* __restrict__ scales,
                const float* __restrict__ rmask, int bq, int n, int d, int k,
                int chunk_rows, int n_chunks, float* bound,
                float* __restrict__ part_v, int* __restrict__ part_i) {
  using C = Cfg<P, DM>;
  using Acc = typename C::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* raw = reinterpret_cast<int8_t*>(smem);  // [RAW_STAGES][64][LDR]
  __nv_bfloat16* bf = reinterpret_cast<__nv_bfloat16*>(
      smem + C::RAW_STAGES * C::RAW_BYTES);                 // BF16: [64][LD]
  float* sr = reinterpret_cast<float*>(
      smem + C::RAW_STAGES * C::RAW_BYTES + C::BF_BYTES);   // [3][2][64]
  float* lv = sr + SR_STAGES * 2 * TILE_ROWS;               // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);
  float* cv = reinterpret_cast<float*>(li + QB * k);        // [QB][64]
  int* ci = reinterpret_cast<int*>(cv + QB * TILE_ROWS);
  int* cnt = ci + QB * TILE_ROWS;                           // [QB]
  float* thr_v = reinterpret_cast<float*>(cnt + QB);        // k-th best
  int* thr_i = reinterpret_cast<int*>(thr_v + QB);
  float* bnd = reinterpret_cast<float*>(thr_i + QB);  // [2][QB] shared bound
  float* pub = bnd + 2 * QB;                          // last published

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(n, row_begin + chunk_rows);
  const int n_tiles = (row_end - row_begin + TILE_ROWS - 1) / TILE_ROWS;

  for (int e = tid; e < QB * k; e += THREADS) {
    lv[e] = NEG;
    li[e] = NO_ROW;
  }
  for (int e = tid; e < QB; e += THREADS) {
    cnt[e] = 0;
    thr_v[e] = NEG;
    thr_i[e] = NO_ROW;
    bnd[e] = q0 + e < bq ? __ldcg(bound + q0 + e) : NEG;
    pub[e] = NEG;
  }
  const int mrow = warp & 3;            // this warp's M-tile
  const int nt0 = (warp >> 2) * NT;     // and its n-tiles of each tile
  uint32_t a[1][C::KSTEPS][4];
  if constexpr (P == Prod::I8)
    load_a_i8<1, DM>(a, static_cast<const int8_t*>(q), bq, d,
                     q0 + 16 * mrow);
  else
    load_a<1, DM>(a, static_cast<const float*>(q), bq, d, q0 + 16 * mrow);

  for (int t = 0; t < 2; ++t) {
    if (t < n_tiles)
      stage_tile<P, DM, CP>(raw, sr, db, scales, rmask, t, row_begin,
                            row_end, d);
    cp_async_commit();
  }
  if constexpr (P == Prod::BF16) {
    cp_async_wait<1>();  // tile 0 has landed
    __syncthreads();
    if (n_tiles > 0) widen<THREADS, DM, C::LDR>(raw, bf);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = row_begin + t * TILE_ROWS;
    if constexpr (P == Prod::I8) cp_async_wait<1>();  // tile t has landed
    __syncthreads();  // tile t staged (BF16: widened) for all; lists merged
    if (t + 2 < n_tiles)  // into the stages tile t - 1 used
      stage_tile<P, DM, CP>(raw, sr, db, scales, rmask, t + 2, row_begin,
                            row_end, d);
    cp_async_commit();
    // the shared bound for tile t + 1, read now and stored after the
    // products, off the tile's critical path
    const float next_bnd =
        tid < QB && q0 + tid < bq ? __ldcg(bound + q0 + tid) : NEG;
    const float* tile_bnd = bnd + (t & 1) * QB;

    Acc acc[1][NT][4];
    if constexpr (P == Prod::I8)
      tile_mma_i8<1, NT, DM>(
          a, smem_addr(raw + (t % C::RAW_STAGES) * C::RAW_BYTES), nt0, acc);
    else
      tile_mma<1, NT, DM>(a, smem_addr(bf), nt0, acc);
    // the lane's rows' scales and mask (0 past the chunk's rows, whose
    // score 0 the admission test below rejects)
    const float* s_sc = sr + (t % SR_STAGES) * 2 * TILE_ROWS;
    float rs[NT][2], rm[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = (nt0 + nt) * 8 + 2 * (lane & 3) + j;
        rs[nt][j] = s_sc[r];
        rm[nt][j] = s_sc[TILE_ROWS + r];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * mrow + (lane >> 2) + 8 * h;
      const float tv = thr_v[qi], floor_v = tile_bnd[qi];
      const int tvi = thr_i[qi];
      // every admitted score is >= gate (+inf past bq): one compare
      // rejects the rest, and a warp whose lanes all reject skips the tests
      const float gate =
          q0 + qi < bq ? fmaxf(fmaxf(tv, floor_v), NEG / 2) : INFINITY;
      float s[NT][2];
      bool any = false;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // (sum * scale) + mask, rounded as written: no fused multiply-add
          s[nt][j] = __fadd_rn(
              __fmul_rn((float)acc[0][nt][2 * h + j], rs[nt][j]),
              rm[nt][j]);
          any |= s[nt][j] >= gate;
        }
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = t0 + (nt0 + nt) * 8 + 2 * (lane & 3) + j;
          if (s[nt][j] >= gate && s[nt][j] > NEG / 2 && row < row_end &&
              s[nt][j] >= floor_v && better(s[nt][j], row, tv, tvi)) {
            const int slot = atomicAdd(&cnt[qi], 1);
            cv[qi * TILE_ROWS + slot] = s[nt][j];
            ci[qi * TILE_ROWS + slot] = row;
          }
        }
    }
    if constexpr (P == Prod::BF16) cp_async_wait<1>();  // tile t + 1 landed
    __syncthreads();  // candidates complete; tile t's stages consumed
    if (tid < QB) bnd[((t + 1) & 1) * QB + tid] = next_bnd;
    if constexpr (P == Prod::BF16)
      if (t + 1 < n_tiles)
        widen<THREADS, DM, C::LDR>(
            raw + ((t + 1) % C::RAW_STAGES) * C::RAW_BYTES, bf);

    // this warp's queries warp + 8 j that have candidates, one bit each
    constexpr int QPW = QB / WARPS;
    const unsigned has = __ballot_sync(
        0xffffffffu, lane < QPW && cnt[warp + WARPS * lane] > 0);
    for (unsigned rest = has; rest; rest &= rest - 1) {
      const int qi = warp + WARPS * (__ffs(rest) - 1);
      float* L = lv + qi * k;
      int* LI = li + qi * k;
      const float* qcv = cv + qi * TILE_ROWS;
      const int* qci = ci + qi * TILE_ROWS;
      if constexpr (S == Sel::MERGE)
        sel::warp_merge(L, LI, qcv, qci, cnt[qi], k);
      else
        warp_drain(L, LI, qcv, qci, cnt[qi], k);
    }
    __syncwarp();
    if (has >> lane & 1) {  // lane j: query warp + 8 j, all in parallel
      const int qi = warp + WARPS * lane;
      // the k-th best: last of the sorted list, or the drain's slot 0
      const int kth_slot = qi * k + (S == Sel::MERGE ? k - 1 : 0);
      const float kth = lv[kth_slot];
      cnt[qi] = 0;
      thr_v[qi] = kth;
      thr_i[qi] = li[kth_slot];
      if (kth > NEG / 2 && kth > pub[qi]) {  // k real entries
        pub[qi] = kth;
        sel::atomic_max_f32(bound + q0 + qi, kth);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int e = tid; e < QB * k; e += THREADS) {
    const int qi = e / k, j = e % k;
    if (q0 + qi < bq) {
      const size_t o = ((size_t)(q0 + qi) * n_chunks + chunk) * k + j;
      part_v[o] = lv[e];
      part_i[o] = li[e];
    }
  }
}

// A scan instance: products, selection, K extent, copy width.
template <Prod P_, Sel S_, int DM_, int CP_>
struct Inst {
  static constexpr Prod P = P_;
  static constexpr Sel S = S_;
  static constexpr int DM = DM_, CP = CP_;
};

// f(Inst<...>{}) for the instance that takes rows of width d (I8: d a
// multiple of 16).
template <Prod P, Sel S, typename F>
cudaError_t dispatch(int d, F&& f) {
  constexpr int NARROW = P == Prod::I8 ? 16 : 4;
  return with_shape<16, NARROW>(d, d % 16 == 0, [&](auto sh) {
    using Sh = decltype(sh);
    return f(Inst<P, S, Sh::DM, Sh::CP>{});
  });
}

template <typename I>
cudaError_t set_smem(int k, size_t* smem) {
  *smem = scan_smem_bytes<I::P, I::DM>(k);
  return cudaFuncSetAttribute(
      sq8_scan_kernel<I::P, I::S, I::DM, I::CP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

inline bool bad_args(Prod p, int bq, int n, int d, int k, int chunk_rows,
                     int n_chunks) {
  return bq <= 0 || n < 0 || d <= 0 || d % (p == Prod::I8 ? 16 : 4) ||
         d > MAX_D || k < 1 || k > MAX_K || chunk_rows <= 0 ||
         chunk_rows % TILE_ROWS ||
         n_chunks != (std::max(n, 1) + chunk_rows - 1) / chunk_rows;
}

// The scan + merge for (bq, d) queries (BF16: f32; I8: int8) over vecs8
// (n, d) int8 with scales and rmask (n,) f32; bound (bq,) f32, every entry
// NEG on entry; part_v/part_i (bq, n_chunks, k) scratch; out_v/out_i (bq,
// k). Returns a CUDA error code, 0 when both launches were accepted.
template <Prod P, Sel S>
int run(const void* q, const int8_t* vecs8, const float* scales,
        const float* rmask, int bq, int n, int d, int k, int chunk_rows,
        int n_chunks, float* bound, float* part_v, int* part_i, float* out_v,
        int* out_i, void* stream) {
  if (bad_args(P, bq, n, d, k, chunk_rows, n_chunks))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch<P, S>(d, [&](auto inst) {
    using I = decltype(inst);
    size_t smem;
    const cudaError_t e = set_smem<I>(k, &smem);
    if (e != cudaSuccess) return e;
    sq8_scan_kernel<I::P, I::S, I::DM, I::CP>
        <<<dim3(n_chunks, (bq + QB - 1) / QB), THREADS, smem, s>>>(
            q, vecs8, scales, rmask, bq, n, d, k, chunk_rows, n_chunks, bound,
            part_v, part_i);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)sel::launch_merge(part_v, part_i, bound, bq, n_chunks * k, k,
                                out_v, out_i, s);
}

// The scan's residency at (d, k): info[0] dynamic shared memory per CTA
// in bytes, info[1] the CTAs one SM holds at once, info[2] registers per
// thread. Returns a CUDA error code (0 on success).
template <Prod P, Sel S>
int occupancy(int d, int k, int* info) {
  if (bad_args(P, 1, 0, d, k, TILE_ROWS, 1))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch<P, S>(d, [&](auto inst) {
    using I = decltype(inst);
    const auto kern = sq8_scan_kernel<I::P, I::S, I::DM, I::CP>;
    size_t smem;
    cudaError_t err = set_smem<I>(k, &smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        THREADS, smem);
    if (err != cudaSuccess) return err;
    info[0] = (int)smem;
    info[1] = per_sm;
    info[2] = attr.numRegs;
    return cudaSuccess;
  });
}

}  // namespace sq8
}  // namespace nafp
