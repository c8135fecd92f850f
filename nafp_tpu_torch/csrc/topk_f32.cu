// Kernel B1: exact f32 top-k of q . DB^T (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel topk_ip_pallas (nafp_tpu/search/pallas_topk.py,
// _kernel_plain -> _kernel_body with _merge_tile / _finish_sort), which
// FlatIndex uses for `-i l2`, `-i ip` and `-i ivf` at >= 50k rows.
//
// What it computes: for each query the k best rows by inner product,
// scores sorted descending, int32 row positions, -1 wherever the score is
// <= NEG/2 (the empty slots when k > N). Ties go to the lower row. The
// (Bq, N) score matrix never reaches device memory.
//
// Numerics: f32-accurate products on the TF32 tensor cores, 3xTF32
// (mma_tile.cuh: each operand split into TF32 hi and lo, a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi summed in f32); about 2^-22 of each |a_i b_i| is
// lost, near the f32 FMA scan it replaces. One TF32 pass (three digits)
// or bf16x3 (about 2^-16) would not hold the f32 reference's 1e-4.
//
// Bound on an H100 at the main path's shape (Bq 512, N 619,500, d 128):
// the split triples the 81.2 GFLOP of the product, 243.6 GFLOP of TF32 at
// 495 TFLOP/s, 0.492 ms; the DB's 317 MB take 0.095 ms at 3.35 TB/s: bound
// by operations. (The FMA design's bound was 81.2 GFLOP at the 67 TFLOP/s
// f32 CUDA-core peak, 1.212 ms.)
//
// Design. 1. scan: grid (n_chunks, ceil(Bq / QB)), one wave of resident
// CTAs (the wrapper plans the chunks from nafp_topk_f32_occupancy). A CTA
// holds QB = 64 queries: each warp one 16-query M-tile and half of each
// 64-row tile. The f32 rows stream through a two-stage cp.async ring
// (16-byte copies: d is a multiple of 4), rows DM + 4 floats apart, read
// by ldmatrix and split in registers. The queries' A fragments stay in
// registers for the launch as f32 values (64 registers at K extent 128,
// 128 at 256) and are split once per tile and k step: split once per
// launch they would take twice that, and staged in shared memory they
// would not fit at 256 beside the f32 ring and the k-lists. The epilogue
// and the selection are B3's (topk_masked.cu) without its bias and ids: a
// score is a candidate only if it is > NEG/2, not below the query's bound
// shared by the chunk CTAs, and better than its k-th best; warp_merge
// merges each tile's candidates, and a query's k-th score is published
// once its list holds k real entries. 2. merge: warp_select.cuh's
// merge_kernel, one warp per query.
//
// Registers (H100; PERF.md, B1 redesign): ptxas schedules the unrolled tile to
// whatever budget it is given and then spills a little (8-56 bytes at 128,
// the cap of two CTAs per SM; 36 at 255). Capped at 168 it spills nothing
// at K extent 128 and one CTA per SM runs 3.2 ms at the main shape; two
// CTAs per SM, with the spill, ran 2.5 ms.
#include <algorithm>

#include "mma_tile.cuh"
#include "warp_select.cuh"

namespace {

using namespace nafp;
using namespace nafp::mma;
using namespace nafp::sel;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QB = 64;                 // queries per scan CTA (4 M-tiles)
constexpr int NT = TILE_ROWS / 8 / 2;  // n-tiles per warp: half the tile

// 232,192 bytes at K extent 256 and k 128, under the 232,448 a CTA may
// take: hence no separate copy of each list's k-th entry.
template <int DM>
size_t scan_smem_bytes(int k) {
  return 2 * (size_t)Tf32Tile<DM>::BYTES                     // ring
         + (sizeof(float) + sizeof(int)) * (size_t)QB * k     // k-lists
         + (sizeof(float) + sizeof(int)) * (size_t)QB * TILE_ROWS  // cands
         + 3 * sizeof(float) * QB;                            // cnt, bnd, pub
}

// Start the cp.async copies of rows row0 .. row0 + 63 of db (n, d) f32
// into `rows` (zero-filled to DM; zeros at and past row_end).
template <int DM>
__device__ __forceinline__ void load_tile(float* rows,
                                          const float* __restrict__ db,
                                          int row0, int row_end, int d) {
  constexpr int CPR = DM / 4;  // 16-byte copies per staged row
  for (int e = threadIdx.x; e < TILE_ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const bool in = 4 * c < d && row0 + r < row_end;
    cp_async<16>(rows + r * Tf32Tile<DM>::LD + 4 * c,
                 in ? db + (size_t)(row0 + r) * d + 4 * c : db, in ? 16 : 0);
  }
}

// One CTA per SM: 168 registers at K extent 128 (no spill; see above), all
// 255 at 256, whose A fragments take 128.
template <int DM>
__global__ void __maxnreg__(DM == 128 ? 168 : 255)
scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
            int bq, int n, int d, int k, int chunk_rows, int n_chunks,
            float* bound, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  constexpr int TE = TILE_ROWS * Tf32Tile<DM>::LD;  // floats of one tile
  extern __shared__ __align__(16) unsigned char smem[];
  float* rows = reinterpret_cast<float*>(smem);     // [2][64][LD]
  float* lv = rows + 2 * TE;                        // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);
  float* cv = reinterpret_cast<float*>(li + QB * k);  // [QB][64]
  int* ci = reinterpret_cast<int*>(cv + QB * TILE_ROWS);
  int* cnt = ci + QB * TILE_ROWS;                     // [QB]
  float* bnd = reinterpret_cast<float*>(cnt + QB);    // shared bound
  float* pub = bnd + QB;                              // last published

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
    pub[e] = NEG;
  }
  const int mt = warp & 3;              // this warp's 16 queries
  const int nt0 = (warp >> 2) * NT;     // and its n-tiles of each tile
  uint32_t a[Tf32Tile<DM>::KSTEPS][4];
  load_a_f32<DM>(a, q, bq, d, q0 + 16 * mt);
  if (n_tiles > 0) load_tile<DM>(rows, db, row_begin, row_end, d);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = row_begin + t * TILE_ROWS;
    if (t + 1 < n_tiles)  // its stage was consumed in tile t - 1
      load_tile<DM>(rows + ((t + 1) & 1) * TE, db, t0 + TILE_ROWS, row_end,
                    d);
    cp_async_commit();
    if (tid < QB)
      bnd[tid] = q0 + tid < bq ? __ldcg(bound + q0 + tid) : NEG;
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();     // ... for every thread; lists merged

    float acc[NT][4];
    tile_mma_3xtf32<NT, DM>(a, smem_addr(rows + (t & 1) * TE), nt0, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * mt + (lane >> 2) + 8 * h;
      const float tv = lv[qi * k + k - 1], floor_v = bnd[qi];
      const int tvi = li[qi * k + k - 1];
      // every admitted score is >= gate (+inf past bq): one compare
      // rejects the rest, and a warp whose lanes all reject skips the tests
      const float gate =
          q0 + qi < bq ? fmaxf(fmaxf(tv, floor_v), NEG / 2) : INFINITY;
      bool any = false;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        any |= acc[nt][2 * h] >= gate || acc[nt][2 * h + 1] >= gate;
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s = acc[nt][2 * h + j];
          const int row = t0 + (nt0 + nt) * 8 + 2 * (lane & 3) + j;
          if (s >= gate && s > NEG / 2 && row < row_end &&
              better(s, row, tv, tvi)) {
            const int slot = atomicAdd(&cnt[qi], 1);
            cv[qi * TILE_ROWS + slot] = s;
            ci[qi * TILE_ROWS + slot] = row;
          }
        }
    }
    __syncthreads();  // candidates complete

    // this warp's queries warp + 8 j that have candidates, one bit each
    constexpr int QPW = QB / WARPS;
    const unsigned has = __ballot_sync(
        0xffffffffu, lane < QPW && cnt[warp + WARPS * lane] > 0);
    for (unsigned rest = has; rest; rest &= rest - 1) {
      const int qi = warp + WARPS * (__ffs(rest) - 1);
      warp_merge(lv + qi * k, li + qi * k, cv + qi * TILE_ROWS,
                 ci + qi * TILE_ROWS, cnt[qi], k);
    }
    __syncwarp();
    if (has >> lane & 1) {  // lane j: query warp + 8 j, all in parallel
      const int qi = warp + WARPS * lane;
      const float kth = lv[qi * k + k - 1];
      cnt[qi] = 0;
      if (kth > NEG / 2 && kth > pub[qi]) {  // k real entries
        pub[qi] = kth;
        atomic_max_f32(bound + q0 + qi, kth);
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

template <int DM>
cudaError_t set_smem(int k, size_t* smem) {
  *smem = scan_smem_bytes<DM>(k);
  return cudaFuncSetAttribute(scan_kernel<DM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// f(Shape<DM, 16>{}) for the K extent of rows of width d (every f32 row is
// whole 16-byte copies).
template <typename F>
cudaError_t dispatch(int d, F&& f) {
  return with_shape<16, 16>(d, true, f);
}

bool bad_args(int bq, int n, int d, int k, int chunk_rows, int n_chunks) {
  return bq <= 0 || n < 0 || d <= 0 || d % 4 || d > MAX_D || k < 1 ||
         k > MAX_K || chunk_rows <= 0 || chunk_rows % TILE_ROWS ||
         n_chunks != (std::max(n, 1) + chunk_rows - 1) / chunk_rows;
}

}  // namespace

// q (bq, d) f32; db (n, d) f32; bound (bq,) f32, every entry NEG on entry
// (the shared admission bound, raised by the scan); part_v/part_i (bq,
// n_chunks, k) scratch; out_v/out_i (bq, k). d a multiple of 4, at most
// MAX_D; chunk_rows a multiple of 64. Returns a CUDA error code, 0 when
// both launches were accepted.
extern "C" int nafp_topk_f32(const float* q, const float* db, int bq, int n,
                             int d, int k, int chunk_rows, int n_chunks,
                             float* bound, float* part_v, int* part_i,
                             float* out_v, int* out_i, void* stream) {
  if (bad_args(bq, n, d, k, chunk_rows, n_chunks))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(d, [&](auto sh) {
    using Sh = decltype(sh);
    size_t smem;
    const cudaError_t e = set_smem<Sh::DM>(k, &smem);
    if (e != cudaSuccess) return e;
    scan_kernel<Sh::DM><<<dim3(n_chunks, (bq + QB - 1) / QB), THREADS, smem,
                          s>>>(q, db, bq, n, d, k, chunk_rows, n_chunks,
                               bound, part_v, part_i);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_v, part_i, bound, bq, n_chunks * k, k, out_v,
                           out_i, s);
}

// The scan's residency at d and k: info[0] dynamic shared memory per CTA
// in bytes, info[1] the CTAs one SM holds at once, info[2] registers per
// thread. Returns a CUDA error code (0 on success).
extern "C" int nafp_topk_f32_occupancy(int d, int k, int* info) {
  if (bad_args(1, 0, d, k, TILE_ROWS, 1)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(d, [&](auto sh) {
    using Sh = decltype(sh);
    size_t smem;
    cudaError_t err = set_smem<Sh::DM>(k, &smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, scan_kernel<Sh::DM>);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_kernel<Sh::DM>, THREADS, smem);
    if (err != cudaSuccess) return err;
    info[0] = (int)smem;
    info[1] = per_sm;
    info[2] = attr.numRegs;
    return cudaSuccess;
  });
}
