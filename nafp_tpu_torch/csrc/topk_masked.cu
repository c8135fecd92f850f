// Kernel B3: top-k of q . DB^T over a decoded IVF-PQ chunk with per-row ids
// and a per-(query, subtile) additive bias (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel topk_ip_pallas_masked (nafp_tpu/search/
// pallas_topk.py, _kernel_masked -> _kernel_body with the bias expansion,
// _merge_tile / _finish_sort), which IVFPQIndex.search calls once per
// (DB chunk, query block) for `-i ivfpq` (k 20) and `-i ivfpq-rr` (k 80).
//
// Numerics kept from the TPU: q is rounded to bf16, the bf16 rows are
// multiplied exactly and summed in f32 (on the tensor cores); then the bias
// of the row's list_tile subtile (the IVF probe mask, 0 or NEG) is added,
// and a row whose id is < 0 is masked. A score <= NEG/2 is never a
// candidate, so such slots come back as -1. Positions come back; the
// wrapper maps them through the ids. Ties go to the lower row.
//
// Bound on an H100 at the main path's shape (Bq 512, N ~636k padded rows,
// d 128, 40 of 256 lists probed): products are needed only for the valid
// rows of probed subtiles, ~13 GFLOP (~0.013 ms at 989 TFLOP/s), while the
// bf16 rows, ids and bias are ~176 MB, ~0.05 ms at 3.35 TB/s: bytes bound.
//
// Design. 1. scan: grid (n_chunks, ceil(Bq / QB)). A CTA keeps QB = 64
// queries' bf16 A fragments in registers (each warp one 16-query M-tile and
// half of the 64-row tile: mma_tile.cuh, K extent 128 for d <= 128, else
// 256) and streams its chunk's bf16 rows and ids through a double-buffered
// cp.async ring. The epilogue adds
// the bias and the id mask to the accumulators and admits a score only if
// it beats its query's current k-th best (sorted k-list in shared memory)
// and is not below the query's shared bound; admitted scores go to a
// per-query candidate list. Then every warp merges the candidates of 8
// queries into their k-lists (warp_merge: each element's new place is its
// rank among the candidates plus its rank in the list, a merge path).
// 2. merge: one warp per query merges the n_chunks lists the same way.
// (warp_select.cuh: the merge and the shared bound.)
#include <algorithm>

#include "mma_tile.cuh"
#include "warp_select.cuh"

namespace {

using namespace nafp;
using namespace nafp::mma;
using namespace nafp::sel;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QB = 64;               // queries per scan CTA (4 M-tiles)
constexpr int NT = TILE_ROWS / 8 / 2;  // n-tiles per warp: half the tile

template <int DM>
size_t scan_smem_bytes(int k) {
  return 2 * (size_t)(Tile<DM>::BYTES + TILE_ROWS * sizeof(int))  // rows, ids
         + (sizeof(float) + sizeof(int)) * (size_t)QB * k    // k-lists
         + (sizeof(float) + sizeof(int)) * (size_t)QB * TILE_ROWS  // cands
         + 6 * sizeof(float) * QB;  // cnt, thr_v, thr_i, bnd, qbias, pub
}

// Start the cp.async copies of rows row0 .. row0 + 63 (bf16, CP bytes a
// copy: 16 when d is a multiple of 8, else 8; zero-filled to DM; zeros at
// and past row_end) and their ids.
template <int DM, int CP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* rows, int* tids,
                                          const __nv_bfloat16* __restrict__ db,
                                          const int* __restrict__ ids,
                                          int row0, int row_end, int d) {
  constexpr int CH = CP / 2;    // values a copy
  constexpr int CPR = DM / CH;  // copies per staged row
  for (int e = threadIdx.x; e < TILE_ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const bool in = CH * c < d && row0 + r < row_end;
    cp_async<CP>(rows + r * Tile<DM>::LD + CH * c,
                 in ? db + (size_t)(row0 + r) * d + CH * c : db,
                 in ? CP : 0);
  }
  if (threadIdx.x < TILE_ROWS / 4) {
    const int r = 4 * threadIdx.x;
    const int n_in = min(4, max(0, row_end - (row0 + r)));
    cp_async<16>(tids + r, n_in ? ids + row0 + r : ids, 4 * n_in);
  }
}

// Two CTAs per SM at K extent 128 (up to k 80); one at 256, whose A
// fragments take twice the registers.
template <int DM, int CP>
__global__ void __launch_bounds__(THREADS, DM == 128 ? 2 : 1)
scan_kernel(const float* __restrict__ q,
            const __nv_bfloat16* __restrict__ db,
            const int* __restrict__ ids, const float* __restrict__ bias,
            int bq, int n, int d, int k, int list_tile, int chunk_rows,
            int n_chunks, float* bound, float* __restrict__ part_v,
            int* __restrict__ part_i) {
  constexpr int TE = TILE_ROWS * Tile<DM>::LD;  // elements of one tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* rows = reinterpret_cast<__nv_bfloat16*>(smem);  // [2]
  int* tids = reinterpret_cast<int*>(rows + 2 * TE);             // [2][64]
  float* lv = reinterpret_cast<float*>(tids + 2 * TILE_ROWS);    // [QB][k]
  int* li = reinterpret_cast<int*>(lv + QB * k);
  float* cv = reinterpret_cast<float*>(li + QB * k);        // [QB][64]
  int* ci = reinterpret_cast<int*>(cv + QB * TILE_ROWS);
  int* cnt = ci + QB * TILE_ROWS;                           // [QB]
  float* thr_v = reinterpret_cast<float*>(cnt + QB);        // list[k - 1]
  int* thr_i = reinterpret_cast<int*>(thr_v + QB);
  float* bnd = reinterpret_cast<float*>(thr_i + QB);        // shared bound
  float* qbias = bnd + QB;                                  // this tile's
  float* pub = qbias + QB;                                  // last published

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * QB;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(n, row_begin + chunk_rows);
  const int n_tiles = (row_end - row_begin + TILE_ROWS - 1) / TILE_ROWS;
  const int n_sub = n / list_tile;

  for (int e = tid; e < QB * k; e += THREADS) {
    lv[e] = NEG;
    li[e] = NO_ROW;
  }
  for (int e = tid; e < QB; e += THREADS) {
    cnt[e] = 0;
    thr_v[e] = NEG;
    thr_i[e] = NO_ROW;
    pub[e] = NEG;
  }
  const int mt = warp & 3;              // this warp's 16 queries
  const int nt0 = (warp >> 2) * NT;     // and its n-tiles of each tile
  uint32_t a[1][Tile<DM>::KSTEPS][4];
  load_a<1, DM>(a, q, bq, d, q0 + 16 * mt);
  if (n_tiles > 0)
    load_tile<DM, CP>(rows, tids, db, ids, row_begin, row_end, d);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = row_begin + t * TILE_ROWS;
    if (t + 1 < n_tiles)  // its stage was consumed in tile t - 1
      load_tile<DM, CP>(rows + ((t + 1) & 1) * TE,
                    tids + ((t + 1) & 1) * TILE_ROWS, db, ids,
                    t0 + TILE_ROWS, row_end, d);
    cp_async_commit();
    if (tid < QB) {
      const bool live = q0 + tid < bq;
      qbias[tid] = live ? bias[(size_t)(q0 + tid) * n_sub + t0 / list_tile]
                        : NEG;
      bnd[tid] = live ? __ldcg(bound + q0 + tid) : NEG;
    }
    cp_async_wait<1>();  // tile t has landed
    __syncthreads();     // ... for every thread; lists merged

    float acc[1][NT][4];
    tile_mma<1, NT, DM>(a, smem_addr(rows + (t & 1) * TE), nt0, acc);
    const int* ti = tids + (t & 1) * TILE_ROWS;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = 16 * mt + (lane >> 2) + 8 * h;
      const float qb = qbias[qi], tv = thr_v[qi];
      const float floor_v = bnd[qi];
      const int tvi = thr_i[qi];
      if (qb <= NEG / 2) continue;  // unprobed subtile or no such query
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = (nt0 + nt) * 8 + 2 * (lane & 3) + j;
          const int row = t0 + r;
          const float s = acc[0][nt][2 * h + j] + qb;
          if (row < row_end && ti[r] >= 0 && s > NEG / 2 && s >= floor_v &&
              better(s, row, tv, tvi)) {
            const int slot = atomicAdd(&cnt[qi], 1);
            cv[qi * TILE_ROWS + slot] = s;
            ci[qi * TILE_ROWS + slot] = row;
          }
        }
    }
    __syncthreads();  // candidates complete

    for (int qi = warp; qi < QB; qi += WARPS) {
      const int m = cnt[qi];
      if (m == 0) continue;
      float* L = lv + qi * k;
      int* LI = li + qi * k;
      warp_merge(L, LI, cv + qi * TILE_ROWS, ci + qi * TILE_ROWS, m, k);
      if (lane == 0) {
        const float kth = L[k - 1];
        cnt[qi] = 0;
        thr_v[qi] = kth;
        thr_i[qi] = LI[k - 1];
        if (kth > NEG / 2 && kth > pub[qi]) {  // k real entries
          pub[qi] = kth;
          atomic_max_f32(bound + q0 + qi, kth);
        }
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

template <int DM, int CP>
cudaError_t set_smem(int k, size_t* smem) {
  *smem = scan_smem_bytes<DM>(k);
  return cudaFuncSetAttribute(scan_kernel<DM, CP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

template <int DM, int CP>
cudaError_t launch_scan(const float* q, const void* db, const int* ids,
                        const float* bias, int bq, int n, int d, int k,
                        int list_tile, int chunk_rows, int n_chunks,
                        float* bound, float* part_v, int* part_i,
                        cudaStream_t s) {
  size_t smem;
  const cudaError_t err = set_smem<DM, CP>(k, &smem);
  if (err != cudaSuccess) return err;
  scan_kernel<DM, CP><<<dim3(n_chunks, (bq + QB - 1) / QB), THREADS, smem, s>>>(
      q, static_cast<const __nv_bfloat16*>(db), ids, bias, bq, n, d, k,
      list_tile, chunk_rows, n_chunks, bound, part_v, part_i);
  return cudaGetLastError();
}

// The scan's residency: info as nafp_topk_masked_occupancy.
template <int DM, int CP>
cudaError_t scan_occupancy(int k, int* info) {
  size_t smem;
  cudaError_t err = set_smem<DM, CP>(k, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, scan_kernel<DM, CP>);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, scan_kernel<DM, CP>, THREADS, smem);
  if (err != cudaSuccess) return err;
  info[0] = (int)smem;
  info[1] = per_sm;
  info[2] = attr.numRegs;
  return cudaSuccess;
}

bool bad_args(int bq, int n, int d, int k, int list_tile, int chunk_rows,
              int n_chunks) {
  return bq <= 0 || n < 0 || d <= 0 || d % 4 || d > MAX_D || k < 1 ||
         k > MAX_K || list_tile <= 0 || list_tile % TILE_ROWS ||
         n % list_tile || chunk_rows <= 0 || chunk_rows % TILE_ROWS ||
         n_chunks != (std::max(n, 1) + chunk_rows - 1) / chunk_rows;
}

}  // namespace

// q (bq, d) f32; db_bf16 (n, d) bf16; ids (n,) int32; bias (bq, n /
// list_tile) f32; bound (bq,) f32, every entry NEG on entry (the shared
// admission bound, raised by the scan); part_v/part_i (bq, n_chunks, k)
// scratch; out_v/out_i (bq, k). d a multiple of 4, at most MAX_D;
// list_tile and chunk_rows multiples of 64; n a multiple of list_tile.
extern "C" int nafp_topk_masked(const float* q, const void* db_bf16,
                                const int* ids, const float* bias, int bq,
                                int n, int d, int k, int list_tile,
                                int chunk_rows, int n_chunks, float* bound,
                                float* part_v, int* part_i, float* out_v,
                                int* out_i, void* stream) {
  if (bad_args(bq, n, d, k, list_tile, chunk_rows, n_chunks))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = with_shape<16, 8>(d, d % 8 == 0, [&](auto sh) {
    using S = decltype(sh);
    return launch_scan<S::DM, S::CP>(q, db_bf16, ids, bias, bq, n, d, k,
                                     list_tile, chunk_rows, n_chunks, bound,
                                     part_v, part_i, s);
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_v, part_i, bound, bq, n_chunks * k, k, out_v,
                           out_i, s);
}

// The scan's residency at d and k: info[0] dynamic shared memory per CTA
// in bytes, info[1] the CTAs one SM holds at once, info[2] registers per
// thread. Returns a CUDA error code (0 on success).
extern "C" int nafp_topk_masked_occupancy(int d, int k, int* info) {
  if (d <= 0 || d % 4 || d > MAX_D || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  return (int)with_shape<16, 8>(d, d % 8 == 0, [&](auto sh) {
    using S = decltype(sh);
    return scan_occupancy<S::DM, S::CP>(k, info);
  });
}
