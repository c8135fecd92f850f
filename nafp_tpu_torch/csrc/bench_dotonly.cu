// Kernel B4b: the streaming floor of the sq8 scan, its products with no
// selection, on the bf16 tensor cores (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel run_dotonly (extras/bench_sq8_kernel.py, body
// _kern_dotonly): bf16(q) . bf16(row) for every query and int8 row, then a
// row max. The TPU kernel writes each grid step's (Bq, 1) maximum over the
// same output block, so it returns the maximum of the LAST blk-row block
// only. Here every block's maximum is kept, (Bq, N / blk), so that no
// product is dead code the compiler could drop; the wrapper returns the
// last column, the reference's result.
//
// Bound on an H100 at the bench's shape (Bq 512, N 8,388,608, d 128): 1.1
// TFLOP, about 1.11 ms on the bf16 tensor cores (989 TFLOP/s), against
// 1.07 GB of rows read and 8.4 MB of maxima written, 0.32 ms at 3.35 TB/s:
// bound by operations.
//
// Design (mma_tile.cuh). A CTA holds QPB = 256 queries, 32 per warp, as
// resident bf16 A fragments in registers (128, 16 per warp, when d > 128
// and the K extent is 256: the same 64 registers), and walks whole blk-row
// blocks (grid-stride over the blocks; the grid is one wave of resident
// CTAs). The int8 rows stream through a ring of STAGES cp.async stages;
// each 64-row tile is widened once per CTA (int8 -> bf16 is exact) into one
// of two bf16 tiles, while the tensor cores take the other. A warp's
// maximum over a tile's rows stays in registers; at the end of a block two
// shuffles reduce it across the lanes that hold the block's other rows, and
// one f32 per (query, block) is written.
#include <algorithm>

#include "mma_tile.cuh"

namespace {

using namespace nafp;
using namespace nafp::mma;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 4;                  // int8 tiles in flight

// The shapes that follow from the K extent DM.
template <int DM>
struct Cfg {
  static constexpr int MT = 256 / DM;  // M-tiles (16 queries) per warp
  static constexpr int QPB = WARPS * MT * 16;      // queries per CTA
  static constexpr int RAW_BYTES = TILE_ROWS * DM;            // int8 tile
  static constexpr int BF_ELEMS = TILE_ROWS * Tile<DM>::LD;   // bf16 tile
  static constexpr size_t SMEM =
      (size_t)STAGES * RAW_BYTES + 2 * Tile<DM>::BYTES;
};

// Two CTAs per SM at K extent 128; one at 256 (shared memory).
template <int DM, int CP>
__global__ void __launch_bounds__(THREADS, DM == 128 ? 2 : 1)
block_max_kernel(const float* __restrict__ q, const int8_t* __restrict__ db,
                 int bq, int n, int d, int blk, float* __restrict__ out) {
  constexpr int MT = Cfg<DM>::MT, RAW_BYTES = Cfg<DM>::RAW_BYTES;
  constexpr int BF_ELEMS = Cfg<DM>::BF_ELEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* raw = reinterpret_cast<int8_t*>(smem);                // [STAGES]
  __nv_bfloat16* bf =
      reinterpret_cast<__nv_bfloat16*>(smem + STAGES * RAW_BYTES);  // [2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * Cfg<DM>::QPB + warp * MT * 16;
  const int n_blocks = n / blk, tpb = blk / TILE_ROWS;
  const int my_blocks = (n_blocks - (int)blockIdx.x + (int)gridDim.x - 1) /
                        (int)gridDim.x;
  const int n_tiles = my_blocks * tpb;
  auto tile_row = [&](int t) {
    return (blockIdx.x + (t / tpb) * gridDim.x) * blk + (t % tpb) * TILE_ROWS;
  };

  uint32_t a[MT][Tile<DM>::KSTEPS][4];
  load_a<MT, DM>(a, q, bq, d, q0);

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles)
      load_raw<THREADS, DM, CP, DM, false>(raw + i * RAW_BYTES, db, tile_row(i),
                                       n, d);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  if (n_tiles > 0) widen<THREADS, DM, DM>(raw, bf);
  if (STAGES - 1 < n_tiles)
    load_raw<THREADS, DM, CP, DM, false>(raw + (STAGES - 1) * RAW_BYTES, db,
                                  tile_row(STAGES - 1), n, d);
  cp_async_commit();

  float mx[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) mx[mt][0] = mx[mt][1] = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // raw tile t + 1 has landed
    __syncthreads();              // bf tile t widened; tile t - 1 consumed
    if (t + 1 < n_tiles)
      widen<THREADS, DM, DM>(raw + ((t + 1) % STAGES) * RAW_BYTES,
                             bf + ((t + 1) & 1) * BF_ELEMS);
    if (t + STAGES < n_tiles)
      load_raw<THREADS, DM, CP, DM, false>(raw + (t % STAGES) * RAW_BYTES, db,
                                    tile_row(t + STAGES), n, d);
    cp_async_commit();

    const uint32_t tile = smem_addr(bf + (t & 1) * BF_ELEMS);
#pragma unroll
    for (int nt = 0; nt < TILE_ROWS / 8; nt += 2) {
      float acc[MT][2][4];
      tile_mma<MT, 2, DM>(a, tile, nt, acc);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mx[mt][0] = fmaxf(mx[mt][0], fmaxf(acc[mt][j][0], acc[mt][j][1]));
          mx[mt][1] = fmaxf(mx[mt][1], fmaxf(acc[mt][j][2], acc[mt][j][3]));
        }
    }
    if (t % tpb == tpb - 1) {  // the block's last tile
      const int b = blockIdx.x + (t / tpb) * gridDim.x;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = mx[mt][h];
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
          const int qi = q0 + 16 * mt + (lane >> 2) + 8 * h;
          if ((lane & 3) == 0 && qi < bq) out[(size_t)qi * n_blocks + b] = m;
          mx[mt][h] = -INFINITY;
        }
    }
  }
  cp_async_wait<0>();
}

// The launch's shape: the CTAs one SM holds, the grid (x: one wave of
// resident CTAs over the blocks; y: query blocks) and the registers.
struct Plan {
  int per_sm;
  dim3 grid;
  int regs;
};

template <int DM, int CP>
cudaError_t plan_launch(int bq, int n, int blk, Plan* p) {
  constexpr size_t SMEM = Cfg<DM>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      block_max_kernel<DM, CP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &p->per_sm, block_max_kernel<DM, CP>, THREADS, SMEM);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, block_max_kernel<DM, CP>);
  if (err != cudaSuccess) return err;
  p->regs = attr.numRegs;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int qblocks = (bq + Cfg<DM>::QPB - 1) / Cfg<DM>::QPB;
  p->grid = dim3(std::max(1, std::min(n / blk, p->per_sm * sms / qblocks)),
                 qblocks);
  return cudaSuccess;
}

template <int DM, int CP>
cudaError_t launch(const float* q, const int8_t* vecs8, int bq, int n,
                   int d, int blk, float* out, cudaStream_t s) {
  Plan p;
  const cudaError_t err = plan_launch<DM, CP>(bq, n, blk, &p);
  if (err != cudaSuccess) return err;
  block_max_kernel<DM, CP><<<p.grid, THREADS, Cfg<DM>::SMEM, s>>>(
      q, vecs8, bq, n, d, blk, out);
  return cudaGetLastError();
}

bool bad_args(int bq, int n, int d, int blk) {
  return bq <= 0 || blk <= 0 || blk % TILE_ROWS || n % blk || d <= 0 ||
         d % 4 || d > MAX_D;
}

}  // namespace

// q (bq, d) f32, vecs8 (n, d) int8, out (bq, n / blk) f32; blk a multiple of
// 64 that divides n; d a multiple of 4, at most MAX_D.
extern "C" int nafp_bench_dotonly(const float* q, const int8_t* vecs8,
                                  int bq, int n, int d, int blk, float* out,
                                  void* stream) {
  if (bad_args(bq, n, d, blk)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  return (int)with_shape<16, 4>(d, d % 16 == 0, [&](auto sh) {
    using S = decltype(sh);
    return launch<S::DM, S::CP>(q, vecs8, bq, n, d, blk, out, s);
  });
}

// The launch nafp_bench_dotonly makes for these arguments: info[0] shared
// memory per CTA in bytes, info[1] resident CTAs per SM, info[2] registers
// per thread, info[3] CTAs in the grid.
extern "C" int nafp_bench_dotonly_occupancy(int bq, int n, int d, int blk,
                                            int* info) {
  if (bad_args(bq, n, d, blk)) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = with_shape<16, 4>(d, d % 16 == 0, [&](auto sh) {
    using S = decltype(sh);
    return plan_launch<S::DM, S::CP>(bq, n, blk, &p);
  });
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)(d <= 128 ? Cfg<128>::SMEM : Cfg<MAX_D>::SMEM);
  info[1] = p.per_sm;
  info[2] = p.regs;
  info[3] = p.grid.x * p.grid.y;
  return 0;
}
