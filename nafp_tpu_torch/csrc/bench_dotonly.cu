// Kernel B4b: the streaming floor of kernel B2, its products with no
// selection (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel run_dotonly (extras/bench_sq8_kernel.py, body
// _kern_dotonly): bf16(q) . bf16(row) for every query and int8 row, then a
// row max. The TPU kernel writes each grid step's (Bq, 1) maximum over the
// same output block, so it returns the maximum of the LAST blk-row block
// only. Here every block's maximum is kept, (Bq, N / blk), so that no
// product is dead code the compiler could drop; the wrapper returns the
// last column, the reference's result.
//
// It stages q and the int8 tiles and runs the product loop of the shared
// scan (topk_common.cuh: stage_queries, stage_rows, tile_products, the
// code B2 runs). B2's time less this kernel's is then what B2's threshold
// compare, selection and merge cost, together with what else differs: B2
// stages scales and mask, keeps its k-lists and candidates in shared memory
// (so fewer of its CTAs fit on an SM at large k) and runs a chunked grid.
// smem_min reserves more shared memory per CTA, to run this floor at B2's
// residency. A CTA holds QB queries and walks whole blk-row blocks
// (grid-stride over the blocks); each warp covers all RB rows of a tile for
// its QPT queries, so a block's maximum is a per-thread max followed by one
// warp shuffle reduction. The grid is one wave of resident CTAs.
//
// Bound on an H100 at the bench's shape (Bq 512, N 8,388,608, d 128): 1.1
// TFLOP, about 1.11 ms on the bf16 tensor cores (989 TFLOP/s), against
// 1.07 GB of rows read and 8.4 MB of maxima written, 0.32 ms at 3.35 TB/s:
// bound by operations. The products here are f32 FMAs on the CUDA cores
// (67 TFLOP/s, at best about 16 ms), as in B2; wgmma is later work.
#include <algorithm>

#include "topk_common.cuh"

namespace {

using nafp::Mode;
using nafp::QB;
using nafp::QPT;
using nafp::RB;
using nafp::THREADS;

__global__ void __launch_bounds__(THREADS)
block_max_kernel(const float* __restrict__ q, const int8_t* __restrict__ db,
                 int bq, int n, int d, int blk, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = d + 4;  // the scan's row stride (topk_common.cuh)
  float* qs = reinterpret_cast<float*>(smem);  // [QB][dp]
  float* ds = qs + QB * dp;                    // [RB][dp]
  const int tid = threadIdx.x;
  const int tr = tid & 31, tq = tid >> 5;
  const int q0 = blockIdx.y * QB;
  const int n_blocks = n / blk;
  const float* qp = qs + tq * QPT * dp;
  const float* dp0 = ds + tr * dp;
  const float* dp1 = ds + (tr + 32) * dp;

  nafp::stage_queries<Mode::SQ8>(q, q0, bq, d, qs);
  __syncthreads();
  for (int b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    float mx[QPT];
#pragma unroll
    for (int i = 0; i < QPT; ++i) mx[i] = -INFINITY;
    const int end = (b + 1) * blk;
    for (int t0 = b * blk; t0 < end; t0 += RB) {
      nafp::stage_rows<Mode::SQ8>(db, t0, end, d, ds);
      __syncthreads();
      float acc[QPT][2];
      nafp::tile_products<Mode::SQ8>(qp, dp0, dp1, d, dp, acc);
#pragma unroll
      for (int i = 0; i < QPT; ++i)
        mx[i] = fmaxf(mx[i], fmaxf(acc[i][0], acc[i][1]));
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < QPT; ++i)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o));
    if (tr == 0) {
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const int qi = q0 + tq * QPT + i;
        if (qi < bq) out[(size_t)qi * n_blocks + b] = mx[i];
      }
    }
  }
}

// The launch's shape: dynamic shared memory (the staged q and row tiles, or
// smem_min bytes if more: a larger reservation runs the same work at another
// kernel's residency), the CTAs one SM holds, and the grid's x extent, one
// wave of resident CTAs.
struct Plan {
  size_t smem;
  int per_sm;
  int gx;
};

cudaError_t plan_launch(int bq, int n, int d, int blk, int smem_min,
                        Plan* p) {
  p->smem = std::max(sizeof(float) * (size_t)(QB + RB) * (d + 4),
                     (size_t)std::max(smem_min, 0));
  cudaError_t err = cudaFuncSetAttribute(
      block_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p->smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &p->per_sm, block_max_kernel, THREADS, p->smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int qblocks = (bq + QB - 1) / QB;
  p->gx = std::max(1, std::min(n / blk, p->per_sm * sms / qblocks));
  return cudaSuccess;
}

bool bad_args(int bq, int n, int d, int blk) {
  return bq <= 0 || blk <= 0 || blk % RB || n % blk || d % 4 ||
         d > nafp::MAX_D;
}

}  // namespace

// q (bq, d) f32, vecs8 (n, d) int8, out (bq, n / blk) f32; blk a multiple of
// RB that divides n; smem_min: shared memory to reserve per CTA (0: what the
// kernel stages).
extern "C" int nafp_bench_dotonly(const float* q, const int8_t* vecs8,
                                  int bq, int n, int d, int blk, int smem_min,
                                  float* out, void* stream) {
  if (bad_args(bq, n, d, blk)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  Plan p;
  const cudaError_t err = plan_launch(bq, n, d, blk, smem_min, &p);
  if (err != cudaSuccess) return (int)err;
  block_max_kernel<<<dim3(p.gx, (bq + QB - 1) / QB), THREADS, p.smem,
                     static_cast<cudaStream_t>(stream)>>>(q, vecs8, bq, n, d,
                                                          blk, out);
  return (int)cudaGetLastError();
}

// The launch nafp_bench_dotonly makes for these arguments: info[0] shared
// memory per CTA in bytes, info[1] resident CTAs per SM, info[2] registers
// per thread, info[3] CTAs in the grid.
extern "C" int nafp_bench_dotonly_occupancy(int bq, int n, int d, int blk,
                                            int smem_min, int* info) {
  if (bad_args(bq, n, d, blk)) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan_launch(bq, n, d, blk, smem_min, &p);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, block_max_kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = (int)p.smem;
  info[1] = p.per_sm;
  info[2] = attr.numRegs;
  info[3] = p.gx * ((bq + QB - 1) / QB);
  return 0;
}
