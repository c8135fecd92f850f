// Kernel B2: exact top-k over an int8 store with per-row scales and an
// additive row mask (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel topk_ip_sq8_pallas (nafp_tpu/search/
// pallas_topk.py, _kernel_sq8 with the shared _merge_tile / _finish_sort),
// which SQ8FlatIndex uses for `-i sq8` and `-i sq8-flat`.
//
// Numerics kept from the TPU: q is rounded to bf16, each int8 row converts
// exactly, the products accumulate in f32, the sum is multiplied by the
// row's scale and then the mask (0, or NEG on pad rows and tombstones) is
// added.
//
// Bound on an H100 at the main path's shape (Bq 1024, N 620,544, d 128):
// 162.7 GFLOP; on the bf16 tensor cores (989 TFLOP/s) about 0.164 ms, and
// the 84 MB of int8 rows, scales and mask take 0.025 ms at 3.35 TB/s. This
// kernel does the products as f32 FMAs on the CUDA cores (67 TFLOP/s,
// about 2.4 ms at best), so it sits far below that bound: moving the
// products to wgmma on bf16 (exact for bf16 x int8) is the next step.
// Design: topk_common.cuh.
#include "topk_common.cuh"

extern "C" int nafp_topk_sq8(const float* q, const int8_t* vecs8,
                             const float* scales, const float* rmask, int bq,
                             int n, int d, int k, int chunk_rows, int n_chunks,
                             float* part_v, int* part_i, float* out_v,
                             int* out_i, void* stream) {
  return nafp::launch_topk<nafp::Mode::SQ8>(
      q, vecs8, nafp::RowInputs{scales, rmask, nullptr, nullptr, 0}, bq, n, d,
      k, chunk_rows, n_chunks, part_v, part_i, out_v, out_i,
      static_cast<cudaStream_t>(stream));
}
