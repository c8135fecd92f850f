// Kernel B1: exact f32 top-k of q . DB^T (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel topk_ip_pallas (nafp_tpu/search/pallas_topk.py,
// _kernel_plain -> _kernel_body with _merge_tile / _finish_sort), which
// FlatIndex uses for `-i l2`, `-i ip` and `-i ivf` at >= 50k rows.
//
// Bound on an H100 at the main path's shape (Bq 512, N 619,500, d 128):
// 81.2 GFLOP of f32 FMA against 67 TFLOP/s, about 1.21 ms; the DB's 317 MB
// alone take 0.095 ms at 3.35 TB/s, so the kernel is compute-bound. The
// products are f32 FMAs on the CUDA cores (no TF32), so the tensor cores
// cannot help without changing the numerics. Design and what it leaves on
// the table: topk_common.cuh.
#include "topk_common.cuh"

extern "C" int nafp_topk_f32(const float* q, const float* db, int bq, int n,
                             int d, int k, int chunk_rows, int n_chunks,
                             float* part_v, int* part_i, float* out_v,
                             int* out_i, void* stream) {
  return nafp::launch_topk<nafp::Mode::F32>(
      q, db, nafp::RowInputs{}, bq, n, d, k, chunk_rows, n_chunks, part_v,
      part_i, out_v, out_i, static_cast<cudaStream_t>(stream));
}
