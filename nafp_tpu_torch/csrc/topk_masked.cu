// Kernel B3: top-k of q . DB^T over a decoded IVF-PQ chunk with per-row ids
// and a per-(query, subtile) additive bias (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel topk_ip_pallas_masked (nafp_tpu/search/
// pallas_topk.py, _kernel_masked -> _kernel_body with the bias expansion,
// _merge_tile / _finish_sort), which IVFPQIndex.search calls once per
// (DB chunk, query block) for `-i ivfpq` and `-i ivfpq-rr`.
//
// Numerics kept from the TPU: q is rounded to bf16, the bf16 rows convert
// exactly, the products accumulate in f32; then the row mask (NEG where
// ids[row] < 0) and the bias of the row's list_tile subtile (the IVF probe
// mask, 0 or NEG) are added. Positions come back; the wrapper maps them
// through the ids, as the JAX function does outside its pallas_call.
//
// Bound on an H100 at the main path's shape (Bq 512, N ~636k padded rows,
// d 128, 40 of 256 lists probed): the function needs products only for the
// valid rows of probed subtiles, about 16 % of the (query, row) pairs or
// ~13 GFLOP (~0.013 ms on the bf16 tensor cores at 989 TFLOP/s), while it
// reads ~163 MB of bf16 rows plus ~10 MB of bias and ids, about 0.05 ms at
// 3.35 TB/s: bytes bound. This kernel does the products as f32 FMAs on the
// CUDA cores (67 TFLOP/s, about 1.2 ms at best) over every row, probed or
// not, so it sits far above that bound; wgmma products, skipping unprobed
// tiles and fusing the PQ decode into the scan are the next steps. Design:
// topk_common.cuh.
#include "topk_common.cuh"

extern "C" int nafp_topk_masked(const float* q, const void* db_bf16,
                                const int* ids, const float* bias, int bq,
                                int n, int d, int k, int list_tile,
                                int chunk_rows, int n_chunks, float* part_v,
                                int* part_i, float* out_v, int* out_i,
                                void* stream) {
  if (list_tile <= 0 || list_tile % nafp::RB || n % list_tile ||
      chunk_rows % nafp::RB)
    return (int)cudaErrorInvalidValue;
  const nafp::RowInputs rin{nullptr, nullptr, ids, bias, list_tile};
  return nafp::launch_topk<nafp::Mode::MASKED>(
      q, db_bf16, rin, bq, n, d, k, chunk_rows, n_chunks, part_v, part_i,
      out_v, out_i, static_cast<cudaStream_t>(stream));
}
