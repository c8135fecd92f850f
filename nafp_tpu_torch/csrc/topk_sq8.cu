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
// The sq8 scan of sq8_scan.cuh with bf16 products on the tensor cores
// (Prod::BF16: int8 tiles widened once per CTA) and the warp merge with the
// shared admission bound (Sel::MERGE). Bound on an H100 at the main path's
// shape (Bq 1024, N 620,544, d 128): 162.7 GFLOP, about 0.164 ms at 989
// TFLOP/s; the 84 MB of int8 rows, scales and mask take 0.025 ms at 3.35
// TB/s. What holds the kernel above it, and what its design does about
// that: sq8_scan.cuh.
#include "sq8_scan.cuh"

using nafp::sq8::Prod;
using nafp::sq8::Sel;

// q (bq, d) f32; vecs8 (n, d) int8; scales, rmask (n,) f32; bound (bq,)
// f32, every entry NEG on entry (the shared admission bound, raised by the
// scan); part_v/part_i (bq, n_chunks, k) scratch; out_v/out_i (bq, k). d a
// multiple of 4, at most MAX_D; chunk_rows a multiple of 64.
extern "C" int nafp_topk_sq8(const float* q, const int8_t* vecs8,
                             const float* scales, const float* rmask, int bq,
                             int n, int d, int k, int chunk_rows,
                             int n_chunks, float* bound, float* part_v,
                             int* part_i, float* out_v, int* out_i,
                             void* stream) {
  return nafp::sq8::run<Prod::BF16, Sel::MERGE>(
      q, vecs8, scales, rmask, bq, n, d, k, chunk_rows, n_chunks, bound,
      part_v, part_i, out_v, out_i, stream);
}

// The scan's shared memory per CTA, resident CTAs per SM and registers per
// thread at (d, k), into info[0..2] (nafp::sq8::occupancy).
extern "C" int nafp_topk_sq8_occupancy(int d, int k, int* info) {
  return nafp::sq8::occupancy<Prod::BF16, Sel::MERGE>(d, k, info);
}
