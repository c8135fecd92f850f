// Kernel B4a: kernel B2's function (exact top-k over an int8 store with
// per-row scales and an additive row mask) with the micro-bench's switches
// (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel run_variant (extras/bench_sq8_kernel.py, body
// _kern_var, v2 merge _merge_tile_v2), which the sq8 kernel micro-bench
// times beside the shipped B2. Its switches are the template switches of
// the sq8 scan (sq8_scan.cuh), so every variant is B2's design:
//   - drain (merge_mode "v2"): Sel::DRAIN, the reference's filter-then-
//     drain merge, one warp per query, each argmax / argmin step a warp
//     shuffle; otherwise ("v0", "v3": the shipped _merge_tile) B2's warp
//     merge, Sel::MERGE, so "v3" runs B2's own instance;
//   - int8_dot: Prod::I8, int8 queries (quantised per row by the wrapper,
//     which also applies the per-query scale afterwards, as the reference
//     does outside its kernel) times the int8 rows on the s8 tensor cores
//     (mma.sync.m16n8k32, exact s32 sums, no widen); otherwise Prod::BF16,
//     B2's bf16-rounded q times the widened rows.
// Both selections keep the per-query bound the chunk CTAs share. The
// reference's scale_mode (a Mosaic layout choice) has no counterpart: a
// per-row scale costs one multiply per score either way.
//
// Bound on an H100 at the bench's shape (Bq 512, N 8,388,608, d 128): 1.1
// TFLOP, about 1.11 ms on the bf16 tensor cores (989 TFLOP/s) and 0.56 ms
// for the int8 variant (1,979 TOP/s), against 1.14 GB of rows, scales and
// mask, 0.34 ms at 3.35 TB/s: bound by operations. What holds the scan
// above it: sq8_scan.cuh.
#include "sq8_scan.cuh"

using nafp::sq8::Prod;
using nafp::sq8::Sel;

// q: (bq, d) f32, or int8 when int8_dot (d a multiple of 16); the other
// arguments as nafp_topk_sq8's.
extern "C" int nafp_bench_variant(const void* q, const int8_t* vecs8,
                                  const float* scales, const float* rmask,
                                  int bq, int n, int d, int k, int int8_dot,
                                  int drain, int chunk_rows, int n_chunks,
                                  float* bound, float* part_v, int* part_i,
                                  float* out_v, int* out_i, void* stream) {
  using nafp::sq8::run;
  if (int8_dot)
    return (drain ? run<Prod::I8, Sel::DRAIN> : run<Prod::I8, Sel::MERGE>)(
        q, vecs8, scales, rmask, bq, n, d, k, chunk_rows, n_chunks, bound,
        part_v, part_i, out_v, out_i, stream);
  return (drain ? run<Prod::BF16, Sel::DRAIN> : run<Prod::BF16, Sel::MERGE>)(
      q, vecs8, scales, rmask, bq, n, d, k, chunk_rows, n_chunks, bound,
      part_v, part_i, out_v, out_i, stream);
}

// The residency of the instance nafp_bench_variant launches for these
// arguments: info as nafp_topk_sq8_occupancy.
extern "C" int nafp_bench_variant_occupancy(int d, int k, int int8_dot,
                                            int drain, int* info) {
  using nafp::sq8::occupancy;
  if (int8_dot)
    return (drain ? occupancy<Prod::I8, Sel::DRAIN>
                  : occupancy<Prod::I8, Sel::MERGE>)(d, k, info);
  return (drain ? occupancy<Prod::BF16, Sel::DRAIN>
                : occupancy<Prod::BF16, Sel::MERGE>)(d, k, info);
}
