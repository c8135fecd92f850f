// Kernel B4a: kernel B2's function (exact top-k over an int8 store with
// per-row scales and an additive row mask) with the micro-bench's switches
// (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel run_variant (extras/bench_sq8_kernel.py, body
// _kern_var, v2 merge _merge_tile_v2), which the sq8 kernel micro-bench
// times beside the shipped B2. Its switches, here compile-time template
// arguments of the shared scan (topk_common.cuh):
//   - drain (merge_mode "v2"): Select::DRAIN, the reference's filter-then-
//     drain merge with each argmax / argmin step a warp shuffle, one warp
//     per query; otherwise ("v0", "v3": the shipped _merge_tile) B2's
//     sorted insertion, Select::INSERT;
//   - int8_dot: Mode::SQ8_I8, int8 queries (quantised per row by the
//     wrapper, which also applies the per-query scale afterwards, as the
//     reference does outside its kernel) times int8 rows with __dp4a into
//     s32; otherwise Mode::SQ8, B2's bf16-rounded q times int8 rows in f32.
// The reference's scale_mode (a Mosaic layout choice) has no counterpart:
// a per-row scale costs one multiply per score either way.
//
// Bound on an H100 at the bench's shape (Bq 512, N 8,388,608, d 128): 1.1
// TFLOP, about 1.11 ms on the bf16 tensor cores (989 TFLOP/s) and 0.56 ms
// for the int8 variant (1,979 TOP/s), against 1.14 GB of rows, scales and
// mask, 0.34 ms at 3.35 TB/s: bound by operations. This kernel does the
// products on the CUDA cores (f32 FMAs, or __dp4a at four int8 products per
// instruction) and so sits far above that bound; the tensor cores (wgmma,
// or IMMA for int8) and a parallel insertion are later work (ROADMAP
// Queue 2).
#include "topk_common.cuh"

namespace {

template <nafp::Mode MODE>
int launch_variant(int drain, const void* q, const int8_t* vecs8,
                   nafp::RowInputs rin, int bq, int n, int d, int k,
                   int chunk_rows, int n_chunks, float* part_v, int* part_i,
                   float* out_v, int* out_i, cudaStream_t stream) {
  if (drain)
    return nafp::launch_topk<MODE, nafp::Select::DRAIN>(
        q, vecs8, rin, bq, n, d, k, chunk_rows, n_chunks, part_v, part_i,
        out_v, out_i, stream);
  return nafp::launch_topk<MODE, nafp::Select::INSERT>(
      q, vecs8, rin, bq, n, d, k, chunk_rows, n_chunks, part_v, part_i,
      out_v, out_i, stream);
}

}  // namespace

// q: (bq, d) f32, or int8 when int8_dot (d a multiple of 16).
extern "C" int nafp_bench_variant(const void* q, const int8_t* vecs8,
                                  const float* scales, const float* rmask,
                                  int bq, int n, int d, int k, int int8_dot,
                                  int drain, int chunk_rows, int n_chunks,
                                  float* part_v, int* part_i, float* out_v,
                                  int* out_i, void* stream) {
  const nafp::RowInputs rin{scales, rmask};
  const auto s = static_cast<cudaStream_t>(stream);
  if (int8_dot) {
    if (d % 16) return (int)cudaErrorInvalidValue;
    return launch_variant<nafp::Mode::SQ8_I8>(drain, q, vecs8, rin, bq, n, d,
                                              k, chunk_rows, n_chunks, part_v,
                                              part_i, out_v, out_i, s);
  }
  return launch_variant<nafp::Mode::SQ8>(drain, q, vecs8, rin, bq, n, d, k,
                                         chunk_rows, n_chunks, part_v, part_i,
                                         out_v, out_i, s);
}
