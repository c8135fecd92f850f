// The ICASSP protocol's sequence re-rank of a query block, in one launch
// (search/evaluate.py hits_for_block; hand-written for Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the re-rank
// (nafp_tpu/search/evaluate.py, _score_candidates and jax.lax.top_k) to
// XLA, which fuses it. Eager PyTorch ran it as ~40 launches and three host
// waits a block, and gathered every candidate window into device memory:
// (128, 380, 19, 128) f32, 473 MB, at 128 clips of 19 segments and 20 hits
// a segment, for inputs of 1.4 MB.
//
// The function, for clip b of the block (hits (B, sl, kp) int32, -1 = no
// hit; n_seg (B,) int32; q (B, sl, d) f32 with rows past n_seg zero; the DB
// rows recon (N, d) f32):
//   candidate starts hits[b, j, i] - j, or -1 where the hit is negative or
//   j >= n_seg[b]; a start is invalid if it is negative, if start + n_seg[b]
//   > N, or if it repeats another start; a valid start's score is the f32
//   sum over j < n_seg[b] of q[b, j] · recon[start + j], over n_seg[b]; the
//   answer is the k_out best valid starts, best first, equal scores to the
//   lower start (the plain version sorts the starts and breaks ties by the
//   lower sorted slot, jax.lax.top_k's order: the same thing), -999999 where
//   no valid start is left.
//
// Bound on an H100: bytes. The least traffic reads the DB rows that the
// valid windows touch once each, and the inputs, at 3.35 TB/s; the product
// is 2·d FLOPs a 4·d-byte row, far below the FP32 units' rate.
//
// Design. One CTA of 512 threads a clip (a block of at most 128 clips is
// one wave on 132 SMs). The CTA writes the clip's sl·kp starts, padded
// with -1 to a power of two P, into shared memory (into the wrapper's
// scratch, B·P int32, when P > SMEM_KEYS), sorts them by a bitonic sort and
// so finds the repeats. Each warp then takes every 16th sorted slot; a
// valid start's window rows are read in place from recon, never gathered:
// a lane takes a 16-byte vector (4 f32) of each row, so a row is one 512-B
// coalesced load at d 128, with UNROLL rows in flight a lane; q's rows come
// through L1. Overlapping windows of one song meet in L2. A warp sums a
// score by shuffles and keeps its own best k_out in its lanes, sorted; the
// CTA merges the 16 lists by rank (each entry counts the entries that beat
// it) and writes the answer. No atomics: the answer does not depend on
// which warp took which slot, and two runs agree bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "limits.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int K_MAX = 32;           // answers a clip: a warp's lanes
constexpr int SMEM_KEYS = 8192;     // sorted starts a CTA keeps in shared memory
constexpr int UNROLL = 8;           // window rows a lane has in flight
constexpr int NO_PICK = -999999;
constexpr unsigned FULL = 0xffffffffu;

// q_row · w_row over d = dv·VEC columns for `rows` rows, this lane's share
// (vectors lane, lane + 32, ...), accumulated in f32.
template <int VEC>
__device__ __forceinline__ float window_dot(const float* __restrict__ q,
                                            const float* __restrict__ w,
                                            int rows, int d, int lane) {
  float acc = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    for (int j0 = 0; j0 < rows; j0 += UNROLL) {
      if constexpr (VEC == 4) {
        float4 r[UNROLL], a[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (j0 + u < rows) {
            r[u] = *reinterpret_cast<const float4*>(w + (size_t)(j0 + u) * d
                                                    + c);
            a[u] = *reinterpret_cast<const float4*>(q + (size_t)(j0 + u) * d
                                                    + c);
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (j0 + u < rows) {
            acc = fmaf(a[u].x, r[u].x, acc);
            acc = fmaf(a[u].y, r[u].y, acc);
            acc = fmaf(a[u].z, r[u].z, acc);
            acc = fmaf(a[u].w, r[u].w, acc);
          }
        }
      } else {
        float r[UNROLL], a[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (j0 + u < rows) {
            r[u] = w[(size_t)(j0 + u) * d + c];
            a[u] = q[(size_t)(j0 + u) * d + c];
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (j0 + u < rows) acc = fmaf(a[u], r[u], acc);
        }
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
  return acc;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    rerank_kernel(const float* __restrict__ q, const int* __restrict__ hits,
                  const int* __restrict__ n_seg,
                  const float* __restrict__ recon, int sl, int d, int kp,
                  int n, int k_out, int p2, int* scratch, int* out) {
  extern __shared__ int smem_keys[];
  __shared__ float top_v[WARPS * K_MAX];
  __shared__ int top_i[WARPS * K_MAX];
  __shared__ int answer[K_MAX];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* keys = scratch ? scratch + (size_t)b * p2 : smem_keys;
  const int ns = n_seg[b];
  const int rows = min(ns, sl);       // window rows with a query row
  const int c = sl * kp;

  // candidate starts, -1 for none, padded with -1 to P
  const int* h = hits + (size_t)b * c;
  for (int i = tid; i < p2; i += THREADS) {
    int key = -1;
    if (i < c) {
      const int j = i / kp;
      const int hit = h[i];
      if (hit >= 0 && j < ns) key = hit - j;
    }
    keys[i] = key;
  }
  if (tid < K_MAX) answer[tid] = NO_PICK;
  __syncthreads();

  // bitonic sort, ascending
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < p2; i += THREADS) {
        const int partner = i ^ stride;
        if (partner > i) {
          const int x = keys[i], y = keys[partner];
          if ((x > y) == ((i & size) == 0)) {
            keys[i] = y;
            keys[partner] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // scores: a warp a slot; lanes < k_out hold the warp's best, best first
  float best_v = -INFINITY;
  int best_i = nafp::NO_ROW;
  const float* qb = q + (size_t)b * sl * d;
  for (int s = warp; s < p2; s += WARPS) {
    const int key = keys[s];
    if (key < 0 || (long long)key + ns > n || (s > 0 && keys[s - 1] == key))
      continue;                       // the same for every lane of the warp
    const float dot =
        window_dot<VEC>(qb, recon + (size_t)key * d, rows, d, lane);
    const float score = __fdiv_rn(dot, (float)ns);
    const unsigned beaten = __ballot_sync(
        FULL, lane < k_out && nafp::better(score, key, best_v, best_i));
    if (beaten) {                     // the beaten lanes are a suffix
      const int pos = __ffs((int)beaten) - 1;
      const float up_v = __shfl_up_sync(FULL, best_v, 1);
      const int up_i = __shfl_up_sync(FULL, best_i, 1);
      if (lane > pos) {
        best_v = up_v;
        best_i = up_i;
      } else if (lane == pos) {
        best_v = score;
        best_i = key;
      }
    }
  }
  if (lane < K_MAX) {
    top_v[warp * K_MAX + lane] = best_v;
    top_i[warp * K_MAX + lane] = best_i;
  }
  __syncthreads();

  // merge by rank: the valid entries have distinct starts, so their ranks
  // are distinct; an empty entry (-inf) beats none and is never written
  {
    const int w = tid / k_out, r = tid % k_out;
    if (w < WARPS && top_i[w * K_MAX + r] != nafp::NO_ROW) {
      const float v = top_v[w * K_MAX + r];
      const int i = top_i[w * K_MAX + r];
      int rank = 0;
      for (int u = 0; u < WARPS; ++u) {
        for (int t = 0; t < k_out; ++t) {
          rank += nafp::better(top_v[u * K_MAX + t], top_i[u * K_MAX + t], v,
                               i);
        }
      }
      if (rank < k_out) answer[rank] = i;
    }
  }
  __syncthreads();
  if (tid < k_out) out[(size_t)b * k_out + tid] = answer[tid];
}

}  // namespace

// The (b, k_out) answers `out` (int32) of a block of b clips: q (b, sl, d)
// f32, rows past n_seg zero; hits (b, sl, kp) int32; n_seg (b,) int32;
// recon (n, d) f32; p2 the power of two >= sl·kp, and scratch (b·p2 int32)
// when p2 > SMEM_KEYS, else null; vec 4 (d % 4 == 0, q and recon 16-byte
// aligned) or 1. Returns a CUDA error code, 0 on success.
extern "C" int nafp_rerank_f32(const float* q, const int* hits,
                               const int* n_seg, const float* recon, int b,
                               int sl, int d, int kp, int n, int k_out,
                               int p2, int vec, int* scratch, int* out,
                               void* stream) {
  const long long c = (long long)sl * kp;
  if (b < 1 || sl < 1 || d < 1 || kp < 1 || n < 1 || k_out < 1 ||
      k_out > K_MAX || k_out > c || p2 < c || (p2 & (p2 - 1)) ||
      (p2 > SMEM_KEYS) != (scratch != nullptr) ||
      !(vec == 1 || (vec == 4 && d % 4 == 0)))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = scratch ? 0 : (size_t)p2 * sizeof(int);
  if (vec == 4) {
    rerank_kernel<4><<<b, THREADS, smem, s>>>(q, hits, n_seg, recon, sl, d,
                                               kp, n, k_out, p2, scratch, out);
  } else {
    rerank_kernel<1><<<b, THREADS, smem, s>>>(q, hits, n_seg, recon, sl, d,
                                               kp, n, k_out, p2, scratch, out);
  }
  return (int)cudaGetLastError();
}
