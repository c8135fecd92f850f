// LAMB's update of f32 parameters as one multi-tensor kernel pair
// (optim/lamb.py; hand-written for Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves LAMB (nafp_tpu/optim/
// lamb.py, lamb) to XLA, which fuses each leaf's update into a few loops.
// Eager PyTorch runs it as a Python loop over the leaves, ~30 small kernels
// a leaf: ~2,200 launches and ~16 ms of host time a 640_lamb step (68
// leaves). Here a step takes two launches for up to MAX_LEAVES leaves.
//
// The update of one leaf at its step t (TF-Addons semantics):
//   m = b1·m + (1 - b1)·g;   v = b2·v + (1 - b2)·g·g;
//   u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)  [+ wd·p if wd != 0];
//   ratio = ||p|| / ||u|| where both are > 0, else 1 (1 for a leaf without
//   layer adaptation);  p = p + (-lr·ratio)·u.
// Each operation rounds once in f32 (the _rn intrinsics: nothing is
// contracted into an FMA), in the plain version's order; the caller passes
// 1 - b1, 1 - b2 and the bias corrections computed in double, as the plain
// version's Python scalars are.
//
// Bound on an H100: bytes. The least traffic reads p, g, m and v and writes
// p, m and v once: 28 B a parameter, 474 MB a 640_lamb step (16,939,008
// parameters), 0.142 ms at 3.35 TB/s. The trust ratio needs ||u|| over the
// whole leaf before the leaf's first parameter is written, so the update
// takes two passes, and this design moves 40 B a parameter:
//   lamb_moments_kernel reads p, g, m and v, writes m and v, and each CTA's
//     partial sums of p·p and u·u (24 B);
//   lamb_apply_kernel reads p, m and v again, recomputes u from them by the
//     same instructions (so bit for bit the first pass's u), and writes p
//     (16 B).
// Writing u to a scratch buffer in the first pass and reading it back
// moves as many bytes (28 + 12) and needs 4 B a parameter of scratch; this
// design chose the recompute.
//
// Design. One CTA per chunk of CHUNK = 4,096 elements of a leaf (256
// threads, 16-byte loads, the four tensors' UNROLL = 4 vectors a thread
// loaded before any is used), so leaves of 128 to 3,145,728 elements share
// one grid: 4,156 CTAs at 640_lamb. The leaf table (pointers, sizes, chunk
// offsets, wd and the adaptation flag of up to MAX_LEAVES leaves) is a
// by-value kernel argument read in place (__grid_constant__), under the 4 KB
// a launch's arguments may hold: nothing is uploaded and nothing waits. A
// CTA finds its leaf by a binary search of the chunk offsets. A leaf whose
// four pointers are not 16-byte aligned, or the last elements of one whose
// size is not a multiple of 4, go one element a thread.
// No float atomics: a CTA's partial sums are reduced in a fixed order (each
// thread's elements in order, warp shuffles, then the warps in order), and
// in the second pass every CTA of a leaf sums that leaf's partials in one
// fixed order, so all of them derive the same ratio, and two runs agree bit
// for bit: every rank of a process group ends a step with the same
// parameters. The caller groups the leaves that share lr, betas, eps and
// step into launches (optim/lamb.py launch_plan) and allocates the partials.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int VEC = 4;          // f32 a 16-byte load
constexpr int UNROLL = 4;       // vectors a thread takes per tensor
constexpr int CHUNK = THREADS * VEC * UNROLL;   // elements a CTA
constexpr int MAX_LEAVES = 80;
constexpr unsigned FULL = 0xffffffffu;

struct Leaves {
  float* p[MAX_LEAVES];
  const float* g[MAX_LEAVES];
  float* m[MAX_LEAVES];
  float* v[MAX_LEAVES];
  int n[MAX_LEAVES];
  int chunk0[MAX_LEAVES + 1];   // leaf i's CTAs: [chunk0[i], chunk0[i + 1])
  float wd[MAX_LEAVES];
  unsigned char adapt[MAX_LEAVES];
  int count;
};

struct Scalars {
  float lr, b1, c1, b2, c2;     // c1 = 1 - b1, c2 = 1 - b2
  float bc1, bc2, eps;          // 1 - b1^t, 1 - b2^t
};

// a launch's arguments: the table, the scalars and the partials' pointer
static_assert(sizeof(Leaves) + sizeof(Scalars) + sizeof(float*) <= 4096,
              "kernel arguments over 4 KB");

__device__ __forceinline__ int find_leaf(const Leaves& t, int b) {
  int lo = 0, hi = t.count - 1;   // t.chunk0[lo] <= b < t.chunk0[hi + 1]
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk0[mid] <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ void moments(float g, float& m, float& v,
                                        const Scalars& s) {
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(s.c1, g));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(s.c2, g), g));
}

__device__ __forceinline__ float update(float p, float m, float v, float wd,
                                        const Scalars& s) {
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.eps));
  if (wd != 0.f) u = __fadd_rn(u, __fmul_rn(wd, p));
  return u;
}

// vector i of VEC f32 at a (16-byte aligned), and back
__device__ __forceinline__ void ld4(const float* __restrict__ a, int i,
                                    float (&f)[VEC]) {
  const float4 q = reinterpret_cast<const float4*>(a)[i];
  f[0] = q.x;
  f[1] = q.y;
  f[2] = q.z;
  f[3] = q.w;
}

__device__ __forceinline__ void st4(float* __restrict__ a, int i,
                                    const float (&f)[VEC]) {
  reinterpret_cast<float4*>(a)[i] = make_float4(f[0], f[1], f[2], f[3]);
}

// (a, b) summed over the CTA in a fixed order; every thread gets the sums
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(FULL, a, o);
    b += __shfl_xor_sync(FULL, b, o);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 r = warp_sums[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    r.x += warp_sums[w].x;
    r.y += warp_sums[w].y;
  }
  return r;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d)) &
          15) == 0;
}

// Pass 1: m and v of one chunk, and its partial sums of p·p and u·u
__global__ void __launch_bounds__(THREADS)
    lamb_moments_kernel(const __grid_constant__ Leaves t, const Scalars s,
                        float* __restrict__ partials) {
  const int leaf = find_leaf(t, blockIdx.x);
  const int start = (blockIdx.x - t.chunk0[leaf]) * CHUNK;
  const int len = min(CHUNK, t.n[leaf] - start);
  const float* __restrict__ p = t.p[leaf] + start;
  const float* __restrict__ g = t.g[leaf] + start;
  float* __restrict__ m = t.m[leaf] + start;
  float* __restrict__ v = t.v[leaf] + start;
  const float wd = t.wd[leaf];
  float wsq = 0.f, usq = 0.f;
  int done = 0;
  if (aligned16(p, g, m, v)) {
    const int nv = len / VEC;
    float rp[UNROLL][VEC], rg[UNROLL][VEC], rm[UNROLL][VEC], rv[UNROLL][VEC];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < nv) {
        ld4(p, i, rp[k]);
        ld4(g, i, rg[k]);
        ld4(m, i, rm[k]);
        ld4(v, i, rv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < nv) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          moments(rg[k][j], rm[k][j], rv[k][j], s);
          const float u = update(rp[k][j], rm[k][j], rv[k][j], wd, s);
          wsq += rp[k][j] * rp[k][j];
          usq += u * u;
        }
        st4(m, i, rm[k]);
        st4(v, i, rv[k]);
      }
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < len; i += THREADS) {
    float mi = m[i], vi = v[i];
    const float pi = p[i];
    moments(g[i], mi, vi, s);
    const float u = update(pi, mi, vi, wd, s);
    wsq += pi * pi;
    usq += u * u;
    m[i] = mi;
    v[i] = vi;
  }
  const float2 sums = block_sum2(wsq, usq);
  if (threadIdx.x == 0) {
    partials[2 * blockIdx.x] = sums.x;
    partials[2 * blockIdx.x + 1] = sums.y;
  }
}

// Pass 2: the leaf's trust ratio from its partials, then p of one chunk
__global__ void __launch_bounds__(THREADS)
    lamb_apply_kernel(const __grid_constant__ Leaves t, const Scalars s,
                      const float* __restrict__ partials) {
  const int leaf = find_leaf(t, blockIdx.x);
  float ratio = 1.f;
  if (t.adapt[leaf]) {
    float w = 0.f, u = 0.f;
    for (int c = t.chunk0[leaf] + threadIdx.x; c < t.chunk0[leaf + 1];
         c += THREADS) {
      w += partials[2 * c];
      u += partials[2 * c + 1];
    }
    const float2 sums = block_sum2(w, u);
    const float wn = __fsqrt_rn(sums.x), un = __fsqrt_rn(sums.y);
    if (wn > 0.f && un > 0.f) ratio = __fdiv_rn(wn, un);
  }
  const float scale = __fmul_rn(-s.lr, ratio);
  const int start = (blockIdx.x - t.chunk0[leaf]) * CHUNK;
  const int len = min(CHUNK, t.n[leaf] - start);
  float* __restrict__ p = t.p[leaf] + start;
  const float* __restrict__ m = t.m[leaf] + start;
  const float* __restrict__ v = t.v[leaf] + start;
  const float wd = t.wd[leaf];
  int done = 0;
  if (aligned16(p, p, m, v)) {
    const int nv = len / VEC;
    float rp[UNROLL][VEC], rm[UNROLL][VEC], rv[UNROLL][VEC];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < nv) {
        ld4(p, i, rp[k]);
        ld4(m, i, rm[k]);
        ld4(v, i, rv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int i = k * THREADS + threadIdx.x;
      if (i < nv) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float u = update(rp[k][j], rm[k][j], rv[k][j], wd, s);
          rp[k][j] = __fadd_rn(rp[k][j], __fmul_rn(scale, u));
        }
        st4(p, i, rp[k]);
      }
    }
    done = nv * VEC;
  }
  for (int i = done + threadIdx.x; i < len; i += THREADS) {
    const float pi = p[i];
    p[i] = __fadd_rn(pi, __fmul_rn(scale, update(pi, m[i], v[i], wd, s)));
  }
}

}  // namespace

// One LAMB step of n_leaves f32 leaves that share lr, betas, eps and step:
// ptrs holds 4·n_leaves device addresses (p, then g, m and v, each
// n_leaves long), sizes their element counts (each > 0), chunk0 the
// n_leaves + 1 chunk offsets (chunk0[0] = 0, then ceil(size / 4096) CTAs a
// leaf), wd each leaf's weight decay and adapt its layer-adaptation flag
// (host arrays, read before this returns); partials 2·chunk0[n_leaves] f32
// of device scratch. Launches the two kernels on stream; returns a CUDA
// error code, 0 on success.
extern "C" int nafp_lamb_step(const long long* ptrs, const int* sizes,
                              const int* chunk0, const float* wd,
                              const int* adapt, int n_leaves,
                              float* partials, float lr, float b1, float c1,
                              float b2, float c2, float bc1, float bc2,
                              float eps, void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || chunk0[0] != 0)
    return (int)cudaErrorInvalidValue;
  Leaves t;
  t.count = n_leaves;
  t.chunk0[0] = 0;
  for (int i = 0; i < n_leaves; ++i) {
    if (sizes[i] < 1 ||
        chunk0[i + 1] - chunk0[i] != (sizes[i] - 1) / CHUNK + 1)
      return (int)cudaErrorInvalidValue;
    t.p[i] = reinterpret_cast<float*>(ptrs[i]);
    t.g[i] = reinterpret_cast<const float*>(ptrs[n_leaves + i]);
    t.m[i] = reinterpret_cast<float*>(ptrs[2 * n_leaves + i]);
    t.v[i] = reinterpret_cast<float*>(ptrs[3 * n_leaves + i]);
    t.n[i] = sizes[i];
    t.chunk0[i + 1] = chunk0[i + 1];
    t.wd[i] = wd[i];
    t.adapt[i] = adapt[i] ? 1 : 0;
  }
  for (int i = n_leaves; i < MAX_LEAVES; ++i) {
    t.p[i] = t.m[i] = t.v[i] = nullptr;
    t.g[i] = nullptr;
    t.n[i] = 0;
    t.chunk0[i + 1] = chunk0[n_leaves];
    t.wd[i] = 0.f;
    t.adapt[i] = 0;
  }
  const Scalars s{lr, b1, c1, b2, c2, bc1, bc2, eps};
  const int grid = chunk0[n_leaves];
  cudaGetLastError();  // clear any stale error from earlier work
  const auto st = static_cast<cudaStream_t>(stream);
  lamb_moments_kernel<<<grid, THREADS, 0, st>>>(t, s, partials);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lamb_apply_kernel<<<grid, THREADS, 0, st>>>(t, s, partials);
  return (int)cudaGetLastError();
}
