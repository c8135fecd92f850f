// LayerNorm2d after an ELU, forward and backward: the encoder's norm
// (models/nnfp.py LayerNorm2d; hand-written for Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this norm
// (nafp_tpu/models/nnfp.py, LayerNorm2d) to XLA, which fuses the ELU, the
// statistics and the affine into a few passes. Eager PyTorch runs the same
// expression as ~35 f32 kernels per norm, forward and autograd backward.
//
// The function, per sample of x (B, N), N = C·F·T, T bf16 or f32, contiguous
// in (C, F, T) order or channels last, (F, T, C); gamma and beta (C, F, T)
// f32:
//   v = T(elu(x)); mean, var of v over the sample in f32 (biased);
//   rstd = rsqrt(var + eps); xhat = (v - mean)·rstd;
//   y = T(xhat·gamma + beta).
// Backward, with g = dy·gamma:
//   dx = T(T(rstd·(g - mean(g) - xhat·mean(g·xhat)))·elu'(x)),
//   dgamma = sum over the batch of dy·xhat, dbeta = sum of dy (f32).
// The two roundings of dx are the plain path's: the f32 gradient is cast
// to T at the f32 copy, then ELU's backward rounds once more. The forward
// saves x (T) and the per-sample mean and rstd, nothing of the
// activation's size in f32.
//
// Bound on an H100: bytes, and nearly the instructions. The least traffic
// is T in and out forward and dy, x in and dx out backward (10 B an element
// in bf16); the design moves 16, since the statistics need the whole sample
// before the first output and a sample (up to 1 MB at the encoder's first
// layer) is read twice, forward and backward. At 2 bytes an element the
// ELU's expm1f (~26 instructions) costs as much time as the bytes: for bf16
// the kernels read bf16(elu(x)) from a table of its 1,864 values between
// 2^-12 and 6.25 in magnitude, computed by the same expm1f into shared
// memory when a CTA starts (elu_table); outside that range it is x or -1
// exactly.
//
// Design. Every load is 16 bytes a thread (8 bf16, 4 f32), coalesced along
// the flat N axis in memory order; a shape whose N or pointers do not allow
// that runs the same kernels one element a thread. For channels-last x
// (the encoder's activations on the card: cuDNN keeps the input's layout)
// ln2d_gather_params_kernel first copies gamma and beta into memory order,
// and dgamma and dbeta are written back in (C, F, T) order.
// Forward: items of (sample, chunk of 256·vec·2 elements) over a
//   grid-stride loop of as many CTAs as the card holds, which balances any
//   batch and volume: ln2d_fwd_stats_kernel writes each item's
//   (count, mean, M2) (Chan et al.'s merge, no E[x²] - E[x]²),
//   ln2d_fwd_merge_kernel merges a sample's items in a fixed order (one warp
//   a sample), ln2d_fwd_norm_kernel writes y.
// Backward: ln2d_bwd_reduce_kernel, grid (position chunks of 32·vec·2,
//   batch chunks): each warp walks its samples through the chunk, writes a
//   sample's partial sums of g and g·xhat, and keeps dgamma and dbeta of its
//   positions in registers; the CTA's warps are summed in a fixed order into
//   one (batch chunk, position) partial (or straight into dgamma and dbeta
//   when there is one batch chunk). ln2d_bwd_merge_kernel sums a sample's
//   partials in a fixed order, ln2d_param_grad_kernel the batch chunks', and
//   ln2d_bwd_dx_kernel writes dx over the items. dy is read through its
//   strides: autograd may hand over a slice of a padded gradient, and a copy
//   would cost as much as a pass of the kernel.
// No float atomics anywhere: every sum runs in an order fixed by the shape,
// so every CTA of a sample derives the same statistics and two runs agree
// bit for bit. The caller chooses the batch chunks from the shape (ops/
// layernorm2d.py plan) and allocates the scratch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 2;            // vectors a thread takes per item or chunk
constexpr unsigned FULL = 0xffffffffu;
// bf16(elu(x)) is read from a table for x < 0 with |x| in [2^-12, 6.25):
// below, expm1(x) = x·(1 + x/2 + ...) lies within 2^-13 of x relatively, far
// inside half a bf16 step, so it rounds to x; at and beyond 6.25, e^x is
// under 2^-9 and -1 + e^x rounds to -1
constexpr int ELU_LO = 0x3980;              // bf16 bits of 2^-12
constexpr int ELU_HI = 0x40C8;              // bf16 bits of 6.25
constexpr int ELU_N = ELU_HI - ELU_LO;      // 1,864 entries

template <class T, int V>
struct Tag {
  using type = T;
  static constexpr int vec = V;
};

// ---- values of T as f32 --------------------------------------------------
__device__ __forceinline__ float bf16_bits(unsigned short h) {
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a)))
         | (static_cast<unsigned>(__bfloat16_as_ushort(
                __float2bfloat16_rn(b))) << 16);
}

// v rounded to T (round to nearest even), as f32
template <class T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) {
    return bf16_bits(__bfloat16_as_ushort(__float2bfloat16_rn(v)));
  } else {
    return v;
  }
}

// V consecutive f32 (16-byte loads when V is a multiple of 4)
template <int V>
__device__ __forceinline__ void load_f32(const float* __restrict__ p,
                                         float (&f)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      f[i] = q.x;
      f[i + 1] = q.y;
      f[i + 2] = q.z;
      f[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = p[i];
  }
}

// V consecutive elements of T (16 bytes when V > 1) as f32, and back
template <class T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (sizeof(T) == 2 && V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = __bfloat162float(p[i]);
  } else {
    load_f32<V>(reinterpret_cast<const float*>(p), f);
  }
}

template <class T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (sizeof(T) == 2 && V == 8) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                   pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(f[i]);
  } else if constexpr (V % 4 == 0) {
    float* q = reinterpret_cast<float*>(p);
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(q + i) =
          make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
  } else {
    float* q = reinterpret_cast<float*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) q[i] = f[i];
  }
}

// ELU (alpha 1) as PyTorch's CUDA elu computes it in f32; its derivative,
// in ln2d_bwd_dx_kernel, is elu_backward's from the input (is_result false)
__device__ __forceinline__ float elu(float x) {
  return x > 0.f ? x : expm1f(x);
}

// (v - mean)·rstd, then ·gamma + beta: each product and sum rounded on its
// own, as the plain path's separate kernels (no fused multiply-add)
__device__ __forceinline__ float norm(float v, float mu, float rs) {
  return __fmul_rn(__fsub_rn(v, mu), rs);
}

// Index in (C, F, T) order of memory position p: p itself, or, channels
// last with ch channels, channel p % ch at spatial position p / ch.
__device__ __forceinline__ int param_index(int p, int n, int ch) {
  return ch ? (p % ch) * (n / ch) + p / ch : p;
}

// The CTA's table of bf16(elu(x)) (their bits) for x = -|bits ELU_LO + i|,
// from the same expm1f as elu(); empty for f32.
template <class T>
__device__ __forceinline__ void elu_table(unsigned short* t) {
  if constexpr (sizeof(T) == 2) {
    for (int i = threadIdx.x; i < ELU_N; i += THREADS)
      t[i] = __bfloat16_as_ushort(__float2bfloat16_rn(
          expm1f(-bf16_bits((unsigned short)(ELU_LO + i)))));
    __syncthreads();
  }
}

// v = T(elu(x)) for x a value of T (as f32): for bf16 from the table (x
// itself for x >= 0, NaN and |x| < 2^-12; -1 for x <= -6.25), for f32
// elu() itself.
template <class T>
__device__ __forceinline__ float act(float x, const unsigned short* t) {
  if constexpr (sizeof(T) == 2) {
    const int m = (int)((__float_as_uint(x) >> 16) & 0x7fffu);
    const float tv = bf16_bits(t[min(max(m - ELU_LO, 0), ELU_N - 1)]);
    return (x >= 0.f || m < ELU_LO) ? x
           : m < ELU_HI             ? tv
           : m > 0x7f80             ? x
                                    : -1.f;
  } else {
    return elu(x);
  }
}

// ---- deterministic reductions ------------------------------------------
struct Stat {
  float n, mean, m2;   // count, mean, sum of squared deviations
};

// Chan, Golub and LeVeque's pairwise merge
__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n, d = b.mean - a.mean, f = b.n / n;
  return {n, a.mean + d * f, a.m2 + b.m2 + d * d * a.n * f};
}

// lane 0 ends with the merge of the warp's 32 values, in a fixed tree
__device__ __forceinline__ Stat warp_merge(Stat s) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const Stat o{__shfl_down_sync(FULL, s.n, off),
                 __shfl_down_sync(FULL, s.mean, off),
                 __shfl_down_sync(FULL, s.m2, off)};
    s = merge(s, o);
  }
  return s;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// The CTA's merge, valid in thread 0; red is reusable on return.
__device__ __forceinline__ Stat block_merge(Stat s, Stat* red) {
  const int w = threadIdx.x / 32, l = threadIdx.x % 32;
  s = warp_merge(s);
  if (l == 0) red[w] = s;
  __syncthreads();
  if (w == 0) s = warp_merge(l < WARPS ? red[l] : Stat{0.f, 0.f, 0.f});
  __syncthreads();
  return s;
}

// ---- forward -------------------------------------------------------------
// gamma and beta in memory order for channels-last x: gb[p], gb[n + p].
__global__ void __launch_bounds__(THREADS)
ln2d_gather_params_kernel(const float* __restrict__ gamma,
                          const float* __restrict__ beta, int n, int ch,
                          float* __restrict__ gb) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= n) return;
  const int i = param_index(p, n, ch);
  gb[p] = gamma[i];
  gb[n + p] = beta[i];
}

// Items (sample b, chunk c of THREADS·V·U elements), grid-stride: each
// item's (count, mean, M2) of v into part[(b·chunks + c)·3 ...].
template <class T, int V>
__global__ void __launch_bounds__(THREADS)
ln2d_fwd_stats_kernel(const T* __restrict__ x, int rows, int n, int chunks,
                      float* __restrict__ part) {
  constexpr int CHUNK = THREADS * V * U;
  __shared__ Stat red[WARPS];
  __shared__ unsigned short lut[ELU_N];
  elu_table<T>(lut);
  for (int it = blockIdx.x; it < rows * chunks; it += gridDim.x) {
    const int b = it / chunks, c = it % chunks;
    float f[U][V];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = c * CHUNK + (u * THREADS + threadIdx.x) * V;
      ok[u] = i < n;
      if (ok[u]) load<T, V>(x + (size_t)b * n + i, f[u]);
    }
    Stat st{0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        f[u][j] = act<T>(f[u][j], lut);
        sum += f[u][j];
      }
      const float m = sum / V;
      float m2 = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[u][j] - m;
        m2 += d * d;
      }
      st = merge(st, Stat{(float)V, m, m2});
    }
    st = block_merge(st, red);
    if (threadIdx.x == 0) {
      float* o = part + (size_t)it * 3;
      o[0] = st.n;
      o[1] = st.mean;
      o[2] = st.m2;
    }
  }
}

// One warp a sample: its items merged in a fixed order -> mean, rstd.
__global__ void __launch_bounds__(THREADS)
ln2d_fwd_merge_kernel(const float* __restrict__ part, int rows, int chunks,
                      int n, float eps, float* __restrict__ mean,
                      float* __restrict__ rstd) {
  const int b = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int l = threadIdx.x % 32;
  if (b >= rows) return;                 // whole warps
  Stat s{0.f, 0.f, 0.f};
  for (int c = l; c < chunks; c += 32) {
    const float* p = part + ((size_t)b * chunks + c) * 3;
    s = merge(s, Stat{p[0], p[1], p[2]});
  }
  s = warp_merge(s);
  if (l == 0) {
    mean[b] = s.mean;
    rstd[b] = rsqrtf(s.m2 / n + eps);
  }
}

template <class T, int V>
__global__ void __launch_bounds__(THREADS)
ln2d_fwd_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd, int rows, int n,
                     int chunks, T* __restrict__ y) {
  constexpr int CHUNK = THREADS * V * U;
  __shared__ unsigned short lut[ELU_N];
  elu_table<T>(lut);
  for (int it = blockIdx.x; it < rows * chunks; it += gridDim.x) {
    const int b = it / chunks, c = it % chunks;
    const float mu = mean[b], rs = rstd[b];
    float f[U][V];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = c * CHUNK + (u * THREADS + threadIdx.x) * V;
      ok[u] = i < n;
      if (ok[u]) load<T, V>(x + (size_t)b * n + i, f[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const int i = c * CHUNK + (u * THREADS + threadIdx.x) * V;
      float g[V], bt[V], o[V];
      load_f32<V>(gamma + i, g);
      load_f32<V>(beta + i, bt);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = __fadd_rn(__fmul_rn(norm(act<T>(f[u][j], lut), mu, rs), g[j]),
                         bt[j]);
      store<T, V>(y + (size_t)b * n + i, o);
    }
  }
}

// dy's layout: memory position p of x (dims n1, n2, n3 in x's memory order,
// n3 innermost) lies at b·s0 + (p / (n2·n3))·s1 + (p / n3 % n2)·s2 +
// (p % n3)·s3 elements into dy, so that the view autograd hands over (the
// slice of a padded gradient) needs no copy. With V > 1, s3 is 1 and n3, s0,
// s1 and s2 are multiples of V.
struct Strided {
  int n2, n3, s0, s1, s2, s3;
  // offset of memory position p within a sample (a thread computes it once
  // for its positions: they are the same for every sample it walks)
  __device__ size_t inner(int p) const {
    if (n2 == 1) return (size_t)p * s3;     // one dim: dense, or strided
    return (size_t)(p / (n2 * n3)) * s1 + (size_t)(p / n3 % n2) * s2 +
           (size_t)(p % n3) * s3;
  }
};

// Grid (position chunks of COLS = 32·V·U, batch chunks of rows_per_chunk
// samples). Warp w takes the chunk's samples w, w + WARPS, ...: per sample
// the sums of g and g·xhat over the chunk's positions into part[(b·gridDim.x
// + s)·2 ...]; per position dy·xhat and dy summed over the warp's samples,
// then over the CTA's warps in order, into pg / pb[batch chunk · n +
// position] (position param_index(p, n, ch_out): dgamma and dbeta
// themselves when there is one batch chunk).
template <class T, int V>
__global__ void __launch_bounds__(THREADS)
ln2d_bwd_reduce_kernel(const T* __restrict__ dy, Strided d,
                       const T* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ mean,
                       const float* __restrict__ rstd, int rows, int n,
                       int rows_per_chunk, int ch_out,
                       float* __restrict__ part, float* __restrict__ pg,
                       float* __restrict__ pb) {
  constexpr int COLS = 32 * V * U;
  __shared__ float sg[WARPS][COLS], sb[WARPS][COLS];
  __shared__ unsigned short lut[ELU_N];
  elu_table<T>(lut);
  const int s = blockIdx.x, w = threadIdx.x / 32, l = threadIdx.x % 32;
  const int b0 = blockIdx.y * rows_per_chunk;
  const int b1 = min(rows, b0 + rows_per_chunk);
  float gam[U][V], ag[U][V], ab[U][V];
  size_t doff[U];
  bool ok[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = s * COLS + (u * 32 + l) * V;
    ok[u] = i < n;
    doff[u] = ok[u] ? d.inner(i) : 0;
    if (ok[u]) load_f32<V>(gamma + i, gam[u]);
#pragma unroll
    for (int j = 0; j < V; ++j) ag[u][j] = ab[u][j] = 0.f;
  }
#pragma unroll 2
  for (int b = b0 + w; b < b1; b += WARPS) {
    const float mu = mean[b], rs = rstd[b];
    float fd[U][V], fx[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      load<T, V>(dy + (size_t)b * d.s0 + doff[u], fd[u]);
      load<T, V>(x + (size_t)b * n + s * COLS + (u * 32 + l) * V, fx[u]);
    }
    float s_g = 0.f, s_gx = 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = norm(act<T>(fx[u][j], lut), mu, rs);
        const float g = fd[u][j] * gam[u][j];
        s_g += g;
        s_gx += g * xh;
        ag[u][j] += fd[u][j] * xh;
        ab[u][j] += fd[u][j];
      }
    }
    s_g = warp_sum(s_g);
    s_gx = warp_sum(s_gx);
    if (l == 0) {
      float* o = part + ((size_t)b * gridDim.x + s) * 2;
      o[0] = s_g;
      o[1] = s_gx;
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sg[w][(u * 32 + l) * V + j] = ag[u][j];
      sb[w][(u * 32 + l) * V + j] = ab[u][j];
    }
  __syncthreads();
  for (int c = threadIdx.x; c < COLS; c += THREADS) {
    const int i = s * COLS + c;
    if (i >= n) continue;
    float a = 0.f, e = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) {
      a += sg[k][c];
      e += sb[k][c];
    }
    const int o = param_index(i, n, ch_out);
    pg[(size_t)blockIdx.y * n + o] = a;
    pb[(size_t)blockIdx.y * n + o] = e;
  }
}

// One warp a sample: mean(g) and mean(g·xhat) from its cols partials, in a
// fixed order, into mg[b·2 ...].
__global__ void __launch_bounds__(THREADS)
ln2d_bwd_merge_kernel(const float* __restrict__ part, int rows, int cols,
                      int n, float* __restrict__ mg) {
  const int b = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int l = threadIdx.x % 32;
  if (b >= rows) return;                 // whole warps
  float s_g = 0.f, s_gx = 0.f;
  for (int c = l; c < cols; c += 32) {
    const float* p = part + ((size_t)b * cols + c) * 2;
    s_g += p[0];
    s_gx += p[1];
  }
  s_g = warp_sum(s_g);
  s_gx = warp_sum(s_gx);
  if (l == 0) {
    mg[2 * b] = s_g / n;
    mg[2 * b + 1] = s_gx / n;
  }
}

// dgamma, dbeta in (C, F, T) order: the batch chunks' partials summed in
// order.
__global__ void __launch_bounds__(THREADS)
ln2d_param_grad_kernel(const float* __restrict__ pg,
                       const float* __restrict__ pb, int n_bc, int n, int ch,
                       float* __restrict__ dgamma,
                       float* __restrict__ dbeta) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float a = 0.f, d = 0.f;
  for (int k = 0; k < n_bc; ++k) {
    a += pg[(size_t)k * n + i];
    d += pb[(size_t)k * n + i];
  }
  const int o = param_index(i, n, ch);
  dgamma[o] = a;
  dbeta[o] = d;
}

// dx over items (sample b, chunk c of THREADS·V·U elements), grid-stride.
template <class T, int V>
__global__ void __launch_bounds__(THREADS)
ln2d_bwd_dx_kernel(const T* __restrict__ dy, Strided d,
                   const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd,
                   const float* __restrict__ mg, int rows, int n, int chunks,
                   T* __restrict__ dx) {
  constexpr int CHUNK = THREADS * V * U;
  __shared__ unsigned short lut[ELU_N];
  elu_table<T>(lut);
  for (int it = blockIdx.x; it < rows * chunks; it += gridDim.x) {
    const int b = it / chunks, c = it % chunks;
    const float mu = mean[b], rs = rstd[b], m_g = mg[2 * b],
                m_gx = mg[2 * b + 1];
    float fd[U][V], fx[U][V];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = c * CHUNK + (u * THREADS + threadIdx.x) * V;
      ok[u] = i < n;
      if (ok[u]) {
        load<T, V>(dy + (size_t)b * d.s0 + d.inner(i), fd[u]);
        load<T, V>(x + (size_t)b * n + i, fx[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const int i = c * CHUNK + (u * THREADS + threadIdx.x) * V;
      float g[V], o[V];
      load_f32<V>(gamma + i, g);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xv = fx[u][j];
        const float xh = norm(act<T>(xv, lut), mu, rs);
        const float gx =
            rnd<T>(rs * (fd[u][j] * g[j] - m_g - xh * m_gx));
        o[j] = xv <= 0.f ? gx * expf(xv) : gx;
      }
      store<T, V>(dx + (size_t)b * n + i, o);
    }
  }
}

// ---- launches --------------------------------------------------------------
// CTAs of kernel K the current card holds at once (SMs x CTAs per SM),
// cached per kernel and device: the grid of the grid-stride kernels.
template <auto K>
int resident() {
  static std::atomic<int> cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int have = cache[dev].load(std::memory_order_relaxed);
  if (have) return have;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, THREADS, 0)
          != cudaSuccess)
    return 0;
  have = sms * (per_sm > 0 ? per_sm : 1);
  cache[dev].store(have, std::memory_order_relaxed);
  return have;
}

template <auto K>
int grid_of(int work) {
  const int r = resident<K>();
  return r <= 0 ? 0 : (work < r ? work : r);
}

// Calls f(Tag<T, vec>{}) for the element type (bf16 or f32) and vector
// width of the launch: 16 bytes, or one element.
template <class F>
cudaError_t with_type(int is_bf16, int vec, F&& f) {
  if (is_bf16 && vec == 8) return f(Tag<bf16, 8>{});
  if (is_bf16 && vec == 1) return f(Tag<bf16, 1>{});
  if (!is_bf16 && vec == 4) return f(Tag<float, 4>{});
  if (!is_bf16 && vec == 1) return f(Tag<float, 1>{});
  return cudaErrorInvalidValue;
}

// Items a sample of the streaming kernels: chunks of THREADS·V·U elements.
template <int V>
int items_of(int n) {
  return (n + THREADS * V * U - 1) / (THREADS * V * U);
}

// Counts stay exact in f32 (n < 2^24) and item numbers in int.
bool bad_shape(int rows, int n, int vec, int ch) {
  return rows <= 0 || n <= 0 || n >= (1 << 24) || vec <= 0 || n % vec ||
         (long long)rows * (n / vec) >= (1LL << 31) || ch < 0 ||
         (ch && n % ch);
}

}  // namespace

// Forward: y, mean and rstd (rows,) f32 of x (rows, n), T bf16 (is_bf16 1)
// or f32, in (C, F, T) order (ch 0) or channels last with ch channels (then
// gb, 2·n f32 scratch, receives gamma and beta in memory order); chunks =
// ceil(n / (256·vec·2)) items a sample and part (rows·chunks·3) f32
// scratch. Returns a CUDA error code, 0 on success.
extern "C" int nafp_layernorm2d_fwd(const void* x, const float* gamma,
                                    const float* beta, int rows, int n,
                                    int is_bf16, int vec, int chunks, int ch,
                                    float eps, float* part, float* gb,
                                    void* y, float* mean, float* rstd,
                                    void* stream) {
  if (bad_shape(rows, n, vec, ch)) return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  if (ch) {
    ln2d_gather_params_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
        gamma, beta, n, ch, gb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gamma = gb;
    beta = gb + n;
  }
  const cudaError_t err = with_type(is_bf16, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    if (chunks != items_of<V>(n)) return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const int g1 = grid_of<ln2d_fwd_stats_kernel<T, V>>(rows * chunks);
    const int g3 = grid_of<ln2d_fwd_norm_kernel<T, V>>(rows * chunks);
    if (!g1 || !g3) return cudaErrorInvalidValue;
    ln2d_fwd_stats_kernel<T, V><<<g1, THREADS, 0, s>>>(xt, rows, n, chunks,
                                                       part);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ln2d_fwd_merge_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
        part, rows, chunks, n, eps, mean, rstd);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ln2d_fwd_norm_kernel<T, V><<<g3, THREADS, 0, s>>>(
        xt, gamma, beta, mean, rstd, rows, n, chunks, static_cast<T*>(y));
    return cudaGetLastError();
  });
  return (int)err;
}

// Backward: dx (rows, n) T in x's memory order, dgamma and dbeta (C, F, T)
// f32, from dy (the layout of Strided: n2, n3, s0 .. s3) and what the
// forward saved (gamma in memory order: for channels-last x, ch > 0, the
// forward's gb). cols = ceil(n / (32·vec·2)) position chunks of the reduce,
// its batch chunks of rows_per_chunk samples (n_bc of them); the dx items
// are the forward's. Scratch: part
// (rows·cols·2), mg (rows·2), and pg, pb (n_bc·n) when n_bc > 1 (with one
// batch chunk the reduce writes dgamma and dbeta itself). Returns a CUDA
// error code, 0 on success.
extern "C" int nafp_layernorm2d_bwd(const void* dy, const void* x,
                                    const float* gamma, const float* mean,
                                    const float* rstd, int rows, int n,
                                    int is_bf16, int vec, int cols,
                                    int rows_per_chunk, int ch, int n2, int n3,
                                    int s0, int s1, int s2, int s3,
                                    float* part, float* mg, float* pg,
                                    float* pb, float* dgamma, float* dbeta,
                                    void* dx, void* stream) {
  if (bad_shape(rows, n, vec, ch) || rows_per_chunk <= 0 || n2 <= 0 ||
      n3 <= 0 || n % (n2 * n3) || s0 < 0 || s1 < 0 || s2 < 0 || s3 < 0 ||
      (vec > 1 && (s3 != 1 || n3 % vec || s0 % vec || s1 % vec || s2 % vec)))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  const int n_bc = (rows + rows_per_chunk - 1) / rows_per_chunk;
  const Strided d{n2, n3, s0, s1, s2, s3};
  const cudaError_t err = with_type(is_bf16, vec, [&](auto tag) {
    using T = typename decltype(tag)::type;
    constexpr int V = decltype(tag)::vec;
    if (cols != (n + 32 * V * U - 1) / (32 * V * U) || n_bc > 65535)
      return cudaErrorInvalidValue;
    const T* dyt = static_cast<const T*>(dy);
    const T* xt = static_cast<const T*>(x);
    float* g_out = n_bc == 1 ? dgamma : pg;
    float* b_out = n_bc == 1 ? dbeta : pb;
    ln2d_bwd_reduce_kernel<T, V><<<dim3(cols, n_bc), THREADS, 0, s>>>(
        dyt, d, xt, gamma, mean, rstd, rows, n, rows_per_chunk,
        n_bc == 1 ? ch : 0, part, g_out, b_out);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    ln2d_bwd_merge_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
        part, rows, cols, n, mg);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (n_bc > 1) {
      ln2d_param_grad_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
          pg, pb, n_bc, n, ch, dgamma, dbeta);
      e = cudaGetLastError();
      if (e != cudaSuccess) return e;
    }
    const int chunks = items_of<V>(n);
    const int g = grid_of<ln2d_bwd_dx_kernel<T, V>>(rows * chunks);
    if (!g) return cudaErrorInvalidValue;
    ln2d_bwd_dx_kernel<T, V><<<g, THREADS, 0, s>>>(
        dyt, d, xt, gamma, mean, rstd, mg, rows, n, chunks,
        static_cast<T*>(dx));
    return cudaGetLastError();
  });
  return (int)err;
}
