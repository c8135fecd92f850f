// The tensor-core product tiles shared by every kernel of csrc/: B1
// (topk_f32.cu: f32 rows, 3xTF32 products, below), B3 (topk_masked.cu), B4b
// (bench_dotonly.cu) and the sq8 scan of B2 and B4a (sq8_scan.cuh), and the
// asynchronous copies that stage their DB tiles.
//
// Layout. Queries are the M side of mma.sync.m16n8k16 (16 per M-tile) and
// DB rows the N side (8 per n-tile); d is the K side, padded with zeros to
// DM, the kernel's K extent: 128 for d <= 128, MAX_D = 256 above (each
// kernel is instantiated for both and picks one per launch). A warp keeps
// its queries' A fragments in registers for the whole launch (loaded once
// from the f32 queries, rounded to bf16). DB rows sit in shared memory as
// bf16 tiles of TILE_ROWS rows at a padded stride of Tile<DM>::LD elements
// (272 or 528 bytes: the 8 row addresses of one ldmatrix fall in 8
// different 16-byte bank groups), and each n-tile's B fragments come from
// ldmatrix.x4. Products of bf16 values are exact in f32; the tensor cores
// sum them in f32, in their own order.
//
// Why mma.sync and not wgmma: every kernel here is compiled only on the
// card machine, so a layout fault shows only there; mma.sync's register
// fragments are fixed per lane and checked against the plain versions
// element by element, while wgmma adds shared-memory descriptors and
// swizzle modes that fail silently when wrong.
//
// Staging: cp.async copies of 16-byte chunks, or of 8- or 4-byte chunks
// when a row's bytes are not a multiple of 16 (any d that is a multiple of
// 4), zero-filled past d, committed per tile into a ring of stages. Each
// kernel is built for every (K extent, copy width) pair (Shape, with_shape).
// int8 rows are staged as they are (load_raw) and either widened into the
// bf16 tile (widen: exact, |x| <= 127) or, for int8 queries, multiplied
// as they are on mma.sync.m16n8k32 s8 x s8 -> s32 (tile_mma_i8). A k32 s8
// fragment holds the same bytes of a row as a k16 bf16 fragment (4 bytes
// at 4 * (lane % 4), and 16 bytes on), so ldmatrix.x4 over 16-byte row
// segments feeds both; an int8 tile's rows sit Tile8<DM>::LD bytes apart
// (DM + 16: again 8 different 16-byte bank groups per ldmatrix).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "limits.cuh"

namespace nafp {
namespace mma {

constexpr int TILE_ROWS = 64;         // DB rows per staged tile

// The shapes that follow from the K extent DM.
template <int DM>
struct Tile {
  static_assert(DM == 128 || DM == MAX_D, "K extent: 128 or MAX_D");
  static constexpr int KSTEPS = DM / 16;    // mma k16 steps per dot product
  static constexpr int LD = DM + 8;         // bf16 elements per staged row
  static constexpr int BYTES = TILE_ROWS * LD * 2;  // one staged bf16 tile
};

// The same for an int8 tile fed to the s8 tensor cores as it is.
template <int DM>
struct Tile8 {
  static_assert(DM == 128 || DM == MAX_D, "K extent: 128 or MAX_D");
  static constexpr int KSTEPS = DM / 32;    // mma k32 steps per dot product
  static constexpr int LD = DM + 16;        // bytes per staged row
};

// A kernel instance: K extent DM and the bytes of one staging copy, CP.
template <int DM_, int CP_>
struct Shape {
  static constexpr int DM = DM_, CP = CP_;
};

// f(Shape<DM, CP>{}) for the instance that takes rows of width d: DM 128
// for d <= 128, else MAX_D; CP = WIDE where `wide` (the row's bytes are a
// multiple of WIDE), else NARROW. The copy width is a template parameter,
// not a branch in the kernel: a branch between the two copy loops costs
// the scans registers.
template <int WIDE, int NARROW, typename F>
cudaError_t with_shape(int d, bool wide, F&& f) {
  if (d <= 128)
    return wide ? f(Shape<128, WIDE>{}) : f(Shape<128, NARROW>{});
  return wide ? f(Shape<MAX_D, WIDE>{}) : f(Shape<MAX_D, NARROW>{});
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) global -> shared, asynchronously; src_bytes < BYTES
// zero-fills the rest (0: all zeros, the global address is not read).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4, "cp.async size");
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Start the cp.async copies of int8 rows row0 .. row0 + 63 (d bytes each,
// CP bytes a copy: 16 when d is a multiple of 16, else 4; zero-filled to
// DM; BOUNDED: zeros at and past row_end, else every row is below it)
// into `raw`, rows LDR bytes apart.
template <int THREADS, int DM, int CP, int LDR, bool BOUNDED>
__device__ __forceinline__ void load_raw(int8_t* raw,
                                         const int8_t* __restrict__ db,
                                         int row0, int row_end, int d) {
  constexpr int CPR = DM / CP;  // copies per staged row
  for (int e = threadIdx.x; e < TILE_ROWS * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    const bool in = CP * c < d && (!BOUNDED || row0 + r < row_end);
    cp_async<CP>(raw + r * LDR + CP * c,
                 in ? db + (size_t)(row0 + r) * d + CP * c : db,
                 in ? CP : 0);
  }
}

// The 4 int8 values of w (byte 0 first) as bf16 pairs, exactly and without
// the quarter-rate int -> float conversions: byte b ^ 0x80 = b + 128 goes
// into the mantissa of 2^23 (f32 bits 0x4B0000xx), 2^23 + 128 is
// subtracted, and the result, an integer of at most 8 bits, is a bf16 in
// the upper half of its f32 bits.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo,
                                               uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + b)) -
           8388736.f;
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

// Widen a staged int8 tile (rows LDR bytes apart) into a bf16 tile (exact:
// |x| <= 128).
template <int THREADS, int DM, int LDR>
__device__ __forceinline__ void widen(const int8_t* raw, __nv_bfloat16* bf) {
  for (int e = threadIdx.x; e < TILE_ROWS * (DM / 16); e += THREADS) {
    const int r = e / (DM / 16), c = e % (DM / 16);
    const int4 v = *reinterpret_cast<const int4*>(raw + r * LDR + 16 * c);
    const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                           (uint32_t)v.w};
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) int8x4_to_bf16(w[i], p[2 * i], p[2 * i + 1]);
    uint4* dst = reinterpret_cast<uint4*>(bf + r * Tile<DM>::LD + 16 * c);
    dst[0] = make_uint4(p[0], p[1], p[2], p[3]);
    dst[1] = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// c += a . b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b for one m16n8k32 tile: s8 operands, s32 accumulators (exact).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The A fragments of MT M-tiles of queries, rows row0 + 16 * mt + (0..15)
// of q (bq, d) f32, rounded to bf16; zeros past bq and past d. Lane l holds
// rows g = l / 4 and g + 8, columns 2 * (l % 4) + {0, 1} (+8) of each step.
template <int MT, int DM>
__device__ __forceinline__ void load_a(
    uint32_t (&a)[MT][Tile<DM>::KSTEPS][4], const float* __restrict__ q,
    int bq, int d, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int s = 0; s < Tile<DM>::KSTEPS; ++s)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 16 * s + c2 + 8 * j;
          float2 v = make_float2(0.f, 0.f);
          if (row < bq && col < d)  // d is even: col + 1 < d too
            v = *reinterpret_cast<const float2*>(q + (size_t)row * d + col);
          a[mt][s][h + 2 * j] = pack_bf16(v.x, v.y);
        }
    }
}

// acc[mt][nt] = the products of M-tile mt with n-tile nt0 + nt of the
// staged bf16 tile at shared address `tile` (rows at Tile<DM>::LD
// elements). c[0], c[1]: query g, rows 2 * (lane % 4) + {0, 1} of the
// n-tile; c[2], c[3]: query g + 8, the same rows.
template <int MT, int NT, int DM>
__device__ __forceinline__ void tile_mma(
    const uint32_t (&a)[MT][Tile<DM>::KSTEPS][4], uint32_t tile, int nt0,
    float (&acc)[MT][NT][4]) {
  constexpr int LD = Tile<DM>::LD;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lane l addresses row l % 8 of matrix l / 8, i.e. column
  // block 8 * (l / 8) of the 32 columns that two k steps cover
  const uint32_t lane_off =
      ((lane & 7) * LD + 8 * (lane >> 3)) * sizeof(__nv_bfloat16);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    const uint32_t row_base =
        tile + (nt0 + nt) * 8 * LD * sizeof(__nv_bfloat16) + lane_off;
#pragma unroll
    for (int s2 = 0; s2 < Tile<DM>::KSTEPS / 2; ++s2) {
      uint32_t b[4];
      ldmatrix_x4(b, row_base + 32 * s2 * sizeof(__nv_bfloat16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][nt], a[mt][2 * s2], b[0], b[1]);
        mma_bf16(acc[mt][nt], a[mt][2 * s2 + 1], b[2], b[3]);
      }
    }
  }
}

// --- f32 products on the TF32 tensor cores (kernel B1) --------------------
//
// 3xTF32: an f32 x is split as hi = rna(x), lo = rna(x - hi), both TF32
// values (11 significant bits; x - hi is exact in f32), and a . b is summed
// as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on mma.sync.m16n8k8 tf32 with f32
// accumulators, the small terms first. A product of two TF32 values is
// exact in f32; the dropped a_lo.b_lo and lo's own rounding leave about
// 2^-22 of each |a_i b_i|, near f32's own error for the same sum. The
// tensor cores round their f32 sums toward zero, so one accumulator over
// d = 128 (48 mma) drifted below the f32 reference by up to 1.1e-4 at
// scores near 50 (H100, standard-normal rows): each 16 columns start a
// fresh partial sum, added to the running sum with a rounded f32 add.
//
// The queries' A fragments stay in registers as f32 values (64 registers
// at K extent 128, 128 at 256; split, they would take twice that) and are
// split once per tile and k step; B is split in registers after each
// ldmatrix (a tile element is read by the 4 warps that share its n-tiles,
// and a split tile in shared memory would double every read).

// DB rows as f32 tiles of TILE_ROWS rows, LD = DM + 4 floats apart (528 or
// 1040 bytes: the 8 row addresses of one ldmatrix fall in 8 different
// 16-byte bank groups).
template <int DM>
struct Tf32Tile {
  static_assert(DM == 128 || DM == MAX_D, "K extent: 128 or MAX_D");
  static constexpr int KSTEPS = DM / 8;     // mma k8 steps per dot product
  static constexpr int LD = DM + 4;         // floats per staged row
  static constexpr int BYTES = TILE_ROWS * LD * 4;  // one staged f32 tile
};

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (nearest, ties away from
// zero), as f32 bits: half an ulp of the 13 dropped bits added to the
// magnitude, then the bits cut. Two integer operations (finite x); B1 ran
// 5 % slower with the cvt (H100; PERF.md, B1 redesign).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi, lo of each of the N f32 values (as bits) in x.
template <int N>
__device__ __forceinline__ void split_tf32(const uint32_t (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float v = __uint_as_float(x[i]);
    hi[i] = to_tf32(v);
    lo[i] = to_tf32(v - __uint_as_float(hi[i]));
  }
}

// c += a . b for one m16n8k8 tile: tf32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of one M-tile of queries as f32 bits, rows row0 +
// (0..15) of q (bq, d) f32; zeros past bq and past d. Lane l holds rows g =
// l / 4 and g + 8, columns l % 4 (+4) of each k8 step: a[s][0] = (g, 8s +
// l%4), a[s][1] = (g + 8, ...), a[s][2] = (g, 8s + l%4 + 4), a[s][3] = (g
// + 8, ...).
template <int DM>
__device__ __forceinline__ void load_a_f32(
    uint32_t (&a)[Tf32Tile<DM>::KSTEPS][4], const float* __restrict__ q,
    int bq, int d, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < Tf32Tile<DM>::KSTEPS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int col = 8 * s + t + 4 * (i >> 1);
      a[s][i] = __float_as_uint(
          row < bq && col < d ? q[(size_t)row * d + col] : 0.f);
    }
}

// acc[nt] = the 3xTF32 products of the warp's M-tile (f32 A fragments a)
// with n-tile nt0 + nt of the staged f32 tile at shared address `tile`
// (rows Tf32Tile<DM>::LD floats apart); acc's places as tile_mma's.
template <int NT, int DM>
__device__ __forceinline__ void tile_mma_3xtf32(
    const uint32_t (&a)[Tf32Tile<DM>::KSTEPS][4], uint32_t tile, int nt0,
    float (&acc)[NT][4]) {
  constexpr int LD = Tf32Tile<DM>::LD;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 .b16 over f32 rows: lane l addresses row l % 8 of matrix
  // l / 8, floats 4 * (l / 8) .. + 3 of the 16 that two k8 steps cover, and
  // receives float l % 4 of row l / 4 of each matrix: the B fragments b0, b1
  // of step 2 s2 and of step 2 s2 + 1
  const uint32_t lane_off = ((lane & 7) * LD + 4 * (lane >> 3)) * 4;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
  for (int s2 = 0; s2 < Tf32Tile<DM>::KSTEPS / 2; ++s2) {
    // the same split in every tile: an empty asm keeps it in the tile
    // loop, where hoisted out it would take twice A's registers
    uint32_t x[2][4], ah[2][4], al[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[j][i] = a[2 * s2 + j][i];
        asm volatile("" : "+r"(x[j][i]));
      }
      split_tf32(x[j], ah[j], al[j]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t b[4], bh[4], bl[4];
      ldmatrix_x4(b, tile + (nt0 + nt) * 8 * LD * 4 + lane_off + 64 * s2);
      split_tf32(b, bh, bl);
      float p[4] = {0.f, 0.f, 0.f, 0.f};  // these 16 columns' partial sum
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma_tf32(p, al[j], bh[2 * j], bh[2 * j + 1]);
        mma_tf32(p, ah[j], bl[2 * j], bl[2 * j + 1]);
        mma_tf32(p, ah[j], bh[2 * j], bh[2 * j + 1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] += p[i];
    }
  }
}

// The s8 A fragments of MT M-tiles of int8 queries, rows row0 + 16 * mt +
// (0..15) of q8 (bq, d), d a multiple of 16; zeros past bq and past d. Lane
// l holds rows g = l / 4 and g + 8, bytes 4 * (l % 4) + (0..3) (+16) of
// each k32 step: load_a's bytes, one int8 value a byte.
template <int MT, int DM>
__device__ __forceinline__ void load_a_i8(
    uint32_t (&a)[MT][Tile8<DM>::KSTEPS][4], const int8_t* __restrict__ q8,
    int bq, int d, int row0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c4 = 4 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * mt + g + 8 * h;
#pragma unroll
      for (int s = 0; s < Tile8<DM>::KSTEPS; ++s)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 32 * s + c4 + 16 * j;
          a[mt][s][h + 2 * j] =
              row < bq && col < d  // d % 16 == 0: all 4 bytes in, or none
                  ? *reinterpret_cast<const uint32_t*>(q8 + (size_t)row * d +
                                                       col)
                  : 0u;
        }
    }
}

// tile_mma for int8 queries and a staged int8 tile at shared address
// `tile` (rows at Tile8<DM>::LD bytes): exact s32 sums, the same (query,
// row) places in acc as tile_mma's.
template <int MT, int NT, int DM>
__device__ __forceinline__ void tile_mma_i8(
    const uint32_t (&a)[MT][Tile8<DM>::KSTEPS][4], uint32_t tile, int nt0,
    int (&acc)[MT][NT][4]) {
  constexpr int LD = Tile8<DM>::LD;
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4: lane l addresses row l % 8 at byte 16 * (l / 8) of the 64
  // bytes that two k32 steps cover
  const uint32_t lane_off = (lane & 7) * LD + 16 * (lane >> 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    const uint32_t row_base = tile + (nt0 + nt) * 8 * LD + lane_off;
#pragma unroll
    for (int s2 = 0; s2 < Tile8<DM>::KSTEPS / 2; ++s2) {
      uint32_t b[4];
      ldmatrix_x4(b, row_base + 64 * s2);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_s8(acc[mt][nt], a[mt][2 * s2], b[0], b[1]);
        mma_s8(acc[mt][nt], a[mt][2 * s2 + 1], b[2], b[3]);
      }
    }
  }
}

}  // namespace mma
}  // namespace nafp
