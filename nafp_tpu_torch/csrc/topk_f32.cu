// Kernel B1: exact f32 top-k of q . DB^T (hand-written for Hopper, sm_90a).
//
// Replaces the TPU kernel topk_ip_pallas (nafp_tpu/search/pallas_topk.py,
// _kernel_plain -> _kernel_body with _merge_tile / _finish_sort), which
// FlatIndex uses for `-i l2`, `-i ip` and `-i ivf` at >= 50k rows.
//
// What it computes: for each query the k best rows by inner product,
// scores sorted descending, int32 row positions, -1 wherever the score is
// <= NEG/2 (the empty slots when k > N). Ties go to the lower row. The
// (Bq, N) score matrix never reaches device memory.
//
// Numerics: f32-accurate products on the TF32 tensor cores, 3xTF32: each
// operand split into TF32 hi = rna(x) and lo = rna(x - hi), a . b summed as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; about 2^-22 of each |a_i b_i| is lost,
// near f32's own error for the same sum. The tensor cores round their f32
// sums toward zero: the two small terms go into one sum (2^-10 of the
// whole), a_hi.b_hi into one sum per 64 columns (32 at d 256), and those
// are added in f32 at the end (tile_products). One TF32 pass (three
// digits) or bf16x3 (about 2^-16) would not hold the f32 reference's 1e-4.
//
// Bound on an H100 at the main path's shape (Bq 512, N 619,500, d 128):
// the split triples the 81.2 GFLOP of the product, 243.6 GFLOP of TF32 at
// 495 TFLOP/s, 0.492 ms; the DB's 317 MB take 0.095 ms at 3.35 TB/s: bound
// by operations, and only wgmma reaches that rate. Its operand from shared
// memory (here the queries) is read at 64 B a clock at the full TF32 rate,
// half of what shared memory gives; the A fragments' loads and the bulk
// copies take most of the rest, so the selection's shared-memory accesses
// run slowly while the other consumer's wgmma run, and the selection is
// built to touch shared memory only for candidates.
//
// Design. 1. scan: grid (n_chunks, ceil(Bq / NQ)), one wave of one CTA per
// SM (the wrapper plans the chunks from nafp_topk_f32_occupancy). A CTA
// holds NQ queries (64 at K extent 128, 32 at 256) and walks its chunk in
// 64-row tiles with three warpgroups:
// - the producer (one thread of one warp; the warpgroup gives back its
//   registers down to 40) copies each stage, R = 64 (d <= 128) or 32
//   consecutive rows, as one bulk copy of contiguous bytes of db into a
//   ring of 2-6 stages (as many as shared memory holds beside the rest),
//   completing on that stage's mbarrier of the tile's consumer;
// - two consumers (232 registers) take the tiles in turn. Each thread
//   loads the 2 x 4 floats of its A fragments for two k8 steps with two
//   16-byte shared loads, splits them into hi/lo in registers and releases
//   the stage once its last fragments are in registers: every DB element
//   is read and split once per CTA. The DB rows are wgmma's A (M = 64), the
//   queries its B (N = NQ), split once per CTA at its start and kept in
//   shared memory in wgmma's K-major layout; both sides permute K alike, so
//   that a thread's fragments of two k8 steps are 4 consecutive floats of
//   a row. One group of two k8 steps (six wgmma) stays in flight;
// - the selection keeps B3's admission rule (topk_masked.cu) without its
//   bias and ids: a score is a candidate only if it is > NEG/2, not below
//   the bound the chunk CTAs share and better than the query's k-th best
//   (ties to the lower row: a zero query, as the index pads a block with,
//   ties every row); each thread keeps its 16 gates, value and row, in
//   registers between merges (older gates admit more). Candidates go into
//   the consumer's own buffer (32 a query); the buffers are merged into
//   the CTA's k-lists with warp_merge under a lock, every 32 tiles of a
//   consumer, when a buffer overflows, and at the end, and a list's k-th
//   score is published once it holds k real entries. While one consumer
//   selects, the other's products run.
// 2. merge: warp_select.cuh's merge_kernel, one warp per query.
//
// Registers, occupancy, stages (H100; PERF.md, B1 on wgmma): 384
// threads and 168 registers each at launch, one CTA per SM. f32 partial
// sums of 16 columns added inside the wgmma pipeline (the mma.sync
// design's scheme) kept it whole only in a 255-register kernel; under 232
// ptxas serialized every wgmma (2.3-2.6 ms). The big/small sums need ~180
// registers (the products alone 0.69-0.71 ms, 70 % of the bound). A merge
// after every tile ran 2.2-2.9 ms; every 8, 16, 32 and 64 tiles 1.98,
// 1.88, 1.72 and 1.80 ms at k 20. Stages: 3 at k <= 67 and d 128 (2
// above), 2-4 at d 256; a fourth at k 20 (buffers of 23) ran 1.74 ms,
// within noise. As built: 1.76-1.83 ms at k 20, 2.62-2.69 at k 80 (the
// mma.sync design: 3.21, 4.36).
#include <algorithm>

#include "mma_tile.cuh"
#include "warp_select.cuh"
#include "wgmma_tf32.cuh"

namespace {

using namespace nafp;
using namespace nafp::hop;
using namespace nafp::sel;
using mma::TILE_ROWS;
using mma::to_tf32;

constexpr int CONSUMERS = 2;                    // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer's
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGE_FLOATS = TILE_ROWS * 128;  // 64 rows x 128 or 32 x 256
constexpr int MAX_STAGES = 6;
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a CTA may take
constexpr int GROUP = 2;         // k8 steps a commit group
constexpr int CAP = 32;          // candidates a query's buffer holds
constexpr int FLUSH = 32;        // a consumer's tiles between merges
// named barriers: 1 + c, consumer c's own warpgroup; DONE, both consumers
constexpr int BAR_WG = 1, BAR_DONE = 3;

// The shapes that follow from the K extent DM.
template <int DM>
struct Cfg {
  static_assert(DM == 128 || DM == MAX_D, "K extent: 128 or MAX_D");
  static constexpr int NQ = DM == 128 ? 64 : 32;  // queries a CTA: N
  static constexpr int NA = NQ / 2;     // accumulators a thread
  static constexpr int H = DM / 128;    // ring stages a tile
  static constexpr int R = TILE_ROWS / H;  // rows a stage
  static constexpr int LBO = NQ / 8 * 128;  // bytes between K core matrices
  static constexpr int QFLOATS = NQ * DM;   // one half of the split queries
  // big sums (a_hi.b_hi) a thread keeps: one per 64 columns at d <= 128,
  // per 32 at 256 (scores of 256 same-sign terms reach ~160)
  static constexpr int NB = DM == 128 ? 2 : 8;
};

// Shared memory of a scan CTA: the split queries (hi, lo), the ring, the
// k-lists, a candidate buffer for each consumer, per-query counters and
// bounds, a lock, barriers.
template <int DM>
size_t scan_smem_bytes(int k, int stages) {
  constexpr int NQ = Cfg<DM>::NQ;
  return 2 * sizeof(float) * (size_t)Cfg<DM>::QFLOATS
         + sizeof(float) * (size_t)stages * STAGE_FLOATS
         + (sizeof(float) + sizeof(int)) * (size_t)NQ * k
         + (sizeof(float) + sizeof(int)) * CONSUMERS * NQ * CAP
         + (CONSUMERS + 2) * sizeof(int) * NQ + 4 * sizeof(int)
         + (CONSUMERS + 1) * sizeof(uint64_t) * stages;
}

// The ring stages beside the rest: as many as fit, at most MAX_STAGES; 0
// if not two.
template <int DM>
int scan_stages(int k) {
  int s = MAX_STAGES;
  while (s >= 2 && scan_smem_bytes<DM>(k, s) > SMEM_LIMIT) --s;
  return s >= 2 ? s : 0;
}

// Logical K position of physical column p: inside each 32-column block,
// thread t's A fragments of k8 steps 4 b' .. 4 b' + 3 are the floats 8 t ..
// 8 t + 7, column 8 t + 2 s + e being (step s, fragment column t + 4 e).
__device__ __forceinline__ int logical_k(int p) {
  const int pp = p & 31;
  return (p & ~31) + 8 * ((pp & 7) >> 1) + (pp >> 3) + 4 * (pp & 1);
}

// Offset in floats of (query n, logical k) in one half of the split
// queries: K-major core matrices of 8 queries x 4 floats.
template <int NQ>
__device__ __forceinline__ int q_offset(int n, int kl) {
  return (((kl >> 2) * (NQ / 8) + (n >> 3)) * 8 + (n & 7)) * 4 + (kl & 3);
}

__device__ __forceinline__ void hi_lo(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// acc = the 3xTF32 products of this consumer's tile (ring stages i0 ..
// i0 + H - 1, R rows of d floats each) with the CTA's queries: row 16 warp
// + g + 8 h of the tile, query 8 j + 2 t + e at acc[4 j + 2 h + e].
//
// The wgmma of a k8 step go into two kinds of sums: a_lo.b_hi and a_hi.b_lo
// into `small`, a_hi.b_hi into one of NB `big` sums, each over 64 columns
// (32 at d 256). The tensor cores round every sum toward zero; the small
// terms' sum is 2^-10 of the whole, and each big sum takes 8 (4) steps at
// a fraction of the score's size, so the rounding stays near that of
// 16-column partial sums added in f32, with no add inside the pipeline.
// One group of two k8 steps stays in flight while the next one's
// fragments are loaded and split.
template <int DM>
__device__ __forceinline__ void tile_products(
    float (&acc)[Cfg<DM>::NA], const float* ring, uint64_t* full,
    uint64_t* empty, int stages, int i0, int d, uint32_t q_hi,
    uint32_t q_lo, uint32_t& phases, int wg, int warp, int lane) {
  using C = Cfg<DM>;
  constexpr int NA = C::NA, GROUPS = DM / 8 / GROUP, NB = C::NB;
  constexpr int KS = DM / 8;  // k8 steps
  float big[NB][NA], small[NA];
  uint32_t ah[2][GROUP][4], al[2][GROUP][4];
  const int g = lane >> 2, t = lane & 3;
  // every stage of the tile has landed before the first wgmma: no wait
  // loop inside the pipeline. Bit s of `phases`: the parity of this
  // consumer's next use of stage s
#pragma unroll
  for (int h = 0; h < C::H; ++h) {
    const int sh = (i0 + h) % stages;
    mbar_wait(&full[sh * CONSUMERS + wg], phases >> sh & 1);
    phases ^= 1u << sh;
  }
  // this warp's rows: stage 16 warp / R, rows g and g + 8 of its 16 there
  const int s = (i0 + 16 * warp / C::R) % stages;
  const float* rows =
      ring + s * STAGE_FLOATS + (16 * warp % C::R + g) * d + 8 * t;
#pragma unroll
  for (int gi = 0; gi < GROUPS; ++gi) {
    const int buf = gi & 1;
    // k8 steps 2 gi, 2 gi + 1: block gi / 2, half gi % 2; zeros past d
    const int col = 32 * (gi >> 1) + 4 * (gi & 1);
    const bool in = col + 8 * t < d;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 x0 = in ? *reinterpret_cast<const float4*>(rows + col) : z;
    const float4 x1 =
        in ? *reinterpret_cast<const float4*>(rows + 8 * d + col) : z;
    hi_lo(x0.x, ah[buf][0][0], al[buf][0][0]);
    hi_lo(x1.x, ah[buf][0][1], al[buf][0][1]);
    hi_lo(x0.y, ah[buf][0][2], al[buf][0][2]);
    hi_lo(x1.y, ah[buf][0][3], al[buf][0][3]);
    hi_lo(x0.z, ah[buf][1][0], al[buf][1][0]);
    hi_lo(x1.z, ah[buf][1][1], al[buf][1][1]);
    hi_lo(x0.w, ah[buf][1][2], al[buf][1][2]);
    hi_lo(x1.w, ah[buf][1][3], al[buf][1][3]);
    if (gi == GROUPS - 1)  // the stage is in registers: hand it back
      mbar_arrive_if(&empty[s], lane == 0);
    wgmma_fence();
    // the descriptors are made here, two a k8 step: hoisted, all of them
    // would take the registers that the wgmma pipeline needs
    const uint32_t qh = opaque(q_hi), ql = opaque(q_lo);
#pragma unroll
    for (int ss = 0; ss < GROUP; ++ss) {
      const int ks = gi * GROUP + ss;
      const uint32_t off = ks * 2 * C::LBO;
      const uint64_t bh = desc_kmajor(qh + off, C::LBO, 128);
      const uint64_t bl = desc_kmajor(ql + off, C::LBO, 128);
      Wgmma<C::NQ>::mma(small, al[buf][ss], bh, ks > 0);
      Wgmma<C::NQ>::mma(small, ah[buf][ss], bl, 1);
      Wgmma<C::NQ>::mma(big[ks / (KS / NB)], ah[buf][ss], bh,
                        ks % (KS / NB));
    }
    wgmma_commit();
    // the previous group is done: its fragments' registers are free
    if (gi > 0 && gi < GROUPS - 1) wgmma_wait<1>();
  }
  wgmma_wait<0>();
  reg_fence(small);
#pragma unroll
  for (int c = 0; c < NB; ++c) reg_fence(big[c]);
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    float b = big[0][j];
#pragma unroll
    for (int c = 1; c < NB; ++c) b += big[c][j];
    acc[j] = b + small[j];
  }
}

// Merge a buffer of candidates (cnt[qi] of them, at most CAP) into each
// k-list of queries warp0, warp0 + step, ... that has any, one warp a
// query; with `publish`, raise the shared bound to a list's k-th score once
// it holds k real entries.
__device__ __forceinline__ void merge_buffers(
    float* lv, int* li, const float* cv, const int* ci, int* cnt, float* pub,
    float* bound, int nq, int warp0, int step, int k, bool publish,
    int lane) {
  for (int qi = warp0; qi < nq; qi += step) {
    const int m = cnt[qi];
    if (!m) continue;
    warp_merge(lv + qi * k, li + qi * k, cv + qi * CAP, ci + qi * CAP,
               min(m, CAP), k);
    if (lane == 0) {
      cnt[qi] = 0;
      const float kth = lv[qi * k + k - 1];
      if (publish && kth > NEG / 2 && kth > pub[qi]) {  // k real entries
        pub[qi] = kth;
        atomic_max_f32(bound + qi, kth);
      }
    }
    __syncwarp();
  }
}

// This thread's gates for query 8 j + 2 t + e, at [2 j + e]: a score is a
// candidate only if it is above gate, or equal to it with a row below
// gate_row. The gate is the larger of the list's k-th entry (then
// gate_row is that entry's row: a tie goes to the lower row), the CTA's
// copy of the shared bound (a score equal to it is kept) and NEG/2; +inf
// past the nvalid real queries. Held in registers between merges: lists
// and bound only rise, so an older gate admits a superset.
template <int DM>
__device__ __forceinline__ void load_gates(float (&gate)[Cfg<DM>::NA / 2],
                                           int (&gate_row)[Cfg<DM>::NA / 2],
                                           const float* lv, const int* li,
                                           const float* bnd, int k,
                                           int nvalid, int t) {
#pragma unroll
  for (int j = 0; j < Cfg<DM>::NQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qi = 8 * j + 2 * t + e;
      const float kth = lv[qi * k + k - 1];
      const float gv = fmaxf(fmaxf(kth, bnd[qi]), NEG / 2);
      gate[2 * j + e] = qi < nvalid ? gv : INFINITY;
      gate_row[2 * j + e] = gv == kth ? li[qi * k + k - 1] : NO_ROW;
    }
}

// Whether score s at row `row` passes its gate.
__device__ __forceinline__ bool passes(float s, int row, float gate,
                                       int gate_row) {
  return s > gate || (s == gate && row < gate_row);
}

// Push this consumer's candidates of a tile (bits of `todo`: acc[4 j + 2 h
// + e], query 8 j + 2 t + e, row t0 + 16 warp + g + 8 h) into its own
// query buffers; merge them into the CTA's k-lists, under the lists' lock,
// when one overflows or when `flush`, after raising the CTA's copy of the
// shared bound, then reload the gates and push what is still above them. A
// candidate below the k-th entry it meets in the merge is dropped there.
// `merged` tells whether it merged; returns whether the buffers may hold
// candidates. Every thread of the warpgroup calls it.
template <int DM>
__device__ __forceinline__ bool push_merge(
    const float (&acc)[Cfg<DM>::NA], float (&gate)[Cfg<DM>::NA / 2],
    int (&gate_row)[Cfg<DM>::NA / 2], uint32_t todo, bool flush, int t0,
    int nvalid, int k, float* lv,
    int* li, float* cv, int* ci, int* cnt, float* pub, float* bnd,
    float* bound, int* lock, bool& merged, int wg, int warp, int lane) {
  constexpr int NQ = Cfg<DM>::NQ;
  const int g = lane >> 2, t = lane & 3;
  merged = false;
  for (;;) {
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int b = 4 * j + 2 * h + e;
          if (!(todo >> b & 1)) continue;
          const int qi = 8 * j + 2 * t + e;
          const int slot = atomicAdd(&cnt[qi], 1);
          if (slot < CAP) {
            cv[qi * CAP + slot] = acc[b];
            ci[qi * CAP + slot] = t0 + 16 * warp + g + 8 * h;
            todo &= ~(1u << b);
          }
        }
    // this round's pushes complete; what did not fit makes a merge due
    const bool over = bar_any(BAR_WG + wg, 128, todo != 0);
    if (!over && !flush) return true;
    // the lists, for this consumer alone; the bound the other CTAs (and
    // the lists) published, for the next gates
    const int wtid = threadIdx.x % 128;
    if (wtid == 0) {
      while (atomicCAS(lock, 0, 1)) {
      }
      __threadfence_block();
    }
    if (wtid < min(NQ, nvalid))
      atomic_max_f32(&bnd[wtid], __ldcg(bound + wtid));
    bar_sync(BAR_WG + wg, 128);
    merge_buffers(lv, li, cv, ci, cnt, pub, bound, NQ, warp, 4, k, true,
                  lane);
    bar_sync(BAR_WG + wg, 128);  // lists complete: hand them back
    if (wtid == 0) {
      __threadfence_block();
      atomicExch(lock, 0);
    }
    load_gates<DM>(gate, gate_row, lv, li, bnd, k, nvalid, t);
    merged = true;
    flush = false;
    if (!over) return false;
#pragma unroll
    for (int b = 0; b < 2 * NQ / 4; ++b) {  // what the merge left behind
      const int gi = b >> 2 << 1 | (b & 1);
      if (!passes(acc[b], t0 + 16 * warp + g + 8 * (b >> 1 & 1), gate[gi],
                  gate_row[gi]))
        todo &= ~(1u << b);
    }
  }
}

template <int DM>
__global__ void __launch_bounds__(THREADS, 1)
scan_kernel(const float* __restrict__ q, const float* __restrict__ db,
            int bq, int n, int d, int k, int chunk_rows, int stages,
            int n_chunks, float* bound,
            float* __restrict__ part_v, int* __restrict__ part_i) {
  using C = Cfg<DM>;
  constexpr int NQ = C::NQ, NA = C::NA;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // hi [QFLOATS], lo
  float* ring = qs + 2 * C::QFLOATS;            // [stages][R][d]
  float* lv = ring + stages * STAGE_FLOATS;     // [NQ][k]
  int* li = reinterpret_cast<int*>(lv + NQ * k);
  float* cv = reinterpret_cast<float*>(li + NQ * k);  // [2][NQ][CAP]
  int* ci = reinterpret_cast<int*>(cv + CONSUMERS * NQ * CAP);
  int* cnt = ci + CONSUMERS * NQ * CAP;               // [2][NQ]
  float* bnd = reinterpret_cast<float*>(cnt + CONSUMERS * NQ);  // bound
  float* pub = bnd + NQ;                              // last published
  int* lock = reinterpret_cast<int*>(pub + NQ);       // the k-lists
  // a stage's fills, one barrier for each consumer (whose uses of it
  // come in its own order: a parity wait never runs two phases ahead),
  // and its releases, awaited by the producer in order
  uint64_t* full = reinterpret_cast<uint64_t*>(lock + 4);  // [stages][2]
  uint64_t* empty = full + CONSUMERS * stages;              // [stages]

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * NQ;
  const int row_begin = chunk * chunk_rows;
  const int row_end = min(n, row_begin + chunk_rows);
  const int n_tiles =
      row_end > row_begin ? (row_end - row_begin + TILE_ROWS - 1) / TILE_ROWS
                          : 0;

  // the queries, split once; zeros past bq and past d
  for (int e = tid; e < C::QFLOATS; e += THREADS) {
    const int nq = e / DM, p = e % DM;
    const float x =
        q0 + nq < bq && p < d ? q[(size_t)(q0 + nq) * d + p] : 0.f;
    uint32_t hi, lo;
    hi_lo(x, hi, lo);
    const int o = q_offset<NQ>(nq, logical_k(p));
    qs[o] = __uint_as_float(hi);
    qs[C::QFLOATS + o] = __uint_as_float(lo);
  }
  for (int e = tid; e < NQ * k; e += THREADS) {
    lv[e] = NEG;
    li[e] = NO_ROW;
  }
  for (int e = tid; e < CONSUMERS * NQ; e += THREADS) {
    cnt[e] = 0;
    if (e < NQ) bnd[e] = pub[e] = NEG;
  }
  if (tid == 0) {
    *lock = 0;
    for (int s = 0; s < stages; ++s) {
      for (int c = 0; c < CONSUMERS; ++c)
        mbar_init(&full[s * CONSUMERS + c], 1);
      mbar_init(&empty[s], 4 / C::H);  // the consumer's warps on it
    }
    mbar_init_fence();
  }
  fence_proxy_async();  // the split queries, before wgmma reads them
  __syncthreads();

  // roles, warp-uniform as ptxas must see them to give each its registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = __shfl_sync(0xffffffffu, tid / 32 % 4, 0);
  const int lane = tid % 32;
  if (wg == CONSUMERS) {  // the producer: one warp feeds the ring
    regs_dec<PRODUCER_REGS>();
    if (warp == 0 && lane == 0) {
      // one bulk copy a stage: up to R consecutive rows, contiguous in db
      for (int i = 0; i < n_tiles * C::H; ++i) {
        const int s = i % stages, use = i / stages;
        const int r0 = row_begin + i * C::R;
        // a short last tile's second stage may hold no row: then only
        // the arrival completes its phase
        const unsigned bytes = 4u * d * max(0, min(C::R, row_end - r0));
        uint64_t* f = &full[s * CONSUMERS + i / C::H % CONSUMERS];
        if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
        mbar_arrive_expect(f, bytes);
        if (bytes)
          bulk_load(ring + s * STAGE_FLOATS, db + (size_t)r0 * d, bytes, f);
      }
    }
  } else {  // a consumer: the products and the selection of every other tile
    regs_inc<CONSUMER_REGS>();
    const int wtid = tid % 128, g = lane >> 2, t = lane & 3;
    const uint32_t q_hi = smem_addr(qs), q_lo = smem_addr(qs + C::QFLOATS);
    float* wcv = cv + wg * NQ * CAP;  // this consumer's buffers
    int* wci = ci + wg * NQ * CAP;
    int* wcnt = cnt + wg * NQ;
    uint32_t phases = 0;   // parities of this consumer's stage uses
    int since = 0;         // this consumer's tiles since it read the gates
    bool pending = false;  // and whether its buffers may hold candidates
    float gate[NA / 2];
    int gate_row[NA / 2];
    load_gates<DM>(gate, gate_row, lv, li, bnd, k, bq - q0, t);
    for (int tile = wg; tile < n_tiles; tile += CONSUMERS) {
      float acc[NA];
      tile_products<DM>(acc, ring, full, empty, stages, tile * C::H, d,
                        q_hi, q_lo, phases, wg, warp, lane);
      // a tile with no score past its gate has no candidate: the usual
      // case
      const int t0 = row_begin + tile * TILE_ROWS;
      uint32_t todo = 0;  // bit 4 j + 2 h + e: acc[bit] is a candidate
#pragma unroll
      for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = t0 + 16 * warp + g + 8 * h;
            if (passes(acc[4 * j + 2 * h + e], row, gate[2 * j + e],
                       gate_row[2 * j + e]) &&
                row < row_end)
              todo |= 1u << (4 * j + 2 * h + e);
          }
      const bool stale = ++since >= FLUSH;  // merge what waits, or reread
      const bool any = bar_any(BAR_WG + wg, 128, todo != 0);
      bool merged = false;
      if (any || (stale && pending))
        pending = push_merge<DM>(acc, gate, gate_row, todo,
                                 stale && pending, t0,
                                 bq - q0, k, lv, li, wcv, wci, wcnt, pub,
                                 bnd, bound + q0, lock, merged, wg, warp,
                                 lane);
      if (merged || stale) {  // the other consumer's merges too
        if (!merged)
          load_gates<DM>(gate, gate_row, lv, li, bnd, k, bq - q0, t);
        since = 0;
      }
    }
    bar_sync(BAR_DONE, CONSUMERS * 128);  // every tile pushed

    // what the buffers still hold, into the lists (a query's both by the
    // same warp, in turn)
    for (int c = 0; c < CONSUMERS; ++c)
      merge_buffers(lv, li, cv + c * NQ * CAP, ci + c * NQ * CAP,
                    cnt + c * NQ, pub, bound + q0, NQ, wg * 4 + warp,
                    CONSUMERS * 4, k, false, lane);
    bar_sync(BAR_DONE, CONSUMERS * 128);
    for (int e = tid; e < NQ * k; e += CONSUMERS * 128) {
      const int qi = e / k, j = e % k;
      if (q0 + qi < bq) {
        const size_t o = ((size_t)(q0 + qi) * n_chunks + chunk) * k + j;
        part_v[o] = lv[e];
        part_i[o] = li[e];
      }
    }
  }
}

// The scan instance's ring stages and shared memory at k.
template <int DM>
cudaError_t set_smem(int k, int* stages, size_t* smem) {
  *stages = scan_stages<DM>(k);
  if (!*stages) return cudaErrorInvalidValue;
  *smem = scan_smem_bytes<DM>(k, *stages);
  return cudaFuncSetAttribute(scan_kernel<DM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// f(Shape<DM, 16>{}) for the K extent of rows of width d.
template <typename F>
cudaError_t dispatch(int d, F&& f) {
  return mma::with_shape<16, 16>(d, true, f);
}

bool bad_args(int bq, int n, int d, int k, int chunk_rows, int n_chunks) {
  return bq <= 0 || n < 0 || d <= 0 || d % 4 || d > MAX_D || k < 1 ||
         k > MAX_K || chunk_rows <= 0 || chunk_rows % TILE_ROWS ||
         n_chunks != (std::max(n, 1) + chunk_rows - 1) / chunk_rows;
}

}  // namespace

// q (bq, d) f32; db (n, d) f32; bound (bq,) f32, every entry NEG on entry
// (the shared admission bound, raised by the scan); part_v/part_i (bq,
// n_chunks, k) scratch; out_v/out_i (bq, k). d a multiple of 4, at most
// MAX_D; chunk_rows a multiple of 64; q and db 16-byte aligned. Returns a
// CUDA error code, 0 when both launches were accepted.
extern "C" int nafp_topk_f32(const float* q, const float* db, int bq, int n,
                             int d, int k, int chunk_rows, int n_chunks,
                             float* bound, float* part_v, int* part_i,
                             float* out_v, int* out_i, void* stream) {
  if (bad_args(bq, n, d, k, chunk_rows, n_chunks))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear any stale error from earlier work
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dispatch(d, [&](auto sh) {
    using Sh = decltype(sh);
    constexpr int NQ = Cfg<Sh::DM>::NQ;
    int stages;
    size_t smem;
    const cudaError_t e = set_smem<Sh::DM>(k, &stages, &smem);
    if (e != cudaSuccess) return e;
    scan_kernel<Sh::DM><<<dim3(n_chunks, (bq + NQ - 1) / NQ), THREADS, smem,
                          s>>>(q, db, bq, n, d, k, chunk_rows, stages,
                               n_chunks, bound, part_v, part_i);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return (int)err;
  return (int)launch_merge(part_v, part_i, bound, bq, n_chunks * k, k, out_v,
                           out_i, s);
}

// The scan's residency at d and k: info[0] dynamic shared memory per CTA
// in bytes, info[1] the CTAs one SM holds at once, info[2] registers per
// thread at launch, info[3] queries per CTA, info[4] local memory (spills)
// per thread in bytes, info[5] ring stages. Returns a CUDA error code (0
// on success).
extern "C" int nafp_topk_f32_occupancy(int d, int k, int* info) {
  if (bad_args(1, 0, d, k, TILE_ROWS, 1)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(d, [&](auto sh) {
    using Sh = decltype(sh);
    int stages;
    size_t smem;
    cudaError_t err = set_smem<Sh::DM>(k, &stages, &smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, scan_kernel<Sh::DM>);
    if (err != cudaSuccess) return err;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_kernel<Sh::DM>, THREADS, smem);
    if (err != cudaSuccess) return err;
    info[0] = (int)smem;
    info[1] = per_sm;
    info[2] = attr.numRegs;
    info[3] = Cfg<Sh::DM>::NQ;
    info[4] = (int)attr.localSizeBytes;
    info[5] = stages;
    return cudaSuccess;
  });
}

