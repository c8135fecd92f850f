#!/usr/bin/env python
"""Drive the PyTorch port (nafp_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are compiled for sm_90a). It builds the CUDA kernels from the
sources in ``nafp_tpu_torch/csrc/``, then:

1. device: the card's name, count and power limit, the kernel build time;
2. kernels B1 (``topk_ip``), B2 (``topk_ip_sq8``), B3 (``topk_ip_masked``),
   B4a (``run_variant``: v3, v2 and int8) and B4b (``run_dotonly``) against
   their plain PyTorch versions at the main path's shapes and edge cases
   (B1, B2, B3 and B4a also with ties across their chunks, at k up to 128,
   and with B4b at d 256 and d 20; B4a's int8 results equal the plain
   version's exactly), timed with CUDA events beside their bound and a
   one-call PyTorch yardstick (matmul + topk, which the port never calls),
   at k 20 and k 80 for B1, B2 and B3; B4a and B4b also at B2's shape beside
   B2, with their yardsticks there, and v2 against B2 at k 80; each
   launch's shared memory, CTAs per SM, registers and grid; LayerNorm2d's
   kernel pair (``ops/layernorm2d.py``) against its plain version at the
   encoder's 16 norms, batch 640 and 125, bf16 and f32, forward and
   backward, timed at batch 640 beside its byte bound, the plain version
   and the library yardstick (``F.elu`` + ``F.layer_norm`` in f32), and its
   launches in ``640_lamb`` train steps (one a norm each way); LAMB's
   kernel pair (``optim/lamb.py``) against its plain version over 3 steps
   at ``640_lamb``'s 68 leaves in three groups (the parameters', moments'
   and trust ratios' widest gaps, two runs bit for bit, launches a step),
   its kernels' device time beside the byte bound and the plain loop's
   time;
3. the serving path through the CLI at full model width (random weights
   from a seed, written in the Flax layout as ``params.npz``): a seeded
   synthetic corpus -> ``generate`` -> a 619,500-row DB (the 10k-song
   protocol size) -> ``evaluate -i l2``, ``-i sq8``, ``-i ivfpq`` (the
   CLI default) and ``-i ivfpq-rr``; the kernels' launch counters are
   zeroed just before each evaluate and read just after it. Then
   ``-i ivf-sq8 --nprobe 40`` (no hand-written kernel: no launch may be
   counted), its top-1 agreement with ``-i l2`` and a profile, and its
   top-k on 256 protocol queries against the exact top-k over the union of
   each query's probed slices (plain torch ops in f32). Then an
   IVF-PQ store of the same DB, built and persisted on the card: small
   searches on the probe-pruned route timed against the linear scan, and
   B1/B3 timed on the protocol's own query fingerprints against random
   queries;
4. the sq8 kernel bench (``python -m nafp_tpu_torch.extras.
   bench_sq8_kernel``, called through its ``main``) at its default shape,
   N 8,388,608 x 128 int8, Bq 512, k 20, with the launch counters zeroed
   just before and read just after; then B2 (the bench's v0), B4a and B4b
   on the same data against their plain versions, with the plain versions'
   and the yardsticks' times, and what B2 leaves above B4b's floor;
5. the encoder on the card against the port on the CPU (f32), bf16
   against f32 on the card, ``evaluate -i l2`` on the card against the
   same protocol on the CPU (a reduced id set), and the persisted IVF-PQ
   store searched on the card and on the CPU;
6. the device-resident corpus (``DEVICE.DEVICE_CORPUS``): batches
   gathered on the card through ``prefetch``'s thread against the host
   loader's, bit for bit (a bsz-640 train loader with bg, IR and speech, a
   db loader with a short last batch, the ``unseen_syn`` query loader),
   and ``generate`` with it on against phase 3's memmaps;
7. the training path at full width on its own synthetic corpus (120
   training songs): one train step (bsz 8, bg + IR + SpecAugment with
   fixed draws) on the card against the CPU in f32 (loss and every
   gradient leaf) and bf16 against f32 on the card; ``train -c default
   --max_epoch 2`` through the CLI (losses finite and falling, both
   checkpoints, mini-search top-1 logged, step time, segments/s, peak
   memory) and a window of its steps under ``torch.profiler``; the resume
   to epoch 3; ``generate`` + ``evaluate -i l2`` (B1) with the trained
   checkpoint and the untrained init on two query sets of held-out songs
   (the corpus's pairs and ``unseen_syn``): top-1 exact reported, and the
   held-out song-level NT-Xent of generate's fingerprints, which must be
   lower for the trained checkpoint;
   ``640_lamb`` (bsz 640, LAMB) and ``MODEL.BN: batch_norm`` steps on
   device-resident batches, timed with CUDA events; ``640_lamb`` through
   ``cli train`` for one epoch (22 steps) with the host loader and then
   with ``DEVICE_CORPUS`` on, their step times side by side;
8. the measurement entry points at cut sizes, through their ``main``s,
   the kernels' launch counters zeroed just before each and read just
   after: ``nafp_tpu_torch/bench.py`` at full width (segments/s, ``mfu``),
   ``bench_search --suite`` at 2,000,000 rows with hnsw at 20,000 (sq8
   recall 1.0, ivfpq-rr within 0.02 of ivfpq), kernel B1's exact top-1
   over that DB (``--gt device``) against the host's exact top-1,
   ``extras/run_100x_protocol.py`` at 2,000,000 rows for sq8, ivf-sq8
   and ivfpq against host ground truth (planted == exact for >= 99.9 % of
   queries), ``extras/run_100x_sequence.py`` over 2,000 songs x 536
   segments with sq8 (top-1 exact 100 % at every length),
   ``extras/bench_train_step.py -c 640_lamb --steps 10`` (finite loss);
   then B1 and B2 over more than 16,777,216 rows (past 2^31 elements of
   the DB): the planted best row of each query, in the tail, is found,
   and equals the plain version's top-1 over the tail alone;
9. the sharded search and the multi-device paths, on one card: ``evaluate
   -i l2-sharded``, ``-i sq8-sharded`` and ``-i ivf-sq8-sharded`` through
   the CLI (one shard: every local card) with phase 3's stores, their
   raw_score.npy equal to ``-i l2`` / ``sq8`` / ``ivf-sq8``'s (the last on
   the first 500 test ids) and B1's launches the ``-i l2`` run's; the API
   at 4 logical shards on cuda:0 against one shard (B1 and B2 per shard,
   the merge on the card): top-1 equal on every query, scores within
   1e-6, ids equal wherever the k-th gap is clear, IVF-SQ8's top-1 never
   below its probed lists' best row; B1 and B2 on a shard against their
   plain versions; a SQ8FlatIndex store in the sharded index and a sharded
   store in SQ8FlatIndex; ``generate`` with ``MESH_DATA_PARALLEL -1``
   equal to phase 3's memmaps bit for bit; ``cli train -c 640_lamb`` for a
   quarter epoch under a one-rank NCCL group started through ``NAFP_*``,
   its losses within a tolerance fixed from two plain runs;
10. the Online-Triplet path, ``MODEL.ACT_STORE``, IVF-PQ's int8 decode and
   ``dataset2wav``: ``online_triplet_loss`` in its four modes, with and
   without ``use_anc_as_pos`` (24 anchors x 4 replicas, d 128), on the card
   against the CPU in f32 (loss, num_active, distances, both gradients);
   one full-width ``now_playing`` step ('hardest', 2 x 4, fixed draws),
   card against CPU in f32; ``cli train`` of ``now_playing`` with
   ``MINING_MODE hardest`` for one epoch on phase 7's corpus (losses finite,
   step ms, segments/s, peak memory), then ``generate`` + ``evaluate -i
   l2`` (B1) of its checkpoint; ``generate --act_store int8`` and ``fp8``
   over phase 3's corpus against the bf16 memmaps (cosine min and mean,
   ``evaluate -i l2``'s top-1 hits against bf16's) and
   ``extras/bench_quant.py`` through its ``main``; phase 3's IVF-PQ store
   with ``decode_int8``: a decoded chunk equal to the plain decode and the
   CPU's bit for bit, the top-1 of noisy copies of DB rows against the
   exact scan within 0.01 of the f32 decode's, with as many B3 launches;
   ``dataset2wav --split val`` on phase 7's corpus, its WAVs read back
   through ``data/audio_io.py``.

Every phase raises on failure; nothing is caught. The last lines are the
``{"kernels": [...]}`` record, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}``. Work
files go to ``smoke_run/`` beside this script (listed in .gitignore).
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "smoke_run")
# the port's copy of the synthetic-corpus writer (numpy and wave only)
SYNTH = os.path.join(ROOT, "nafp_tpu_torch", "extras", "make_synth_dataset.py")
NAME, INDEX = "smoke", 1
SEED = 0
N_DB_ROWS = 619_500          # dummy_db + db of the 10k-song protocol
SQ8_ROWS = 620_544           # the same DB padded to the sq8 store's 2048
K = 20                       # k_probe of the protocol
N_QUERY, N_DUMMY, SONG_SEC = 100, 200, 30   # synthetic corpus: 23,600 segs
N_TEST = 2000                # test ids of the protocol run
# H100 SXM published peaks (dense): bf16 and int8 tensor cores, HBM3
# bandwidth, and the TF32 tensor cores.
PEAK_BF16, PEAK_INT8, PEAK_BYTES = 989e12, 1979e12, 3.35e12
PEAK_TF32 = 495e12           # B1's 3xTF32 products
SCORE_ATOL = 1e-4            # scores vs plain (tests/test_pallas_topk.py)
# B4b's unscaled sums (|sum| up to ~300; the row scale ~1/127 makes them
# scores): exact bf16 x int8 products summed in f32 in another order
RAW_ATOL = 1e-3
# the sq8 kernel bench's default shape (nafp_tpu_torch/extras/
# bench_sq8_kernel.py), and the row blocks its one-call yardsticks take
# (a (512, 8,388,608) f32 score matrix is 17 GB)
BENCH_N, BENCH_BQ, BENCH_BLK = 8_388_608, 512, 2048
LIB_ROWS = 1 << 20
# B4a's variants as the kernels line names them: merge v3 (B2's insertion),
# v2 (the drain) and int8 products (insertion)
B4A = {"v3": dict(merge_mode="v3"), "v2": dict(merge_mode="v2"),
       "int8": dict(merge_mode="v3", int8_dot=True)}
# int8 queries may flip the top-1 of near-tied rows; the bench's queries sit
# 0.05 away from a picked row, so its top-1 holds
BENCH_INT8_TOP1_MIN = 0.99
ENCODER_ATOL = 1e-4          # f32 card vs f32 CPU, unit-norm embeddings
BF16_COS_MIN = 0.98          # bf16 vs f32 on the card (tests/test_nnfp.py)
# top-1 hits of the int8 scan against the f32 scan (int8 rounding flips only
# near-ties; tests/test_sq8flat.py holds top-1 equal on random queries)
L2_SQ8_AGREE_MIN = 0.99
# card (kernel B1) against the port on the CPU (plain B1) over the same
# memmaps: identical hits up to score near-ties; for IVF-PQ the card
# scores with bf16 queries and the CPU with f32 ones, which can flip
# near-ties too
CARD_CPU_AGREE_MIN = 0.995
# IVF-PQ (kernel B3) store of the protocol DB: nlist 256, each list padded
# to 128-row subtiles, the total to 1024 rows; nprobe 40; k 20, or 80 for
# the ivfpq-rr shortlist
NLIST, LIST_TILE, PQ_BLK, NPROBE = 256, 128, 1024, 40
# B1 and B3 launches per protocol run: 2000 ids in blocks of 128 at lengths
# 1 3 5 9 11 19, query blocks of at most 512 rows, one decode chunk
B1_LAUNCHES_PER_RUN = B3_LAUNCHES_PER_RUN = 235
# ivfpq-rr top-1 agreement with l2 may trail ivfpq's by at most this
# (tests/test_index.py's IVF-PQ recall rule)
RR_AGREE_SLACK = 0.02
# row widths off the main path that B3 and B4b also take: 256 (their second
# K extent) and 20 (a multiple of 4 only: narrower cp.async copies)
OTHER_D = (256, 20)
# rows of one chunk of the --gt device pass (extras/run_100x_protocol.py)
GT_CHUNK_ROWS = 2_097_152
# Phase 7, the training path: its own synthetic corpus (120 train songs of
# SONG_SEC s, 30 validation songs, 20 query/db pairs, 20 dummy songs)
TRAIN_SONGS, TRAIN_QUERY, TRAIN_DUMMY = 120, 20, 20
TRAIN_NAME = "smoke_train"
# one f32 step, card (TF32 off) vs CPU: products and sums in other orders
# through 16 convolutions, the norms and tau 0.05
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3        # per gradient leaf, in Frobenius norm
# bf16 vs f32 loss of the same step on the card: bf16 convolution and
# DivEnc operands (<= 0.42 % at narrower widths on the CPU's emulation)
BF16_LOSS_RTOL = 2e-2
PROFILE_STEPS = 20
# DB rows of phase 7's evaluate: the generated dummy and db rows, then
# random unit rows, past FlatIndex.PALLAS_MIN_ROWS so l2 takes B1
TRAIN_DB_ROWS = 60_000
# seeded batches (one random segment per held-out song) of the served
# checkpoints' song-level NT-Xent
SERVE_LOSS_BATCHES = 50
LAMB_STEPS, BN_STEPS = 30, 5
# protocol queries whose IVF-SQ8 top-k is held against the exact top-k over
# the union of their probed slices
IVFSQ8_GATE_QUERIES = 256
# generate with DEVICE_CORPUS on against off: the same waveforms, so the
# same fingerprints up to the card's run-to-run variation
DEVICE_CORPUS_ATOL = 2e-5
# Phase 8, the measurement entry points at cut sizes: the suite's and the
# 100x protocol's DB (the JAX suite's own 2 M rows), hnsw's rows, the
# sequence runner's dummy songs (x 536 segments)
SUITE_N, SUITE_HNSW_N, SEQ_SONGS = 2_000_000, 20_000, 2_000
# planted == exact top-1 share of the protocol's noisy-copy queries
PLANTED_AGREE_MIN = 0.999
# B1's exact top-1 may differ from the host sgemm's only where the host's
# top-2 scores are this close
GT_GAP_MIN = 1e-6
# rows past 2^31 / 128: a DB whose byte (f32) and element (int8) offsets
# pass 2^31; the best rows are planted past PLANT_FROM
PLANT_ROWS, PLANT_FROM = 17_301_504, 1 << 24
# Phase 9, sharded search and the multi-device paths on one card: logical
# shards of the protocol DB on cuda:0, and the protocol queries the API's
# searches take
SHARDS, SHARD_QUERIES = 4, 1024
# R shards against one: the same scores, and the same ids wherever the
# k-th and (k+1)-th scores lie further apart than this
SHARD_SCORE_ATOL = SHARD_GAP = 1e-6
# test ids of the ivf-sq8-sharded evaluate: the first of phase 3's 2,000
# (one permutation), so its raw_score.npy rows are phase 3's first rows
IVF_SHARDED_TEST = 500
# cli train -c 640_lamb under a one-rank NCCL group: a quarter of the epoch
NCCL_TRAIN_REDUCE_P = 25
# the group's epoch losses within NCCL_LOSS_SPREAD x the spread of two
# plain runs in the same call (cuDNN's backward is not deterministic), plus
# a relative floor for a spread of 0
NCCL_LOSS_SPREAD, NCCL_LOSS_FLOOR = 4.0, 1e-5
# Phase 10, the Online-Triplet path: the loss at the now_playing layout (24
# anchors x 4 replicas, d 128), card (TF32 off) vs CPU in f32: sums in other
# orders (tests/test_torch_triplet.py's tolerances); the identity block of
# use_anc_as_pos is sqrt(max(2(1 - a·a), 0) + EPS) of each device's own f32
# a·a, between sqrt(EPS) and TRIPLET_IDENTITY_MAX, and read by nothing
TRIPLET_A, TRIPLET_P, TRIPLET_D = 24, 4, 128
TRIPLET_LOSS_RTOL, TRIPLET_DIST_ATOL, TRIPLET_GRAD_ATOL = 1e-5, 1e-6, 1e-5
TRIPLET_IDENTITY_MAX = (2 * 16 * 2.0 ** -24 + 1e-9) ** 0.5
TRIPLET_NAME = "smoke_triplet"
# ACT_STORE's fingerprints against bf16's over phase 3's corpus (the JAX
# package's on a TPU v5e: int8 cosine min .9907 / mean .9946, fp8 .9799 /
# .9887); every memmap must differ from bf16's (an inactive store gives
# bf16's bytes). The top-1 hits of its evaluate -i l2 against bf16's are
# printed: phase 3's random-weight fingerprints lie so close together that
# a 1 % perturbation moves which queries hit.
# LayerNorm2d's kernel pair against its plain version (phase 2): batch 640
# (the train step) and 125 (generate); y within 1 bf16 ulp (the f32
# statistics differ in their last bits) and dx within 2 (rounded twice:
# after the f32 gradient and after ELU's derivative), f32 y within 1e-5 and
# dx within 1e-4 of the largest |value| (their sums over up to 524,288
# elements run in other orders); dgamma and dbeta within 1e-4 of the sum of
# |terms| of an f64 sum (an f32 sum over up to 640 samples)
LN2D_ROWS = (640, 125)
LN2D_Y_GAP = {"torch.bfloat16": 1.0, "torch.float32": 1e-5}
LN2D_DX_GAP = {"torch.bfloat16": 2.0, "torch.float32": 1e-4}
LN2D_PARAM_GAP = 1e-4
# LAMB's kernel pair against its plain version (phase 2) at 640_lamb's 68
# leaves over LAMB_STEPS steps from seeded weights and gradients (one group
# as the preset has, then a wd-0 group and one without adaptation): the
# parameters and moments within LAMB_RTOL of each leaf's largest |value|
# (f32 operations rounded once each on both sides, but the plain adds may
# fuse into FMAs and the norms sum in other orders); the parameters' change
# within LAMB_CHANGE_RTOL of its norm (each side rounds p + change to f32:
# half an ulp of a LayerNorm scale near 1 is ~6e-8 against a change of
# ~1e-3 an element at lr 1e-3); each step's trust ratio, the kernels'
# ||change|| / (lr·||u||) against the plain version's, both in f64, within
# LAMB_RATIO_RTOL (that change carries p's rounding too: at a 128-element
# leaf of ratio ~1e-3 it moves the reading by ~1e-5); two runs bit for bit;
# two launches a step
LAMB_STEPS, LAMB_LR = 3, 1e-3
LAMB_RTOL, LAMB_CHANGE_RTOL, LAMB_RATIO_RTOL = 1e-6, 1e-4, 1e-4
LAMB_BYTES_PER_PARAM = 28     # p, g, m, v read; p, m, v written (f32)
ACT_COS_MIN = {"int8": 0.98, "fp8": 0.97}
ACT_COS_MEAN = {"int8": 0.99, "fp8": 0.98}
# ACT_STORE's top-1 against bf16's on the now_playing checkpoint's rows:
# ACT_QUERIES noisy copies of its bf16 rows at each noise of ACT_NOISES (per
# dimension), exact search (B1) over its bf16 rows and over its ACT_STORE
# rows. The synthetic songs are stationary tones, so a song's segments are
# near-duplicates (nearest-neighbour cosine 0.9997 on the card) while songs
# lie apart (mean cosine 0.14): which segment comes first is not clear, the
# song is. The top-1 row's song must equal bf16's on ACT_TOP1_MIN of the
# queries at ACT_GATE_NOISE.
ACT_QUERIES, ACT_NOISES, ACT_GATE_NOISE = 2048, (0.002, 0.01, 0.05), 0.01
ACT_TOP1_MIN = 0.95
# IVF-PQ's int8 decode: noisy-copy queries searched, and its top-1
# agreement with the exact scan within this of the f32 decode's
PQ_INT8_QUERIES, PQ_INT8_AGREE_SLACK = 2048, 0.01



def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def check_topk(tag, v, i, pv, pi, score_at):
    """Kernel (v, i) against plain (pv, pi): -1 at the same slots; on the
    other slots, scores within SCORE_ATOL, the scores recomputed (f64) at
    the kernel's ids equal to the plain scores, and descending order.
    Values at -1 slots (<= NEG/2) are not compared. Returns the max abs
    error."""
    import torch
    torch.cuda.synchronize()
    if not torch.equal(i < 0, pi < 0):
        raise AssertionError(f"{tag}: -1 slots differ from the plain version")
    ok = pi >= 0
    if not ok.any():
        log(f"  {tag}: every slot -1 in both")
        return 0.0
    err = (v - pv).abs()[ok].max().item()
    at = score_at(i.clamp(min=0).long())
    err_at = (at - pv.double()).abs()[ok].max().item()
    if not (err <= SCORE_ATOL and err_at <= SCORE_ATOL):
        raise AssertionError(f"{tag}: |kernel - plain| {err}, at the "
                             f"kernel's ids {err_at}")
    vv = torch.where(ok, v, float("-inf"))
    if not bool((vv[:, :-1] >= vv[:, 1:]).all()):
        raise AssertionError(f"{tag}: scores not sorted descending")
    log(f"  {tag}: max|kernel-plain| {err:.3e}, at ids {err_at:.3e}, "
        f"ids equal {float((i == pi).float().mean()):.4f}, "
        f"-1 slots {int((i < 0).sum())}")
    return max(err, err_at)


def check_twins(tag, i, offset):
    """Rows r and r + offset repeat each other: wherever the kernel
    returns r + offset it must return r too (the lower row wins the
    tie)."""
    high = i >= offset
    has_twin = ((i - offset)[:, :, None] == i[:, None, :]).any(2)
    if not bool(has_twin[high].all()):
        raise AssertionError(f"{tag}: a higher twin row was returned "
                             "without the lower one")
    log(f"  {tag}: {int(high.sum())} higher twins returned, each with its "
        "lower twin")


def sq8_store(x, gen, dead_share):
    """An sq8 store of rows x: int8 rows quantised per row, and a
    dead_share of them tombstoned (scale 0, mask NEG)."""
    import torch
    from nafp_tpu_torch.search.topk import NEG
    v8, sc = quantize(x)
    dead = torch.rand(len(x), generator=gen, device=x.device) < dead_share
    return (v8, torch.where(dead, 0.0, sc).contiguous(),
            torch.where(dead, NEG, 0.0).to(torch.float32).contiguous())


def scan_residency(lib, bq, n, d, k, *flags):
    """Shared memory per CTA, CTAs per SM, registers and grid of the scan
    instance that library ``lib``'s wrapper launches for (bq, n, d, k) in
    one wave (B1 "topk_f32", B2 "topk_sq8", B4a "bench_variant" with flags
    int8_dot, drain)."""
    import torch
    from nafp_tpu_torch import kernels
    from nafp_tpu_torch.search import topk as T
    b1 = lib == "topk_f32"
    info = kernels.occupancy(lib, d, k, *flags, n_out=6 if b1 else 3)
    smem, per_sm, regs = info[:3]
    qb = info[3] if b1 else T.QB
    sms = T._sm_count(torch.device("cuda", 0))
    n_chunks = T._plan_chunks(bq, n, sms, per_sm, qb)[1]
    r = dict(smem=smem, ctas_per_sm=per_sm, regs=regs,
             grid=n_chunks * -(-bq // qb))
    if b1:   # queries per CTA, spilled bytes per thread, ring stages
        r.update(queries_per_cta=qb, local_bytes=info[4], stages=info[5])
    return r


def log_residency(tag, r):
    more = "".join(f", {r[key]} {what}" for key, what in (
        ("queries_per_cta", "queries per CTA"),
        ("local_bytes", "B local memory (spills) per thread"),
        ("stages", "ring stages")) if key in r)
    log(f"    residency {tag}: {r['smem']} B shared memory per CTA, "
        f"{r['ctas_per_sm']} CTAs per SM, {r['regs']} registers, "
        f"{r['grid']} CTAs in the grid{more}")


def unit_rows(n, d, gen, device):
    import torch
    x = torch.randn(n, d, generator=gen, device=device)
    return x / x.norm(dim=1, keepdim=True)


def quantize(x):
    import torch
    sc = x.abs().amax(dim=1).clamp(min=1e-12) / 127.0
    q8 = torch.clamp(torch.round(x / sc[:, None]), -127, 127).to(torch.int8)
    return q8.contiguous(), sc.contiguous()


def phase_kernels(dev):
    import torch
    from nafp_tpu_torch.search import topk as T

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rec = {}

    # --- B1 --------------------------------------------------------------
    db = unit_rows(N_DB_ROWS, 128, gen, dev)
    errs = []

    def b1_check(tag, q, dbx, k, twin_offset=0):
        v, i = T.topk_ip(q, dbx, k)
        pv, pi = T.topk_ip_plain(q, dbx, k)
        if twin_offset:
            check_twins(tag, i, twin_offset)
        return check_topk(tag, v, i, pv, pi, lambda ids: torch.einsum(
            "bd,bkd->bk", q.double(), dbx.double()[ids]))

    # the main shape at k 20 / 80 / 128, and a ragged query block
    for bq, k in ((128, K), (512, K), (512, 4 * K), (512, 128), (300, 4 * K)):
        errs.append(b1_check(f"B1 Bq={bq} k={k} N={N_DB_ROWS}",
                             unit_rows(bq, 128, gen, dev), db, k))
    errs.append(b1_check("B1 Bq=1", unit_rows(1, 128, gen, dev), db, K))
    # every score negative at the main shape: negative queries against the
    # rows' absolute values
    errs.append(b1_check(f"B1 all-negative Bq=512 k={4 * K} N={N_DB_ROWS}",
                         -unit_rows(512, 128, gen, dev).abs(), db.abs(),
                         4 * K))
    errs.append(b1_check("B1 k>N", unit_rows(9, 128, gen, dev),
                         unit_rows(30, 128, gen, dev), 50))
    # query blocks around the CTA's query tile, and the sizes the protocol
    # sends (1-segment blocks of 128, 384, 512)
    for bq in (63, 65, 384):
        errs.append(b1_check(f"B1 Bq={bq} k={K} N={N_DB_ROWS}",
                             unit_rows(bq, 128, gen, dev), db, K))
    # a padded block, as the index sends a multi-block search's last one:
    # zero queries tie every row, and the lowest rows win
    padded = torch.cat([unit_rows(129, 128, gen, dev),
                        torch.zeros(383, 128, device=dev)])
    errs.append(b1_check(f"B1 padded Bq=512 (383 zero) k={K} N={N_DB_ROWS}",
                         padded, db, K))
    if not bool((T.topk_ip(padded, db, K)[1][129:].long()
                 == torch.arange(K, device=dev)).all()):
        raise AssertionError("B1: a zero query did not return rows 0..k-1")
    # ties across chunks: rows 32,768 apart repeat each other (other
    # chunks), and equal scores meet the shared bound
    half = unit_rows(32_768, 128, gen, dev)
    twin = torch.cat([half, half])
    for bq, k in ((128, 4 * K), (512, 41)):
        errs.append(b1_check(f"B1 ties across chunks Bq={bq} k={k} N=65536",
                             unit_rows(bq, 128, gen, dev), twin, k,
                             twin_offset=len(half)))
    del half, twin
    # the other row widths: K extent 256, and d 20
    for d, bq, k in ((OTHER_D[0], 200, 4 * K), (OTHER_D[1], 64, 128)):
        errs.append(b1_check(f"B1 d={d} Bq={bq} k={k} N=65536",
                             unit_rows(bq, d, gen, dev),
                             unit_rows(65_536, d, gen, dev), k))
        log_residency(f"B1 d {d} k {k}",
                      scan_residency("topk_f32", bq, 65_536, d, k))
    q = unit_rows(512, 128, gen, dev)
    ms = time_ms(lambda: T.topk_ip(q, db, K), 20)
    ms80 = time_ms(lambda: T.topk_ip(q, db, 4 * K), 20)
    ms_bq = {bq: time_ms(lambda: T.topk_ip(q[:bq], db, K), 20)
             for bq in (128, 384)}
    ms_padded = time_ms(lambda: T.topk_ip(padded, db, K), 20)
    plain_ms = time_ms(lambda: T.topk_ip_plain(q, db, K), 5)
    lib_ms, lib_ms_k80 = (time_ms(lambda: torch.topk(
        torch.matmul(q, db.T), k, dim=1), 10) for k in (K, 4 * K))
    # 3xTF32: three TF32 products for each f32 one
    flops = 3 * 2.0 * 512 * N_DB_ROWS * 128
    nbytes = 4.0 * (N_DB_ROWS * 128 + 512 * 128) + 8.0 * 512 * K
    bound = max(flops / PEAK_TF32, nbytes / PEAK_BYTES) * 1e3
    residency = {f"k{k}": scan_residency("topk_f32", 512, N_DB_ROWS, 128, k)
                 for k in (K, 4 * K, 128)}
    for k, r in residency.items():
        log_residency(f"B1 {k}", r)
    rec["topk_ip"] = dict(
        name="topk_ip (B1)", route="cuda",
        source="nafp_tpu_torch/csrc/topk_f32.cu",
        replaces="nafp_tpu/search/pallas_topk.py:247 (topk_ip_pallas)",
        max_abs_err=max(errs), ms=ms, ms_k80=ms80, plain_ms=plain_ms,
        bound_ms=bound, bound_by="operations (3xTF32)"
        if flops / PEAK_TF32 >= nbytes / PEAK_BYTES else "bytes",
        library_ms=lib_ms, library_ms_k80=lib_ms_k80,
        tf32_tflops=flops / ms / 1e9, residency=residency,
        shape="Bq 512, N 619500, d 128, k 20",
        ms_bq128=ms_bq[128], ms_bq384=ms_bq[384], ms_padded=ms_padded)
    log(f"  B1 @ Bq 512: kernel {ms:.3f} ms (k {K}), {ms80:.3f} ms (k "
        f"{4 * K}), plain {plain_ms:.3f} ms, matmul+topk {lib_ms:.3f} ms "
        f"({lib_ms_k80:.3f} ms at k {4 * K}), bound {bound:.3f} ms, "
        f"{flops / ms / 1e9:.1f} TFLOP/s of TF32; Bq 128 {ms_bq[128]:.3f} "
        f"ms, Bq 384 {ms_bq[384]:.3f} ms, padded Bq 512 {ms_padded:.3f} ms")
    del db, padded
    # one 2,097,152-row chunk of the --gt device pass over the 53.6 M store
    # (extras/run_100x_protocol.py), at its k 1 and at the protocol's k
    big = unit_rows(GT_CHUNK_ROWS, 128, gen, dev)
    for k in (1, K):
        errs.append(b1_check(f"B1 Bq=512 k={k} N={GT_CHUNK_ROWS}", q, big,
                             k))
    gt_ms = {k: time_ms(lambda: T.topk_ip(q, big, k), 10) for k in (1, K)}
    gt_bound = 3 * 2.0 * 512 * GT_CHUNK_ROWS * 128 / PEAK_TF32 * 1e3
    rec["topk_ip"].update(gt_chunk_ms_k1=gt_ms[1], gt_chunk_ms_k20=gt_ms[K],
                          gt_chunk_bound_ms=gt_bound,
                          max_abs_err=max(errs))
    log_residency(f"B1 {GT_CHUNK_ROWS} rows k{K}",
                  scan_residency("topk_f32", 512, GT_CHUNK_ROWS, 128, K))
    log(f"  B1 @ Bq 512 x {GT_CHUNK_ROWS}: {gt_ms[1]:.3f} ms (k 1), "
        f"{gt_ms[K]:.3f} ms (k {K}), bound {gt_bound:.3f} ms")
    del big

    # --- B2 --------------------------------------------------------------
    x = unit_rows(SQ8_ROWS, 128, gen, dev)
    vecs8, scales = quantize(x)
    del x
    tomb = torch.rand(SQ8_ROWS, generator=gen, device=dev) < 0.01
    tomb[N_DB_ROWS:] = True                 # pad rows past the DB
    rmask = torch.where(tomb, T.NEG, 0.0).to(torch.float32).contiguous()
    scales = torch.where(tomb, 0.0, scales).contiguous()
    errs = []

    def b2_check(tag, q, v8, sc, rm, k, twin_offset=0):
        v, i = T.topk_ip_sq8(q, v8, sc, rm, k)
        pv, pi = T.topk_ip_sq8_plain(q, v8, sc, rm, k,
                                     compute_dtype=torch.bfloat16)
        if bool(((rm[i.clamp(min=0).long()] < 0) & (i >= 0)).any()):
            raise AssertionError(f"{tag}: a masked row was returned")
        if twin_offset:
            check_twins(tag, i, twin_offset)
        qb = q.to(torch.bfloat16).double()
        return check_topk(tag, v, i, pv, pi, lambda ids: torch.einsum(
            "bd,bkd->bk", qb, v8.double()[ids]) * sc.double()[ids]
            + rm.double()[ids])

    for bq, k in ((128, K), (1024, K), (1024, 4 * K), (512, 128)):
        errs.append(b2_check(f"B2 Bq={bq} k={k} N={SQ8_ROWS} (1% "
                             "tombstones)", unit_rows(bq, 128, gen, dev),
                             vecs8, scales, rmask, k))
    errs.append(b2_check("B2 Bq=1", unit_rows(1, 128, gen, dev), vecs8,
                         scales, rmask, K))
    # every score negative at the main shape: negative queries against the
    # rows' absolute values
    errs.append(b2_check(f"B2 all-negative Bq=256 k={4 * K} N={SQ8_ROWS}",
                         -unit_rows(256, 128, gen, dev).abs(), vecs8.abs(),
                         scales, rmask, 4 * K))
    small8, small_sc = quantize(unit_rows(40, 128, gen, dev).abs())
    small_rm = torch.zeros(40, device=dev)
    small_rm[::3] = T.NEG
    errs.append(b2_check("B2 all-negative, k>N",
                         -unit_rows(5, 128, gen, dev).abs(), small8,
                         torch.where(small_rm < 0, 0.0, small_sc).contiguous(),
                         small_rm.contiguous(), 48))
    # ties across chunks: rows 32,768 apart repeat each other (other
    # chunks), and equal scores meet the shared bound
    half = unit_rows(32_768, 128, gen, dev)
    tw8, tw_sc, tw_rm = sq8_store(torch.cat([half, half]), gen, 0.0)
    for bq, k in ((128, 4 * K), (512, 41)):
        errs.append(b2_check(f"B2 ties across chunks Bq={bq} k={k} N=65536",
                             unit_rows(bq, 128, gen, dev), tw8, tw_sc, tw_rm,
                             k, twin_offset=len(half)))
    del half
    # the other row widths: 65,536 rows, 5% tombstones
    for d, bq, k in ((OTHER_D[0], 200, 4 * K), (OTHER_D[1], 64, 128)):
        errs.append(b2_check(f"B2 d={d} Bq={bq} k={k} N=65536",
                             unit_rows(bq, d, gen, dev),
                             *sq8_store(unit_rows(65_536, d, gen, dev), gen,
                                        0.05), k))
        log_residency(f"B2 d {d} k {k}",
                      scan_residency("topk_sq8", bq, 65_536, d, k))
    q = unit_rows(1024, 128, gen, dev)
    ms = time_ms(lambda: T.topk_ip_sq8(q, vecs8, scales, rmask, K), 20)
    plain_ms = time_ms(lambda: T.topk_ip_sq8_plain(
        q, vecs8, scales, rmask, K, compute_dtype=torch.bfloat16), 5)
    v16 = vecs8.to(torch.bfloat16)
    q16 = q.to(torch.bfloat16)
    lib_ms, lib_ms_k80 = (time_ms(lambda: torch.topk(
        torch.matmul(q16, v16.T).float() * scales + rmask, k, dim=1), 10)
        for k in (K, 4 * K))
    flops = 2.0 * 1024 * SQ8_ROWS * 128
    nbytes = (SQ8_ROWS * 128 + 8.0 * SQ8_ROWS + 4.0 * 1024 * 128
              + 8.0 * 1024 * K)
    bound = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    residency = {f"k{k}": scan_residency("topk_sq8", 1024, SQ8_ROWS, 128, k)
                 for k in (K, 4 * K, 128)}
    for k, r in residency.items():
        log_residency(f"B2 {k}", r)
    rec["topk_ip_sq8"] = dict(
        name="topk_ip_sq8 (B2)", route="cuda",
        source="nafp_tpu_torch/csrc/topk_sq8.cu",
        replaces="nafp_tpu/search/pallas_topk.py:306 (topk_ip_sq8_pallas)",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES
        else "bytes", library_ms=lib_ms, library_ms_k80=lib_ms_k80,
        residency=residency, shape="Bq 1024, N 620544, d 128, k 20")
    log(f"  B2 @ Bq 1024: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bf16 matmul+topk {lib_ms:.3f} ms ({lib_ms_k80:.3f} ms at k "
        f"{4 * K}), bound {bound:.3f} ms")
    del q16
    rec["b4"] = phase_kernel_b4(dev, gen, vecs8, v16, scales, rmask)
    del v16
    del vecs8, scales, rmask

    rec["topk_ip_masked"] = phase_kernel_b3(dev, gen)
    return rec


def b4a_score_at(q, v8, sc, rm, int8_dot):
    """score_at for check_topk: B4a's scores recomputed in f64 at given
    ids, from the bf16-rounded queries or the int8 ones and their scale."""
    import torch
    from nafp_tpu_torch.extras import bench_sq8_kernel as B
    if int8_dot:
        q8, qs = B.quantize_queries(q)
        qd, qscale = q8.double(), qs.double()[:, None]
    else:
        qd, qscale = q.to(torch.bfloat16).double(), 1.0
    return lambda ids: (torch.einsum("bd,bkd->bk", qd, v8.double()[ids])
                        * sc.double()[ids] + rm.double()[ids]) * qscale


def check_b4a(tag, name, q, v8, sc, rm, k, blk=2048, twin_offset=0):
    """Kernel B4a's variant ``name`` against its plain version with bf16
    queries (the kernel's numerics); a masked row returned fails. The int8
    variant's sums are exact: its scores and ids must equal the plain
    version's."""
    import torch
    from nafp_tpu_torch.extras import bench_sq8_kernel as B
    int8_dot = B4A[name].get("int8_dot", False)
    v, i = B.run_variant(q, v8, sc, rm, k=k, blk=blk, **B4A[name])
    pv, pi = B.run_variant_plain(q, v8, sc, rm, k, int8_dot=int8_dot,
                                 compute_dtype=torch.bfloat16)
    if bool(((rm[i.clamp(min=0).long()] < 0) & (i >= 0)).any()):
        raise AssertionError(f"{tag}: a masked row was returned")
    if int8_dot and not (torch.equal(v, pv) and torch.equal(i, pi)):
        raise AssertionError(f"{tag}: int8 results differ from the plain "
                             "version's")
    if twin_offset:
        check_twins(tag, i, twin_offset)
    return check_topk(tag, v, i, pv, pi,
                      b4a_score_at(q, v8, sc, rm, int8_dot))


def check_b4b(tag, q, v8, blk):
    """Kernel B4b's per-block maxima against its plain version (bf16 q),
    and its default result, the last block's column."""
    import torch
    from nafp_tpu_torch.extras import bench_sq8_kernel as B
    none = torch.empty(0, device=q.device)
    got = B.run_dotonly(q, v8, none, none, blk=blk, all_blocks=True)
    want = B.run_dotonly_plain(q, v8, blk)
    err = (got - want).abs().max().item()
    if not err <= RAW_ATOL:
        raise AssertionError(f"{tag}: |kernel - plain| {err} > {RAW_ATOL}")
    if not torch.equal(B.run_dotonly(q, v8, none, none, blk=blk),
                       got[:, -1:]):
        raise AssertionError(f"{tag}: the last block's column differs")
    log(f"  {tag}: max|kernel-plain| {err:.3e} over {got.numel()} block "
        "maxima")
    return err


def phase_kernel_b4(dev, gen, vecs8, v16, scales, rmask):
    """B4a (v3, v2, int8) and B4b on B2's store (the main path's sq8 shape,
    1 % tombstones) against their plain versions, with edge cases; then
    timed beside B2 at B2's main shape (Bq 1024, k 20), each with its
    one-call yardstick there, and v2 against B2 at k 80. B4b is the
    tensor-core floor: (B2 - B4b) / B2 is what B2 leaves above it. Each
    launch's shared memory, CTAs per SM, registers and grid are logged."""
    import torch
    from nafp_tpu_torch import kernels
    from nafp_tpu_torch.extras import bench_sq8_kernel as B
    from nafp_tpu_torch.search import topk as T

    errs = {name: [] for name in (*B4A, "dotonly")}
    for bq in (128, 512):
        q = unit_rows(bq, 128, gen, dev)
        for name in B4A:
            errs[name].append(check_b4a(
                f"B4a {name} Bq={bq} N={SQ8_ROWS} (1% tombstones)", name, q,
                vecs8, scales, rmask, K))
    for k in (4 * K, 128):
        q = unit_rows(512, 128, gen, dev)
        for name in B4A:
            errs[name].append(check_b4a(f"B4a {name} Bq=512 k={k}", name, q,
                                        vecs8, scales, rmask, k))
    neg_q = -unit_rows(256, 128, gen, dev).abs()
    for name in B4A:
        errs[name].append(check_b4a(
            f"B4a {name} all-negative Bq=256 k={4 * K} N={SQ8_ROWS}", name,
            neg_q, vecs8.abs(), scales, rmask, 4 * K))
    # ties across chunks: rows 32,768 apart repeat each other
    half = unit_rows(32_768, 128, gen, dev)
    tw = sq8_store(torch.cat([half, half]), gen, 0.0)
    for name in B4A:
        errs[name].append(check_b4a(
            f"B4a {name} ties across chunks Bq=128 k={4 * K} N=65536", name,
            unit_rows(128, 128, gen, dev), *tw, 4 * K,
            twin_offset=len(half)))
    del half, tw
    # the other row widths (int8 queries: d a multiple of 16)
    for d, bq, k in ((OTHER_D[0], 200, 4 * K), (OTHER_D[1], 64, 128),
                     (16, 64, 128)):
        store = sq8_store(unit_rows(65_536, d, gen, dev), gen, 0.05)
        q = unit_rows(bq, d, gen, dev)
        for name, kw in B4A.items():
            if d % 16 and kw.get("int8_dot", False):
                continue
            if d == 16 and not kw.get("int8_dot", False):
                continue
            errs[name].append(check_b4a(f"B4a {name} d={d} Bq={bq} k={k} "
                                        "N=65536", name, q, *store, k))
            log_residency(f"B4a {name} d {d} k {k}", scan_residency(
                "bench_variant", bq, 65_536, d, k,
                int(kw.get("int8_dot", False)), int(name == "v2")))
    q1 = unit_rows(1, 128, gen, dev)
    for name in B4A:
        errs[name].append(check_b4a(f"B4a {name} Bq=1", name, q1, vecs8,
                                    scales, rmask, K))
    # all-negative scores and k larger than the valid rows: 30 valid of 256
    small8, small_sc = quantize(unit_rows(256, 128, gen, dev).abs())
    small_rm = torch.full((256,), T.NEG, device=dev)
    small_rm[torch.randperm(256, generator=gen, device=dev)[:30]] = 0.0
    small_sc = torch.where(small_rm < 0, 0.0, small_sc).contiguous()
    neg_q = -unit_rows(5, 128, gen, dev).abs()
    for name in B4A:
        errs[name].append(check_b4a(
            f"B4a {name} all-negative, k 48 > 30 valid rows", name, neg_q,
            small8, small_sc, small_rm.contiguous(), 48, blk=128))
    for bq, blk in ((512, 2048), (1, 2048), (300, 128)):
        errs["dotonly"].append(check_b4b(
            f"B4b Bq={bq} N={SQ8_ROWS} blk {blk}",
            unit_rows(bq, 128, gen, dev), vecs8, blk))
    for d in OTHER_D:
        v8d, _ = quantize(unit_rows(65_536, d, gen, dev))
        errs["dotonly"].append(check_b4b(
            f"B4b d={d} Bq=300 N=65536 blk 128", unit_rows(300, d, gen, dev),
            v8d, 128))
        occ = kernels.occupancy("bench_dotonly", 300, 65_536, d, 128,
                                n_out=4)
        log(f"    residency B4b d {d}: {occ[0]} B shared memory per CTA, "
            f"{occ[1]} CTAs per SM, {occ[2]} registers, {occ[3]} CTAs")

    # B2's main shape, in turns with B2, then the yardsticks
    q = unit_rows(1024, 128, gen, dev)
    q16 = q.to(torch.bfloat16)
    ms = {"b2": time_ms(lambda: T.topk_ip_sq8(q, vecs8, scales, rmask, K),
                        20)}
    for name, kw in B4A.items():
        ms[name] = time_ms(lambda: B.run_variant(q, vecs8, scales, rmask,
                                                 k=K, **kw), 20)
    ms["dotonly"] = time_ms(lambda: B.run_dotonly(q, vecs8, scales, rmask),
                            20)
    ms["b2_again"] = time_ms(lambda: T.topk_ip_sq8(q, vecs8, scales, rmask,
                                                   K), 20)
    ms["b2_k80"] = time_ms(lambda: T.topk_ip_sq8(q, vecs8, scales, rmask,
                                                 4 * K), 10)
    ms["v2_k80"] = time_ms(lambda: B.run_variant(
        q, vecs8, scales, rmask, k=4 * K, merge_mode="v2"), 10)
    lib = {"v3": time_ms(lambda: lib_sq8_topk(q16, v16, scales, rmask, K,
                                              False), 10),
           "int8": time_ms(lambda: lib_sq8_topk(q, vecs8, scales, rmask, K,
                                                True), 10),
           "v2_k80": time_ms(lambda: lib_sq8_topk(q16, v16, scales, rmask,
                                                  4 * K, False), 10),
           "dotonly": time_ms(lambda: lib_block_max(q16, v16, 2048), 10)}
    lib["v2"] = lib["v3"]      # the same function
    keys = ("smem", "ctas_per_sm", "regs", "grid")
    res = {"b4b": dict(zip(keys, kernels.occupancy(
        "bench_dotonly", 1024, SQ8_ROWS, 128, 2048, n_out=4)))}
    for name, kw in B4A.items():
        flags = (int(kw.get("int8_dot", False)), int(name == "v2"))
        for k in (K, 4 * K):
            res[f"b4a_{name}_k{k}"] = scan_residency(
                "bench_variant", 1024, SQ8_ROWS, 128, k, *flags)
    b2, b2_80 = min(ms["b2"], ms["b2_again"]), ms["b2_k80"]
    share = {"k20": (b2 - ms["dotonly"]) / b2,
             "k80": (b2_80 - ms["dotonly"]) / b2_80}
    log(f"  B2 shape (Bq 1024, N {SQ8_ROWS}): B2 {ms['b2']:.3f} / "
        f"{ms['b2_again']:.3f} ms, B4a v3 {ms['v3']:.3f}, v2 {ms['v2']:.3f}, "
        f"int8 {ms['int8']:.3f}, B4b {ms['dotonly']:.3f} ms; k 80: B2 "
        f"{ms['b2_k80']:.3f}, v2 {ms['v2_k80']:.3f} ms")
    log(f"  yardsticks there: bf16 matmul+scale+mask+topk {lib['v3']:.3f} ms "
        f"({lib['v2_k80']:.3f} at k {4 * K}), _int_mm+topk "
        f"{lib['int8']:.3f} ms, bf16 matmul+amax {lib['dotonly']:.3f} ms")
    for name, r in res.items():
        log_residency(name, r)
    log(f"  B2 above the tensor-core floor, (B2 - B4b) / B2: "
        f"{share['k20']:.3f} at k {K}, {share['k80']:.3f} at k {4 * K}")
    return dict(max_abs_err={n: max(e) for n, e in errs.items()},
                main_shape_ms=ms, main_shape_library_ms=lib,
                selection_share=share, residency=res)


def synthetic_pq_layout(n_rows, gen_np):
    """An IVF-PQ store's layout: random list sizes over NLIST lists summing
    to n_rows, each list padded to LIST_TILE-row subtiles (at least one),
    the total to PQ_BLK with filler subtiles. Returns (ids (n_pad,) int32:
    a permutation of 0..n_rows-1 at the rows, -1 on padding; sub_list
    (n_pad // LIST_TILE,) int32, -1 on filler)."""
    import numpy as np
    counts = gen_np.multinomial(n_rows, gen_np.dirichlet(np.full(NLIST, 2.0)))
    padded = np.maximum(-(-counts // LIST_TILE), 1) * LIST_TILE
    n_pad = int(padded.sum())
    n_pad += (-n_pad) % PQ_BLK
    ids = np.full(n_pad, -1, np.int32)
    sub_list = np.full(n_pad // LIST_TILE, -1, np.int32)
    perm = gen_np.permutation(n_rows).astype(np.int32)
    start, used = 0, 0
    for li in range(NLIST):
        ids[start:start + counts[li]] = perm[used:used + counts[li]]
        sub_list[start // LIST_TILE:(start + padded[li]) // LIST_TILE] = li
        start += padded[li]
        used += counts[li]
    return ids, sub_list


def probe_bias(bq, sub_list, gen_np, dev, unprobed=()):
    """(bq, n_sub) 0 / NEG bias: NPROBE random lists of NLIST per query
    (none for the queries in ``unprobed``), filler subtiles NEG."""
    import numpy as np
    import torch
    from nafp_tpu_torch.search.index import _pq_expand_bias
    from nafp_tpu_torch.search.topk import NEG
    bl = np.full((bq, NLIST), NEG, np.float32)
    for r in range(bq):
        if r not in unprobed:
            bl[r, gen_np.choice(NLIST, NPROBE, replace=False)] = 0.0
    return _pq_expand_bias(torch.from_numpy(bl).to(dev),
                           sub_list).contiguous()


def check_masked(tag, q, db, ids, bias, k, pos_of_id, twin_offset=0):
    """Kernel B3 against its plain version with bf16 queries (the kernel's
    numerics). A returned row that is masked or unprobed fails the check:
    its recomputed score is ~NEG. ``twin_offset``: row r + offset repeats
    row r, so wherever the kernel returns r + offset it must return r
    (the lower row wins the tie)."""
    import torch
    from nafp_tpu_torch.search import topk as T
    v, i = T.topk_ip_masked(q, db, ids, bias, k, LIST_TILE)
    pv, pi = T.topk_ip_masked_plain(q, db, ids, bias, k, LIST_TILE,
                                    compute_dtype=torch.bfloat16)
    if twin_offset:
        check_twins(tag, i, twin_offset)
    qb = q.to(torch.bfloat16).double()

    def score_at(row_ids):
        pos = pos_of_id[row_ids]
        return (torch.einsum("bd,bkd->bk", qb, db[pos].double())
                + bias.double().gather(1, pos // LIST_TILE))
    return check_topk(tag, v, i, pv, pi, score_at)


def phase_kernel_b3(dev, gen):
    """B3 on a synthetic IVF-PQ store of the protocol's size."""
    import numpy as np
    import torch
    from nafp_tpu_torch import kernels
    from nafp_tpu_torch.search import topk as T

    gen_np = np.random.default_rng(SEED + 3)
    ids_np, sub_np = synthetic_pq_layout(N_DB_ROWS, gen_np)
    n_pad = len(ids_np)
    ids = torch.from_numpy(ids_np).to(dev)
    sub_list = torch.from_numpy(sub_np).to(dev)
    pos_of_id = torch.empty(N_DB_ROWS, dtype=torch.long, device=dev)
    valid = ids >= 0
    pos_of_id[ids[valid].long()] = torch.nonzero(valid)[:, 0]
    db = unit_rows(n_pad, 128, gen, dev).to(torch.bfloat16)
    log(f"  B3 store: {N_DB_ROWS} rows in {NLIST} lists -> n_pad {n_pad} "
        f"({n_pad // LIST_TILE} subtiles, "
        f"{int((sub_list < 0).sum())} filler)")
    errs = []
    for bq in (128, 512):
        for k in (K, 4 * K):
            errs.append(check_masked(
                f"B3 Bq={bq} k={k} N={n_pad}", unit_rows(bq, 128, gen, dev),
                db, ids, probe_bias(bq, sub_list, gen_np, dev), k, pos_of_id))
    errs.append(check_masked(
        "B3 Bq=128 k=80, queries 0 and 7 probe nothing",
        unit_rows(128, 128, gen, dev), db, ids,
        probe_bias(128, sub_list, gen_np, dev, unprobed=(0, 7)), 4 * K,
        pos_of_id))
    errs.append(check_masked("B3 Bq=1", unit_rows(1, 128, gen, dev), db, ids,
                             probe_bias(1, sub_list, gen_np, dev), K,
                             pos_of_id))
    # k larger than the valid rows: 30 valid rows in a 2048-row chunk
    few = torch.full((2048,), -1, dtype=torch.int32, device=dev)
    few[torch.randperm(2048, generator=gen, device=dev)[:30]] = torch.arange(
        30, dtype=torch.int32, device=dev)
    few_pos = torch.full((30,), 0, dtype=torch.long, device=dev)
    few_pos[few[few >= 0].long()] = torch.nonzero(few >= 0)[:, 0]
    errs.append(check_masked(
        "B3 k=80 > 30 valid rows", unit_rows(9, 128, gen, dev), db[:2048],
        few, torch.zeros((9, 16), device=dev), 4 * K, few_pos))
    # ties across chunks: the second half of the rows repeats the first, so
    # every score comes twice, from rows 32,768 apart (other chunks), and
    # equal scores meet the shared bound; the lower row must win each tie
    half = unit_rows(32_768, 128, gen, dev).to(torch.bfloat16)
    twin = torch.cat([half, half]).contiguous()
    twin_ids = torch.arange(len(twin), dtype=torch.int32, device=dev)
    for bq, k in ((128, 4 * K), (512, 41)):
        errs.append(check_masked(
            f"B3 ties across chunks Bq={bq} k={k} N={len(twin)}",
            unit_rows(bq, 128, gen, dev), twin, twin_ids,
            torch.zeros((bq, len(twin) // LIST_TILE), device=dev), k,
            twin_ids.long(), twin_offset=len(half)))
    del half, twin, twin_ids
    # the other row widths: 16,384 rows, every 7th masked, half the
    # subtiles probed
    for d, bq, k in ((OTHER_D[0], 200, 4 * K), (OTHER_D[1], 64, K)):
        ids_d = torch.arange(16_384, dtype=torch.int32, device=dev)
        ids_d[::7] = -1
        bias_d = torch.where(
            torch.rand((bq, 16_384 // LIST_TILE), generator=gen, device=dev)
            < 0.5, 0.0, T.NEG).to(torch.float32)
        errs.append(check_masked(
            f"B3 d={d} Bq={bq} k={k} N=16384", unit_rows(bq, d, gen, dev),
            unit_rows(16_384, d, gen, dev).to(torch.bfloat16), ids_d, bias_d,
            k, torch.arange(16_384, device=dev)))
        occ = kernels.occupancy("topk_masked", d, k)
        log(f"    residency B3 d {d} k {k}: {occ[0]} B shared memory per CTA, "
            f"{occ[1]} CTAs per SM, {occ[2]} registers")

    q = unit_rows(512, 128, gen, dev)
    bias = probe_bias(512, sub_list, gen_np, dev)
    ms = time_ms(lambda: T.topk_ip_masked(q, db, ids, bias, K, LIST_TILE), 20)
    ms80 = time_ms(lambda: T.topk_ip_masked(q, db, ids, bias, 4 * K,
                                            LIST_TILE), 20)
    plain_ms = time_ms(lambda: T.topk_ip_masked_plain(
        q, db, ids, bias, K, LIST_TILE, compute_dtype=torch.bfloat16), 5)
    rmask = torch.where(ids >= 0, 0.0, T.NEG).to(torch.float32)
    q16 = q.to(torch.bfloat16)
    lib_ms, lib_ms_k80 = (time_ms(lambda: torch.topk(
        torch.matmul(q16, db.T).float()
        + bias.repeat_interleave(LIST_TILE, 1) + rmask, k, dim=1), 10)
        for k in (K, 4 * K))
    n_sub = n_pad // LIST_TILE
    # the products the function needs: valid rows of the subtiles each
    # query probes (an unprobed or masked row scores <= NEG/2 whatever its
    # product)
    valid_per_sub = (ids >= 0).view(n_sub, LIST_TILE).sum(1).double()
    pairs = float(((bias > T.NEG / 2).double() @ valid_per_sub).sum())
    flops = 2.0 * 128 * pairs
    nbytes = (2.0 * n_pad * 128 + 4.0 * n_pad + 4.0 * 512 * n_sub
              + 4.0 * 512 * 128 + 8.0 * 512 * K)
    bound = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    log(f"  B3 bound: {pairs:.0f} probed valid (query, row) pairs = "
        f"{pairs / (512 * n_pad):.4f} of all, {flops / 1e9:.2f} GFLOP "
        f"({flops / PEAK_BF16 * 1e3:.4f} ms), {nbytes / 1e6:.1f} MB "
        f"({nbytes / PEAK_BYTES * 1e3:.4f} ms)")
    log(f"  B3 @ Bq 512: kernel {ms:.3f} ms (k {K}), {ms80:.3f} ms "
        f"(k {4 * K}), plain {plain_ms:.3f} ms, bf16 matmul+bias+topk "
        f"{lib_ms:.3f} ms ({lib_ms_k80:.3f} ms at k {4 * K}), bound "
        f"{bound:.3f} ms")
    residency = {}
    for k in (K, 4 * K):
        occ = kernels.occupancy("topk_masked", 128, k)
        grid = T._grid(512, n_pad, dev, T.MASKED_CTAS_PER_SM)[1] * -(
            -512 // T.QB)
        residency[f"k{k}"] = dict(zip(("smem", "ctas_per_sm", "regs",
                                       "grid"), (*occ, grid)))
        log(f"    residency B3 k {k}: {occ[0]} B shared memory per CTA, "
            f"{occ[1]} CTAs per SM, {occ[2]} registers, {grid} scan CTAs")
    # how the scan and merge kernels' device time grows with k (ivfpq-rr
    # keeps 4 k = 80)
    k_sweep = {}
    for k in (K, 2 * K, 4 * K, 128):
        prof = profile_call(lambda: [T.topk_ip_masked(
            q, db, ids, bias, k, LIST_TILE) for _ in range(3)],
            f"B3 x3 at k {k}", top=2)
        k_sweep[k] = {("scan" if "scan_kernel" in r["name"] else
                       "merge" if "merge_kernel" in r["name"] else
                       r["name"][:30]): r["ms"] / 3 for r in prof["top"]}
    return dict(
        name="topk_ip_masked (B3)", route="cuda",
        source="nafp_tpu_torch/csrc/topk_masked.cu",
        replaces="nafp_tpu/search/pallas_topk.py:378 (topk_ip_pallas_masked)",
        max_abs_err=max(errs), ms=ms, ms_k80=ms80, k_sweep_ms=k_sweep,
        plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES
        else "bytes", library_ms=lib_ms, library_ms_k80=lib_ms_k80,
        residency=residency,
        shape=f"Bq 512, N {n_pad} (bf16), d 128, k {K}; 40 of 256 lists "
              "probed")


# ---------------------------------------------------------------------------
# Phase 2, LayerNorm2d: the kernel pair against its plain version
# ---------------------------------------------------------------------------
def bf16_ulp_gap(got, want):
    """The largest |got - want| in bf16 ulps of the larger of |got|, |want|
    and 1e-3 of the largest |want| (below that, the last bits of the f32
    statistics can move a value by more than its own ulp)."""
    import torch
    got, want = got.double(), want.double()
    scale = torch.maximum(torch.maximum(got.abs(), want.abs()),
                          1e-3 * want.abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(1e-30))) - 7)
    return float(((got - want).abs() / ulp).max())


def ln2d_gaps(x, gamma, beta, dy):
    """Kernel against plain, forward and backward, at one input: y and dx
    (bf16: in ulps, ``bf16_ulp_gap``; f32: over the largest |plain|), and
    dgamma and dbeta against an f64 sum over the batch, over the sum of the
    absolute terms; then a second run, which must equal the first bit for
    bit."""
    import torch
    import torch.nn.functional as F
    from nafp_tpu_torch.ops import layernorm2d as L

    def run(fn):
        xs, g, b = (t.detach().clone().requires_grad_(True)
                    for t in (x, gamma, beta))
        y = fn(xs, g, b, 1e-3)
        y.backward(dy)
        return y.detach(), xs.grad, g.grad, b.grad

    got, again, want = run(L.layer_norm2d), run(L.layer_norm2d), \
        run(L.layer_norm2d_plain)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"LayerNorm2d {tuple(x.shape)}: two runs differ")
    if x.dtype == torch.bfloat16:
        gap = [bf16_ulp_gap(got[i], want[i]) for i in (0, 1)]
    else:
        gap = [float((got[i] - want[i]).abs().max() / want[i].abs().max())
               for i in (0, 1)]
    v = F.elu(x).double()
    mean = v.mean((1, 2, 3), keepdim=True)
    xh = (v - mean) / torch.sqrt((v - mean).square().mean(
        (1, 2, 3), keepdim=True) + 1e-3)
    for k, terms in ((2, dy.double() * xh), (3, dy.double())):
        gap.append(float(((got[k].double() - terms.sum(0)).abs()
                          / terms.abs().sum(0).clamp_min(1e-30)).max()))
        del terms
    return gap


def ln2d_timings(x, gamma, beta, iters):
    """ms of the kernels' forward and backward (called directly), of the
    plain version and of the library yardstick (F.elu + F.layer_norm in
    f32, which the port never calls), each backward as forward + backward
    less forward."""
    import torch
    import torch.nn.functional as F
    from nafp_tpu_torch.ops import layernorm2d as L

    shape = tuple(x.shape[1:])

    def library(xs, g, b, eps):
        return F.layer_norm(F.elu(xs).float(), shape, g, b, eps).to(xs.dtype)

    y, mean, rstd, g_mem = L._forward(x, gamma, beta, 1e-3)
    dy = torch.randn_like(y)
    out = dict(ms=time_ms(lambda: L._forward(x, gamma, beta, 1e-3), iters),
               bwd_ms=time_ms(lambda: L._backward(dy, x, g_mem, mean, rstd),
                              iters))
    xg, gg, bg = (t.detach().clone().requires_grad_(True)
                  for t in (x, gamma, beta))
    for tag, fn in (("plain", L.layer_norm2d_plain), ("library", library)):
        with torch.no_grad():
            f = time_ms(lambda: fn(x, gamma, beta, 1e-3), iters)
        def fwd_bwd():
            xg.grad = gg.grad = bg.grad = None
            fn(xg, gg, bg, 1e-3).backward(dy)
        fb = time_ms(fwd_bwd, iters)
        out[f"{tag}_ms"], out[f"{tag}_bwd_ms"] = f, fb - f
    return out


def ln2d_elu_check(dev):
    """The kernels' bf16 ELU table against F.elu at every bf16 value from -16
    to 16 (and -100, the most negative finite value, -inf): one sample
    through the kernels, whose backward with dy = 1 returns
    dgamma = (v - mean)·rstd as computed, reproduced bit for bit from
    F.elu's v and the kernels' mean and rstd."""
    import torch
    import torch.nn.functional as F
    from nafp_tpu_torch.ops import layernorm2d as L
    pos = torch.arange(0, 0x4181, dtype=torch.int16).view(torch.bfloat16)
    x = torch.cat([pos, -pos, torch.tensor(
        [-100.0, -3.3895e38, float("-inf")], dtype=torch.bfloat16)])
    x = torch.cat([x, x.new_zeros(-len(x) % 64)]).view(1, 1, 1, -1).to(dev)
    gamma = torch.ones(x.shape[1:], device=dev)
    _, mean, rstd, g_mem = L._forward(x, gamma, torch.zeros_like(gamma), 1e-3)
    _, dgamma, _ = L._backward(torch.ones_like(x), x, g_mem, mean, rstd)
    want = (F.elu(x).float() - mean) * rstd
    bad = int((dgamma.view(-1) != want.view(-1)).sum())
    if bad:
        raise AssertionError(f"LayerNorm2d's bf16 ELU differs from F.elu at "
                             f"{bad} of {x.numel()} values")
    log(f"  LayerNorm2d's bf16 ELU equals F.elu at all {x.numel()} values")


def phase_layernorm2d(dev):
    """LayerNorm2d's kernel pair against its plain version at the
    encoder's 16 norms, at batch 640 (the train step) and 125 (generate),
    in bf16 and f32, x channels last as the encoder holds it, after the
    bf16 ELU table against F.elu at every bf16 value: y and dx
    within LN2D_Y_GAP / LN2D_DX_GAP, dgamma and dbeta within
    LN2D_PARAM_GAP of an f64 sum, two runs bit for bit. Then, at batch
    640 in bf16, each norm timed forward and backward against the byte
    bound (4 and 6 bytes an element), the plain version and the library
    yardstick; and one 640_lamb train step launches the pair once a norm
    each way and LAMB's kernel pair once (bench_train_step, 2 steps after
    its warm-up: the trainer's ``Lamb.step`` reaches ``csrc/lamb.cu``)."""
    import torch
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.extras import bench_train_step
    from nafp_tpu_torch.models import nnfp
    from nafp_tpu_torch.ops import layernorm2d as L
    from nafp_tpu_torch.optim import lamb

    ln2d_elu_check(dev)
    model = nnfp.get_fingerprinter(load_config("640_lamb"))
    shapes = [tuple(m.gamma.shape) for m in model.modules()
              if isinstance(m, nnfp.LayerNorm2d)]
    del model
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {}
    for rows in LN2D_ROWS:
        for dt in (torch.bfloat16, torch.float32):
            for shape in shapes:
                x = torch.randn((rows, *shape), generator=gen, device=dev
                                ).to(dt).contiguous(
                                    memory_format=torch.channels_last)
                dy = torch.randn(x.shape, generator=gen, device=dev).to(
                    dt).contiguous(memory_format=torch.channels_last)
                gamma = 1 + 0.3 * torch.randn(shape, generator=gen,
                                              device=dev)
                beta = 0.2 * torch.randn(shape, generator=gen, device=dev)
                gap = ln2d_gaps(x, gamma, beta, dy)
                key = f"{rows} {str(dt)[6:]}"
                worst[key] = [max(a, b) for a, b in
                              zip(worst.get(key, gap), gap)]
                lim = LN2D_Y_GAP[str(dt)], LN2D_DX_GAP[str(dt)], \
                    LN2D_PARAM_GAP, LN2D_PARAM_GAP
                if any(g > m for g, m in zip(gap, lim)):
                    raise AssertionError(f"LayerNorm2d B {rows} {shape} {dt}: "
                                         f"y, dx, dgamma, dbeta gaps {gap}, "
                                         f"limits {lim}")
                del x, dy
    for key, gap in worst.items():
        log(f"  LayerNorm2d B {key}: worst y {gap[0]:.3g}, dx {gap[1]:.3g}, "
            f"dgamma {gap[2]:.3g}, dbeta {gap[3]:.3g}")
    rows, per_shape = LN2D_ROWS[0], []
    for shape in shapes:
        x = torch.randn((rows, *shape), generator=gen, device=dev).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        gamma = 1 + 0.3 * torch.randn(shape, generator=gen, device=dev)
        beta = 0.2 * torch.randn(shape, generator=gen, device=dev)
        n = x.numel()
        t = ln2d_timings(x, gamma, beta, 20 if n > (1 << 26) else 50)
        t.update(shape=shape, bound_ms=4 * n / PEAK_BYTES * 1e3,
                 bwd_bound_ms=6 * n / PEAK_BYTES * 1e3)
        per_shape.append(t)
        log(f"  LayerNorm2d B {rows} x {shape} bf16: fwd {t['ms']:.4f} / "
            f"bwd {t['bwd_ms']:.4f} ms (bound {t['bound_ms']:.4f} / "
            f"{t['bwd_bound_ms']:.4f}; plain {t['plain_ms']:.3f} / "
            f"{t['plain_bwd_ms']:.3f}; library {t['library_ms']:.3f} / "
            f"{t['library_bwd_ms']:.3f})")
        del x
    step = {k: sum(t[k] for t in per_shape) for k in (
        "ms", "bwd_ms", "bound_ms", "bwd_bound_ms", "plain_ms",
        "plain_bwd_ms", "library_ms", "library_bwd_ms")}
    log(f"  LayerNorm2d, the 16 norms of a batch-640 step: " + json.dumps(
        {k: round(v, 4) for k, v in step.items()}))
    L.reset_launches()
    lamb.reset_launches()
    res = bench_train_step.main(["-c", "640_lamb", "--steps", "2"])
    torch.cuda.synchronize()
    want = 3 * len(shapes)                  # the warm-up step and 2 more
    if L.LAUNCHES != {"layer_norm2d": want, "layer_norm2d_backward": want}:
        raise AssertionError(f"640_lamb steps launched {L.LAUNCHES}, "
                             f"expected {want} each way")
    # one group of 68 leaves: one launch of each kernel a step
    if lamb.LAUNCHES != {"lamb_moments": 3, "lamb_apply": 3}:
        raise AssertionError(f"640_lamb steps launched LAMB's kernels "
                             f"{lamb.LAUNCHES}, expected 3 each")
    log(f"  640_lamb: 3 steps launched {dict(L.LAUNCHES)} and "
        f"{dict(lamb.LAUNCHES)}; step {res['step_ms']} ms")
    return dict(worst_gaps=worst, layer1=per_shape[0], step=step,
                train_step_ms=res["step_ms"], launches=dict(L.LAUNCHES),
                lamb_launches=dict(lamb.LAUNCHES))


def lamb_ratios(states, groups, p_old):
    """(trust ratio, ||u||) of every leaf at the step just made, in f64,
    by the plain version's arithmetic: u from the leaf's moments,
    bias-corrected at its step, and its parameters before the step; the
    ratio 1 without adaptation or where a norm is 0."""
    import torch
    out = []
    for group in groups:
        b1, b2 = group["betas"]
        for i in group["params"]:
            t, m, v = (states[i][k] for k in ("step", "exp_avg",
                                              "exp_avg_sq"))
            u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt()
                                       + group["eps"])
            if group["weight_decay"]:
                u = u + group["weight_decay"] * p_old[i]
            wn, un = (float(torch.linalg.vector_norm(x.double()))
                      for x in (p_old[i], u))
            out.append((wn / un if group["layer_adaptation"] and wn > 0
                        and un > 0 else 1.0, un))
    return out


def phase_lamb(dev):
    """LAMB's kernel pair against its plain version at 640_lamb's 68 leaves:
    LAMB_STEPS steps from seeded weights (one leaf zeroed) and gradients,
    the leaves in three groups (as the preset's one, a wd-0 group, one
    without layer adaptation) through ``Lamb.step`` and through
    ``plain_update`` leaf by leaf, in lockstep; the widest gaps of the
    parameters and moments (absolute, and over each leaf's largest
    |value|), of the parameters' change (over its norm) and of the trust
    ratios each step (the kernels' effective ratio, ||change|| /
    (lr·||u||), against the plain version's, in f64); a second run of the
    kernels bit for bit. (The trainer's launches a step are counted in
    ``phase_layernorm2d``'s 640_lamb run.) Then the preset's
    one group: the kernels' device time a step (under the profiler, where
    the port's counter ``lamb.fused_leaves`` must read the 68 leaves a
    step) beside the byte bound (LAMB_BYTES_PER_PARAM a parameter), the
    fused route's wall time a step and the plain loop's."""
    import torch
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.optim import lamb as L
    from nafp_tpu_torch.optim.schedules import build_optimizer
    from nafp_tpu_torch.train.trainer import build_fp
    from nafp_tpu_torch.utils import profiling
    from nafp_tpu_torch.utils.profiling import device_profile

    cfg = load_config("640_lamb")
    _, _, model, _ = build_fp(cfg)
    opt, _ = build_optimizer(cfg, model, 100)
    (preset,) = opt.param_groups
    gen = torch.Generator(device=dev).manual_seed(SEED)
    p0 = [p.detach().to(dev) for p in model.parameters()]
    del model, opt
    p0[1].zero_()
    n = len(p0)
    grads = [[0.01 * torch.randn(p.shape, generator=gen, device=dev)
              for p in p0] for _ in range(LAMB_STEPS)]
    base = dict(lr=LAMB_LR, betas=tuple(preset["betas"]), eps=preset["eps"],
                weight_decay=preset["weight_decay"],
                layer_adaptation=preset["layer_adaptation"])
    split = [dict(base, params=list(range(n - 8))),
             dict(base, params=list(range(n - 8, n - 4)), weight_decay=0.0),
             dict(base, params=list(range(n - 4, n)), weight_decay=0.0,
                  layer_adaptation=False)]

    def fused():
        ps = [torch.nn.Parameter(p.clone()) for p in p0]
        return ps, L.Lamb([dict(g, params=[ps[i] for i in g["params"]])
                           for g in split], lr=LAMB_LR)

    def fused_step(ps, opt, step):
        for p, g in zip(ps, grads[step]):
            p.grad = g
        opt.step()

    def gap(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    # the kernels and the plain version in lockstep, with the kernels'
    # effective ratios
    got, kopt = fused()
    ps = [p.clone() for p in p0]
    states = [{"step": 0, "exp_avg": torch.zeros_like(p),
               "exp_avg_sq": torch.zeros_like(p)} for p in p0]
    ratio_gap, ratios = 0.0, []
    for step in range(LAMB_STEPS):
        p_old = [p.clone() for p in ps]
        for g in split:
            for i in g["params"]:
                L.plain_update(ps[i], grads[step][i], states[i], g)
        k_old = [p.detach().clone() for p in got]
        fused_step(got, kopt, step)
        for i, (ratio, un) in enumerate(lamb_ratios(states, split, p_old)):
            ratios.append(ratio)
            change = float(torch.linalg.vector_norm(
                got[i].detach().double() - k_old[i]))
            ratio_gap = max(ratio_gap,
                            abs(change / (LAMB_LR * un) - ratio) / ratio)
    # a second run of the kernels from the same state
    again, aopt = fused()
    for step in range(LAMB_STEPS):
        fused_step(again, aopt, step)
    torch.cuda.synchronize()
    got_st = [kopt.state[p] for p in got]
    again_st = [aopt.state[p] for p in again]
    got = [p.detach() for p in got]
    same = all(torch.equal(a, b) for a, b in zip(got, again)) and all(
        torch.equal(a[k], b[k]) for a, b in zip(got_st, again_st)
        for k in ("exp_avg", "exp_avg_sq"))
    pairs = dict(param=list(zip(got, ps)), **{
        k: [(a[k], b[k]) for a, b in zip(got_st, states)]
        for k in ("exp_avg", "exp_avg_sq")})
    abs_gaps = {k: max(float((a - b).abs().max()) for a, b in v)
                for k, v in pairs.items()}
    gaps = dict(
        {k: max(gap(a, b) for a, b in v) for k, v in pairs.items()},
        change=max(float(torch.linalg.vector_norm(a.double() - b)
                         / torch.linalg.vector_norm(b.double() - c))
                   for a, b, c in zip(got, ps, p0)),
        ratio=ratio_gap)
    log(f"  LAMB at 640_lamb's {n} leaves, {LAMB_STEPS} steps: relative "
        "gaps " + json.dumps({k: float(f"{v:.3g}") for k, v in gaps.items()})
        + ", absolute " + json.dumps({k: float(f"{v:.3g}")
                                      for k, v in abs_gaps.items()})
        + f"; trust ratios {min(ratios):.4g}..{max(ratios):.4g}; two runs "
        f"equal {same}")
    lim = dict(param=LAMB_RTOL, exp_avg=LAMB_RTOL, exp_avg_sq=LAMB_RTOL,
               change=LAMB_CHANGE_RTOL, ratio=LAMB_RATIO_RTOL)
    bad = {k: v for k, v in gaps.items() if not v <= lim[k]}
    if bad or not same:
        raise AssertionError(f"LAMB's kernel pair: gaps over the limits "
                             f"{bad}, two runs equal {same}")
    # timings in the preset's one group
    del got, again, got_st, again_st, kopt, aopt, pairs
    ps = [torch.nn.Parameter(p.clone()) for p in p0]
    opt = L.Lamb([dict(base, params=ps)], lr=LAMB_LR)
    for p, g in zip(ps, grads[0]):
        p.grad = g
    iters = 50
    ms = time_ms(opt.step, iters)
    profiling.reset()
    prof = device_profile(lambda: [opt.step() for _ in range(iters)])
    kernel_ms = {k: v[0] / iters for k, v in prof["by_name"].items()
                 if "lamb_" in k}
    fused_leaves = profiling.snapshot()["counts"].get(
        "lamb.fused_leaves", 0) / iters
    if fused_leaves != n:
        raise AssertionError(f"lamb.fused_leaves {fused_leaves} a step under "
                             f"the profiler, expected {n}")
    plain_states = [{"step": 0, "exp_avg": torch.zeros_like(p),
                     "exp_avg_sq": torch.zeros_like(p)} for p in p0]
    pp = [p.clone() for p in p0]

    def plain_step():
        for i, p in enumerate(pp):
            L.plain_update(p, grads[0][i], plain_states[i], base)
    plain_ms = time_ms(plain_step, 10)
    n_params = sum(p.numel() for p in p0)
    out = dict(gaps=gaps, abs_gaps=abs_gaps, ratios=[min(ratios), max(ratios)],
               two_runs_equal=same,
               kernel_ms=sum(kernel_ms.values()), kernels=kernel_ms,
               step_ms=ms, plain_ms=plain_ms, n_params=n_params,
               fused_leaves_per_step=fused_leaves,
               bound_ms=LAMB_BYTES_PER_PARAM * n_params / PEAK_BYTES * 1e3)
    log(f"  LAMB a 640_lamb step: kernels {out['kernel_ms']:.4f} ms "
        f"({json.dumps({k[:60]: round(v, 4) for k, v in kernel_ms.items()})})"
        f", bound {out['bound_ms']:.4f} ms ({n_params} parameters x "
        f"{LAMB_BYTES_PER_PARAM} B), the fused route's wall {ms:.4f} ms a "
        f"step, the plain loop {plain_ms:.3f} ms; lamb.fused_leaves "
        f"{fused_leaves:g} a step")
    return out


# ---------------------------------------------------------------------------
# Phase 3: the serving path through the CLI
# ---------------------------------------------------------------------------
def flax_params(cfg, seed):
    """Full-width FingerPrinter variables in the Flax layout (HWIO conv
    kernels, (F,T,C) layer-norm parameters), drawn with numpy from
    ``seed``: glorot-uniform kernels, near-identity norms."""
    import numpy as np
    from nafp_tpu_torch.models.nnfp import DEFAULT_CHANNELS, DEFAULT_STRIDES
    from nafp_tpu_torch.ops.melspec import MelSpecConfig

    rng = np.random.default_rng(seed)
    m = MelSpecConfig.from_cfg(cfg)
    emb = int(cfg["MODEL"]["EMB_SZ"])

    def glorot(shape, fan_in, fan_out):
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    def norm(shape):
        return {"gamma": (1 + 0.1 * rng.standard_normal(shape)).astype(
                    np.float32),
                "beta": (0.1 * rng.standard_normal(shape)).astype(np.float32)}

    params, hw, c_in = {}, (m.n_mels, m.n_frames), 1
    for i, ((s1, s2), ch) in enumerate(zip(DEFAULT_STRIDES,
                                           DEFAULT_CHANNELS)):
        hw1 = (-(-hw[0] // s1[0]), -(-hw[1] // s1[1]))
        hw2 = (-(-hw1[0] // s2[0]), -(-hw1[1] // s2[1]))
        params[f"conv_layer_{i}"] = {
            "conv_1x3": {"kernel": glorot((1, 3, c_in, ch), 3 * c_in, 3 * ch),
                         "bias": np.zeros(ch, np.float32)},
            "LayerNorm2d_0": norm((*hw1, ch)),
            "conv_3x1": {"kernel": glorot((3, 1, ch, ch), 3 * ch, 3 * ch),
                         "bias": np.zeros(ch, np.float32)},
            "LayerNorm2d_1": norm((*hw2, ch)),
        }
        hw, c_in = hw2, ch
    s = hw[0] * hw[1] * c_in // emb
    params["div_enc"] = {
        "w1": glorot((emb, s, 32), s, 32),
        "b1": np.zeros((emb, 32), np.float32),
        "w2": glorot((emb, 32, 1), 32, 1),
        "b2": np.zeros((emb, 1), np.float32)}
    return {"params": params}


def phase_main_path(dev):
    import numpy as np
    import torch
    import yaml
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.data.audio_io import create_memmap, load_memmap
    from nafp_tpu_torch.models.convert import save_params_npz
    from nafp_tpu_torch.search import topk as T

    data = os.path.join(WORK, "data")
    t0 = time.perf_counter()
    subprocess.run([sys.executable,
                    SYNTH,
                    data, "--n_train", "0", "--n_query", str(N_QUERY),
                    "--n_dummy", str(N_DUMMY), "--sec", str(SONG_SEC)],
                   check=True, timeout=600, stdout=subprocess.DEVNULL)
    log(f"  synthetic corpus in {time.perf_counter() - t0:.1f} s")

    cfg = load_config("default")
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{data}/music/",
                      BG_ROOT_DIR=f"{data}/aug/bg/",
                      IR_ROOT_DIR=f"{data}/aug/ir/",
                      OUTPUT_ROOT_DIR=f"{WORK}/emb/",
                      LOG_ROOT_DIR=f"{WORK}/logs/")
    cfg_path = os.path.join(WORK, "smoke.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    variables = flax_params(cfg, SEED)
    save_params_npz(os.path.join(WORK, "logs", "checkpoint", NAME,
                                 str(INDEX), "params.npz"), variables)

    T.reset_launches()
    t0 = time.perf_counter()
    cli(["generate", NAME, str(INDEX), "-c", cfg_path, "--yes"],
        standalone_mode=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    emb_dir = os.path.join(WORK, "emb", NAME, str(INDEX))
    n_seg = 0
    for key in ("dummy_db", "db", "query"):
        arr, shape = load_memmap(emb_dir, key, display=False)
        a = np.asarray(arr)
        norms = np.linalg.norm(a, axis=1)
        if not (shape[1] == 128 and np.isfinite(a).all()
                and np.abs(norms - 1).max() < 1e-3):
            raise AssertionError(f"{key}.mm: bad fingerprints {shape}")
        n_seg += int(shape[0])
    log(f"  generate: {n_seg} segments in {gen_s:.2f} s = "
        f"{n_seg / gen_s:.1f} segments/s (bf16, TS_BATCH_SZ "
        f"{cfg['BSZ']['TS_BATCH_SZ']}, wall clock incl. decode and setup)")

    # dummy DB at the 10k-song protocol size: generated rows, then seeded
    # random unit rows up to 619,500 rows of dummy_db + db
    dummy, _ = load_memmap(emb_dir, "dummy_db", display=False)
    n_db = load_memmap(emb_dir, "db", shape_only=True)[0]
    n_dummy = N_DB_ROWS - n_db
    dummy_dir = os.path.join(WORK, "dummy10k")
    out = create_memmap(dummy_dir, "dummy_db", (n_dummy, 128))
    out[:len(dummy)] = dummy
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out[len(dummy):] = unit_rows(n_dummy - len(dummy), 128, gen,
                                 dev).cpu().numpy()
    out.flush()
    del out
    log(f"  dummy DB: {len(dummy)} generated + "
        f"{n_dummy - len(dummy)} random unit rows; DB {N_DB_ROWS} rows")

    results, launches_by_run = {}, {}
    paths = {"l2": "topk_ip", "sq8": "topk_ip_sq8", "ivfpq": "topk_ip_masked",
             "ivfpq-rr": "topk_ip_masked"}

    def evaluate_args(itype):
        extra = (["--index_cache", os.path.join(WORK, "sq8_store.npz")]
                 if itype == "sq8" else [])
        return ["evaluate", NAME, str(INDEX), "-c", cfg_path, "-i", itype,
                "-t", str(N_TEST), "--emb_dummy_dir", dummy_dir, *extra]

    for itype, kernel in paths.items():
        T.reset_launches()
        t0 = time.perf_counter()
        cli(evaluate_args(itype), standalone_mode=False)
        wall = time.perf_counter() - t0
        launches_by_run[itype] = dict(T.LAUNCHES)
        for name in ("raw_score.npy", "test_ids.npy", "eval_summary.json"):
            if not os.path.exists(os.path.join(emb_dir, name)):
                raise AssertionError(f"evaluate -i {itype}: {name} missing")
        with open(os.path.join(emb_dir, "eval_summary.json")) as f:
            summary = json.load(f)
        if summary["n_db"] != N_DB_ROWS or summary["n_test"] != N_TEST:
            raise AssertionError(f"evaluate -i {itype}: {summary}")
        results[itype] = dict(
            summary=summary, wall_s=wall,
            raw=np.load(os.path.join(emb_dir, "raw_score.npy")))
        log(f"  evaluate -i {itype}: {summary['ms_per_query']} ms/query, "
            f"index build {summary['build_sec']} s, wall {wall:.1f} s, "
            f"launches {launches_by_run[itype]}")
        log(f"    hit rates (%) at lengths {summary['seq_lens']}: "
            f"{json.dumps(summary['rates'])}")
        if launches_by_run[itype][kernel] <= 0:
            raise AssertionError(f"evaluate -i {itype} never launched "
                                 f"kernel {kernel}")
    if not os.path.exists(os.path.join(WORK, "sq8_store.npz")):
        raise AssertionError("sq8 --index_cache store was not written")
    launches = {name: sum(r[name] for r in launches_by_run.values())
                for name in T.LAUNCHES}
    log(f"  kernel launches on the main path: {launches}")
    predicted = {"l2": ("topk_ip", B1_LAUNCHES_PER_RUN),
                 "ivfpq": ("topk_ip_masked", B3_LAUNCHES_PER_RUN),
                 "ivfpq-rr": ("topk_ip_masked", B3_LAUNCHES_PER_RUN)}
    for itype, (kernel, want) in predicted.items():
        n = launches_by_run[itype][kernel]
        if n != want:
            raise AssertionError(f"evaluate -i {itype} launched {kernel} {n} "
                                 f"times, predicted {want}")
    n_sl = len(results["l2"]["summary"]["seq_lens"])
    top1 = {k: r["raw"][:, :n_sl] for k, r in results.items()}
    agree = {k: float((top1["l2"] == top1[k]).mean())
             for k in ("sq8", "ivfpq", "ivfpq-rr")}
    log(f"  top-1 exact agreement with l2 over {N_TEST} ids x {n_sl} "
        f"lengths: {agree} (sq8 floor {L2_SQ8_AGREE_MIN}; ivfpq-rr floor "
        f"ivfpq - {RR_AGREE_SLACK})")
    if not agree["sq8"] >= L2_SQ8_AGREE_MIN:
        raise AssertionError(f"l2 and sq8 top-1 agree on only {agree}")
    if not agree["ivfpq-rr"] >= agree["ivfpq"] - RR_AGREE_SLACK:
        raise AssertionError(f"ivfpq-rr trails ivfpq against l2: {agree}")

    # where the time goes (after the counted runs)
    profile = {"generate": profile_call(lambda: cli(
        ["generate", NAME, str(INDEX), "-c", cfg_path, "--yes", "-o",
         os.path.join(WORK, "emb_profiled")], standalone_mode=False),
        "generate")}
    for itype in paths:
        profile[itype] = profile_call(lambda: cli(
            evaluate_args(itype), standalone_mode=False),
            f"evaluate -i {itype}")
    return dict(launches=launches, launches_by_run=launches_by_run,
                gen_segments=n_seg, gen_s=gen_s, top1_agreement_with_l2=agree,
                ms_per_query={k: r["summary"]["ms_per_query"]
                              for k, r in results.items()},
                build_sec={k: r["summary"]["build_sec"]
                           for k, r in results.items()},
                rates={k: r["summary"]["rates"] for k, r in results.items()},
                profile=profile, cfg=cfg, cfg_path=cfg_path,
                dummy_dir=dummy_dir, emb_dir=emb_dir, variables=variables,
                l2_top1=top1["l2"], data=data,
                raw={k: r["raw"] for k, r in results.items()})


def ivfsq8_union_topk(idx, q, k, block=16):
    """The exact top-k over the union of each query's probed slices of an
    IVF-SQ8 store, by plain torch ops: the same coarse probe (f32, ties to
    the lower list), every row of the nprobe slices once, bf16-rounded
    queries times the int8 rows in f32, times the row scale."""
    import torch
    from nafp_tpu_torch.search.topk import topk_low_index
    dev = idx.vecs8.device
    out_v, out_i = [], []
    for s in range(0, len(q), block):
        qd = torch.from_numpy(q[s:s + block]).to(dev)
        _, probes = topk_low_index(qd @ idx.centroids.T, idx.nprobe)
        rows = (idx.starts[probes][:, :, None] + torch.arange(
            idx.list_cap, device=dev)).view(len(qd), -1).sort(1).values
        dup = torch.cat([torch.zeros_like(rows[:, :1], dtype=torch.bool),
                         rows[:, 1:] == rows[:, :-1]], 1)
        qb = qd.to(torch.bfloat16).to(torch.float32)
        score = torch.einsum("qd,qnd->qn", qb,
                             idx.vecs8[rows].to(torch.float32))
        score = score * idx.scales[rows]
        rid = idx.ids[rows]
        score = score.masked_fill(dup | (rid < 0), float("-inf"))
        v, sel = topk_low_index(score, k)
        i = rid.gather(1, sel)
        out_v.append(v)
        out_i.append(torch.where(torch.isfinite(v), i, -1))
    return torch.cat(out_v), torch.cat(out_i)


def phase_ivf_sq8(dev, main_path):
    """``evaluate -i ivf-sq8 --nprobe 40`` over the protocol DB (no
    hand-written kernel: the JAX package scans IVF-SQ8 in XLA, the port in
    torch ops): build time, ms/query, top-1 agreement with ``-i l2``, a
    profile; then, on 256 protocol queries, the index's top-k against the
    exact top-k over the union of each query's probed slices."""
    import numpy as np
    import torch
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.search import index as I
    from nafp_tpu_torch.search import topk as T

    store = os.path.join(WORK, "ivfsq8_store.npz")
    args = ["evaluate", NAME, str(INDEX), "-c", main_path["cfg_path"], "-i",
            "ivf-sq8", "--nprobe", str(NPROBE), "-t", str(N_TEST),
            "--emb_dummy_dir", main_path["dummy_dir"], "--index_cache", store]
    emb_dir = main_path["emb_dir"]
    T.reset_launches()
    t0 = time.perf_counter()
    cli(args, standalone_mode=False)
    wall = time.perf_counter() - t0
    launches = dict(T.LAUNCHES)
    with open(os.path.join(emb_dir, "eval_summary.json")) as f:
        summary = json.load(f)
    raw = np.load(os.path.join(emb_dir, "raw_score.npy"))
    if (summary["index_type"] != "ivf-sq8" or summary["n_db"] != N_DB_ROWS
            or summary["n_test"] != N_TEST or summary["nprobe"] != NPROBE):
        raise AssertionError(f"evaluate -i ivf-sq8: {summary}")
    if not os.path.exists(store):
        raise AssertionError("ivf-sq8 --index_cache store was not written")
    if any(launches.values()):
        raise AssertionError(f"evaluate -i ivf-sq8 launched {launches}")
    n_sl = len(summary["seq_lens"])
    agree = float((main_path["l2_top1"] == raw[:, :n_sl]).mean())
    log(f"  evaluate -i ivf-sq8 --nprobe {NPROBE}: {summary['ms_per_query']}"
        f" ms/query, index build {summary['build_sec']} s, wall {wall:.1f} "
        f"s, launches {launches}; top-1 exact agreement with l2 {agree:.4f}")
    log(f"    hit rates (%) at lengths {summary['seq_lens']}: "
        f"{json.dumps(summary['rates'])}")
    prof = profile_call(lambda: cli(args, standalone_mode=False),
                        "evaluate -i ivf-sq8 (store from --index_cache)")

    idx = I.IVFSQ8Index.load(store, nprobe=NPROBE, device=dev)
    _, query = protocol_db(main_path)
    rng = np.random.default_rng(SEED + 6)
    qs = np.ascontiguousarray(query[rng.choice(
        len(query), min(IVFSQ8_GATE_QUERIES, len(query)), replace=False)])
    v, i = (torch.from_numpy(a).to(dev) for a in idx.search(qs, K))
    pv, pi = ivfsq8_union_topk(idx, qs, K)
    pos = torch.empty(idx.ntotal, dtype=torch.long, device=dev)
    pos[idx.ids[:idx.ntotal].long()] = torch.arange(idx.ntotal, device=dev)
    qb = torch.from_numpy(qs).to(dev).to(torch.bfloat16).double()

    def score_at(ids):
        r = pos[ids]
        return (qb[:, None, :] * idx.vecs8[r].double()).sum(-1) \
            * idx.scales[r].double()
    err = check_topk(f"ivf-sq8 vs the exact top-{K} over the probed "
                     f"slices ({len(qs)} queries, nprobe {NPROBE}, list_cap "
                     f"{idx.list_cap}, nlist {idx.nlist})", v, i.long(), pv,
                     pi, score_at)
    return dict(summary=summary, wall_s=wall, launches=launches,
                top1_agreement_with_l2=agree, profile=prof,
                union_max_abs_err=err, nlist=idx.nlist,
                list_cap=idx.list_cap, raw=raw, store=store)


def protocol_db(main_path):
    """The protocol's merged [dummy_db; db] rows (619,500 x 128 f32) and its
    query fingerprints, from the memmaps of phase 3."""
    import numpy as np
    from nafp_tpu_torch.data.audio_io import load_memmap
    dummy, _ = load_memmap(main_path["dummy_dir"], "dummy_db", display=False)
    db, _ = load_memmap(main_path["emb_dir"], "db", display=False)
    query, _ = load_memmap(main_path["emb_dir"], "query", display=False)
    return (np.concatenate([np.asarray(dummy), np.asarray(db)]),
            np.array(query, np.float32))


def phase_ivfpq_store(dev, main_path):
    """An IVF-PQ store of the protocol DB, built and persisted on the card;
    small searches on the probe-pruned route timed against the linear
    scan; and
    kernels B1 and B3 timed on the protocol's query fingerprints against
    random unit queries (is their cost data-dependent?)."""
    import numpy as np
    import torch
    import nafp_tpu_torch.search.index as I
    from nafp_tpu_torch.search import topk as T

    full_db, query = protocol_db(main_path)
    store = os.path.join(WORK, "ivfpq_store.npz")
    t0 = time.perf_counter()
    idx = I.get_index("ivfpq", full_db, nprobe=NPROBE, device=dev)
    idx.add(full_db, persist_path=store)
    torch.cuda.synchronize()
    log(f"  IVF-PQ store on the card: train + add "
        f"{time.perf_counter() - t0:.1f} s, n_pad {idx.n_pad}, persisted to "
        f"{os.path.basename(store)}")

    # probe-pruned route against the linear scan (PRUNE_COVERAGE below any
    # coverage), timed as whole search calls: one query segment, and it with
    # seven near copies (a burst of similar segments probes nearly the same
    # lists)
    rng = np.random.default_rng(SEED + 4)
    q8 = query[:1] + 0.01 * rng.standard_normal((8, 128)).astype(np.float32)
    q8 /= np.linalg.norm(q8, axis=1, keepdims=True)
    q8[0] = query[0]
    calls = []
    orig = I._pq_gather_subtiles

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)
    prune_ms = {}
    I._pq_gather_subtiles = spy
    try:
        for nq in (1, 8):
            qs = q8[:nq]
            idx.PRUNE_COVERAGE = -1.0
            calls.clear()
            _, i_lin = idx.search(qs, K)
            linear_calls = len(calls)
            lin_ms = time_ms(lambda: idx.search(qs, K), 10)
            del idx.PRUNE_COVERAGE
            calls.clear()
            _, i_pr = idx.search(qs, K)
            if linear_calls or not calls:
                raise AssertionError(f"{nq} queries: pruned route gathers "
                                     f"{calls}, linear scan {linear_calls}")
            if not np.array_equal(i_pr, i_lin):
                raise AssertionError(f"{nq} queries: pruned search ids "
                                     "differ from the linear scan")
            pr_ms = time_ms(lambda: idx.search(qs, K), 10)
            prune_ms[nq] = dict(linear_ms=lin_ms, pruned_ms=pr_ms)
            log(f"  search of {nq} queries: pruned route {pr_ms:.3f} ms, "
                f"linear scan {lin_ms:.3f} ms (whole call); "
                f"_pq_gather_subtiles ran, ids identical")
    finally:
        I._pq_gather_subtiles = orig

    # data-dependent cost: the same kernels at the main shape, protocol
    # query fingerprints against random unit queries, in one call
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    qsets = {"protocol": torch.from_numpy(query[:512].copy()).to(dev),
             "random": unit_rows(512, 128, gen, dev)}
    db_dev = torch.from_numpy(full_db).to(dev)
    dec = idx._decode_chunk(idx.codes, idx.sub_list)
    times = {}
    for tag, q in qsets.items():
        bias = I._pq_expand_bias(
            I._pq_bias_list(q, idx.centroids, nprobe=NPROBE), idx.sub_list)
        times[tag] = dict(
            b1_ms=time_ms(lambda: T.topk_ip(q, db_dev, K), 20),
            b3_ms=time_ms(lambda: T.topk_ip_masked(
                q, dec, idx.ids, bias, K, LIST_TILE), 20),
            b3_k80_ms=time_ms(lambda: T.topk_ip_masked(
                q, dec, idx.ids, bias, 4 * K, LIST_TILE), 20))
        log(f"  {tag} queries (512): B1 {times[tag]['b1_ms']:.3f} ms over "
            f"{len(full_db)} rows, B3 {times[tag]['b3_ms']:.3f} ms (k {K}) / "
            f"{times[tag]['b3_k80_ms']:.3f} ms (k {4 * K}) over {idx.n_pad}")
    del db_dev, dec
    return dict(store=store, n_pad=idx.n_pad, query=query,
                data_dependence=times, prune_ms=prune_ms)


def profile_call(fn, tag: str, top: int = 6):
    """Run fn under torch.profiler (``utils.profiling.device_profile``):
    wall time, the device's busy time and busy share, and the device
    operations that take most time."""
    from nafp_tpu_torch.utils.profiling import device_profile

    p = device_profile(fn)
    wall_ms, busy_ms = p["wall_ms"], p["device_busy_ms"]
    rows = list(p["by_name"].items())[:top]
    log(f"  profile {tag}: wall {wall_ms:.1f} ms (profiler on), device "
        f"busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of the wall")
    for name, (ms, n) in rows:
        log(f"    {ms:9.2f} ms  x{n:<6d} {name[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy=busy_ms / wall_ms,
                top=[dict(name=name[:90], ms=ms, count=n)
                     for name, (ms, n) in rows])


# ---------------------------------------------------------------------------
# The device-resident corpus (DEVICE.DEVICE_CORPUS)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def counting_gathers():
    """Count ``device_corpus.gather_segments`` calls (one per key and
    batch of a loader on the device corpus) while the block runs; yields
    a one-element list holding the count."""
    from nafp_tpu_torch.data import device_corpus as DC
    n, orig = [0], DC.gather_segments

    def counted(*a, **kw):
        n[0] += 1
        return orig(*a, **kw)
    DC.gather_segments = counted
    try:
        yield n
    finally:
        DC.gather_segments = orig


def phase_device_corpus(dev, main_path):
    """Batches gathered on the card against the host loader's, bit for
    bit: a bsz-640 train loader with bg, IR and speech, a db loader with a
    short last batch and the ``unseen_syn`` query loader, on phase 3's
    corpus; then ``generate`` with DEVICE_CORPUS on against phase 3's
    memmaps (off)."""
    import copy
    import glob

    import numpy as np
    import torch
    import yaml
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.data import device_corpus as DC
    from nafp_tpu_torch.data.audio_io import load_memmap
    from nafp_tpu_torch.data.loader import SegmentLoader, prefetch

    data = main_path["data"]
    songs = sorted(glob.glob(f"{data}/music/test-dummy-db-100k-full/*.wav"))

    def aug(sub):
        return sorted(glob.glob(f"{data}/aug/{sub}/*.wav"))
    cases = {
        "train, bsz 640, bg + IR + speech": dict(
            fns_event_list=songs[:40], bsz=640, n_anchor=320, shuffle=True,
            random_offset_anchor=True, bg_fps=aug("bg/tr"),
            ir_fps=aug("ir/tr"), speech_fps=aug("speech/train")),
        "db, short last batch": dict(
            fns_event_list=songs[:7], bsz=125, n_anchor=125,
            drop_the_last_non_full_batch=False),
        "unseen_syn query": dict(
            fns_event_list=songs[:10], bsz=250, n_anchor=125,
            bg_fps=aug("bg/ts"), ir_fps=aug("ir/ts"),
            reduce_batch_first_half=True,
            drop_the_last_non_full_batch=False),
    }
    out = {}
    for tag, kw in cases.items():
        host = SegmentLoader(**kw)
        gathered = DC.DeviceGatherLoader(SegmentLoader(**kw), device=dev)
        host.set_epoch(2)
        gathered.set_epoch(2)
        n = 0
        for i, b in enumerate(prefetch(gathered)):
            h = host[i]
            if set(h) != set(b) or int(h["n_valid"]) != int(b["n_valid"]):
                raise AssertionError(f"{tag}, batch {i}: keys or n_valid")
            for k, x in b.items():
                if k == "n_valid":
                    continue
                if not (x.device == dev
                        and np.array_equal(x.cpu().numpy(), h[k])):
                    raise AssertionError(f"{tag}, batch {i}, {k}: the "
                                         "gathered batch differs")
            n += 1
        last = int(host[len(host) - 1]["n_valid"])
        out[tag] = dict(batches=n, last_n_valid=last)
        log(f"  device corpus, {tag}: {n} batches gathered on the card "
            f"(through prefetch's thread) equal the host loader's bit for "
            f"bit; keys {sorted(h)}; last batch n_valid {last}")
    if out["db, short last batch"]["last_n_valid"] >= 125:
        raise AssertionError("the db case has no short last batch")

    # generate with DEVICE_CORPUS on against phase 3's memmaps
    cfg = copy.deepcopy(main_path["cfg"])
    cfg["DEVICE"].update(DEVICE_CORPUS=True, DEVICE_CORPUS_MAX_GB=4)
    cfg_path = os.path.join(WORK, "smoke_device_corpus.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    with counting_gathers() as gathers:
        t0 = time.perf_counter()
        cli(["generate", NAME, str(INDEX), "-c", cfg_path, "--yes", "-o",
             os.path.join(WORK, "emb_device_corpus")], standalone_mode=False)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    worst = 0.0
    for key in ("dummy_db", "db", "query"):
        a, _ = load_memmap(os.path.join(WORK, "emb_device_corpus", NAME,
                                        str(INDEX)), key, display=False)
        b, _ = load_memmap(main_path["emb_dir"], key, display=False)
        worst = max(worst, float(np.abs(np.asarray(a) - np.asarray(b)).max()))
    log(f"  generate with DEVICE_CORPUS on: {gen_s:.2f} s "
        f"({main_path['gen_segments'] / gen_s:.1f} segments/s; off: "
        f"{main_path['gen_s']:.2f} s), {gathers[0]} gathers; memmaps within "
        f"{worst:.2e} of DEVICE_CORPUS off (tolerance {DEVICE_CORPUS_ATOL})")
    if not gathers[0]:
        raise AssertionError("generate with DEVICE_CORPUS on never gathered")
    if not worst <= DEVICE_CORPUS_ATOL:
        raise AssertionError(f"DEVICE_CORPUS memmaps differ by {worst}")
    return dict(loaders=out, generate_s=gen_s, generate_gathers=gathers[0],
                generate_max_abs_diff=worst)


# ---------------------------------------------------------------------------
# Phase 4: the sq8 kernel bench (kernels B4a and B4b)
# ---------------------------------------------------------------------------
def lib_sq8_topk(q, v, sc, rm, k, int8_dot):
    """One-call yardstick of B4a, taken in LIB_ROWS-row blocks: a bf16
    ``matmul`` (int8: ``torch._int_mm`` of the quantised queries) + scale +
    mask + ``topk`` per block, then ``topk`` of the blocks' results."""
    import torch
    from nafp_tpu_torch.extras import bench_sq8_kernel as B
    if int8_dot:
        q8, qs = B.quantize_queries(q)
    vals, ids = [], []
    for r0 in range(0, v.shape[0], LIB_ROWS):
        rows = v[r0:r0 + LIB_ROWS].T
        raw = (torch._int_mm(q8, rows) if int8_dot
               else torch.matmul(q, rows))
        s = raw.float() * sc[r0:r0 + LIB_ROWS] + rm[r0:r0 + LIB_ROWS]
        bv, bi = torch.topk(s, k, dim=1)
        vals.append(bv)
        ids.append(bi + r0)
    bv, j = torch.topk(torch.cat(vals, 1), k, dim=1)
    return (bv * qs[:, None] if int8_dot else bv), torch.cat(ids, 1).gather(
        1, j)


def lib_block_max(q16, v16, blk):
    """One-call yardstick of B4b in LIB_ROWS-row blocks: bf16 ``matmul`` +
    ``amax`` over each blk-row block."""
    import torch
    bq = q16.shape[0]
    return torch.cat([torch.matmul(q16, v16[r0:r0 + LIB_ROWS].T).view(
        bq, -1, blk).amax(dim=2) for r0 in range(0, v16.shape[0], LIB_ROWS)],
        dim=1)


def phase_bench(dev, b4_main):
    """The port's sq8 kernel bench through its entry point at its default
    shape (N 8,388,608 x 128 int8, Bq 512, k 20, blk 2048), the launch
    counters zeroed just before and read just after; then, on the same data
    (seed 0), B4a and B4b against their plain versions, the plain versions'
    and the one-call yardsticks' times, and each kernel's bound."""
    import torch
    from nafp_tpu_torch import kernels
    from nafp_tpu_torch.extras import bench_sq8_kernel as B
    from nafp_tpu_torch.search import topk as T

    B.reset_launches()
    T.reset_launches()
    t0 = time.perf_counter()
    res = B.main([])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(B.LAUNCHES, topk_ip_sq8=T.LAUNCHES["topk_ip_sq8"])
    log(f"  bench: {wall:.1f} s, launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the bench left a kernel unlaunched: {launches}")
    for name in ("v3", "v2"):
        if not (res[name]["ids_agree"] == 1.0 and res[name]["top1"] == 1.0):
            raise AssertionError(f"bench {name}: ids differ from v0: "
                                 f"{res[name]}")
    if not res["int8"]["top1"] >= BENCH_INT8_TOP1_MIN:
        raise AssertionError(f"bench int8: top-1 {res['int8']['top1']}")

    n, bq, blk = BENCH_N, BENCH_BQ, BENCH_BLK
    q, vecs8, scales, rmask = B.make_data(n, bq, dev)
    q16, v16 = q.to(torch.bfloat16), vecs8.to(torch.bfloat16)
    flops = 2.0 * bq * n * 128
    sq8_bytes = n * 128 + 8.0 * n + 4.0 * bq * 128 + 8.0 * bq * K
    # the bench's v0 is kernel B2 (topk_ip_sq8) at this shape
    v, i = T.topk_ip_sq8(q, vecs8, scales, rmask, K)
    pv, pi = T.topk_ip_sq8_plain(q, vecs8, scales, rmask, K,
                                 compute_dtype=torch.bfloat16)
    v0_err = check_topk("B2 (the bench's v0) @ bench shape", v, i, pv, pi,
                        b4a_score_at(q, vecs8, scales, rmask, False))
    v0_residency = scan_residency("topk_sq8", bq, n, 128, K)
    log_residency("B2 @ bench shape", v0_residency)
    del v, i, pv, pi
    variants = {}
    for name, kw in B4A.items():
        int8_dot = kw.get("int8_dot", False)
        tag = f"B4a {name} @ bench shape"
        v, i = B.run_variant(q, vecs8, scales, rmask, k=K, **kw)
        pv, pi = B.run_variant_plain(q, vecs8, scales, rmask, K,
                                     int8_dot=int8_dot,
                                     compute_dtype=torch.bfloat16)
        if int8_dot and not (torch.equal(v, pv) and torch.equal(i, pi)):
            raise AssertionError(f"{tag}: int8 results differ from the "
                                 "plain version's")
        err = check_topk(tag, v, i, pv, pi,
                         b4a_score_at(q, vecs8, scales, rmask, int8_dot))
        del v, i, pv, pi
        plain_ms = time_ms(lambda: B.run_variant_plain(
            q, vecs8, scales, rmask, K, int8_dot=int8_dot,
            compute_dtype=torch.bfloat16), 2, warmup=1)
        if not int8_dot:
            lib_ms = time_ms(lambda: lib_sq8_topk(q16, v16, scales, rmask,
                                                  K, False), 3, warmup=1)
        elif bq > 16 and q.shape[1] % 8 == 0 and LIB_ROWS % 8 == 0:
            # torch._int_mm's shape rule on CUDA: (m, k) x (k, n) int8 with
            # m > 16 and k, n multiples of 8
            lib_ms = time_ms(lambda: lib_sq8_topk(
                q, vecs8, scales, rmask, K, True), 3, warmup=1)
        else:
            lib_ms = "not measured (torch._int_mm takes m > 16, k % 8 == 0)"
        peak = PEAK_INT8 if int8_dot else PEAK_BF16
        bound = max(flops / peak, sq8_bytes / PEAK_BYTES) * 1e3
        variants[name] = dict(
            ms=res[name]["ms"], plain_ms=plain_ms, library_ms=lib_ms,
            bound_ms=bound, bound_by="operations"
            if flops / peak >= sq8_bytes / PEAK_BYTES else "bytes",
            max_abs_err=max(err, b4_main["max_abs_err"][name]),
            residency=scan_residency("bench_variant", bq, n, 128, K,
                                    int(int8_dot), int(name == "v2")))
        log_residency(tag, variants[name]["residency"])
        lib = lib_ms if isinstance(lib_ms, str) else f"{lib_ms:.3f} ms"
        log(f"  {tag}: kernel {res[name]['ms']:.3f} ms, plain "
            f"{plain_ms:.3f} ms, yardstick {lib}, bound {bound:.3f} ms")
    err = check_b4b("B4b @ bench shape", q, vecs8, blk)
    plain_ms = time_ms(lambda: B.run_dotonly_plain(q, vecs8, blk), 2,
                       warmup=1)
    lib_ms = time_ms(lambda: lib_block_max(q16, v16, blk), 3, warmup=1)
    dot_bytes = n * 128 + 4.0 * bq * 128 + 4.0 * bq * (n // blk)
    bound = max(flops / PEAK_BF16, dot_bytes / PEAK_BYTES) * 1e3
    dotonly = dict(ms=res["dotonly"]["ms"], plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound,
                   bound_by="operations" if flops / PEAK_BF16
                   >= dot_bytes / PEAK_BYTES else "bytes",
                   max_abs_err=max(err, b4_main["max_abs_err"]["dotonly"]))
    log(f"  B4b @ bench shape: kernel {dotonly['ms']:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bf16 matmul+amax {lib_ms:.3f} ms, bound "
        f"{bound:.3f} ms")
    residency = dict(zip(("smem", "ctas_per_sm", "regs", "grid"),
                         kernels.occupancy("bench_dotonly", bq, n, 128, blk,
                                           n_out=4)))
    v0 = res["v0"]["ms"]
    share = (v0 - res["dotonly"]["ms"]) / v0
    log(f"  B4b @ bench shape: {residency['smem']} B shared memory per CTA, "
        f"{residency['ctas_per_sm']} CTAs per SM, {residency['regs']} "
        f"registers, {residency['grid']} CTAs ({n // blk} blocks); "
        f"{flops / res['dotonly']['ms'] / 1e9:.1f} TFLOP/s")
    log(f"  B2 above the tensor-core floor at the bench shape, (v0 - "
        f"dotonly) / v0: {share:.3f}")
    del q16, v16, vecs8
    return dict(results=res, wall_s=wall, launches=launches,
                variants=variants, dotonly=dotonly, v0_max_abs_err=v0_err,
                v0_residency=v0_residency, selection_share=share,
                residency=residency)


# ---------------------------------------------------------------------------
# Phase 5: card against CPU
# ---------------------------------------------------------------------------
def phase_card_vs_cpu(dev, main_path, ivfpq):
    import copy

    import numpy as np
    import torch
    from nafp_tpu_torch.data.catalog import Dataset
    from nafp_tpu_torch.generate import build_model
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.ops.melspec import get_melspec_fn

    cfg, variables = main_path["cfg"], main_path["variables"]
    cfg_path, dummy_dir, emb_dir = (main_path["cfg_path"],
                                    main_path["dummy_dir"],
                                    main_path["emb_dir"])
    t0 = time.perf_counter()
    cfg32 = copy.deepcopy(cfg)
    cfg32["MODEL"]["MIXED_PRECISION"] = False
    melspec_fn, _ = get_melspec_fn(cfg)
    loader, _ = Dataset(cfg).get_test_query_db_ds()
    batches = [torch.from_numpy(loader[i]["anchors"])
               for i in range(min(2, len(loader)))]
    cpu = torch.device("cpu")
    m_cpu = build_model(cfg32, variables, cpu)
    m_gpu = build_model(cfg32, variables, dev)
    m_bf16 = build_model(cfg, variables, dev)
    worst, cos_min = 0.0, 1.0
    with torch.inference_mode():
        for x in batches:
            e_cpu = m_cpu(melspec_fn(x)).numpy()
            xg = x.to(dev)
            e_gpu = m_gpu(melspec_fn(xg)).cpu().numpy()
            e_bf = m_bf16(melspec_fn(xg)).float().cpu().numpy()
            worst = max(worst, float(np.abs(e_gpu - e_cpu).max()))
            cos_min = min(cos_min, float((e_bf * e_gpu).sum(1).min()))
    log(f"  f32 card vs f32 CPU: max |diff| {worst:.3e} over "
        f"{sum(len(b) for b in batches)} segments (tolerance {ENCODER_ATOL})")
    log(f"  bf16 vs f32 on the card: min cosine {cos_min:.5f} "
        f"(floor {BF16_COS_MIN})")
    if not worst <= ENCODER_ATOL:
        raise AssertionError(f"card vs CPU encoder differ by {worst}")
    if not cos_min > BF16_COS_MIN:
        raise AssertionError(f"bf16 vs f32 cosine {cos_min}")
    log(f"  (encoder checks took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()

    # the protocol itself: card (B1 + rescoring on the card) against the
    # CPU (plain B1), same memmaps and a reduced id set
    raws = {}
    for flag in ([], ["--nogpu"]):
        cli(["evaluate", NAME, str(INDEX), "-c", cfg_path, "-i", "l2",
             "-t", "200", "--test_seq_len", "1 5", "--emb_dummy_dir",
             dummy_dir, *flag], standalone_mode=False)
        raws[bool(flag)] = np.load(os.path.join(emb_dir, "raw_score.npy"))
    eval_agree = float((raws[False] == raws[True]).mean())
    log(f"  evaluate -i l2 (200 ids, lengths 1 5) card vs CPU: raw_score "
        f"agreement {eval_agree:.4f} (floor {CARD_CPU_AGREE_MIN})")
    if not eval_agree >= CARD_CPU_AGREE_MIN:
        raise AssertionError(f"card and CPU evaluate agree on {eval_agree}")
    log(f"  (evaluate card vs CPU took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()

    # the persisted IVF-PQ store, loaded on the card (B3, bf16 queries) and
    # on the CPU (plain B3, f32 queries): 256 protocol queries
    from nafp_tpu_torch.search.index import IVFPQIndex
    q256 = ivfpq["query"][:256]
    card, host = (IVFPQIndex.load(ivfpq["store"], nprobe=NPROBE,
                                  device=where).search(q256, K)[1][:, 0]
                  for where in (dev, cpu))
    pq_agree = float((card == host).mean())
    log(f"  IVF-PQ store card vs CPU: top-1 id agreement {pq_agree:.4f} over "
        f"256 protocol queries (floor {CARD_CPU_AGREE_MIN}), "
        f"{time.perf_counter() - t0:.1f} s")
    if not pq_agree >= CARD_CPU_AGREE_MIN:
        raise AssertionError(f"IVF-PQ card and CPU agree on {pq_agree}")
    return dict(card_vs_cpu_max_abs=worst, bf16_cos_min=cos_min,
                eval_card_vs_cpu_agreement=eval_agree,
                ivfpq_card_vs_cpu_top1=pq_agree)


# ---------------------------------------------------------------------------
# Phase 7: the training path
# ---------------------------------------------------------------------------
def train_corpus_cfg(data, preset="default", **model):
    """A preset pointed at the training corpus and phase 7's work dirs."""
    from nafp_tpu_torch.configuration import load_config
    cfg = load_config(preset)
    cfg["DIR"].update(SOURCE_ROOT_DIR=f"{data}/music/",
                      BG_ROOT_DIR=f"{data}/aug/bg/",
                      IR_ROOT_DIR=f"{data}/aug/ir/",
                      OUTPUT_ROOT_DIR=f"{WORK}/train_emb/",
                      LOG_ROOT_DIR=f"{WORK}/train_logs/")
    cfg["MODEL"].update(model)
    return cfg


def host_draws(cfg, n_rep, gen, n_all=None):
    """One step's augmentation draws (bg mix of ``n_rep`` replicas,
    SpecAugment holes and gates of ``n_all`` segments, default 2·n_rep)
    from a CPU generator, so the card and the CPU compute on the same
    values."""
    import torch
    from nafp_tpu_torch.ops.specaug import hole_ranges
    from nafp_tpu_torch.ops.tdaug import draw_bg_mix
    snr, amp = draw_bg_mix(gen, n_rep, tuple(cfg["TD_AUG"]["TR_SNR"]))
    sa = cfg["SPEC_AUG"]
    spec = [dict(ranges=hole_ranges(
                     gen, kind, 1, int(sa["SPECAUG_N_HOLES"]) if kind ==
                     "cutout" else 1, 256, 32),
                 act=torch.rand((n_all or 2 * n_rep, 1, 1, 1), generator=gen)
                 < float(sa["SPECAUG_PROBS"]))
            for kind in sa["SPECAUG_CHAIN"]]
    return {"td": dict(snr=snr, amp=amp), "spec": spec}


def to_device(tree, dev):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    return tree


def step_loss_grads(cfg, state, batch, draws, dev):
    """Loss and gradients of one train step of the full-width model with
    ``state``'s weights, on ``dev``."""
    from nafp_tpu_torch.train import trainer as TR
    mel, spec, model, _ = TR.build_fp(cfg)
    model.load_state_dict(state)
    model.to(dev).train()
    loss, _ = TR._make_loss_fn(cfg, mel, spec, model, train=True)(
        to_device(batch, dev), None, to_device(draws, dev))
    loss.backward()
    return loss.item(), {n: p.grad.float().cpu()
                         for n, p in model.named_parameters()}


def train_metrics(run_dir):
    """{tag: {epoch: value}} of one training run's metrics.jsonl."""
    out = {}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        for line in f:
            m = json.loads(line)
            out.setdefault(m["tag"], {})[m["step"]] = m["value"]
    return out


def train_runs(name):
    d = os.path.join(WORK, "train_logs", "fit", name)
    return sorted(os.path.join(d, r) for r in os.listdir(d))


def ckpt_meta(name, epoch):
    with open(os.path.join(WORK, "train_logs", "checkpoint", name,
                           str(epoch), "meta.json")) as f:
        return json.load(f)


def timed_steps(cfg, batch_np, dev, n_steps, warmup=3):
    """``n_steps`` train steps of ``cfg`` on one device-resident batch,
    timed with CUDA events after ``warmup`` steps: (step ms, peak device
    bytes, losses, the model)."""
    import torch
    from nafp_tpu_torch.optim.schedules import build_optimizer
    from nafp_tpu_torch.train import trainer as TR
    mel, spec, model, _ = TR.build_fp(cfg)
    model.to(dev)
    opt, sched = build_optimizer(cfg, model, 1000)
    step = TR.TrainStep(cfg, model, opt, sched,
                        TR._make_loss_fn(cfg, mel, spec, model, train=True),
                        dev)
    batch = TR.BatchUploader(dev)(batch_np)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [step(batch)[0] for _ in range(warmup)]
    ms = time_ms(lambda: losses.append(step(batch)[0]), n_steps, warmup=0)
    return (ms, torch.cuda.max_memory_allocated(),
            [float(x) for x in losses], model)


def check_uploader(ds, dev, n=4):
    """``n`` host batches through one BatchUploader back to back, with no
    synchronisation between them, so its pinned buffer slots are refilled
    while earlier copies may be in flight: every device tensor must equal
    its host batch."""
    import numpy as np
    import torch
    from nafp_tpu_torch.train import trainer as TR
    host = [ds[i] for i in range(n)]
    upload = TR.BatchUploader(dev)
    got = [upload(b) for b in host]
    torch.cuda.synchronize()
    for i, (h, d) in enumerate(zip(host, got)):
        for k, v in d.items():
            if not np.array_equal(v.cpu().numpy(), h[k]):
                raise AssertionError(f"uploaded batch {i} {k} differs from "
                                     "its host batch")
    log(f"  BatchUploader: {n} batches through {TR.UPLOAD_SLOTS} pinned "
        f"slots, each equal to its host batch")


def step_layers(cfg, ds, dev, iters=20):
    """Where a bsz-120 step's time goes, layer by layer (CUDA events, one
    device-resident batch; the loader by the host clock): ms each."""
    import torch
    from nafp_tpu_torch.losses.ntxent import ntxent_loss
    from nafp_tpu_torch.ops.tdaug import augment_replicas
    from nafp_tpu_torch.optim.schedules import build_optimizer
    from nafp_tpu_torch.train import trainer as TR

    t0 = time.perf_counter()
    host = [ds[i] for i in range(5)]
    loader_ms = (time.perf_counter() - t0) * 1e3 / 5
    upload = TR.BatchUploader(dev)
    upload_ms = time_ms(lambda: upload(host[0]), iters)
    b = upload(host[0])
    mel, spec, model, _ = TR.build_fp(cfg)
    model.to(dev).train()
    opt, _ = build_optimizer(cfg, model, 1000)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    snr = tuple(cfg["TD_AUG"]["TR_SNR"])

    def aug():
        return augment_replicas(b["replicas"], b["bg"], b["ir"], gen, snr)
    xp = aug()
    x = torch.cat([b["anchors"], xp])
    feat = spec(mel(x), gen)
    n = b["anchors"].shape[0]

    def fwd_bwd():
        emb = model(feat)
        emb.sum().backward()

    emb = model(feat).detach().requires_grad_()

    def loss_fwd_bwd():
        ntxent_loss(emb[:n], emb[n:])[0].backward()
    fwd_bwd()
    with torch.no_grad():
        fwd_ms = time_ms(lambda: model(feat), iters)
    return dict(loader_host_ms=loader_ms, upload_ms=upload_ms,
                tdaug_ms=time_ms(aug, iters),
                logmel_specaug_ms=time_ms(lambda: spec(mel(x), gen), iters),
                encoder_fwd_ms=fwd_ms,
                encoder_fwd_bwd_ms=time_ms(fwd_bwd, iters),
                loss_fwd_bwd_ms=time_ms(loss_fwd_bwd, iters),
                optimizer_ms=time_ms(opt.step, iters))


def serve_checkpoint(cli, T, cfg_path, out_root, index, dev,
                     name=TRAIN_NAME):
    """generate + evaluate -i l2 (kernel B1) of checkpoint ``index`` of run
    ``name`` over a DB padded with random unit rows to TRAIN_DB_ROWS:
    top-1 exact % at 1, 2 and 3 s, the held-out song-level NT-Xent of
    generate's fingerprints (batches of one random segment per song, its
    db row the anchor and its query row the positive; tau 0.05,
    SERVE_LOSS_BATCHES seeded batches), and the evaluate's launches."""
    import numpy as np
    import torch
    from nafp_tpu_torch.data.audio_io import create_memmap, load_memmap
    from nafp_tpu_torch.losses.ntxent import ntxent_loss
    cli(["generate", name, str(index), "-c", cfg_path, "--yes"],
        standalone_mode=False)
    emb_dir = os.path.join(WORK, out_root, name, str(index))
    dummy, _ = load_memmap(emb_dir, "dummy_db", display=False)
    db = torch.from_numpy(np.array(load_memmap(emb_dir, "db",
                                               display=False)[0]))
    query = torch.from_numpy(np.array(load_memmap(emb_dir, "query",
                                                  display=False)[0]))
    n_db, seg = len(db), len(db) // TRAIN_QUERY
    if len(query) != n_db or n_db != seg * TRAIN_QUERY:
        raise AssertionError(f"query/db rows {len(query)}/{n_db}")
    dummy_dir = os.path.join(WORK, f"{out_root}_dummy{index}")
    arr = create_memmap(dummy_dir, "dummy_db", (TRAIN_DB_ROWS - n_db, 128))
    arr[:len(dummy)] = dummy
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    arr[len(dummy):] = unit_rows(TRAIN_DB_ROWS - n_db - len(dummy), 128, gen,
                                 dev).cpu().numpy()
    arr.flush()
    del arr
    T.reset_launches()
    cli(["evaluate", name, str(index), "-c", cfg_path, "-i", "l2", "-t",
         "all", "--test_seq_len", "1 3 5", "--emb_dummy_dir", dummy_dir],
        standalone_mode=False)
    launches = dict(T.LAUNCHES)
    if launches["topk_ip"] <= 0:
        raise AssertionError("evaluate -i l2 did not launch B1")
    raw = np.load(os.path.join(emb_dir, "raw_score.npy"))
    rng = np.random.default_rng(SEED)
    losses = []
    for _ in range(SERVE_LOSS_BATCHES):
        sel = torch.from_numpy(np.arange(TRAIN_QUERY) * seg
                               + rng.integers(0, seg, TRAIN_QUERY))
        losses.append(ntxent_loss(db[sel], query[sel])[0].item())
    return dict(top1=[round(100.0 * float(raw[:, i].mean()), 3)
                      for i in range(3)],
                song_loss=float(np.mean(losses)), launches=launches)


def phase_training(dev):
    import copy

    import numpy as np
    import torch
    import yaml
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.data.catalog import Dataset
    from nafp_tpu_torch.data.loader import prefetch
    from nafp_tpu_torch.models.convert import save_params_npz, torch_to_flax
    from nafp_tpu_torch.optim.schedules import build_optimizer
    from nafp_tpu_torch.search import topk as T
    from nafp_tpu_torch.train import trainer as TR

    out = {}
    data = os.path.join(WORK, "train_data")
    t0 = time.perf_counter()
    subprocess.run([sys.executable,
                    SYNTH,
                    data, "--n_train", str(TRAIN_SONGS), "--n_query",
                    str(TRAIN_QUERY), "--n_dummy", str(TRAIN_DUMMY), "--sec",
                    str(SONG_SEC)],
                   check=True, timeout=600, stdout=subprocess.DEVNULL)
    log(f"  training corpus in {time.perf_counter() - t0:.1f} s")
    cfg = train_corpus_cfg(data)
    cfg_path = os.path.join(WORK, "train.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)

    # one step at full width, card (f32, TF32 off) against the CPU (f32),
    # then bf16 against f32 on the card; same weights, batch and draws
    t0 = time.perf_counter()
    cfg32 = train_corpus_cfg(data, MIXED_PRECISION=False)
    cfg32["BSZ"].update(TR_BATCH_SZ=8, TR_N_ANCHOR=4)
    batch = {k: torch.from_numpy(v) for k, v in
             Dataset(cfg32).get_train_ds()[0].items() if k in TR.BATCH_KEYS}
    if sorted(batch) != ["anchors", "bg", "ir", "replicas"]:
        raise AssertionError(f"train batch keys {sorted(batch)}")
    draws = host_draws(cfg32, 4, torch.Generator().manual_seed(SEED))
    state = TR.build_fp(cfg32)[2].state_dict()
    cpu_loss, cpu_g = step_loss_grads(cfg32, state, batch, draws,
                                      torch.device("cpu"))
    gpu_loss, gpu_g = step_loss_grads(cfg32, state, batch, draws, dev)
    bf_cfg = copy.deepcopy(cfg32)
    bf_cfg["MODEL"]["MIXED_PRECISION"] = True
    bf_loss, _ = step_loss_grads(bf_cfg, state, batch, draws, dev)
    loss_rel = abs(gpu_loss / cpu_loss - 1)
    grad_rel = max(float((gpu_g[n] - cpu_g[n]).norm() / cpu_g[n].norm())
                   for n in cpu_g)
    bf_rel = abs(bf_loss / gpu_loss - 1)
    log(f"  one step, card vs CPU (f32, bsz 8): loss {gpu_loss:.6f} vs "
        f"{cpu_loss:.6f} ({loss_rel:.2e} relative, tolerance "
        f"{STEP_LOSS_RTOL}); worst gradient leaf {grad_rel:.2e} relative in "
        f"Frobenius norm over {len(cpu_g)} leaves (tolerance "
        f"{STEP_GRAD_RTOL}); bf16 loss {bf_loss:.6f} ({bf_rel:.2e} relative "
        f"to f32 on the card, tolerance {BF16_LOSS_RTOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not loss_rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"card vs CPU step loss differ by {loss_rel}")
    if not grad_rel <= STEP_GRAD_RTOL:
        raise AssertionError(f"card vs CPU gradients differ by {grad_rel}")
    if not bf_rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 vs f32 step loss differ by {bf_rel}")
    out["step_card_vs_cpu"] = dict(loss_rel=loss_rel, grad_rel=grad_rel,
                                   bf16_loss_rel=bf_rel)

    # training through the CLI: the default preset at full width, 2 epochs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli(["train", TRAIN_NAME, "-c", cfg_path, "--max_epoch", "2"],
        standalone_mode=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    (run,) = train_runs(TRAIN_NAME)
    m = train_metrics(run)
    losses = list(m["loss/train"].values()) + list(m["loss/val"].values())
    top1 = m.get("mini_search/top1_g(f)_scope1", {})
    steps = ckpt_meta(TRAIN_NAME, 1)["step"]
    log(f"  cli train -c default --max_epoch 2: {train_s:.1f} s, {steps} "
        f"steps per epoch; train loss {m['loss/train']}, val loss "
        f"{m['loss/val']}; mini-search top-1 g(f) @1 seg {top1}; step "
        f"{m['throughput/step_ms']} ms, {m['throughput/segments_per_sec']} "
        f"segments/s (bsz 120, EMA of the epoch's host step time); peak "
        f"device memory {peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {m}")
    if not m["loss/train"][2] < m["loss/train"][1]:
        raise AssertionError(f"train loss did not fall: {m['loss/train']}")
    ck = os.path.join(WORK, "train_logs", "checkpoint", TRAIN_NAME)
    for ep in (1, 2):
        if not os.path.exists(os.path.join(ck, str(ep), "params.npz")):
            raise AssertionError(f"checkpoint {ep}/params.npz missing")
    if sorted(top1) != [1, 2]:
        raise AssertionError(f"mini-search top-1 not logged: {top1}")

    # where a step's time goes: a window of the real loop (host loader,
    # pinned upload, step) under torch.profiler, on a fresh model
    mel, spec, model, _ = TR.build_fp(cfg)
    model.to(dev)
    ds = Dataset(cfg).get_train_ds()
    opt, sched = build_optimizer(cfg, model, len(ds))
    step = TR.TrainStep(cfg, model, opt, sched, TR._make_loss_fn(
        cfg, mel, spec, model, train=True, aug_keys=TR._aug_keys(ds)), dev)
    upload = TR.BatchUploader(dev)
    batches = prefetch(ds)
    for _, b in zip(range(3), batches):
        step(upload(b))
    n_prof = min(PROFILE_STEPS, (len(ds) - 3) // 2)

    def window():
        for _, b in zip(range(n_prof), batches):
            step(upload(b))
    # the same window without the profiler: its wall time against the
    # device busy time the profiled window measures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_call(window, f"{n_prof} train steps (bsz 120)")
    busy_plain = prof["device_busy_ms"] / plain_wall_ms
    log(f"  the same {n_prof} steps without the profiler: wall "
        f"{plain_wall_ms:.1f} ms; device busy (the profiled window's) "
        f"{busy_plain:.3f} of it")
    check_uploader(ds, dev)
    layers = step_layers(cfg, ds, dev)
    log("  a bsz-120 step by layer (ms; CUDA events on one device batch, "
        "the loader by the host clock): " + json.dumps(
            {k: round(v, 3) for k, v in layers.items()}))
    out["cli_train"] = dict(
        seconds=train_s, steps_per_epoch=steps, peak_bytes=peak,
        train_loss=m["loss/train"], val_loss=m["loss/val"],
        step_ms=m["throughput/step_ms"],
        segments_per_sec=m["throughput/segments_per_sec"],
        mini_top1=top1, profile=prof, layers=layers,
        profile_step_ms=prof["wall_ms"] / n_prof,
        plain_step_ms=plain_wall_ms / n_prof, busy_unprofiled=busy_plain)

    # resume: --max_epoch 3 restores epoch 2 and trains only epoch 3
    t0 = time.perf_counter()
    cli(["train", TRAIN_NAME, "-c", cfg_path, "--max_epoch", "3"],
        standalone_mode=False)
    runs = train_runs(TRAIN_NAME)
    m3 = train_metrics(runs[-1])
    epochs = sorted({ep for v in m3.values() for ep in v})
    log(f"  resume --max_epoch 3: epochs logged {epochs}, step "
        f"{ckpt_meta(TRAIN_NAME, 3)['step']}, train loss "
        f"{m3['loss/train']}, {time.perf_counter() - t0:.1f} s")
    if len(runs) != 2 or epochs != [3]:
        raise AssertionError(f"resume trained epochs {epochs}")
    if ckpt_meta(TRAIN_NAME, 3)["step"] != 3 * steps:
        raise AssertionError("resume did not continue from epoch 2's step")
    if not np.isfinite(list(m3["loss/train"].values())).all():
        raise AssertionError(f"non-finite loss after resume: {m3}")

    # the checkpoint feeds serving: generate + evaluate -i l2 (B1) with the
    # trained weights (index 3) and the untrained init (index 0), on the
    # corpus's 20 held-out db songs with two query sets: its own
    # 'unseen_icassp' pairs (gain and faint white noise) and 'unseen_syn'
    # (generate synthesizes the queries with the test-time background mix
    # and IR). The gate is the held-out song-level NT-Xent of generate's
    # fingerprints: the trained checkpoint must separate the songs better
    # than the init. Top-1 exact is printed, not gated: a few epochs on
    # this corpus do not lift it above the random init's, and at a reduced
    # width on the CPU the JAX package's trainer does not lift it either
    # (tests/train_top1_jax_vs_port.py; PERF.md, Findings).
    save_params_npz(os.path.join(ck, "0", "params.npz"),
                    torch_to_flax(TR.build_fp(cfg)[2].state_dict()))
    serve = os.path.join(WORK, "serve_data", "music")
    shutil.copytree(os.path.join(data, "music", "test-query-db-500-30s", "db"),
                    os.path.join(serve, "val-query-db-500-30s", "db"))
    shutil.copytree(os.path.join(data, "music", "test-dummy-db-100k-full"),
                    os.path.join(serve, "test-dummy-db-100k-full"))
    syn = copy.deepcopy(cfg)
    syn["DIR"].update(SOURCE_ROOT_DIR=serve + "/",
                      OUTPUT_ROOT_DIR=f"{WORK}/serve_emb/")
    syn["DATA_SEL"]["TEST_QUERY_DB"] = "unseen_syn"
    syn_path = os.path.join(WORK, "serve_syn.yaml")
    with open(syn_path, "w") as f:
        yaml.safe_dump(syn, f)
    served = {}
    for proto, path, root in (("unseen_icassp", cfg_path, "train_emb"),
                              ("unseen_syn", syn_path, "serve_emb")):
        for index in (0, 3):
            r = serve_checkpoint(cli, T, path, root, index, dev)
            served[f"{proto}@{index}"] = r
            log(f"  {proto}, checkpoint {index} ({'trained, epoch 3' if index else 'untrained init'}): "
                f"top-1 exact % at 1/2/3 s {r['top1']} over {TRAIN_DB_ROWS} "
                f"DB rows (generate + evaluate -i l2); held-out song-level "
                f"NT-Xent {r['song_loss']:.4f}")
        if not (served[f"{proto}@3"]["song_loss"]
                < served[f"{proto}@0"]["song_loss"]):
            raise AssertionError(f"{proto}: the trained checkpoint does not "
                                 f"separate held-out songs better than the "
                                 f"init: {served}")
    out["served"] = served

    # the other presets: 640_lamb (bsz 640, LAMB) on a device-resident
    # batch, timed with CUDA events; batch_norm for a few steps
    cfg640 = train_corpus_cfg(data, "640_lamb")
    b640 = Dataset(cfg640).get_train_ds()[0]
    ms, peak640, l640, _ = timed_steps(cfg640, b640, dev, LAMB_STEPS)
    log(f"  640_lamb: {ms:.2f} ms per step = {640 / ms * 1e3:.1f} "
        f"segments/s over {LAMB_STEPS} steps on one device-resident batch "
        f"(CUDA events), peak device memory {peak640 / 2**30:.2f} GiB, "
        f"loss {l640[0]:.4f} -> {l640[-1]:.4f}")
    if not np.isfinite(l640).all():
        raise AssertionError(f"640_lamb loss not finite: {l640}")
    # 640_lamb through the CLI for one epoch (22 steps), the host loader
    # and then the device-resident corpus (DEVICE_CORPUS) in turns
    lamb_cli = {}
    for on in (False, True):
        tag = "device corpus" if on else "host loader"
        c = train_corpus_cfg(data, "640_lamb")
        c["DEVICE"]["DEVICE_CORPUS"] = on
        c["TRAIN"].update(MINI_TEST_IN_TRAIN=False, SAVE_IMG=False)
        path = os.path.join(WORK, f"train640_{int(on)}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(c, f)
        name = f"smoke640_{int(on)}"
        with counting_gathers() as gathers:
            t0 = time.perf_counter()
            cli(["train", name, "-c", path, "--max_epoch", "1"],
                standalone_mode=False)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        (run,) = train_runs(name)
        m = train_metrics(run)
        lamb_cli[tag] = dict(step_ms=m["throughput/step_ms"][1],
                             segments_per_sec=m[
                                 "throughput/segments_per_sec"][1],
                             epoch_sec=m["time/epoch_sec"][1],
                             train_loss=m["loss/train"][1],
                             val_loss=m["loss/val"][1], gathers=gathers[0],
                             cli_s=secs)
        if not np.isfinite([m["loss/train"][1], m["loss/val"][1]]).all():
            raise AssertionError(f"640_lamb, {tag}: loss not finite: {m}")
        if bool(gathers[0]) != on:
            raise AssertionError(f"640_lamb, {tag}: {gathers[0]} gathers")
    log("  640_lamb, cli train 1 epoch (22 steps of bsz 640): " + "; ".join(
        f"{tag} {r['step_ms']:.1f} ms/step, {r['segments_per_sec']:.0f} "
        f"segments/s (the CLI's EMA), epoch {r['epoch_sec']:.1f} s with "
        f"validation, train loss {r['train_loss']:.4f}, {r['gathers']} "
        f"gathers" for tag, r in lamb_cli.items()))
    out["lamb640_cli"] = lamb_cli
    cfg_bn = train_corpus_cfg(data, BN="batch_norm")
    b120 = Dataset(cfg_bn).get_train_ds()[0]
    ms_bn, _, l_bn, model_bn = timed_steps(cfg_bn, b120, dev, BN_STEPS,
                                           warmup=1)
    stats = {k: v.float().cpu() for k, v in model_bn.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    moved = sum(1 for k, v in stats.items() if not torch.equal(
        v, torch.zeros_like(v) if k.endswith("mean") else torch.ones_like(v)))
    finite = all(torch.isfinite(v).all() for v in stats.values())
    log(f"  batch_norm: {1 + BN_STEPS} steps, {ms_bn:.2f} ms per step, loss "
        f"{l_bn[0]:.4f} -> {l_bn[-1]:.4f}; running statistics changed in "
        f"{moved} of {len(stats)} buffers, finite: {finite}")
    if not (moved == len(stats) and finite and np.isfinite(l_bn).all()):
        raise AssertionError("batch_norm running statistics did not move or "
                             "are not finite")
    out.update(lamb640=dict(step_ms=ms, segments_per_sec=640 / ms * 1e3,
                            peak_bytes=peak640, loss=[l640[0], l640[-1]]),
               batch_norm=dict(step_ms=ms_bn, loss=[l_bn[0], l_bn[-1]]))
    return out


def phase_measurement(dev):
    import numpy as np
    import torch
    from nafp_tpu_torch import bench, bench_search
    from nafp_tpu_torch.extras import bench_train_step
    from nafp_tpu_torch.extras import run_100x_protocol as P100
    from nafp_tpu_torch.extras import run_100x_sequence
    from nafp_tpu_torch.search import topk as T

    out = {"launches": {}}

    def counted(tag, fn, *args, need=()):
        """fn(*args) with the launch counters zeroed just before and read
        just after; each kernel of ``need`` must have launched."""
        T.reset_launches()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        n = dict(T.LAUNCHES)
        out["launches"][tag] = n
        log(f"  {tag}: {time.perf_counter() - t0:.1f} s, launches {n}")
        for kernel in need:
            if n[kernel] <= 0:
                raise AssertionError(f"{tag} never launched {kernel}")
        return res

    line = counted("bench", bench.main, ["--batch", "1024", "--iters", "20"])
    if not (line["value"] > 0 and 0 < line.get("mfu", 0) <= 1):
        raise AssertionError(f"bench.py: {line}")
    out["bench"] = line

    root = os.path.join(WORK, "bench2m")
    suite = counted("bench_search --suite", bench_search.main,
                    ["--suite", "--n", str(SUITE_N), "--hnsw_n",
                     str(SUITE_HNSW_N), "--root", root, "--out",
                     os.path.join(WORK, "SEARCH_BENCH_torch.json")],
                    need=("topk_ip_sq8", "topk_ip_masked"))
    rows = {r["index"]: r for r in suite["suite"] if r["index"] != "hnsw"}
    recall = {k: r["recall_at_k"] for k, r in rows.items()}
    if recall["sq8"] != 1.0:
        raise AssertionError(f"suite: sq8 recall {recall['sq8']} != 1.0")
    if not recall["ivfpq-rr"] >= recall["ivfpq"] - RR_AGREE_SLACK:
        raise AssertionError(f"suite: ivfpq-rr trails ivfpq: {recall}")
    out["suite"] = suite["suite"]

    mm = P100.load_mm(root)
    q, _ = P100.make_queries(mm, 2048)
    host_i, host_v, host_v2 = P100.exact_gt_host(mm, q, root)   # cached
    dev_i = counted("--gt device (B1)", P100.exact_gt_top1, mm, q,
                    need=("topk_ip",))
    clear = (host_v - host_v2) >= GT_GAP_MIN
    if not bool((dev_i == host_i)[clear].all()):
        raise AssertionError("B1's exact top-1 differs from the host's at "
                             f"{int((dev_i != host_i)[clear].sum())} "
                             "queries with a clear top-2 gap")
    log(f"  B1's top-1 equals the host's at {int(clear.sum())} of {len(q)} "
        f"queries ({int((dev_i == host_i).sum())} in all)")

    out["protocol"] = {}
    for index, kernel in (("sq8", "topk_ip_sq8"), ("ivf-sq8", None),
                          ("ivfpq", "topk_ip_masked")):
        res = counted(f"run_100x_protocol {index}", P100.main,
                      ["--n", str(SUITE_N), "--root", root, "--index", index,
                       "--gt", "host"], need=(kernel,) if kernel else ())
        if not res["planted_agree"] >= PLANTED_AGREE_MIN:
            raise AssertionError(f"100x {index}: planted == exact for only "
                                 f"{res['planted_agree']}")
        out["protocol"][index] = {k: res[k] for k in ("qps", "recall_at_k",
                                                      "planted_agree")}

    seq = counted("run_100x_sequence sq8", run_100x_sequence.main,
                  ["--root", os.path.join(WORK, "seq100x"),
                   "--n_dummy_songs", str(SEQ_SONGS), "--index", "sq8"],
                  need=("topk_ip_sq8",))
    if any(x != 100.0 for x in seq["rates"]["top1_exact"]):
        raise AssertionError(f"100x sequence sq8: top-1 exact "
                             f"{seq['rates']['top1_exact']}, not 100 %")
    out["sequence"] = {k: seq[k] for k in ("n_db", "rates", "ms_per_query",
                                           "build_sec")}

    step = counted("bench_train_step 640_lamb", bench_train_step.main,
                   ["-c", "640_lamb", "--steps", "10"])
    if not step["loss_finite"]:
        raise AssertionError(f"bench_train_step: {step}")
    out["train_step"] = step
    out["past_2g"] = check_past_2g(dev)
    return out


def check_past_2g(dev):
    """B1 and B2 over PLANT_ROWS rows (past 2^31 elements: every row
    offset is a 64-bit product in csrc/): each query's best row is a
    planted row past PLANT_FROM; the kernel's top-1 must be it, and equal
    the plain version's top-1 over the tail alone (positions compared
    after the offset)."""
    import torch
    from nafp_tpu_torch.search import topk as T

    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    bq = 64
    plant = PLANT_FROM + torch.randint(PLANT_ROWS - PLANT_FROM, (bq,),
                                       generator=gen, device=dev)
    out = {}

    def check(tag, v, i, pv, pi):
        top = i[:, 0].long()
        err = (v[:, 0] - pv[:, 0]).abs().max().item()
        if not (torch.equal(top, plant) and torch.equal(
                pi[:, 0].long() + PLANT_FROM, plant) and err <= SCORE_ATOL):
            raise AssertionError(f"{tag}: planted rows found "
                                 f"{int((top == plant).sum())}/{bq}, "
                                 f"top-1 score error {err}")
        log(f"  {tag} over {PLANT_ROWS} rows: the {bq} planted rows past row "
            f"{PLANT_FROM} found, equal to the plain version over the tail "
            f"(top-1 score error {err:.2e})")
        out[tag] = err

    db = unit_rows(PLANT_ROWS, 128, gen, dev)
    q = db[plant] + 0.05 * torch.randn(bq, 128, generator=gen, device=dev)
    q = (q / q.norm(dim=1, keepdim=True)).contiguous()
    check("B1", *T.topk_ip(q, db, K),
          *T.topk_ip_plain(q, db[PLANT_FROM:], K))
    v8, sc = quantize(db)
    del db
    rm = torch.zeros(PLANT_ROWS, device=dev)
    check("B2", *T.topk_ip_sq8(q, v8, sc, rm, K),
          *T.topk_ip_sq8_plain(q, v8[PLANT_FROM:], sc[PLANT_FROM:],
                               rm[PLANT_FROM:], K,
                               compute_dtype=torch.bfloat16))
    return out


# ---------------------------------------------------------------------------
# Phase 9: sharded search, generate over the cards, a one-rank NCCL group
# ---------------------------------------------------------------------------
def ivfsq8_lists_best(idx, q, block=16):
    """Each query's best score over the rows of its probed lists only
    (not the slice tails past a list's end): every layout of the store, at
    any shard count, scans each of these rows, so its top-1 can be no
    lower. Plain torch ops: the index's f32 coarse probe, bf16-rounded
    queries times the int8 rows in f32, times the row scale."""
    import torch
    from nafp_tpu_torch.search.topk import topk_low_index
    dev = idx.vecs8.device
    counts = torch.diff(idx.starts, append=torch.tensor(
        [idx.ntotal], device=dev))
    out = []
    for s in range(0, len(q), block):
        qd = torch.from_numpy(q[s:s + block]).to(dev)
        _, probes = topk_low_index(qd @ idx.centroids.T, idx.nprobe)
        off = torch.arange(idx.list_cap, device=dev)
        rows = idx.starts[probes][:, :, None] + off
        inside = (off < counts[probes][:, :, None]).view(len(qd), -1)
        rows = rows.view(len(qd), -1)
        qb = qd.to(torch.bfloat16).to(torch.float32)
        score = torch.einsum("qd,qnd->qn", qb,
                             idx.vecs8[rows].to(torch.float32))
        score = (score * idx.scales[rows]).masked_fill(~inside,
                                                        float("-inf"))
        out.append(score.max(1).values)
    return torch.cat(out).cpu().numpy()


def phase_sharded(dev, main_path, ivf_sq8):
    """``evaluate -i l2-sharded / sq8-sharded / ivf-sq8-sharded`` through
    the CLI on one card (R = 1): raw_score.npy equal to phase 3's ``-i l2
    / sq8 / ivf-sq8`` (the stores phase 3 persisted); the API at SHARDS
    logical shards on cuda:0 against one shard (B1 and B2 per shard, the
    merge on the card), B1 and B2 on a shard held against their plain
    versions, a SQ8FlatIndex store in the sharded index and a sharded
    store in SQ8FlatIndex; ``generate`` over ``MESH_DATA_PARALLEL -1`` (every
    card: one) against phase 3's memmaps, bit for bit; ``cli train -c
    640_lamb`` under a one-rank NCCL group started through ``NAFP_*``
    against two plain runs."""
    import copy
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    import yaml
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.data.audio_io import load_memmap
    from nafp_tpu_torch.search import index as I
    from nafp_tpu_torch.search import sharded as S
    from nafp_tpu_torch.search import topk as T

    out = {"launches_by_run": {}}
    emb_dir = main_path["emb_dir"]
    sq8_store = os.path.join(WORK, "sq8_store.npz")

    # --- the sharded types through the CLI, one card: one shard ----------
    runs = (("l2-sharded", "l2", main_path["raw"]["l2"], [], "topk_ip"),
            ("sq8-sharded", "sq8", main_path["raw"]["sq8"],
             ["--index_cache", sq8_store], "topk_ip_sq8"),
            ("ivf-sq8-sharded", "ivf-sq8",
             ivf_sq8["raw"][:IVF_SHARDED_TEST],
             ["--nprobe", str(NPROBE), "--index_cache", ivf_sq8["store"]],
             None))
    twin_ms = dict(main_path["ms_per_query"],
                   **{"ivf-sq8": ivf_sq8["summary"]["ms_per_query"]})
    out["cli"] = {}
    for itype, twin, want, extra, kernel in runs:
        T.reset_launches()
        t0 = time.perf_counter()
        cli(["evaluate", NAME, str(INDEX), "-c", main_path["cfg_path"], "-i",
             itype, "-t", str(len(want)), "--emb_dummy_dir",
             main_path["dummy_dir"], *extra], standalone_mode=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = dict(T.LAUNCHES)
        out["launches_by_run"][itype] = n
        with open(os.path.join(emb_dir, "eval_summary.json")) as f:
            summary = json.load(f)
        raw = np.load(os.path.join(emb_dir, "raw_score.npy"))
        if (summary["index_type"] != itype or summary["n_db"] != N_DB_ROWS
                or summary["n_test"] != len(want)):
            raise AssertionError(f"evaluate -i {itype}: {summary}")
        if not np.array_equal(raw, want):
            raise AssertionError(
                f"evaluate -i {itype}: raw_score.npy differs from -i "
                f"{twin}'s at {int((raw != want).sum())} entries")
        launched = {k: v for k, v in n.items() if v}
        if set(launched) != ({kernel} if kernel else set()):
            raise AssertionError(f"evaluate -i {itype} launched {launched}")
        if kernel == "topk_ip" and n[kernel] != B1_LAUNCHES_PER_RUN:
            raise AssertionError(f"evaluate -i {itype}: {n[kernel]} B1 "
                                 f"launches, predicted {B1_LAUNCHES_PER_RUN}")
        log(f"  evaluate -i {itype} (one card, one shard; {len(want)} ids): "
            f"raw_score.npy equal to -i {twin}'s; {summary['ms_per_query']}"
            f" ms/query (-i {twin}: {twin_ms[twin]}), build "
            f"{summary['build_sec']} s, wall {wall:.1f} s, launches "
            f"{launched}")
        out["cli"][itype] = dict(ms_per_query=summary["ms_per_query"],
                                 twin_ms_per_query=twin_ms[twin],
                                 build_sec=summary["build_sec"],
                                 wall_s=wall, launches=launched,
                                 n_test=len(want))

    # --- the API at SHARDS logical shards on cuda:0 against one ----------
    db, query = protocol_db(main_path)
    rng = np.random.default_rng(SEED + 9)
    qs = np.ascontiguousarray(query[rng.choice(len(query), SHARD_QUERIES,
                                               replace=False)])
    one, many = [dev], [dev] * SHARDS
    out["api"] = {}

    def timed_search(idx, k, tag=None):
        idx.search(qs[:8], k)                               # warm
        T.reset_launches()
        t0 = time.perf_counter()
        res = idx.search(qs, k)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        if tag:
            out["launches_by_run"][tag] = dict(T.LAUNCHES)
        return res, ms

    def against_one(tag, idx1, idx_r, kernel):
        rv, ri = idx1.search(qs, K + 1)
        (_, _), ms1 = timed_search(idx1, K)
        (gv, gi), ms_r = timed_search(idx_r, K, tag)
        err = float(np.abs(gv - rv[:, :K]).max())
        clear = (rv[:, K - 1] - rv[:, K]) > SHARD_GAP
        n = out["launches_by_run"][tag][kernel]
        if not (np.array_equal(gi[:, 0], ri[:, 0])
                and err <= SHARD_SCORE_ATOL
                and np.array_equal(gi[clear], ri[clear, :K]) and n > 0):
            raise AssertionError(
                f"{tag}: top-1 equal {float((gi[:, 0] == ri[:, 0]).mean())},"
                f" score error {err}, ids equal where the gap is clear "
                f"{float((gi[clear] == ri[clear, :K]).mean())}, {n} "
                f"{kernel} launches")
        log(f"  {tag}: top-1 equal to one shard's on {len(qs)} of "
            f"{len(qs)} queries, scores within {err:.2e}, ids equal on the "
            f"{int(clear.sum())} queries with a k-th gap > {SHARD_GAP}; "
            f"{ms_r:.1f} ms for {len(qs)} queries against {ms1:.1f} ms at "
            f"one shard; {n} {kernel} launches")
        out["api"][tag] = dict(ms=ms_r, ms_one_shard=ms1, max_abs_err=err,
                               clear_gap=int(clear.sum()), launches=n)
        return ri[:, :K], rv[:, :K]

    flat1 = S.ShardedFlatIndex(db, devices=one)
    flat_r = S.ShardedFlatIndex(db, devices=many)
    against_one(f"l2-sharded, {SHARDS} shards", flat1, flat_r, "topk_ip")
    del flat1
    sq1 = S.ShardedSQ8FlatIndex.load(sq8_store, devices=one)
    sq_r = S.ShardedSQ8FlatIndex.load(sq8_store, devices=many)
    sq_ids, sq_v = against_one(f"sq8-sharded, {SHARDS} shards (phase 3's "
                               "SQ8FlatIndex store)", sq1, sq_r,
                               "topk_ip_sq8")
    del sq1

    # B1 and B2 on the last shard (its rows no multiple of the kernels'
    # 64-row tile; B2's shard ends in pad rows) against their plain versions
    shard = flat_r.shards[-1]
    q512 = torch.from_numpy(qs[:512]).to(dev)
    v, i = T.topk_ip(q512, shard.db, K)
    pv, pi = T.topk_ip_plain(q512, shard.db, K)
    tag = f"B1 on shard {SHARDS - 1} (Bq 512, N {shard.ntotal}, k {K})"
    b1_err = check_topk(tag, v, i, pv, pi, lambda ids: torch.einsum(
        "bd,bkd->bk", q512.double(), shard.db.double()[ids]))
    # bounds as phase 2 counts them: 3xTF32 products (B1), bf16 (B2)
    b1 = dict(rows=shard.ntotal, max_abs_err=b1_err,
              bound_ms=1e3 * max(3 * 2.0 * 512 * shard.ntotal * 128
                                 / PEAK_TF32,
                                 (4.0 * (shard.ntotal + 512) * 128
                                  + 8.0 * 512 * K) / PEAK_BYTES),
              ms=time_ms(lambda: T.topk_ip(q512, shard.db, K), 20),
              plain_ms=time_ms(lambda: T.topk_ip_plain(q512, shard.db, K),
                               3))
    sh = sq_r.shards[-1]
    q1024 = torch.from_numpy(qs).to(dev)
    args = (q1024, sh.vecs8, sh.scales, sh.rmask, K)
    v, i = T.topk_ip_sq8(*args)
    pv, pi = T.topk_ip_sq8_plain(*args, compute_dtype=torch.bfloat16)
    qb = q1024.to(torch.bfloat16).double()
    real = int((sh.ids >= 0).sum())
    tag = (f"B2 on shard {SHARDS - 1} (Bq 1024, N {len(sh.ids)}, "
           f"{real} of them real rows, k {K})")
    b2_err = check_topk(tag, v, i, pv, pi, lambda ids: torch.einsum(
        "bd,bkd->bk", qb, sh.vecs8.double()[ids])
        * sh.scales.double()[ids] + sh.rmask.double()[ids])
    n2 = len(sh.ids)
    b2 = dict(rows=n2, real_rows=real, max_abs_err=b2_err,
              bound_ms=1e3 * max(2.0 * 1024 * n2 * 128 / PEAK_BF16,
                                 (n2 * (128 + 8) + 4.0 * 1024 * 128
                                  + 8.0 * 1024 * K) / PEAK_BYTES),
              ms=time_ms(lambda: T.topk_ip_sq8(*args), 20),
              plain_ms=time_ms(lambda: T.topk_ip_sq8_plain(
                  *args, compute_dtype=torch.bfloat16), 3))
    log(f"  per shard: B1 {b1['ms']:.3f} ms (plain {b1['plain_ms']:.3f}), "
        f"B2 {b2['ms']:.3f} ms (plain {b2['plain_ms']:.3f})")
    out["shard_kernels"] = dict(topk_ip=b1, topk_ip_sq8=b2)
    del flat_r, sq_r, shard, sh

    # a store the sharded index persisted, in the single-device index
    path = os.path.join(WORK, "sq8_sharded_store.npz")
    S.ShardedSQ8FlatIndex(devices=many).add(db, persist_path=path)
    with np.load(path) as a, np.load(sq8_store) as b:
        same = all(np.array_equal(a[key][:N_DB_ROWS], b[key][:N_DB_ROWS])
                   for key in ("vecs8", "scales", "ids"))
        same = same and int(a["ntotal"]) == int(b["ntotal"]) == N_DB_ROWS
    sv, si = I.SQ8FlatIndex.load(path, device=dev).search(qs, K)
    if not (same and np.array_equal(si, sq_ids) and np.array_equal(sv, sq_v)):
        raise AssertionError("the store ShardedSQ8FlatIndex persisted: rows "
                             f"equal to phase 3's {same}; SQ8FlatIndex over "
                             "it differs from one shard's search")
    log(f"  a {SHARDS}-shard sq8 store (written by ShardedSQ8FlatIndex.add) "
        "holds phase 3's rows and, in SQ8FlatIndex, returns one shard's ids "
        "and scores")

    # IVF-SQ8 dealt over SHARDS shards: each shard scans ceil(cap/R) rows a
    # probed list, so the slice tails past a list's end differ from one
    # shard's; every row of the probed lists is scanned by both
    ivf1 = S.ShardedIVFSQ8Index.load(ivf_sq8["store"], nprobe=NPROBE,
                                     devices=one)
    ivf_r = S.ShardedIVFSQ8Index.load(ivf_sq8["store"], nprobe=NPROBE,
                                      devices=many)
    (v1, i1), ms1 = timed_search(ivf1, K)
    (vr, ir), ms_r = timed_search(ivf_r, K, f"ivf-sq8-sharded, {SHARDS} "
                                            "shards")
    gate = slice(0, IVFSQ8_GATE_QUERIES)
    best = ivfsq8_lists_best(I.IVFSQ8Index.load(
        ivf_sq8["store"], nprobe=NPROBE, device=dev), qs[gate])
    low = {r: int((v[gate, 0] < best - SHARD_SCORE_ATOL).sum())
           for r, v in ((1, v1), (SHARDS, vr))}
    agree = float((ir[:, 0] == i1[:, 0]).mean())
    log(f"  ivf-sq8-sharded, {SHARDS} shards (list_cap {ivf_r.list_cap} "
        f"against {ivf1.list_cap}): top-1 equal to one shard's on {agree:.4f}"
        f" of {len(qs)} queries; top-1 below the best row of the probed "
        f"lists on {low} of {IVFSQ8_GATE_QUERIES}; {ms_r:.1f} ms against "
        f"{ms1:.1f} ms at one shard")
    if any(low.values()):
        raise AssertionError(f"ivf-sq8-sharded: a top-1 below its probed "
                             f"lists' best row: {low}")
    out["api"][f"ivf-sq8-sharded, {SHARDS} shards"] = dict(
        ms=ms_r, ms_one_shard=ms1, top1_agree=agree,
        list_cap=ivf_r.list_cap, list_cap_one_shard=ivf1.list_cap)
    del ivf1, ivf_r, db

    # --- generate over every card (MESH_DATA_PARALLEL -1) ----------------
    cfg = copy.deepcopy(main_path["cfg"])
    cfg["DEVICE"]["MESH_DATA_PARALLEL"] = -1
    cfg_path = os.path.join(WORK, "smoke_mesh.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    t0 = time.perf_counter()
    cli(["generate", NAME, str(INDEX), "-c", cfg_path, "--yes", "-o",
         os.path.join(WORK, "emb_mesh")], standalone_mode=False)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    for key in ("dummy_db", "db", "query"):
        a, _ = load_memmap(os.path.join(WORK, "emb_mesh", NAME, str(INDEX)),
                           key, display=False)
        b, _ = load_memmap(emb_dir, key, display=False)
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise AssertionError(f"generate with MESH_DATA_PARALLEL -1: "
                                 f"{key}.mm differs from phase 3's")
    log(f"  generate with MESH_DATA_PARALLEL -1 ({torch.cuda.device_count()}"
        f" card): memmaps equal to phase 3's bit for bit; {gen_s:.2f} s "
        f"({main_path['gen_segments'] / gen_s:.1f} segments/s)")
    out["generate_s"] = gen_s

    # --- cli train -c 640_lamb under a one-rank NCCL group ---------------
    data = os.path.join(WORK, "train_data")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    train = {}
    for tag in ("plain", "plain again", "one-rank nccl"):
        c = train_corpus_cfg(data, "640_lamb")
        c["DATA_SEL"]["REDUCE_ITEMS_P"] = NCCL_TRAIN_REDUCE_P
        c["DEVICE"]["DEVICE_CORPUS"] = False
        c["TRAIN"].update(MINI_TEST_IN_TRAIN=False, SAVE_IMG=False)
        name = "smoke_nccl_" + tag.replace(" ", "_").replace("-", "_")
        path = os.path.join(WORK, name + ".yaml")
        with open(path, "w") as f:
            yaml.safe_dump(c, f)
        env = ({"NAFP_COORDINATOR": f"localhost:{port}",
                "NAFP_NUM_PROCESSES": "1", "NAFP_PROCESS_ID": "0"}
               if "nccl" in tag else {})
        os.environ.update(env)
        try:
            t0 = time.perf_counter()
            cli(["train", name, "-c", path, "--max_epoch", "1"],
                standalone_mode=False)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            if env:
                backend = "nccl" if dev.type == "cuda" else "gloo"
                if not (dist.is_initialized()
                        and dist.get_backend() == backend
                        and dist.get_world_size() == 1):
                    raise AssertionError("cli train did not run under a "
                                         f"one-rank {backend} group")
                t = torch.arange(4.0, device=dev)
                dist.all_reduce(t)
                if not torch.equal(t, torch.arange(4.0, device=dev)):
                    raise AssertionError(f"NCCL all_reduce over one rank: {t}")
        finally:
            for k in env:
                os.environ.pop(k)
            if env and dist.is_initialized():
                dist.destroy_process_group()
        (run,) = train_runs(name)
        m = train_metrics(run)
        train[tag] = dict(train_loss=m["loss/train"][1],
                          val_loss=m["loss/val"][1],
                          step_ms=m["throughput/step_ms"][1],
                          steps=ckpt_meta(name, 1)["step"], cli_s=secs)
    a, b, g = (train[t] for t in ("plain", "plain again", "one-rank nccl"))
    for key in ("train_loss", "val_loss"):
        tol = NCCL_LOSS_SPREAD * abs(a[key] - b[key]) \
            + NCCL_LOSS_FLOOR * abs(a[key])
        if not (abs(g[key] - a[key]) <= tol and abs(g[key] - b[key]) <= tol
                and np.isfinite(g[key]) and a["steps"] == g["steps"] > 0):
            raise AssertionError(f"640_lamb under one-rank NCCL: {key} "
                                 f"{g[key]} against {a[key]}, {b[key]} "
                                 f"(tolerance {tol}); steps {a['steps']}, "
                                 f"{g['steps']}")
        train[tag + " tolerance " + key] = tol
    log("  cli train -c 640_lamb, " + f"{a['steps']} steps: " + "; ".join(
        f"{t} train loss {r['train_loss']:.6f}, val loss "
        f"{r['val_loss']:.6f}, {r['step_ms']:.1f} ms/step"
        for t, r in train.items() if isinstance(r, dict))
        + "; the group's losses within the tolerance from the plain runs")
    out["train"] = train
    return out


def triplet_card_vs_cpu(dev):
    """online_triplet_loss in its four modes, with and without
    use_anc_as_pos, on the card against the port on the CPU (f32): loss,
    num_active, distances and both inputs' gradients."""
    import numpy as np
    import torch
    from nafp_tpu_torch.losses.triplet import MODES, online_triplet_loss
    rng = np.random.default_rng(SEED + 11)

    def unit(n):
        x = rng.standard_normal((n, TRIPLET_D)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)
    ea, ep = unit(TRIPLET_A), unit(TRIPLET_A * TRIPLET_P)
    n_pos = TRIPLET_A * TRIPLET_P

    def run(d, mode, uap):
        a = torch.from_numpy(ea).to(d).requires_grad_()
        p = torch.from_numpy(ep).to(d).requires_grad_()
        loss, dists, n = online_triplet_loss(a, p, TRIPLET_A, TRIPLET_P,
                                             0.5, mode, uap)
        loss.backward()
        return (loss.item(), dists.detach().cpu().numpy(), n.item(),
                a.grad.cpu().numpy(), p.grad.cpu().numpy())
    worst = {"loss": 0.0, "dists": 0.0, "grad": 0.0}
    for mode in MODES:
        for uap in (True, False):
            c, g = run(torch.device("cpu"), mode, uap), run(dev, mode, uap)
            ident = np.zeros(c[1].shape, bool)
            if uap:
                ident[:, n_pos:] = np.eye(TRIPLET_A, dtype=bool)
                if not (g[1][ident].max() <= TRIPLET_IDENTITY_MAX
                        and c[1][ident].max() <= TRIPLET_IDENTITY_MAX):
                    raise AssertionError(f"triplet {mode}: identity block "
                                         "off its bound")
            errs = {"loss": abs(g[0] / c[0] - 1),
                    "dists": float(np.abs(g[1] - c[1])[~ident].max()),
                    "grad": float(max(np.abs(g[3] - c[3]).max(),
                                      np.abs(g[4] - c[4]).max()))}
            if not (errs["loss"] <= TRIPLET_LOSS_RTOL and g[2] == c[2]
                    and errs["dists"] <= TRIPLET_DIST_ATOL
                    and errs["grad"] <= TRIPLET_GRAD_ATOL):
                raise AssertionError(f"triplet {mode}, use_anc_as_pos {uap}:"
                                     f" card vs CPU {errs}, num_active "
                                     f"{g[2]} vs {c[2]}")
            worst = {k: max(v, errs[k]) for k, v in worst.items()}
    log(f"  triplet loss, card vs CPU (f32, {TRIPLET_A} x {TRIPLET_P}, d "
        f"{TRIPLET_D}, 4 modes x use_anc_as_pos): worst loss "
        f"{worst['loss']:.2e} relative, distances {worst['dists']:.2e}, "
        f"gradients {worst['grad']:.2e}; num_active equal")
    return worst


def act_cosines(emb_dir, ref_dir):
    """Row cosines of generate's memmaps in ``emb_dir`` with those in
    ``ref_dir`` (dummy_db, db, query), and whether every memmap differs."""
    import numpy as np
    from nafp_tpu_torch.data.audio_io import load_memmap
    cos, changed = [], True
    for key in ("dummy_db", "db", "query"):
        a = np.asarray(load_memmap(emb_dir, key, display=False)[0])
        b = np.asarray(load_memmap(ref_dir, key, display=False)[0])
        cos.append((a * b).sum(1))
        changed = changed and not np.array_equal(a, b)
    return np.concatenate(cos), changed


def served_db(emb_dir, dummy_dir, n_db_songs, ref_db=None):
    """The DB that evaluate searched: [dummy_db of ``dummy_dir`` (generated
    rows, then random unit rows); db], with the generated rows those of
    ``emb_dir``, whole songs of equal length (``n_db_songs`` in db).
    Without ``ref_db``, also each row's song (-1 for a random row); with
    it, ``ref_db`` with the generated rows replaced."""
    import numpy as np
    from nafp_tpu_torch.data.audio_io import load_memmap
    gen = np.asarray(load_memmap(emb_dir, "dummy_db", display=False)[0])
    db = np.asarray(load_memmap(emb_dir, "db", display=False)[0])
    if ref_db is not None:
        out = ref_db.copy()
        out[:len(gen)] = gen
        out[len(out) - len(db):] = db
        return out
    seg = len(db) // n_db_songs
    if len(gen) % seg or len(db) != seg * n_db_songs:
        raise AssertionError(f"{len(gen)} / {len(db)} rows are not songs "
                             f"of {seg} segments")
    pad = np.asarray(load_memmap(dummy_dir, "dummy_db", display=False)[0])
    song = np.full(len(pad) + len(db), -1, np.int64)
    song[:len(gen)] = np.arange(len(gen)) // seg
    song[len(pad):] = (len(gen) + np.arange(len(db))) // seg
    return np.concatenate([pad, db]), song


def act_top1(dev, I, ref_db, db, song):
    """Exact top-1 (B1 at these sizes) over ``db`` against over ``ref_db``
    of ACT_QUERIES noisy copies of ref_db's song rows (``song`` >= 0) at
    each noise of ACT_NOISES (per dimension, then unit norm): the share of
    queries with the same top-1 row and with a top-1 row of the same song.
    Also ref_db's song rows' nearest-neighbour cosine (5th / 50th / 95th
    percentile) and mean cosine, over 4,096 of them."""
    import numpy as np
    rows = np.flatnonzero(song >= 0)
    ref_i = I.FlatIndex(ref_db, metric="ip", device=dev)
    got_i = I.FlatIndex(db, metric="ip", device=dev)
    rng = np.random.default_rng(7)
    out = {}
    for noise in ACT_NOISES:
        src = ref_db[rows[rng.integers(0, len(rows), ACT_QUERIES)]]
        q = src + noise * rng.standard_normal(src.shape).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        _, i_ref = ref_i.search(q, 1)
        _, i_got = got_i.search(q, 1)
        s_ref, s_got = song[i_ref[:, 0]], song[i_got[:, 0]]
        out[str(noise)] = dict(
            same_row=float((i_got[:, 0] == i_ref[:, 0]).mean()),
            same_song=float(((s_got == s_ref) & (s_ref >= 0)).mean()))
    sub = ref_db[rows[rng.permutation(len(rows))[:4096]]]
    _, nn = ref_i.search(sub, 2)
    c = (sub * ref_db[nn[:, 1]]).sum(1)
    out["nn_cos_pct_5_50_95"] = [float(v) for v in
                                 np.percentile(c, [5, 50, 95])]
    out["mean_cos"] = float((sub @ sub.T).mean())
    return out


def phase_triplet_tools(dev, main_path, ivfpq):
    """Phase 10: the Online-Triplet training path, ACT_STORE, IVF-PQ's int8
    decode and dataset2wav."""
    import copy

    import numpy as np
    import torch
    import yaml
    from nafp_tpu_torch.cli import main as cli
    from nafp_tpu_torch.data.audio_io import load_wav_segment
    from nafp_tpu_torch.data.catalog import Dataset
    from nafp_tpu_torch.extras import bench_quant, dataset2wav
    import nafp_tpu_torch.search.index as I
    from nafp_tpu_torch.search import topk as T
    from nafp_tpu_torch.train import trainer as TR

    out, by_run = {"triplet_loss": triplet_card_vs_cpu(dev)}, {}
    data = os.path.join(WORK, "train_data")       # phase 7's corpus

    # one full-width now_playing step ('hardest'), 2 anchors x 4 replicas
    # with bg, IR and SpecAugment, card against CPU in f32
    t0 = time.perf_counter()
    cfg32 = train_corpus_cfg(data, "now_playing", MIXED_PRECISION=False)
    cfg32["LOSS"]["MINING_MODE"] = "hardest"
    cfg32["BSZ"].update(TR_BATCH_SZ=10, TR_N_ANCHOR=2)
    batch = {k: torch.from_numpy(v) for k, v in
             Dataset(cfg32).get_train_ds()[0].items() if k in TR.BATCH_KEYS}
    if batch["replicas"].shape[0] != 8:
        raise AssertionError(f"now_playing batch {batch['replicas'].shape}")
    draws = host_draws(cfg32, 8, torch.Generator().manual_seed(SEED + 12),
                       n_all=10)
    state = TR.build_fp(cfg32)[2].state_dict()
    cpu_loss, cpu_g = step_loss_grads(cfg32, state, batch, draws,
                                      torch.device("cpu"))
    gpu_loss, gpu_g = step_loss_grads(cfg32, state, batch, draws, dev)
    loss_rel = abs(gpu_loss / cpu_loss - 1)
    grad_rel = max(float((gpu_g[n] - cpu_g[n]).norm() / cpu_g[n].norm())
                   for n in cpu_g)
    log(f"  one now_playing step ('hardest', 2 x 4), card vs CPU (f32): loss "
        f"{gpu_loss:.6f} vs {cpu_loss:.6f} ({loss_rel:.2e} relative, "
        f"tolerance {STEP_LOSS_RTOL}); worst gradient leaf {grad_rel:.2e} "
        f"relative over {len(cpu_g)} leaves (tolerance {STEP_GRAD_RTOL}); "
        f"{time.perf_counter() - t0:.1f} s")
    if not (cpu_loss > 0 and loss_rel <= STEP_LOSS_RTOL
            and grad_rel <= STEP_GRAD_RTOL):
        raise AssertionError(f"now_playing step card vs CPU: loss "
                             f"{loss_rel}, gradients {grad_rel}")
    out["step_card_vs_cpu"] = dict(loss_rel=loss_rel, grad_rel=grad_rel)

    # cli train -c <now_playing, hardest> for one epoch on phase 7's corpus,
    # then generate + evaluate -i l2 (B1) of its checkpoint
    cfg = train_corpus_cfg(data, "now_playing")
    cfg["LOSS"]["MINING_MODE"] = "hardest"
    path = os.path.join(WORK, "triplet.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli(["train", TRIPLET_NAME, "-c", path, "--max_epoch", "1"],
        standalone_mode=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    (run,) = train_runs(TRIPLET_NAME)
    m = train_metrics(run)
    steps = ckpt_meta(TRIPLET_NAME, 1)["step"]
    losses = [m["loss/train"][1], m["loss/val"][1]]
    log(f"  cli train -c now_playing (hardest) --max_epoch 1: {secs:.1f} s, "
        f"{steps} steps of bsz 120 (24 anchors x 4); train / val loss "
        f"{losses[0]:.4f} / {losses[1]:.4f}; step "
        f"{m['throughput/step_ms'][1]:.2f} ms, "
        f"{m['throughput/segments_per_sec'][1]:.1f} segments/s (the CLI's "
        f"EMA); peak device memory {peak / 2**30:.2f} GiB")
    if not (np.isfinite(losses).all() and losses[0] > 0):
        raise AssertionError(f"now_playing losses {losses}")
    served = serve_checkpoint(cli, T, path, "train_emb", 1, dev,
                              name=TRIPLET_NAME)
    by_run["triplet l2"] = served["launches"]
    log(f"  now_playing checkpoint 1: top-1 exact % at 1/2/3 s "
        f"{served['top1']} over {TRAIN_DB_ROWS} DB rows (generate + "
        f"evaluate -i l2), launches {served['launches']}")
    out["cli_train"] = dict(seconds=secs, steps=steps, peak_bytes=peak,
                            train_loss=losses[0], val_loss=losses[1],
                            step_ms=m["throughput/step_ms"][1],
                            segments_per_sec=m[
                                "throughput/segments_per_sec"][1],
                            served=served)

    # ACT_STORE: generate --act_store over phase 3's corpus, against the
    # bf16 memmaps; evaluate -i l2 (B1) of each against bf16's top-1 hits
    n_sl = main_path["l2_top1"].shape[1]
    ref3, song3 = served_db(main_path["emb_dir"], main_path["dummy_dir"],
                            N_QUERY)
    act = {}
    for mode in ("int8", "fp8"):
        c = copy.deepcopy(main_path["cfg"])
        c["DIR"]["OUTPUT_ROOT_DIR"] = f"{WORK}/emb_{mode}/"
        cpath = os.path.join(WORK, f"act_{mode}.yaml")
        with open(cpath, "w") as f:
            yaml.safe_dump(c, f)
        t0 = time.perf_counter()
        cli(["generate", NAME, str(INDEX), "-c", cpath, "--yes",
             "--act_store", mode], standalone_mode=False)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        emb_dir = os.path.join(WORK, f"emb_{mode}", NAME, str(INDEX))
        cos, changed = act_cosines(emb_dir, main_path["emb_dir"])
        T.reset_launches()
        cli(["evaluate", NAME, str(INDEX), "-c", cpath, "-i", "l2", "-t",
             str(N_TEST), "--emb_dummy_dir", main_path["dummy_dir"]],
            standalone_mode=False)
        by_run[f"act_store {mode} l2"] = dict(T.LAUNCHES)
        raw = np.load(os.path.join(emb_dir, "raw_score.npy"))
        agree = float((raw[:, :n_sl] == main_path["l2_top1"]).mean())
        with open(os.path.join(emb_dir, "eval_summary.json")) as f:
            hits = json.load(f)["rates"]["top1_exact"]
        T.reset_launches()
        top1 = act_top1(dev, I, ref3, served_db(emb_dir, main_path[
            "dummy_dir"], N_QUERY, ref_db=ref3), song3)
        by_run[f"act_store {mode} phase-3 top-1 (API)"] = dict(T.LAUNCHES)
        act[mode] = dict(cos_min=float(cos.min()), cos_mean=float(cos.mean()),
                         changed=changed, top1_agree=agree, top1_hits=hits,
                         generate_s=gen_s, top1=top1,
                         launches=by_run[f"act_store {mode} l2"])
        log(f"  generate --act_store {mode}: {len(cos)} fingerprints in "
            f"{gen_s:.1f} s, cosine with bf16 min {cos.min():.4f} / mean "
            f"{cos.mean():.4f}, every memmap changed: {changed}; evaluate -i "
            f"l2 top-1 exact % {hits} (bf16 "
            f"{main_path['rates']['l2']['top1_exact']}), its hits equal to "
            f"bf16's on {agree:.4f} of {N_TEST} ids x {n_sl} lengths, "
            f"launches {by_run[f'act_store {mode} l2']}; top-1 of noisy "
            f"copies, by noise: {json.dumps(top1)}")
        if not (changed and cos.min() < 1.0
                and cos.min() >= ACT_COS_MIN[mode]
                and cos.mean() >= ACT_COS_MEAN[mode]
                and by_run[f"act_store {mode} l2"]["topk_ip"] > 0):
            raise AssertionError(f"ACT_STORE {mode}: {act[mode]}")

    # ... and over the now_playing checkpoint: top-1 of exact search (B1)
    # over its ACT_STORE rows against over its bf16 rows, where clear
    tri_emb = os.path.join(WORK, "train_emb", TRIPLET_NAME, "1")
    tri_dummy = os.path.join(WORK, "train_emb_dummy1")
    ref_db, song = served_db(tri_emb, tri_dummy, TRAIN_QUERY)
    for mode in ("int8", "fp8"):
        c = copy.deepcopy(cfg)
        c["DIR"]["OUTPUT_ROOT_DIR"] = f"{WORK}/train_emb_{mode}/"
        cpath = os.path.join(WORK, f"triplet_{mode}.yaml")
        with open(cpath, "w") as f:
            yaml.safe_dump(c, f)
        cli(["generate", TRIPLET_NAME, "1", "-c", cpath, "--yes",
             "--act_store", mode], standalone_mode=False)
        emb_dir = os.path.join(WORK, f"train_emb_{mode}", TRIPLET_NAME, "1")
        cos, changed = act_cosines(emb_dir, tri_emb)
        db = served_db(emb_dir, tri_dummy, TRAIN_QUERY, ref_db=ref_db)
        T.reset_launches()
        top1 = act_top1(dev, I, ref_db, db, song)
        by_run[f"act_store {mode} now_playing top-1 (API)"] = dict(
            T.LAUNCHES)
        act[f"now_playing {mode}"] = dict(
            cos_min=float(cos.min()), cos_mean=float(cos.mean()),
            changed=changed, launches=dict(T.LAUNCHES), top1=top1)
        log(f"  now_playing checkpoint, generate --act_store {mode}: cosine "
            f"with bf16 min {cos.min():.4f} / mean {cos.mean():.4f}, every "
            f"memmap changed: {changed}; top-1 of {ACT_QUERIES} noisy copies "
            f"of its {int((song >= 0).sum())} bf16 song rows over the {mode} "
            f"rows against over the bf16 rows, by noise: {json.dumps(top1)}; "
            f"launches {dict(T.LAUNCHES)}")
        if not (changed and cos.min() < 1.0
                and top1[str(ACT_GATE_NOISE)]["same_song"] >= ACT_TOP1_MIN
                and T.LAUNCHES["topk_ip"] > 0):
            raise AssertionError(f"ACT_STORE {mode} on the now_playing "
                                 f"checkpoint: {act[f'now_playing {mode}']}")
    act["bench_quant"] = bench_quant.main([])
    out["act_store"] = act

    # IVF-PQ's int8 decode on phase 3's store: a chunk decoded on the card
    # equals the plain decode (the dequantised books through the f32 gather
    # decode) and the CPU's; top-1 against the exact scan (B1) of noisy
    # copies of DB rows (the 100x protocol's queries: phase 3's random
    # weights leave its query segments' nearest rows near-tied), the int8
    # decode against the f32 decode (B3)
    from nafp_tpu_torch.extras.run_100x_protocol import make_queries
    full_db, _ = protocol_db(main_path)
    q, _ = make_queries(full_db, PQ_INT8_QUERIES)
    T.reset_launches()
    _, exact = I.FlatIndex(full_db, metric="l2", device=dev).search(q, 1)
    by_run["ivfpq decode: exact l2 (API)"] = dict(T.LAUNCHES)
    pq = {}
    for dec in ("f32", "int8"):
        idx = I.IVFPQIndex.load(ivfpq["store"], nprobe=NPROBE, device=dev)
        idx.decode_int8 = dec == "int8"
        if dec == "int8":
            cs = min(idx.CHUNK_ROWS, idx.n_pad)
            codes, sub = idx.codes[:cs], idx.sub_list[:cs // LIST_TILE]
            got = idx._decode_chunk(codes, sub)
            bq, bs = idx._quantized_books()
            plain = I._pq_decode_chunk(codes, sub, bq.float() * bs[:, None],
                                       idx.centroids, lt=LIST_TILE)
            cpu = I._pq_decode_chunk_i8(codes.cpu(), sub.cpu(), bq.cpu(),
                                        bs.cpu(), idx.centroids.cpu(),
                                        lt=LIST_TILE)
            if not (torch.equal(got, plain) and torch.equal(got.cpu(), cpu)):
                raise AssertionError("int8 decode differs from the plain "
                                     "decode or the CPU's")
        T.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ids = idx.search(q, K)
        ms = (time.perf_counter() - t0) * 1e3
        by_run[f"ivfpq {dec} decode (API)"] = dict(T.LAUNCHES)
        pq[dec] = dict(top1_agree=float((ids[:, 0] == exact[:, 0]).mean()),
                       search_ms=ms, launches=dict(T.LAUNCHES), ids=ids)
        del idx
    same = float((pq["int8"].pop("ids") == pq["f32"].pop("ids")).mean())
    pq["int8"]["ids_equal_to_f32"] = same
    log(f"  IVF-PQ, {len(q)} noisy copies of DB rows: top-1 equal to the "
        f"exact scan's on {pq['f32']['top1_agree']:.4f} (f32 decode) / "
        f"{pq['int8']['top1_agree']:.4f} (int8 decode); search "
        f"{pq['f32']['search_ms']:.1f} / {pq['int8']['search_ms']:.1f} ms "
        f"(host clock, one call); B3 launches {pq['f32']['launches']} / "
        f"{pq['int8']['launches']}; top-{K} ids equal to the f32 decode's on "
        f"{same:.4f}; a {cs}-row chunk decoded on the card equals the plain "
        "decode and the CPU's bit for bit")
    if not (abs(pq["int8"]["top1_agree"] - pq["f32"]["top1_agree"])
            <= PQ_INT8_AGREE_SLACK
            and pq["int8"]["launches"]["topk_ip_masked"]
            == pq["f32"]["launches"]["topk_ip_masked"] > 0):
        raise AssertionError(f"IVF-PQ int8 decode: {pq}")
    out["ivfpq_int8"] = pq

    # dataset2wav --split val on phase 7's corpus, on the card
    wav_dir = os.path.join(WORK, "d2w")
    t0 = time.perf_counter()
    n = dataset2wav.synthesize(train_corpus_cfg(data), wav_dir, "val", 1,
                               42, device=dev)
    names = sorted(os.listdir(wav_dir))
    peak_abs = 0.0
    for name in names:
        x = load_wav_segment(os.path.join(wav_dir, name), 0, 8000,
                             expected_fs=8000)
        peak_abs = max(peak_abs, float(np.abs(x).max()))
    expect = (TRAIN_SONGS // 4) * (int((SONG_SEC - 1) / 0.5) + 1)
    log(f"  dataset2wav --split val: {n} WAVs in "
        f"{time.perf_counter() - t0:.1f} s ({TRAIN_SONGS // 4} songs of "
        f"{SONG_SEC} s), read back through data/audio_io.py, peak "
        f"|x| {peak_abs:.3f}")
    if not (n == len(names) == expect and 0 < peak_abs <= 1.0):
        raise AssertionError(f"dataset2wav wrote {n} / {len(names)} WAVs, "
                             f"expected {expect}")
    out["dataset2wav"] = dict(n_wavs=n)
    out["launches_by_run"] = by_run
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU "
              "machine", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import nafp_tpu_torch
    pkg = os.path.dirname(os.path.abspath(nafp_tpu_torch.__file__))
    if os.path.dirname(pkg) != ROOT:
        raise RuntimeError(f"nafp_tpu_torch imported from {pkg}, not from "
                           f"this checkout ({ROOT})")
    from nafp_tpu_torch import kernels
    from nafp_tpu_torch.device import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device()
    smi = nvidia_smi_line()
    log(f"[1/10] device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    build_s, logs = kernels.build_all()
    log(f"  kernels built and loaded in {build_s:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)

    phase_s = {"build": build_s}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"  ({name} took {phase_s[name]:.1f} s)")
        return out

    log("[2/10] kernels against their plain versions")
    rec = timed("kernels", phase_kernels, dev)
    ln2d = timed("LayerNorm2d", phase_layernorm2d, dev)
    lamb = timed("LAMB", phase_lamb, dev)
    log("[3/10] serving path through the CLI (full width)")
    main_path = timed("main path", phase_main_path, dev)
    ivf_sq8 = timed("IVF-SQ8", phase_ivf_sq8, dev, main_path)
    ivfpq = timed("IVF-PQ store", phase_ivfpq_store, dev, main_path)
    log("[4/10] the sq8 kernel bench (B4a, B4b)")
    bench = timed("sq8 kernel bench", phase_bench, dev, rec["b4"])
    log("[5/10] card against CPU")
    enc = timed("card vs CPU", phase_card_vs_cpu, dev, main_path, ivfpq)
    log("[6/10] the device-resident corpus")
    corpus = timed("device corpus", phase_device_corpus, dev, main_path)
    log("[7/10] training path (full width)")
    training = timed("training", phase_training, dev)
    log("[8/10] the measurement entry points")
    measurement = timed("measurement", phase_measurement, dev)
    log("[9/10] sharded search, generate over the cards, a one-rank NCCL "
        "group")
    sharded = timed("sharded", phase_sharded, dev, main_path, ivf_sq8)
    log("[10/10] the Online-Triplet path, ACT_STORE, IVF-PQ's int8 decode, "
        "dataset2wav")
    triplet = timed("triplet and tools", phase_triplet_tools, dev, main_path,
                    ivfpq)

    kernels_line = []
    for name in ("topk_ip", "topk_ip_sq8", "topk_ip_masked"):
        r = dict(rec[name])
        by_run = {**main_path["launches_by_run"],
                  **sharded["launches_by_run"],
                  **triplet["launches_by_run"]}
        r["launches"] = sum(n[name] for n in by_run.values())
        r["launches_by_run"] = {run: n[name] for run, n in by_run.items()
                                if n[name]}
        r["launches_by_entry_point"] = {
            tag: n[name] for tag, n in measurement["launches"].items()
            if n[name]}
        kernels_line.append(r)
    kernels_line[0]["shard"] = sharded["shard_kernels"]["topk_ip"]
    kernels_line[1]["shard"] = sharded["shard_kernels"]["topk_ip_sq8"]
    kernels_line[1].update(ms_k80=rec["b4"]["main_shape_ms"]["b2_k80"],
                           launches_bench=bench["launches"]["topk_ip_sq8"],
                           ms_bench=bench["results"]["v0"]["ms"],
                           max_abs_err_bench=bench["v0_max_abs_err"],
                           residency_bench=bench["v0_residency"])
    shape = (f"Bq {BENCH_BQ}, N {BENCH_N}, d 128, k {K}, blk {BENCH_BLK} "
             "(the bench's default)")
    kernels_line.append(dict(
        name="run_variant (B4a)", route="cuda",
        source="nafp_tpu_torch/csrc/bench_variant.cu",
        replaces="extras/bench_sq8_kernel.py:154 (run_variant)",
        variant="v2", **bench["variants"]["v2"],
        launches=bench["launches"]["run_variant"], shape=shape,
        variants=bench["variants"],
        main_shape_ms=rec["b4"]["main_shape_ms"],
        main_shape_library_ms=rec["b4"]["main_shape_library_ms"],
        b2_above_floor=rec["b4"]["selection_share"]))
    kernels_line.append(dict(
        name="run_dotonly (B4b)", route="cuda",
        source="nafp_tpu_torch/csrc/bench_dotonly.cu",
        replaces="extras/bench_sq8_kernel.py:201 (run_dotonly)",
        **bench["dotonly"], launches=bench["launches"]["run_dotonly"], shape=shape,
        b2_above_floor_bench=bench["selection_share"],
        residency_bench=bench["residency"], residency=rec["b4"]["residency"],
        main_shape_library_ms=rec["b4"]["main_shape_library_ms"]))
    # ms at layer 1 (batch 640, bf16, channels last) and summed over the
    # 16 norms of a step; gaps of y and dx in bf16 ulps (bf16) or over the
    # largest |plain| (f32), of dgamma and dbeta over an f64 sum's |terms|
    kernels_line.append(dict(
        name="LayerNorm2d", route="cuda",
        source="nafp_tpu_torch/csrc/layernorm2d.cu",
        replaces="none (XLA fusion)",
        **{k: v for k, v in ln2d["layer1"].items() if k != "shape"},
        shape=f"B {LN2D_ROWS[0]} x {tuple(ln2d['layer1']['shape'])} bf16, "
              "channels last (layer 1)",
        step=ln2d["step"],
        max_abs_err={key: dict(zip(("y", "dx", "dgamma", "dbeta"), gap))
                     for key, gap in ln2d["worst_gaps"].items()},
        launches=ln2d["launches"], launches_run="640_lamb, 3 steps"))
    # ms of a 640_lamb step's update (68 leaves, one group); absolute gaps
    # of the parameters and moments, and relative ones over each leaf's
    # largest |value| (the change's and the ratio's over their own);
    # launches of the trainer's 640_lamb steps
    kernels_line.append(dict(
        name="LAMB", route="cuda", source="nafp_tpu_torch/csrc/lamb.cu",
        replaces="none (XLA fusion)", ms=lamb["kernel_ms"],
        bound_ms=lamb["bound_ms"], plain_ms=lamb["plain_ms"],
        wall_ms=lamb["step_ms"], kernels=lamb["kernels"],
        shape=f"640_lamb's 68 leaves, {lamb['n_params']} f32 parameters",
        max_abs_err=lamb["abs_gaps"], max_rel_err=lamb["gaps"],
        trust_ratios=lamb["ratios"], two_runs_equal=lamb["two_runs_equal"],
        launches=ln2d["lamb_launches"], launches_run="640_lamb, 3 steps"))
    for r in kernels_line:
        r["max_err"] = r["max_abs_err"]
    summary = {k: v for k, v in main_path.items()
               if k not in ("cfg", "variables", "cfg_path", "dummy_dir",
                            "emb_dir", "l2_top1", "data", "raw")}
    summary.update(enc, training=training, sharded=sharded, triplet=triplet,
                   layernorm2d=ln2d, lamb=lamb,
                   ivf_sq8={k: v for k, v in ivf_sq8.items()
                            if k not in ("raw", "store")},
                   measurement=measurement,
                   device_corpus=corpus,
                   data_dependence=ivfpq["data_dependence"],
                   bench=bench["results"],
                   prune_ms=ivfpq["prune_ms"],
                   ivfpq_store_n_pad=ivfpq["n_pad"], phase_s=phase_s,
                   total_s=time.perf_counter() - t_start)
    log("summary " + json.dumps(summary))
    print(json.dumps({"kernels": kernels_line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
