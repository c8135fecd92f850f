#!/usr/bin/env python
"""Drive the PyTorch port (nafp_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper:
the kernels are compiled for sm_90a). It builds the CUDA kernels from the
sources in ``nafp_tpu_torch/csrc/``, then:

1. device: the card's name, count and power limit, the kernel build time;
2. kernels B1 (``topk_ip``), B2 (``topk_ip_sq8``) and B3
   (``topk_ip_masked``) against their plain PyTorch versions at the main
   path's shapes and edge cases, timed with CUDA events beside their bound
   and a one-call PyTorch yardstick (matmul + topk, which the port never
   calls);
3. the serving path through the CLI at full model width (random weights
   from a seed, written in the Flax layout as ``params.npz``): a seeded
   synthetic corpus -> ``generate`` -> a 619,500-row DB (the 10k-song
   protocol size) -> ``evaluate -i l2``, ``-i sq8``, ``-i ivfpq`` (the
   CLI default) and ``-i ivfpq-rr``; the kernels' launch counters are
   zeroed just before each evaluate and read just after it. Then an
   IVF-PQ store of the same DB, built and persisted on the card: small
   searches on the probe-pruned route timed against the linear scan, and
   B1/B3 timed on the protocol's own query fingerprints against random
   queries;
4. the encoder on the card against the port on the CPU (f32), bf16
   against f32 on the card, ``evaluate -i l2`` on the card against the
   same protocol on the CPU (a reduced id set), and the persisted IVF-PQ
   store searched on the card and on the CPU.

Every phase raises on failure; nothing is caught. The last lines are the
``{"kernels": [...]}`` record, the card's name and power limit as
``nvidia-smi`` prints them, and ``{"ok": true, "device": {...}}``. Work
files go to ``smoke_run/`` beside this script (listed in .gitignore).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "smoke_run")
NAME, INDEX = "smoke", 1
SEED = 0
N_DB_ROWS = 619_500          # dummy_db + db of the 10k-song protocol
SQ8_ROWS = 620_544           # the same DB padded to the sq8 store's 2048
K = 20                       # k_probe of the protocol
N_QUERY, N_DUMMY, SONG_SEC = 100, 200, 30   # synthetic corpus: 23,600 segs
N_TEST = 2000                # test ids of the protocol run
# H100 SXM published peaks (dense): f32 on the CUDA cores, bf16 tensor
# cores, HBM3 bandwidth.
PEAK_F32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
SCORE_ATOL = 1e-4            # scores vs plain (tests/test_pallas_topk.py)
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
# B3 launches per protocol run: 2000 ids in blocks of 128 at lengths
# 1 3 5 9 11 19, query blocks of at most 512 rows, one decode chunk
B3_LAUNCHES_PER_RUN = 235
# ivfpq-rr top-1 agreement with l2 may trail ivfpq's by at most this
# (tests/test_index.py's IVF-PQ recall rule)
RR_AGREE_SLACK = 0.02


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

    def b1_check(tag, q, dbx, k):
        v, i = T.topk_ip(q, dbx, k)
        pv, pi = T.topk_ip_plain(q, dbx, k)
        return check_topk(tag, v, i, pv, pi, lambda ids: torch.einsum(
            "bd,bkd->bk", q.double(), dbx.double()[ids]))

    for bq in (128, 512):
        errs.append(b1_check(f"B1 Bq={bq} N={N_DB_ROWS}",
                             unit_rows(bq, 128, gen, dev), db, K))
    errs.append(b1_check("B1 Bq=1", unit_rows(1, 128, gen, dev), db, K))
    neg_q = -unit_rows(64, 128, gen, dev).abs()
    errs.append(b1_check("B1 all-negative scores", neg_q,
                         unit_rows(5000, 128, gen, dev).abs(), K))
    errs.append(b1_check("B1 k>N", unit_rows(9, 128, gen, dev),
                         unit_rows(30, 128, gen, dev), 50))
    q = unit_rows(512, 128, gen, dev)
    ms = time_ms(lambda: T.topk_ip(q, db, K), 20)
    plain_ms = time_ms(lambda: T.topk_ip_plain(q, db, K), 5)
    lib_ms = time_ms(lambda: torch.topk(torch.matmul(q, db.T), K, dim=1), 10)
    flops = 2.0 * 512 * N_DB_ROWS * 128
    nbytes = 4.0 * (N_DB_ROWS * 128 + 512 * 128) + 8.0 * 512 * K
    bound = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
    rec["topk_ip"] = dict(
        name="topk_ip (B1)", route="cuda",
        source="nafp_tpu_torch/csrc/topk_f32.cu",
        replaces="nafp_tpu/search/pallas_topk.py:247 (topk_ip_pallas)",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations" if flops / PEAK_F32 >= nbytes / PEAK_BYTES
        else "bytes", library_ms=lib_ms, shape="Bq 512, N 619500, d 128, k 20")
    log(f"  B1 @ Bq 512: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"matmul+topk {lib_ms:.3f} ms, bound {bound:.3f} ms")
    del db

    # --- B2 --------------------------------------------------------------
    x = unit_rows(SQ8_ROWS, 128, gen, dev)
    vecs8, scales = quantize(x)
    del x
    tomb = torch.rand(SQ8_ROWS, generator=gen, device=dev) < 0.01
    tomb[N_DB_ROWS:] = True                 # pad rows past the DB
    rmask = torch.where(tomb, T.NEG, 0.0).to(torch.float32).contiguous()
    scales = torch.where(tomb, 0.0, scales).contiguous()
    errs = []

    def b2_check(tag, q, v8, sc, rm, k):
        v, i = T.topk_ip_sq8(q, v8, sc, rm, k)
        pv, pi = T.topk_ip_sq8_plain(q, v8, sc, rm, k,
                                     compute_dtype=torch.bfloat16)
        if bool(((rm[i.clamp(min=0).long()] < 0) & (i >= 0)).any()):
            raise AssertionError(f"{tag}: a masked row was returned")
        qb = q.to(torch.bfloat16).double()
        return check_topk(tag, v, i, pv, pi, lambda ids: torch.einsum(
            "bd,bkd->bk", qb, v8.double()[ids]) * sc.double()[ids]
            + rm.double()[ids])

    for bq in (128, 1024):
        errs.append(b2_check(f"B2 Bq={bq} N={SQ8_ROWS} (1% tombstones)",
                             unit_rows(bq, 128, gen, dev), vecs8, scales,
                             rmask, K))
    errs.append(b2_check("B2 Bq=1", unit_rows(1, 128, gen, dev), vecs8,
                         scales, rmask, K))
    small8, small_sc = quantize(unit_rows(40, 128, gen, dev).abs())
    small_rm = torch.zeros(40, device=dev)
    small_rm[::3] = T.NEG
    errs.append(b2_check("B2 all-negative, k>N",
                         -unit_rows(5, 128, gen, dev).abs(), small8,
                         torch.where(small_rm < 0, 0.0, small_sc).contiguous(),
                         small_rm.contiguous(), 48))
    q = unit_rows(1024, 128, gen, dev)
    ms = time_ms(lambda: T.topk_ip_sq8(q, vecs8, scales, rmask, K), 20)
    plain_ms = time_ms(lambda: T.topk_ip_sq8_plain(
        q, vecs8, scales, rmask, K, compute_dtype=torch.bfloat16), 5)
    v16 = vecs8.to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.topk(
        torch.matmul(q.to(torch.bfloat16), v16.T).float() * scales + rmask,
        K, dim=1), 10)
    flops = 2.0 * 1024 * SQ8_ROWS * 128
    nbytes = (SQ8_ROWS * 128 + 8.0 * SQ8_ROWS + 4.0 * 1024 * 128
              + 8.0 * 1024 * K)
    bound = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    rec["topk_ip_sq8"] = dict(
        name="topk_ip_sq8 (B2)", route="cuda",
        source="nafp_tpu_torch/csrc/topk_sq8.cu",
        replaces="nafp_tpu/search/pallas_topk.py:306 (topk_ip_sq8_pallas)",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES
        else "bytes", library_ms=lib_ms,
        shape="Bq 1024, N 620544, d 128, k 20")
    log(f"  B2 @ Bq 1024: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"bf16 matmul+topk {lib_ms:.3f} ms, bound {bound:.3f} ms")
    del vecs8, scales, rmask, v16

    rec["topk_ip_masked"] = phase_kernel_b3(dev, gen)
    return rec


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


def check_masked(tag, q, db, ids, bias, k, pos_of_id):
    """Kernel B3 against its plain version with bf16 queries (the kernel's
    numerics). A returned row that is masked or unprobed fails the check:
    its recomputed score is ~NEG."""
    import torch
    from nafp_tpu_torch.search import topk as T
    v, i = T.topk_ip_masked(q, db, ids, bias, k, LIST_TILE)
    pv, pi = T.topk_ip_masked_plain(q, db, ids, bias, k, LIST_TILE,
                                    compute_dtype=torch.bfloat16)
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

    q = unit_rows(512, 128, gen, dev)
    bias = probe_bias(512, sub_list, gen_np, dev)
    ms = time_ms(lambda: T.topk_ip_masked(q, db, ids, bias, K, LIST_TILE), 20)
    ms80 = time_ms(lambda: T.topk_ip_masked(q, db, ids, bias, 4 * K,
                                            LIST_TILE), 20)
    plain_ms = time_ms(lambda: T.topk_ip_masked_plain(
        q, db, ids, bias, K, LIST_TILE, compute_dtype=torch.bfloat16), 5)
    rmask = torch.where(ids >= 0, 0.0, T.NEG).to(torch.float32)
    q16 = q.to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.topk(
        torch.matmul(q16, db.T).float()
        + bias.repeat_interleave(LIST_TILE, 1) + rmask, K, dim=1), 10)
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
        f"{lib_ms:.3f} ms, bound {bound:.3f} ms")
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
        plain_ms=plain_ms,
        bound_ms=bound,
        bound_by="operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES
        else "bytes", library_ms=lib_ms,
        shape=f"Bq 512, N {n_pad} (bf16), d 128, k {K}; 40 of 256 lists "
              "probed")


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
                    os.path.join(ROOT, "extras", "make_synth_dataset.py"),
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
    for itype in ("ivfpq", "ivfpq-rr"):
        n = launches_by_run[itype]["topk_ip_masked"]
        if n != B3_LAUNCHES_PER_RUN:
            raise AssertionError(f"evaluate -i {itype} launched B3 {n} times,"
                                 f" predicted {B3_LAUNCHES_PER_RUN}")
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
                dummy_dir=dummy_dir, emb_dir=emb_dir, variables=variables)


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
    """Run fn under torch.profiler: wall time, the device's busy time (the
    union of its kernel and copy intervals) and busy share, and the device
    operations that take most time. Reads the raw trace events: turning
    the ~1M host events of an IVF-PQ build into ``prof.events()`` takes
    minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() != DeviceType.CUDA or name.startswith("Activity"):
            continue
        start, dur = e.start_ns(), e.duration_ns()
        spans.append((start, start + dur))
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + dur / 1e6, n + 1)
    busy_ns, end = 0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_ns += b - max(a, end)
            end = b
    busy_ms = busy_ns / 1e6
    rows = sorted(by_name.items(), key=lambda r: -r[1][0])[:top]
    log(f"  profile {tag}: wall {wall_ms:.1f} ms (profiler on), device "
        f"busy {busy_ms:.1f} ms = {busy_ms / wall_ms:.3f} of the wall")
    for name, (ms, n) in rows:
        log(f"    {ms:9.2f} ms  x{n:<6d} {name[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                busy=busy_ms / wall_ms,
                top=[dict(name=name[:90], ms=ms, count=n)
                     for name, (ms, n) in rows])


# ---------------------------------------------------------------------------
# Phase 4: card against CPU
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
    log(f"[1/4] device: {torch.cuda.get_device_name(0)} x "
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

    log("[2/4] kernels against their plain versions")
    rec = timed("kernels", phase_kernels, dev)
    log("[3/4] serving path through the CLI (full width)")
    main_path = timed("main path", phase_main_path, dev)
    ivfpq = timed("IVF-PQ store", phase_ivfpq_store, dev, main_path)
    log("[4/4] card against CPU")
    enc = timed("card vs CPU", phase_card_vs_cpu, dev, main_path, ivfpq)

    kernels_line = []
    for name in ("topk_ip", "topk_ip_sq8", "topk_ip_masked"):
        r = dict(rec[name])
        r["launches"] = main_path["launches"][name]
        r["launches_by_run"] = {
            run: n[name] for run, n in main_path["launches_by_run"].items()
            if n[name]}
        r["max_err"] = r["max_abs_err"]
        kernels_line.append(r)
    summary = {k: v for k, v in main_path.items()
               if k not in ("cfg", "variables", "cfg_path", "dummy_dir",
                            "emb_dir")}
    summary.update(enc, data_dependence=ivfpq["data_dependence"],
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
