"""Segment/sequence-level search evaluation (the ICASSP protocol).

Counterpart of ``nafp_tpu/search/evaluate.py`` (reference
``eval/eval_faiss.py:93-275``). Protocol, kept bit-faithful:

  - the index holds dummy_db then db, so ground truth for query i is
    ``i + len(dummy_db)`` (eval_faiss.py:121-148);
  - per segment top-k (k_probe=20), candidate starts = hit id − segment
    offset (:211-216), negatives dropped, duplicates deduped (:219);
  - sequence score = mean of diag(q · cand_window) over the raw vectors
    (:222-229), from a merged [dummy_db; db] array built separately instead
    of mutating dummy_db.mm in place;
  - metrics: top1-exact, top1-near(±1), top3, top10 per seq_len (:236-243);
  - outputs ``raw_score.npy`` (n_test, 4*len(seq_lens)), ``test_ids.npy``
    and ``eval_summary.json``.

Tail test ids (fewer than seq_len segments left) are zero-padded into the
search batch and their padded hits dropped. Candidate scoring runs on the
device when the merged array fits half the free device memory, on the host
otherwise. The final top-10 breaks score ties by the lower candidate slot,
as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np
import torch

from nafp_tpu_torch.data.audio_io import load_memmap
from nafp_tpu_torch.device import (DeviceLike, device_recon_budget,
                                   resolve_device)
from nafp_tpu_torch.search.index import cacheable_cls, get_index
from nafp_tpu_torch.search.table import LiveTable, print_results_table
from nafp_tpu_torch.search.topk import topk_low_index


def _score_candidates(q_seq: torch.Tensor, cands: torch.Tensor,
                      recon: torch.Tensor, sl: int, n_seg: torch.Tensor):
    """Sequence scores for candidate start ids, on ``recon``'s device.

    q_seq: (B, sl, d) with rows past n_seg zeroed; cands: (B, C) candidate
    start ids (-1 = invalid); recon: (N, d) raw vectors; n_seg: (B,) valid
    segments per query (tail test ids have fewer; the reference searches the
    truncated sequence, eval_faiss.py:208). Returns ((B, C) scores with
    duplicates and invalid entries at -inf, sorted candidates).
    """
    n = recon.shape[0]
    cands_sorted = torch.sort(cands, dim=1).values
    dup = torch.cat([torch.zeros_like(cands_sorted[:, :1], dtype=torch.bool),
                     cands_sorted[:, 1:] == cands_sorted[:, :-1]], dim=1)
    # validity against the TRUNCATED query length: a tail id with
    # n_seg < sl segments must still match a window of n_seg rows near the
    # DB end; window rows past n_seg meet zeroed query rows
    invalid = ((cands_sorted < 0) | (cands_sorted + n_seg[:, None] > n)
               | dup)
    safe = cands_sorted.clamp(0, n - 1)
    win_idx = (safe[:, :, None]
               + torch.arange(sl, device=safe.device)[None, None, :])
    windows = recon[win_idx.clamp(max=n - 1)]                   # (B,C,sl,d)
    scores = torch.einsum("bod,bcod->bc", q_seq, windows) \
        / n_seg[:, None].to(torch.float32)
    return scores.masked_fill(invalid, -float("inf")), cands_sorted


def _score_candidates_host(q_seq, cands, recon, sl, n_seg):
    """Numpy mirror of _score_candidates for DBs too large for device
    memory: gathers candidate windows from the host (memmap-backed)
    array."""
    n = recon.shape[0]
    cands_sorted = np.sort(cands, axis=1)
    dup = np.concatenate([np.zeros_like(cands_sorted[:, :1], bool),
                          cands_sorted[:, 1:] == cands_sorted[:, :-1]], axis=1)
    invalid = (cands_sorted < 0) | (cands_sorted + n_seg[:, None] > n) | dup
    safe = np.clip(cands_sorted, 0, n - 1)
    win_idx = np.minimum(safe[:, :, None] + np.arange(sl)[None, None, :],
                         n - 1)
    windows = recon[win_idx]                                    # (B,C,sl,d)
    scores = np.einsum("bod,bcod->bc", q_seq, windows) \
        / n_seg[:, None].astype(np.float64)
    scores[invalid] = -np.inf
    return scores, cands_sorted


# Above this size the merged dummy_db+db array lives on disk, not RAM.
MERGE_RAM_LIMIT = 8 << 30


def _icassp_asset_path() -> str:
    """Path of the packaged ICASSP-2021 test-id asset (package only, no
    CWD globbing); raises with a clear message when it is missing."""
    asset = os.path.normpath(os.path.join(
        os.path.dirname(__file__), os.pardir, "assets",
        "test_ids_icassp2021.npy"))
    if not os.path.exists(asset):
        raise FileNotFoundError(
            f"packaged ICASSP test-id asset missing at {asset}; pass "
            "test_ids='all', an integer count, or a path to a .npy file")
    return asset


def _merged_recon(emb_dir: str, dummy_db, db) -> np.ndarray:
    """Merged [dummy_db; db] raw-vector array for index build + rescoring,
    WITHOUT mutating dummy_db.mm (the reference's 'fake_recon_index',
    eval_faiss.py:163-174). Small DBs concatenate in RAM; past
    MERGE_RAM_LIMIT the merge is an on-disk memmap written blockwise."""
    n_d, n_q = len(dummy_db), len(db)
    d = db.shape[1]
    total_bytes = (n_d + n_q) * d * 4
    if total_bytes <= MERGE_RAM_LIMIT:
        return np.concatenate([np.asarray(dummy_db), np.asarray(db)])
    path = os.path.join(emb_dir, "merged_recon.mm")
    shape = (n_d + n_q, d)
    if os.path.exists(path) and os.path.getsize(path) == total_bytes:
        print(f"reusing merged recon memmap {path}")
        return np.memmap(path, np.float32, mode="r", shape=shape)
    blk = 1 << 20
    buf = np.empty((blk, d), np.float32)
    with open(path, "wb") as f:
        for src, n_src in ((dummy_db, n_d), (db, n_q)):
            for s in range(0, n_src, blk):
                e = min(s + blk, n_src)
                v = buf[:e - s]
                v[:] = src[s:e]
                v.tofile(f)
    return np.memmap(path, np.float32, mode="r", shape=shape)


def _hits_for_block(index, recon_dev, recon_host, query, ids_block, sl,
                    k_probe):
    """The (B, 10) ranked candidate start ids for a block of test ids at
    one sequence length."""
    b = len(ids_block)
    d = query.shape[1]
    q_seq = np.zeros((b, sl, d), np.float32)
    n_seg = np.minimum(len(query) - ids_block, sl).astype(np.int32)
    for j, t in enumerate(ids_block):
        q_seq[j, :n_seg[j]] = query[t:t + n_seg[j]]
    _, hit_ids = index.search(q_seq.reshape(-1, d), k_probe)
    hit_ids = hit_ids.reshape(b, sl, k_probe)
    # drop hits from padded (zero) segments
    seg_valid = np.arange(sl)[None, :] < n_seg[:, None]
    hit_ids = np.where(seg_valid[:, :, None], hit_ids, -1)
    # offset compensation (eval_faiss.py:215-216); ignore id<0 (:219)
    starts = hit_ids - np.arange(sl)[None, :, None]
    starts = np.where(hit_ids < 0, -1, starts)
    cands = starts.reshape(b, sl * k_probe)

    if recon_dev is not None:
        dev = recon_dev.device
        scores, cands_sorted = _score_candidates(
            torch.from_numpy(q_seq).to(dev),
            torch.from_numpy(cands.astype(np.int64)).to(dev), recon_dev, sl,
            torch.from_numpy(n_seg).to(dev))
        k10 = min(10, scores.shape[1])
        top_scores, pos = topk_low_index(scores, k10)
        pred = cands_sorted.gather(1, pos).cpu().numpy()
        valid = torch.isfinite(top_scores).cpu().numpy()
    else:
        scores, cands_sorted = _score_candidates_host(q_seq, cands,
                                                       recon_host, sl, n_seg)
        k10 = min(10, scores.shape[1])
        pos = np.argsort(-scores, axis=1, kind="stable")[:, :k10]
        top_scores = np.take_along_axis(scores, pos, axis=1)
        pred = np.take_along_axis(cands_sorted, pos, axis=1)
        valid = np.isfinite(top_scores)
    pred = np.where(valid, pred, -999999)
    return pred  # (B, 10) ranked candidate start ids


def _test_ids(test_ids, n_query: int, max_sl: int, seed: int) -> np.ndarray:
    """Test-id modes (eval_faiss.py:177-186): 'all', 'icassp', an integer
    count drawn with ``seed``, or a path to a .npy file."""
    if isinstance(test_ids, str) and test_ids.lower() == "all":
        ids = np.arange(0, n_query - max_sl, 1)
    elif isinstance(test_ids, str) and test_ids.lower() == "icassp":
        ids = np.load(_icassp_asset_path())
    elif isinstance(test_ids, str) and test_ids.isnumeric():
        rng = np.random.default_rng(seed)
        ids = rng.permutation(n_query - max_sl)[:int(test_ids)]
    else:
        ids = np.load(test_ids)
    return np.asarray(ids, np.int64)


def eval_fingerprints(emb_dir: str,
                      emb_dummy_dir: Optional[str] = None,
                      index_type: str = "ivfpq",
                      test_ids: str = "icassp",
                      test_seq_len: str = "1 3 5 9 11 19",
                      k_probe: int = 20,
                      max_train: int = int(1e7),
                      nprobe: int = 40,
                      seed: int = 42,
                      index_cache: Optional[str] = None,
                      ef_search: int = 64,
                      device: DeviceLike = None) -> np.ndarray:
    """Run the full search experiment; returns the hit-rate matrix
    (4, n_seq_len) in percent and writes raw_score.npy / test_ids.npy /
    eval_summary.json into ``emb_dir``.

    ``device``: where the index and the rescoring run (``cuda:0`` by
    default; raises when no card is present). ``index_cache``: npz path of
    the int8 store (sq8 / sq8-flat), loaded when present and written after
    a fresh build. ``max_train``, ``nprobe`` and ``ef_search`` belong to
    index families of later slices."""
    device = resolve_device(device)
    cache_cls, load_kwargs = cacheable_cls(index_type, nprobe)  # fail fast
    seq_lens = np.asarray(list(map(int, str(test_seq_len).split())))

    query, _ = load_memmap(emb_dir, "query")
    db, _ = load_memmap(emb_dir, "db")
    dummy_db, dummy_shape = load_memmap(emb_dummy_dir or emb_dir, "dummy_db")
    n_dummy = int(dummy_shape[0])
    full_db = _merged_recon(emb_dir, dummy_db, db)
    del dummy_db

    t0 = time.time()
    index = None
    if index_cache and cache_cls is not None \
            and os.path.exists(index_cache):
        try:
            with np.load(index_cache) as z:
                cached_n = int(z["ntotal"])
        except (OSError, ValueError, KeyError) as e:  # partial write
            print(f"ignoring unreadable index cache {index_cache}: {e}")
            cached_n = -1
        if cached_n == len(full_db):
            index = cache_cls.load(index_cache, device=device, **load_kwargs)
            print(f"loaded persisted {index_type} store {index_cache}")
    if index is None:
        index = get_index(index_type, full_db, max_train=max_train,
                          nprobe=nprobe, ef_search=ef_search, device=device)
        if hasattr(index, "add") and index.ntotal == 0:
            if index_cache and cache_cls is not None:
                index.add(full_db, persist_path=index_cache)
            else:
                index.add(full_db)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_build = time.time() - t0
    print(f"index[{index_type}] over {len(full_db):,} items "
          f"({t_build:.2f}s)")
    # raw vectors for rescoring: on the device when they fit half of the
    # free device memory left after the index was built, else host gathers
    limit = device_recon_budget(device)
    recon_dev = (torch.from_numpy(np.ascontiguousarray(full_db)).to(device)
                 if full_db.nbytes <= limit else None)
    if recon_dev is None:
        print(f"recon array {full_db.nbytes / 2**30:.1f} GiB > "
              f"budget {limit / 2**30:.1f} GiB: host-side rescoring")

    query = np.asarray(query, np.float32)
    ids = _test_ids(test_ids, len(query), int(seq_lens.max()), seed)
    n_test = len(ids)
    gt = ids + n_dummy
    print(f"test_id: {test_ids},  n_test: {n_test}")

    top1_exact = np.zeros((n_test, len(seq_lens)), int)
    top1_near = np.zeros((n_test, len(seq_lens)), int)
    top3_exact = np.zeros((n_test, len(seq_lens)), int)
    top10_exact = np.zeros((n_test, len(seq_lens)), int)

    t_start = time.time()
    n_searches = 0
    block = 128
    with LiveTable(seq_lens) as table:
        for si, sl in enumerate(seq_lens):
            for s in range(0, n_test, block):
                ids_block = ids[s:s + block]
                pred = _hits_for_block(index, recon_dev, full_db, query,
                                       ids_block, int(sl), k_probe)
                g = gt[s:s + block, None]
                top1_exact[s:s + block, si] = (pred[:, :1] == g).any(1)
                top1_near[s:s + block, si] = \
                    (np.abs(pred[:, :1] - g) <= 1).any(1)
                top3_exact[s:s + block, si] = (pred[:, :3] == g).any(1)
                top10_exact[s:s + block, si] = (pred[:, :10] == g).any(1)
                n_searches += len(ids_block)
                done = s + len(ids_block)
                ms = 1000.0 * (time.time() - t_start) / max(1, n_searches)
                table.update(si, [100.0 * m[:done, si].mean() for m in
                                  (top1_exact, top1_near, top3_exact,
                                   top10_exact)], done, n_test, ms)
            table.line_break()

    elapsed = time.time() - t_start
    ms_per_query = 1000.0 * elapsed / max(1, n_test * len(seq_lens))
    rates = np.stack([100.0 * top1_exact.mean(0), 100.0 * top1_near.mean(0),
                      100.0 * top3_exact.mean(0), 100.0 * top10_exact.mean(0)])
    print_results_table(seq_lens, rates, ms_per_query)

    np.save(os.path.join(emb_dir, "raw_score.npy"),
            np.concatenate([top1_exact, top1_near, top3_exact, top10_exact],
                           axis=1))
    np.save(os.path.join(emb_dir, "test_ids.npy"), ids)
    with open(os.path.join(emb_dir, "eval_summary.json"), "w") as f:
        json.dump({"index_type": index_type, "n_db": int(len(full_db)),
                   "n_test": int(n_test), "k_probe": int(k_probe),
                   "nprobe": (int(getattr(index, "nprobe", 0)) or None),
                   "seq_lens": [int(x) for x in seq_lens],
                   "device": str(device),
                   "build_sec": round(t_build, 1),
                   "search_sec": round(elapsed, 1),
                   "ms_per_query": round(ms_per_query, 3),
                   "rates": {name: [round(float(x), 2) for x in row]
                             for name, row in zip(
                                 ("top1_exact", "top1_near", "top3",
                                  "top10"), rates)}}, f, indent=1)
    print(f"Saved test_ids, raw score and eval_summary.json to {emb_dir}.")
    return rates
