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
search batch and their padded hits dropped. The re-rank runs where the
merged array lives: in one launch of the kernel ``csrc/rerank_f32.cu``
(``rerank_f32``) when it is on the card, as PyTorch ops (``rerank_plain``,
the kernel's plain version) when it is a CPU tensor, and in numpy over the
host array when it did not fit half the free device memory. The final
top-10 breaks score ties by the lower candidate slot, as ``jax.lax.top_k``
does. ``LAUNCHES`` counts the kernel's launches, one a block re-ranked on
the card.
"""
from __future__ import annotations

import ctypes
import functools
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from nafp_tpu_torch.data.audio_io import load_memmap
from nafp_tpu_torch.device import (DeviceLike, chunked_device_put,
                                   device_recon_budget, resolve_device)
from nafp_tpu_torch.search.index import cacheable_cls, get_index
from nafp_tpu_torch.search.table import LiveTable, print_results_table
from nafp_tpu_torch.search.topk import topk_low_index
from nafp_tpu_torch.utils.profiling import count, span

K_OUT = 10              # answers a clip: the protocol's top 10
NO_PICK = -999999       # an answer slot without a valid candidate
RERANK_K_MAX = 32       # csrc/rerank_f32.cu K_MAX
RERANK_SMEM_KEYS = 8192  # csrc/rerank_f32.cu SMEM_KEYS: sorted in shared memory

LAUNCHES: Dict[str, int] = {"rerank": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def candidate_starts(hit_ids: np.ndarray, n_seg: np.ndarray,
                     sl: int) -> np.ndarray:
    """(B, sl·k) candidate start ids of a block's segment hits (B, sl, k):
    hit − segment offset (eval_faiss.py:215-216), -1 where the hit is
    negative (:219) or its segment is padding (at or past n_seg)."""
    b = len(hit_ids)
    seg_valid = np.arange(sl)[None, :] < n_seg[:, None]
    hit_ids = np.where(seg_valid[:, :, None], hit_ids, -1)
    starts = hit_ids - np.arange(sl)[None, :, None]
    return np.where(hit_ids < 0, -1, starts).reshape(b, -1)


def rerank_plain(q_seq: torch.Tensor, cands: torch.Tensor,
                 recon: torch.Tensor, sl: int, n_seg: torch.Tensor
                 ) -> torch.Tensor:
    """The re-rank as PyTorch ops on ``recon``'s device (the CPU route, and
    the kernel's plain version): (B, min(K_OUT, C)) int64 candidate starts,
    best first, NO_PICK where no valid candidate is left."""
    scores, cands_sorted = _score_candidates(q_seq, cands, recon, sl, n_seg)
    top, pos = topk_low_index(scores, min(K_OUT, scores.shape[1]))
    return torch.where(torch.isfinite(top), cands_sorted.gather(1, pos),
                       NO_PICK)


_RERANK_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                    + [ctypes.c_void_p] * 3)


@functools.lru_cache(maxsize=None)
def _rerank_fn():
    from nafp_tpu_torch import kernels
    return kernels.function("rerank_f32", _RERANK_ARGTYPES)


def rerank_f32(q_seq: torch.Tensor, hits: torch.Tensor, n_seg: torch.Tensor,
               recon: torch.Tensor, k_out: int) -> torch.Tensor:
    """The re-rank of a block in one launch of ``csrc/rerank_f32.cu``, on
    one CUDA device: q_seq (B, sl, d) f32 with rows past n_seg zero, hits
    (B, sl, k) int32 segment hits (-1 = none), n_seg (B,) int32, recon (N,
    d) f32. Returns (B, k_out) int32 candidate starts, best first, NO_PICK
    where no valid candidate is left: what ``candidate_starts`` +
    ``rerank_plain`` give, but for the order of f32 sums. Raises for
    tensors off the card (the plain version is ``rerank_plain``)."""
    b, sl, d = q_seq.shape
    kp = hits.shape[2] if hits.dim() == 3 else 0
    n = recon.shape[0]
    dev = recon.device
    if dev.type != "cuda":
        raise ValueError(f"rerank_f32 runs on the card; recon is on {dev} "
                         "(the plain version is rerank_plain)")
    for name, t, dtype, shape in (
            ("q_seq", q_seq, torch.float32, (b, sl, d)),
            ("hits", hits, torch.int32, (b, sl, kp)),
            ("n_seg", n_seg, torch.int32, (b,)),
            ("recon", recon, torch.float32, (n, d))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"rerank_f32: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}, expected a "
                             f"contiguous {dtype} {shape} on {dev}")
    if not (1 <= k_out <= min(RERANK_K_MAX, sl * kp)) or not 0 < n < 2 ** 31:
        raise ValueError(f"rerank_f32: k_out {k_out} (at most "
                         f"{RERANK_K_MAX} and sl·k = {sl * kp}), {n} rows")
    out = torch.empty((b, k_out), dtype=torch.int32, device=dev)
    if b == 0:
        return out
    p2 = 1 << (sl * kp - 1).bit_length()
    scratch = (torch.empty(b * p2, dtype=torch.int32, device=dev)
               if p2 > RERANK_SMEM_KEYS else None)
    vec = 4 if d % 4 == 0 and q_seq.data_ptr() % 16 == 0 \
        and recon.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(dev):
        err = _rerank_fn()(
            q_seq.data_ptr(), hits.data_ptr(), n_seg.data_ptr(),
            recon.data_ptr(), b, sl, d, kp, n, k_out, p2, vec,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"nafp_rerank_f32 kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["rerank"] += 1
    return out


class _Staging:
    """A block's re-rank inputs in one pinned host buffer, for one copy up:
    q_seq (B, sl, d) f32, hits (B, sl, k) int32 and n_seg (B,) int32, each
    at a 16-byte boundary. Each block takes a buffer of its own from
    PyTorch's caching pinned allocator, which hands a buffer out again only
    once nothing refers to it and its copies have ended: the caller of
    ``index.search`` may keep the query rows it was given (the benchmark's
    check does)."""

    def __init__(self, b: int, sl: int, d: int, kp: int):
        self.parts, size = self.layout(b, sl, d, kp)
        self.buf = torch.empty(size, dtype=torch.uint8, pin_memory=True)
        self.q_seq, self.hits, self.n_seg = (
            t.numpy() for t in self.views(self.buf))

    @staticmethod
    def layout(b: int, sl: int, d: int, kp: int):
        """[(byte offset, shape, dtype)] of q_seq, hits and n_seg, and the
        buffer's size in bytes."""
        parts, off = [], 0
        for shape, dtype in (((b, sl, d), torch.float32),
                             ((b, sl, kp), torch.int32),
                             ((b,), torch.int32)):
            parts.append((off, shape, dtype))
            off += -(-int(np.prod(shape)) * 4 // 16) * 16
        return parts, off

    def views(self, buf: torch.Tensor):
        """q_seq, hits and n_seg as views of ``buf`` (this buffer or its
        copy)."""
        return [buf[off:off + 4 * int(np.prod(shape))].view(dtype).view(shape)
                for off, shape, dtype in self.parts]

    def upload(self, dev: torch.device):
        """One copy of the whole buffer to ``dev`` on its current stream,
        without waiting: q_seq, hits and n_seg there."""
        return self.views(self.buf.to(dev, non_blocking=True))


def _fill_queries(query, ids_block, sl: int, q_seq: np.ndarray,
                  n_seg: np.ndarray) -> None:
    """q_seq[j] = the sl query rows from ids_block[j], zero past the n_seg[j]
    that are left (a tail test id has fewer; the reference searches the
    truncated sequence, eval_faiss.py:208)."""
    n_seg[:] = np.minimum(len(query) - ids_block, sl)
    off = np.arange(sl)
    valid = off[None, :] < n_seg[:, None]
    rows = np.where(valid, ids_block[:, None] + off[None, :], 0)
    np.take(np.asarray(query, np.float32), rows, axis=0, out=q_seq,
            mode="clip")
    q_seq[~valid] = 0.0


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


def hits_for_block(index, recon_dev, recon_host, query, ids_block, sl,
                   k_probe):
    """The (B, 10) ranked candidate start ids for a block of test ids at
    one sequence length: the protocol's unit of work, one search of the
    block's B·sl segments and one re-rank. With ``recon_dev`` on the card
    the re-rank is one copy up of the staged block, one launch of
    ``rerank_f32`` and one copy of the answers down."""
    b = len(ids_block)
    d = query.shape[1]
    ids_block = np.asarray(ids_block)
    on_card = recon_dev is not None and recon_dev.device.type == "cuda"
    with span("query.assemble"):
        if on_card:
            stage = _Staging(b, sl, d, k_probe)
            q_seq, n_seg = stage.q_seq, stage.n_seg
        else:
            q_seq = np.empty((b, sl, d), np.float32)
            n_seg = np.empty(b, np.int32)
        _fill_queries(query, ids_block, sl, q_seq, n_seg)
    _, hit_ids = index.search(q_seq.reshape(-1, d), k_probe)

    if on_card:
        dev = recon_dev.device
        with span("query.assemble"):
            stage.hits[...] = hit_ids.reshape(b, sl, k_probe)
        with span("query.rerank"):
            q_d, hits_d, n_seg_d = stage.upload(dev)
            out = rerank_f32(q_d, hits_d, n_seg_d, recon_dev,
                             min(K_OUT, sl * k_probe))
        with span("query.rerank_wait"):
            host = torch.empty(out.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(out, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            pred = host.numpy().astype(np.int64)
        count("query.rerank_fused")
        return pred

    with span("query.assemble"):
        cands = candidate_starts(hit_ids.reshape(b, sl, k_probe), n_seg, sl)
    if recon_dev is not None:
        with span("query.rerank"):
            pred = rerank_plain(torch.from_numpy(q_seq),
                                torch.from_numpy(cands.astype(np.int64)),
                                recon_dev, sl, torch.from_numpy(n_seg))
        with span("query.rerank_wait"):
            pred = pred.numpy()
    else:
        with span("query.rerank"):
            scores, cands_sorted = _score_candidates_host(
                q_seq, cands, recon_host, sl, n_seg)
            k10 = min(K_OUT, scores.shape[1])
            pos = np.argsort(-scores, axis=1, kind="stable")[:, :k10]
            top_scores = np.take_along_axis(scores, pos, axis=1)
            pred = np.take_along_axis(cands_sorted, pos, axis=1)
            pred = np.where(np.isfinite(top_scores), pred, NO_PICK)
    return pred  # (B, 10) ranked candidate start ids


# the name the benchmark's query runner imports
_hits_for_block = hits_for_block


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
                      device: DeviceLike = None,
                      kmeans_seed: int = 0) -> np.ndarray:
    """Run the full search experiment; returns the hit-rate matrix
    (4, n_seq_len) in percent and writes raw_score.npy / test_ids.npy /
    eval_summary.json into ``emb_dir``.

    ``device``: where the index and the rescoring run (``cuda:0`` by
    default; raises when no card is present). The sharded types split the
    rows over every local card (one CPU shard for the CPU); the rescoring
    stays on ``device``. ``index_cache``: npz path of the int8 store (sq8,
    sq8-flat, ivf-sq8 and the sharded twins), loaded when present and
    written after a fresh build. ``max_train``: rows the trained indexes
    learn from; ``nprobe``: lists the IVF indexes probe; ``ef_search``:
    hnsw's beam; ``kmeans_seed``: the k-means seed of the trained indexes
    (``seed`` draws the test ids)."""
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
                          nprobe=nprobe, ef_search=ef_search, device=device,
                          seed=kmeans_seed)
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
    recon_dev = (chunked_device_put(full_db, device)
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
                pred = hits_for_block(index, recon_dev, full_db, query,
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
