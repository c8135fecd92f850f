#!/usr/bin/env python
"""Measure the 100x search protocol at its real scale: 53.6 M vectors.

Counterpart of ``extras/run_100x_protocol.py``. The reference's full
evaluation runs 2,000 queries against a 100k-song dummy DB of ~53.6 M
fingerprints (``eval/eval_faiss.py:147-148``, TEST_DUMMY_DB
'100k_full_icassp'). This script builds that scale on disk and measures
the port's indexes against ground truth: QPS and recall@k, on ``cuda:0``
(``--cpu``: the CPU, with the kernels' plain versions).

Stages (each skipped when its artifact already exists):
  1. gen      — ``dummy_db.mm`` (N x 128 f32, unit rows) +
                ``dummy_db_shape.npy``, written in chunks from
                ``default_rng(12345)``: the same bytes as the JAX writer,
                so either package's DB feeds the other.
  2. build    — ``sq8`` (the int8 flat scan, kernel B2), ``ivf-sq8``,
                ``ivfpq`` (kernel B3; ``--pq_decode int8`` decodes from
                int8 codebooks, set after a load as in the JAX script) or
                ``ivfpq-rr``; the store is
                persisted as ``sq8_store.npz`` / ``ivfsq8_store.npz`` /
                ``ivfpq_store.npz`` in the JAX package's format (loads in
                either package) and reused when present.
  3. qps      — warm, then a timed search of NQ noisy-copy queries (seed
                7) per nprobe; the timing ends when the ids are on the host.
  4. recall   — recall@k of the ground truth. Default GT is PLANTED: each
                query is a noisy copy of a known row, which is the exact
                top-1 with impostor probability ~1e-31 at 53.6 M rows, d
                128. ``--gt host`` checks that with an exact top-2 by
                blocked torch sgemm on the host (cached in
                ``exact_gt.npz`` under the JAX package's key); ``--gt
                device`` scans the memmap with kernel B1 in 2 M-row chunks
                uploaded to the card.

Results are appended as JSON lines to ROOT/results.jsonl.

Usage:
    python -m nafp_tpu_torch.extras.run_100x_protocol [--n 53600000]
        [--nq 2048] [--root DIR] [--stages gen,build,qps,recall]
        [--index ivf-sq8|ivfpq|ivfpq-rr|sq8] [--pq_decode f32|int8]
        [--gt planted|host|device] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import zipfile

import numpy as np
import torch

from nafp_tpu_torch.device import chunked_device_put, resolve_device

D = 128
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# default working directories of the measurement entry points (listed in
# .gitignore): the checkout's own, never a shared system directory
RUN_ROOT = os.path.join(REPO, "bench_run")


def stage_gen(root: str, n: int, chunk: int = 1 << 20) -> str:
    """``dummy_db.mm``: n unit rows from ``default_rng(12345)``, written
    through a warm reused buffer (the JAX writer's bytes)."""
    path = os.path.join(root, "dummy_db.mm")
    shape_path = os.path.join(root, "dummy_db_shape.npy")
    if os.path.exists(path) and os.path.exists(shape_path) \
            and tuple(np.load(shape_path)) == (n, D):
        print(f"[gen] exists: {path}")
        return path
    print(f"[gen] writing {n:,} x {D} f32 ({n * D * 4 / 2**30:.1f} GiB) ...")
    rng = np.random.default_rng(12345)
    buf = np.empty((chunk, D), np.float32)
    nrm = np.empty(chunk, np.float32)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            v, nv = buf[:e - s], nrm[:e - s]
            rng.standard_normal((e - s, D), dtype=np.float32, out=v)
            np.sqrt(np.einsum("nd,nd->n", v, v, optimize=True), out=nv)
            v /= nv[:, None]
            v.tofile(f)
            if (s // chunk) % 8 == 0:
                print(f"  {e:,}/{n:,}  ({time.perf_counter()-t0:.0f}s)",
                      flush=True)
    np.save(shape_path, np.asarray((n, D)))
    print(f"[gen] done in {time.perf_counter()-t0:.0f}s")
    return path


def load_mm(root: str) -> np.memmap:
    shape = tuple(np.load(os.path.join(root, "dummy_db_shape.npy")))
    return np.memmap(os.path.join(root, "dummy_db.mm"), np.float32, "r",
                     shape=shape)


def make_queries(mm, nq: int, seed: int = 7):
    """nq noisy unit copies of seeded rows; returns (queries, planted
    rows)."""
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.integers(0, len(mm), nq))
    q = np.asarray(mm[pick], np.float32)
    q = q + 0.05 * rng.standard_normal(q.shape).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q, pick


def _cached_n(path: str) -> int:
    """ntotal of a persisted store, or -1 when it is unreadable (a partial
    write from a killed run)."""
    try:
        with np.load(path) as z:
            return int(z["ntotal"])
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        print(f"[build] unreadable store {path}: {e}", flush=True)
        return -1


def stage_build(root: str, out: dict, index: str = "ivf-sq8",
                pq_decode: str = "f32", device=None):
    """Train + add (or load the persisted store) on ``device``;
    ``pq_decode`` ('f32' or 'int8'): the IVF-PQ decode."""
    if pq_decode not in ("f32", "int8"):
        raise ValueError(f"pq_decode {pq_decode!r}: 'f32' or 'int8'")
    dev = resolve_device(device)
    if index == "ivfpq":
        return _build_ivfpq(root, out, dev, pq_decode)
    if index == "ivfpq-rr":
        return _build_ivfpq_rr(root, out, dev, pq_decode)
    if index == "sq8":
        return _build_sq8(root, out, dev)
    if index != "ivf-sq8":
        raise ValueError(index)
    from nafp_tpu_torch.search.index import IVFSQ8Index
    mm = load_mm(root)
    cache = os.path.join(root, "ivfsq8_store.npz")
    if os.path.exists(cache):
        if _cached_n(cache) == len(mm):
            print(f"[build] loading persisted index {cache}", flush=True)
            t0 = time.perf_counter()
            idx = IVFSQ8Index.load(cache, device=dev)
            print(f"[build] store resident in "
                  f"{time.perf_counter()-t0:.0f}s", flush=True)
            out.update(nlist=idx.nlist, list_cap=idx.list_cap,
                       build_cached=True)
            return idx
        os.remove(cache)
    idx = IVFSQ8Index(d=D, device=dev)
    t0 = time.perf_counter()
    idx.train(mm)
    t_train = time.perf_counter() - t0
    print(f"[build] trained nlist={idx.nlist} in {t_train:.0f}s", flush=True)
    t0 = time.perf_counter()
    idx.add(mm, persist_path=cache)
    t_add = time.perf_counter() - t0
    print(f"[build] added {idx.ntotal:,} rows in {t_add:.0f}s "
          f"(list_cap={idx.list_cap}); store persisted to {cache}",
          flush=True)
    out.update(nlist=idx.nlist, list_cap=idx.list_cap,
               train_sec=round(t_train, 1), add_sec=round(t_add, 1))
    return idx


def _build_sq8(root: str, out: dict, dev):
    """The exact int8 scan: one quantize pass and the upload. A persisted
    ivf-sq8 store serves too: its sorted rows and original-row ids are
    what a full scan needs."""
    from nafp_tpu_torch.search.index import SQ8FlatIndex
    mm = load_mm(root)
    own_cache = os.path.join(root, "sq8_store.npz")
    for cache in (own_cache, os.path.join(root, "ivfsq8_store.npz"),
                  os.path.join(root, "ivf-sq8_store.npz")):
        if os.path.exists(cache) and _cached_n(cache) == len(mm):
            print(f"[build] loading persisted store {cache}", flush=True)
            t0 = time.perf_counter()
            idx = SQ8FlatIndex.load(cache, device=dev)
            print(f"[build] store resident in "
                  f"{time.perf_counter()-t0:.0f}s", flush=True)
            out.update(index="sq8", build_cached=True)
            return idx
    idx = SQ8FlatIndex(d=D, device=dev)
    t0 = time.perf_counter()
    idx.add(mm, persist_path=own_cache)
    t_add = time.perf_counter() - t0
    print(f"[build] quantized+uploaded {idx.ntotal:,} rows in {t_add:.0f}s; "
          f"store persisted to {own_cache}", flush=True)
    out.update(index="sq8", add_sec=round(t_add, 1))
    return idx


def _build_ivfpq(root: str, out: dict, dev, pq_decode: str = "f32"):
    """IVF-PQ with the reference's parameters (nlist 256, 64 x 8-bit codes,
    ``get_index_faiss.py:69-74``), trained on 512 k sampled rows: 64 B of
    codes a row, ~3.4 GB at 53.6 M rows."""
    from nafp_tpu_torch.search.index import IVFPQIndex
    mm = load_mm(root)
    cache = os.path.join(root, "ivfpq_store.npz")
    if os.path.exists(cache):
        if _cached_n(cache) == len(mm):
            print(f"[build] loading persisted index {cache}", flush=True)
            t0 = time.perf_counter()
            idx = IVFPQIndex.load(cache, device=dev)
            idx.decode_int8 = pq_decode == "int8"
            print(f"[build] store resident in "
                  f"{time.perf_counter()-t0:.0f}s", flush=True)
            out.update(index="ivfpq", nlist=idx.nlist, m=idx.m,
                       pq_decode=pq_decode, build_cached=True)
            return idx
        os.remove(cache)
    idx = IVFPQIndex(d=D, device=dev, decode_int8=pq_decode == "int8")
    t0 = time.perf_counter()
    idx.train(mm, max_train=1 << 19)
    t_train = time.perf_counter() - t0
    print(f"[build] trained ivfpq nlist={idx.nlist} m={idx.m} in "
          f"{t_train:.0f}s", flush=True)
    t0 = time.perf_counter()
    idx.add(mm, persist_path=cache)
    t_add = time.perf_counter() - t0
    print(f"[build] added {idx.ntotal:,} rows in {t_add:.0f}s; store "
          f"persisted to {cache}", flush=True)
    out.update(index="ivfpq", nlist=idx.nlist, m=idx.m, pq_decode=pq_decode,
               train_sec=round(t_train, 1), add_sec=round(t_add, 1))
    return idx


def _build_ivfpq_rr(root: str, out: dict, dev, pq_decode: str = "f32"):
    """ivfpq-rr: the persisted ivfpq store plus the raw f32 rows uploaded
    for the exact re-rank (refine stores are not persisted)."""
    idx = _build_ivfpq(root, out, dev, pq_decode)
    mm = load_mm(root)
    t0 = time.perf_counter()
    idx.raw = chunked_device_put(mm, dev)
    idx.refine = True
    out.update(index="ivfpq-rr",
               raw_ship_sec=round(time.perf_counter() - t0, 1))
    return idx


def stage_qps(idx, mm, nq: int, k: int, out: dict, nprobes=None, gt=None,
              on_point=None, qblock=None):
    """Timed search, optionally per nprobe. ``gt``: exact top-1 ids; when
    given, recall is measured against it and the planted-row recall is
    reported beside it."""
    q, pick = make_queries(mm, nq)
    skw = {} if qblock is None else {"block": qblock}
    sweep = []
    points = ((nprobes or [idx.nprobe]) if hasattr(idx, "nprobe")
              else [None])
    for np_ in points:
        if np_ is not None:
            idx.nprobe = np_
        idx.search(q, k, **skw)           # warm with identical shapes
        t0 = time.perf_counter()
        _, ids = idx.search(q, k, **skw)  # ids on the host
        dt = time.perf_counter() - t0
        rec_pl = float(np.mean([pick[i] in ids[i] for i in range(len(q))]))
        point = {"nprobe": np_, "qps": round(nq / dt, 1),
                 "recall_planted": round(rec_pl, 4)}
        if gt is not None:
            rec_gt = float(np.mean([gt[i] in ids[i] for i in range(len(q))]))
            point["recall_at_k"] = round(rec_gt, 4)
        else:
            point["recall_at_k"] = point["recall_planted"]
        sweep.append(point)
        print(f"[qps] nprobe={np_}: {point['qps']} queries/sec "
              f"recall@{k} {point['recall_at_k']:.4f}", flush=True)
        if on_point is not None:
            on_point(point)
    out.update(nq=nq, k=k, qps=sweep[-1]["qps"],
               search_sec=round(dt, 2), sweep=sweep)
    return ids


def query_hash(q: np.ndarray) -> int:
    """The key ``exact_gt.npz`` is cached under (the JAX package's)."""
    return int(np.abs(q * 1e6).sum()) % (1 << 31)


def exact_gt_host(mm, q, root: str, chunk: int = 1 << 18):
    """Exact top-2 over the whole memmap by blocked torch sgemm on the host,
    with torch's threads. Returns (top1_ids, top1_vals, top2_vals); cached
    as ``exact_gt.npz`` keyed on the query set, in the JAX package's
    format."""
    qhash = query_hash(q)
    cache = os.path.join(root, "exact_gt.npz")
    if os.path.exists(cache):
        with np.load(cache) as z:
            if int(z["qhash"]) == qhash and int(z["n"]) == len(mm):
                print(f"[gt] cached: {cache}", flush=True)
                return z["top1_i"], z["top1_v"], z["top2_v"]
    n, nq = len(mm), len(q)
    best_v = np.full((nq, 2), -np.inf, np.float32)   # top-2 running merge
    best_i = np.full((nq, 2), -1, np.int64)
    qt = torch.from_numpy(np.ascontiguousarray(q))
    # warm reused buffers (block + product)
    blk_np = np.empty((chunk, mm.shape[1]), np.float32)
    sim_np = np.empty((nq, chunk), np.float32)
    t0 = time.perf_counter()
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        bv = blk_np[:e - s]
        bv[:] = mm[s:e]
        if e - s == chunk:                            # (nq, chunk) f32
            sim = torch.from_numpy(sim_np)
            torch.mm(qt, torch.from_numpy(bv).T, out=sim)
        else:   # the tail chunk: a column slice of sim_np is not contiguous
            sim = qt @ torch.from_numpy(bv).T
        pv, pi = torch.topk(sim, 2, dim=1)
        cat_v = np.concatenate([best_v, pv.numpy()], axis=1)
        cat_i = np.concatenate([best_i, pi.numpy().astype(np.int64) + s],
                               axis=1)
        sel = np.argsort(cat_v, axis=1)[:, -2:]
        best_v = np.take_along_axis(cat_v, sel, axis=1)
        best_i = np.take_along_axis(cat_i, sel, axis=1)
        if (s // chunk) % 16 == 0:
            print(f"  gt {e:,}/{n:,} ({time.perf_counter()-t0:.0f}s)",
                  flush=True)
    print(f"[gt] exact host scan done in {time.perf_counter()-t0:.0f}s",
          flush=True)
    top1_i, top1_v, top2_v = best_i[:, 1], best_v[:, 1], best_v[:, 0]
    np.savez(cache, qhash=qhash, n=n, top1_i=top1_i, top1_v=top1_v,
             top2_v=top2_v)
    return top1_i, top1_v, top2_v


def exact_gt_top1(mm, q, chunk: int = 1 << 21, device=None) -> np.ndarray:
    """Exact top-1 over the whole memmap with kernel B1 (``topk_ip``): each
    ``chunk``-row slice is uploaded (``chunked_device_put``) and scanned for
    every 512-query block; the winners merge on the device (a later
    chunk wins only with a strictly higher score, so ties keep the lower
    row). On the CPU B1's plain version runs. Returns int64 row ids."""
    from nafp_tpu_torch.search.topk import topk_ip
    dev = resolve_device(device)
    n = len(mm)
    qd = torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(dev)
    best_v = torch.full((len(q),), -float("inf"), device=dev)
    best_i = torch.full((len(q),), -1, dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    for s in range(0, n, chunk):
        db_dev = chunked_device_put(mm[s:s + chunk], dev, np.float32)
        for qs in range(0, len(q), 512):
            v, i = topk_ip(qd[qs:qs + 512], db_dev, 1)
            sl = slice(qs, qs + len(v))
            better = v[:, 0] > best_v[sl]
            best_v[sl] = torch.where(better, v[:, 0], best_v[sl])
            best_i[sl] = torch.where(better, i[:, 0].long() + s, best_i[sl])
        del db_dev
        print(f"  gt {min(s + chunk, n):,}/{n:,} "
              f"({time.perf_counter()-t0:.0f}s)", flush=True)
    return best_i.cpu().numpy()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=53_600_000)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--root", default=os.path.join(RUN_ROOT, "nafp_100x"))
    ap.add_argument("--stages", default="gen,build,qps,recall")
    ap.add_argument("--nprobes", default=None,
                    help="comma-separated nprobe sweep for the qps stage, "
                         "e.g. '40,80,128' (default: the index's 40)")
    ap.add_argument("--index", choices=("ivf-sq8", "ivfpq", "ivfpq-rr",
                                        "sq8"), default="ivf-sq8")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--pq_decode", choices=("f32", "int8"), default="f32",
                    help="ivfpq decode path: 'int8' decodes from int8 "
                         "codebooks with an f32 scale per (m, dim)")
    ap.add_argument("--qblock", type=int, default=None,
                    help="search query-block size")
    ap.add_argument("--gt", choices=("planted", "host", "device"),
                    default="planted",
                    help="'host' = exact top-1 by blocked host sgemm "
                         "(cached, checks the planted shortcut); 'device' "
                         "= kernel B1 over the memmap in uploaded chunks")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.root, exist_ok=True)
    stages = set(args.stages.split(","))
    out = {"protocol": "100x", "n": args.n, "index": args.index,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}

    if "gen" in stages:
        stage_gen(args.root, args.n)
    mm = load_mm(args.root)

    q, pick = make_queries(mm, args.nq)
    gt = None
    if args.gt == "host":
        gt, gt_v, imp_v = exact_gt_host(mm, q, args.root)
        agree = float(np.mean(gt == pick))
        out.update(gt="host-exact", planted_agree=round(agree, 4),
                   planted_cos_mean=round(float(gt_v.mean()), 4),
                   impostor_cos_max=round(float(imp_v.max()), 4))
        print(f"[gt] planted==exact for {agree:.4%} of queries; "
              f"cos(query,planted) mean {gt_v.mean():.4f}, "
              f"max impostor cos {imp_v.max():.4f}", flush=True)

    idx = None
    if {"build", "qps", "recall"} & stages:
        out_build = {}
        idx = stage_build(args.root, out_build, index=args.index,
                          pq_decode=args.pq_decode, device=dev)
        out.update(out_build)

    results_path = os.path.join(args.root, "results.jsonl")

    def checkpoint_line(extra):   # partial results survive a timeout
        with open(results_path, "a") as f:
            f.write(json.dumps({**extra, "partial": True}) + "\n")

    ids = None
    if "qps" in stages:
        nprobes = ([int(x) for x in args.nprobes.split(",")]
                   if args.nprobes else None)
        ids = stage_qps(idx, mm, args.nq, args.k, out, nprobes=nprobes,
                        gt=gt, qblock=args.qblock,
                        on_point=lambda p: checkpoint_line({**out, **p}))

    if "recall" in stages:
        if ids is None:
            _, ids = idx.search(q, args.k)
        if args.gt == "device":
            t0 = time.perf_counter()
            gt = exact_gt_top1(mm, q, device=dev)
            out.update(gt="exact-streamed", planted_agree=round(
                float(np.mean(gt == pick)), 4),
                gt_sec=round(time.perf_counter() - t0, 1))
        elif gt is None:
            gt = pick           # planted GT == exact top-1 (see docstring)
            out["gt"] = "planted"
        recall = float(np.mean([gt[i] in ids[i] for i in range(len(q))]))
        out["recall_at_k"] = round(recall, 4)
        print(f"[recall] recall@{args.k} = {recall:.4f} ({out['gt']})",
              flush=True)

    line = json.dumps(out)
    with open(results_path, "a") as f:
        f.write(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()
