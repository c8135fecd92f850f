#!/usr/bin/env python
"""Search-throughput benchmark of the port on one card.

Counterpart of ``bench_search.py``: QPS of segment-level top-k over a
synthetic fingerprint DB, per index type, on ``cuda:0`` (``--cpu``: the
CPU, with the kernels' plain versions).

Usage:
    python -m nafp_tpu_torch.bench_search [--n 2000000] [--nq 2048]
        [--k 20] [--index l2|ip|ivfpq|hnsw|pallas] [--recall] [--cpu]
    python -m nafp_tpu_torch.bench_search --suite [--root DIR] [--out F]

``--index pallas`` is kernel B1 (``search/topk.topk_ip``) called directly
in 512-query blocks over the uploaded DB. ``--suite`` measures {sq8,
ivfpq, ivfpq-rr, ivf-sq8} at ``--n`` rows plus hnsw (ef 64/128/256,
built with the host's threads) at ``--hnsw_n`` rows, all against exact
host ground truth, with the DB, stores and graph persisted under
``--root`` (the 100x protocol's files: ``extras/run_100x_protocol.py``),
and writes the rows to ``--out``: by default
``nafp_tpu_torch/measurements/SEARCH_BENCH_torch.json``, never the JAX
package's ``SEARCH_BENCH.json``. Its ``backend`` names the card.
"""
import argparse
import json
import os
import time

import numpy as np
import torch

from nafp_tpu_torch.device import chunked_device_put, resolve_device

PKG = os.path.dirname(os.path.abspath(__file__))
DEFAULT_OUT = os.path.join(PKG, "measurements", "SEARCH_BENCH_torch.json")


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def host_top1(db, q, block: int = 1 << 20) -> np.ndarray:
    """Exact top-1 ids of q over the rows of db by blocked torch sgemm on
    the host (torch's threads)."""
    qt = torch.from_numpy(np.ascontiguousarray(q, np.float32))
    gt = np.full(len(q), -1, np.int64)
    gv = np.full(len(q), -np.inf, np.float32)
    for s in range(0, len(db), block):
        e = min(s + block, len(db))
        sim = qt @ torch.from_numpy(np.ascontiguousarray(db[s:e],
                                                         np.float32)).T
        pv, pi = torch.max(sim, dim=1)
        pv, pi = pv.numpy(), pi.numpy().astype(np.int64) + s
        better = pv > gv
        gv = np.where(better, pv, gv)
        gt = np.where(better, pi, gt)
    return gt


def recall_of(gt, ids) -> float:
    return float(np.mean([gt[i] in ids[i] for i in range(len(gt))]))


def run_suite(args, dev: torch.device) -> dict:
    from nafp_tpu_torch.extras.run_100x_protocol import (exact_gt_host,
                                                         load_mm,
                                                         make_queries,
                                                         stage_build,
                                                         stage_gen)
    root = args.root
    os.makedirs(root, exist_ok=True)
    stage_gen(root, args.n)
    mm = load_mm(root)
    q, _ = make_queries(mm, args.nq)
    gt, _, _ = exact_gt_host(mm, q, root)      # cached after the first run
    rows = []
    for index in ("sq8", "ivfpq", "ivfpq-rr", "ivf-sq8"):
        out = {}
        idx = stage_build(root, out, index=index, device=dev)
        if hasattr(idx, "nprobe"):
            idx.nprobe = args.nprobe
        idx.search(q, args.k)                  # warm with identical shapes
        t0 = time.perf_counter()
        _, ids = idx.search(q, args.k)
        dt = time.perf_counter() - t0
        row = {"metric": "search_qps", "index": index, "n": args.n,
               "value": round(args.nq / dt, 1), "unit": "queries/sec",
               "k": args.k, "recall_at_k": round(recall_of(gt, ids), 4),
               **({"nprobe": args.nprobe} if hasattr(idx, "nprobe") else {}),
               **{kk: out[kk] for kk in ("train_sec", "add_sec",
                                         "build_cached") if kk in out}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del idx
    if not args.no_hnsw:
        rows.extend(_suite_hnsw(args, mm, q))
    result = {"suite": rows, "n": args.n, "nq": args.nq, "gt": "host-exact",
              "backend": device_name(dev)}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return result


def _suite_hnsw(args, mm, q):
    """hnsw rows at --hnsw_n (host C++; the graph is built with the host's
    threads and persists under --root)."""
    from nafp_tpu_torch.native.hnsw import HNSWIndex
    n = min(args.hnsw_n, len(mm))
    sub = np.asarray(mm[:n], np.float32)
    gt_path = os.path.join(args.root, f"gt_hnsw_{n}.npy")
    if os.path.exists(gt_path):
        gt = np.load(gt_path)
    else:
        gt = host_top1(sub, q)
        np.save(gt_path, gt)
    graph = os.path.join(args.root, f"hnsw_{n}_efc200.bin")
    if os.path.exists(graph):
        idx = HNSWIndex.load(graph)
        build = {"build_cached": True}
        print(f"[hnsw] loaded persisted graph {graph}", flush=True)
    else:
        threads = os.cpu_count() or 1
        idx = HNSWIndex(d=sub.shape[1], m=16, ef_construction=200)
        t0 = time.perf_counter()
        idx.add(sub, threads=threads)
        build = {"build_sec": round(time.perf_counter() - t0, 1),
                 "threads": threads}
        idx.save(graph)
        print(f"[hnsw] built + persisted {graph} "
              f"({build['build_sec']}s, {threads} threads)", flush=True)
    rows = []
    for ef in (64, 128, 256):
        idx.search(q[:64], args.k, ef_search=ef)          # warm
        t0 = time.perf_counter()
        _, ids = idx.search(q, args.k, ef_search=ef)
        dt = time.perf_counter() - t0
        row = {"metric": "search_qps", "index": "hnsw", "n": n,
               "value": round(args.nq / dt, 1), "unit": "queries/sec",
               "k": args.k, "recall_at_k": round(recall_of(gt, ids), 4),
               "ef_search": ef, "ef_construction": 200, **build}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


class _KernelB1:
    """Kernel B1 called directly in 512-query blocks over a resident DB."""

    def __init__(self, db: np.ndarray, dev: torch.device):
        self.db = chunked_device_put(db, dev, np.float32)
        self.ntotal = len(db)
        self.dev = dev

    def search(self, q, k):
        from nafp_tpu_torch.search.topk import topk_ip
        outs = []
        for s in range(0, len(q), 512):
            blk = torch.from_numpy(np.ascontiguousarray(
                q[s:s + 512], np.float32)).to(self.dev)
            outs.append(topk_ip(blk, self.db, k)[1].cpu().numpy())
        return None, np.concatenate(outs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2_000_000)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--index", default="ip")
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--recall", action="store_true",
                    help="also report recall@k of the true top-1 vs exact")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--suite", action="store_true",
                    help="measure the fixed suite ({sq8, ivfpq, ivfpq-rr, "
                         "ivf-sq8} @ --n rows + hnsw @ --hnsw_n, exact GT) "
                         "and write --out")
    ap.add_argument("--root", default=None,
                    help="suite artifact dir (DB memmap + built stores; "
                         "rebuild-on-miss); default bench_run/nafp_bench2m "
                         "in the checkout")
    ap.add_argument("--nprobe", type=int, default=40)
    ap.add_argument("--hnsw_n", type=int, default=500_000,
                    help="suite scale of the host-side hnsw rows")
    ap.add_argument("--no_hnsw", action="store_true",
                    help="skip the hnsw suite rows")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    if args.suite:
        if args.root is None:
            from nafp_tpu_torch.extras.run_100x_protocol import RUN_ROOT
            args.root = os.path.join(RUN_ROOT, "nafp_bench2m")
        return run_suite(args, dev)

    rng = np.random.default_rng(0)
    print(f"building DB: {args.n:,} x {args.d} ...", flush=True)
    db = rng.standard_normal((args.n, args.d)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[rng.integers(0, args.n, args.nq)] + \
        0.05 * rng.standard_normal((args.nq, args.d)).astype(np.float32)

    t0 = time.perf_counter()
    if args.index == "pallas":
        index = _KernelB1(db, dev)
    elif args.index == "hnsw":
        from nafp_tpu_torch.native.hnsw import HNSWIndex
        index = HNSWIndex(d=args.d)
        index.add(db)
    else:
        from nafp_tpu_torch.search.index import get_index
        index = get_index(args.index, db, device=dev)
        if hasattr(index, "add") and index.ntotal == 0:
            index.add(db)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    build_s = time.perf_counter() - t0

    # warm with the same shapes as the timed call
    index.search(q, args.k)
    t0 = time.perf_counter()
    _, ids = index.search(q, args.k)      # ids on the host
    dt = time.perf_counter() - t0

    recall = recall_of(host_top1(db, q), ids) if args.recall else None
    line = {
        "metric": "search_qps",
        "index": args.index,
        "n": args.n,
        "value": round(args.nq / dt, 1),
        "unit": "queries/sec",
        "build_sec": round(build_s, 2),
        "ms_per_query_batch": round(1000 * dt, 1),
        **({"recall_at_k": round(recall, 4)} if recall is not None else {}),
        "backend": device_name(dev),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
