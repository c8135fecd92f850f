#!/usr/bin/env python
"""HNSW sweep: efConstruction x efSearch at 500 k rows, with the graph's
save/load round trip.

Counterpart of ``extras/bench_hnsw.py`` over the port's
``native/hnsw.py``. The index lives on the host by nature (graph
pointer-chasing, as the reference's CPU-only ``faiss.IndexHNSWFlat``), so
this bench touches no device: it measures the host it runs on, with
``--threads`` build threads (``HNSWIndex.add(threads=)``). Recall@k is of
the exact top-1, from ``exact_gt_host`` of the port's 100x protocol
(cached under its query key).

Results append to ROOT/results.jsonl; the built graphs persist there, so
a re-sweep skips the build.

Usage:
    python -m nafp_tpu_torch.extras.bench_hnsw [--n 500000] [--nq 2048]
        [--k 20] [--ef_construction 80,200] [--ef_search 64,128,256,512]
        [--threads N] [--root DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nafp_tpu_torch.extras.run_100x_protocol import RUN_ROOT, exact_gt_host

D = 128


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--nq", type=int, default=2048)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--m", type=int, default=16)
    ap.add_argument("--ef_construction", default="80,200")
    ap.add_argument("--ef_search", default="64,128,256,512")
    ap.add_argument("--threads", type=int, default=1,
                    help="build threads (0 = the host's cores)")
    ap.add_argument("--root", default=os.path.join(RUN_ROOT, "nafp_hnsw"))
    args = ap.parse_args(argv)
    os.makedirs(args.root, exist_ok=True)
    from nafp_tpu_torch.native.hnsw import HNSWIndex

    rng = np.random.default_rng(0)
    db = rng.standard_normal((args.n, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[rng.integers(0, args.n, args.nq)] + \
        0.05 * rng.standard_normal((args.nq, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt1, _, _ = exact_gt_host(db, q, args.root)

    results_path = os.path.join(args.root, "results.jsonl")
    rows = []
    for efc in map(int, args.ef_construction.split(",")):
        graph = os.path.join(args.root, f"hnsw_n{args.n}_m{args.m}_"
                                        f"efc{efc}.bin")
        if os.path.exists(graph):
            t0 = time.perf_counter()
            idx = HNSWIndex.load(graph)
            t_build, cached = time.perf_counter() - t0, True
            print(f"[build] loaded {graph} in {t_build:.0f}s", flush=True)
            if idx.ntotal != args.n:
                raise ValueError(f"{graph} holds {idx.ntotal} rows, not "
                                 f"{args.n}")
        else:
            idx = HNSWIndex(d=D, m=args.m, ef_construction=efc)
            t0 = time.perf_counter()
            idx.add(db, threads=args.threads)
            t_build, cached = time.perf_counter() - t0, False
            t0 = time.perf_counter()
            idx.save(graph)
            print(f"[build] efC={efc}: built in {t_build:.0f}s, saved in "
                  f"{time.perf_counter()-t0:.0f}s", flush=True)
        for ef in map(int, args.ef_search.split(",")):
            idx.search(q[:64], args.k, ef_search=ef)   # warm
            t0 = time.perf_counter()
            _, ids = idx.search(q, args.k, ef_search=ef)
            dt = time.perf_counter() - t0
            rec = float(np.mean([gt1[i] in ids[i] for i in range(len(q))]))
            row = {"index": "hnsw", "n": args.n, "m": args.m, "efc": efc,
                   "ef_search": ef, "qps": round(args.nq / dt, 1),
                   "recall_at_k": round(rec, 4), "k": args.k,
                   "build_sec": round(t_build, 1), "build_cached": cached,
                   "threads": args.threads, "host_cpus": os.cpu_count()}
            with open(results_path, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
