#!/usr/bin/env python
"""The sequence-level ICASSP protocol at 100x scale, on one card.

Counterpart of ``extras/run_100x_sequence.py``. ``run_100x_protocol.py``
measures raw search QPS / recall on IID vectors; the reference's
100k-song evaluation is the *sequence* eval: per-segment top-k, offset
compensation, re-ranking over a dummy DB (``eval/eval_faiss.py:147-148,
204-243``). This runner writes SONG-STRUCTURED fingerprints (unit-sphere
random walks, so hop-adjacent segments correlate like real 0.5 s-hop
fingerprints) at full scale (default 100k dummy songs x 536 segments =
53.6 M rows, plus the 500-song query/db set) and drives the port's
``eval_fingerprints`` end to end with the fixed ICASSP test ids, on
``cuda:0`` (``--cpu``: the CPU).

Song model: x_0 ~ uniform(S^127); x_{t+1} = normalize(a·x_t + √(1−a²)·ε),
a = 0.7 by default. Queries are per-segment noisy copies of db rows,
q = normalize(db + s·ε), s = 0.066 (cos(q, db) ≈ 0.80). The writers draw
``default_rng(2024)`` (walks) and ``default_rng(777)`` (queries) in the
JAX writers' order: the same bytes, so either package's files feed the
other.

Stages (skipped when their artifact exists):
  gen   — dummy_db.mm / db.mm / query.mm (+ *_shape.npy) under ROOT,
          recorded in gen.done.json.
  eval  — eval_fingerprints(index, test_ids='icassp'); the ivf-sq8 store
          is persisted in ROOT/ivf-sq8_store.npz, and ``sq8`` reuses that
          file (its sorted int8 rows and original ids are what the flat
          scan needs). A line goes to ROOT/results.jsonl.

Usage:
    python -m nafp_tpu_torch.extras.run_100x_sequence [--root DIR]
        [--n_dummy_songs 100000] [--segs_per_song 536] [--index ivf-sq8]
        [--nprobe 40] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from nafp_tpu_torch.extras.run_100x_protocol import RUN_ROOT

D = 128


def _write_walks(path_base: str, n_songs: int, segs: int, alpha: float,
                 rng: np.random.Generator, song_chunk: int = 4096) -> None:
    """Write (n_songs*segs, D) unit random-walk fingerprints as {base}.mm
    + {base}_shape.npy, blockwise through warm reused buffers."""
    n = n_songs * segs
    beta = float(np.sqrt(1.0 - alpha * alpha))
    block = np.empty((song_chunk, segs, D), np.float32)
    x = np.empty((song_chunk, D), np.float32)
    eps = np.empty((song_chunk, D), np.float32)
    nrm = np.empty(song_chunk, np.float32)

    def _unitize(v, nv):
        np.sqrt(np.einsum("nd,nd->n", v, v, optimize=True), out=nv)
        v /= nv[:, None]

    t0 = time.perf_counter()
    with open(path_base + ".mm", "wb") as f:
        for s0 in range(0, n_songs, song_chunk):
            ns = min(song_chunk, n_songs - s0)
            xv, ev, bv, nv = x[:ns], eps[:ns], block[:ns], nrm[:ns]
            rng.standard_normal((ns, D), dtype=np.float32, out=xv)
            _unitize(xv, nv)
            bv[:, 0] = xv
            for t in range(1, segs):
                rng.standard_normal((ns, D), dtype=np.float32, out=ev)
                np.multiply(xv, alpha, out=xv)
                np.multiply(ev, beta, out=ev)
                np.add(xv, ev, out=xv)
                _unitize(xv, nv)
                bv[:, t] = xv
            bv.tofile(f)
            print(f"  {path_base}: {(s0 + ns):,}/{n_songs:,} songs "
                  f"({time.perf_counter()-t0:.0f}s)", flush=True)
    np.save(path_base + "_shape.npy", np.asarray((n, D)))


def _write_queries(root: str, n_db_songs: int, db_segs: int,
                   noise: float) -> None:
    db = np.memmap(os.path.join(root, "db.mm"), np.float32, "r",
                   shape=(n_db_songs * db_segs, D))
    rng = np.random.default_rng(777)
    q = np.asarray(db) + noise * rng.standard_normal(
        (len(db), D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qmm = np.memmap(os.path.join(root, "query.mm"), np.float32, "w+",
                    shape=q.shape)
    qmm[:] = q
    qmm.flush()
    np.save(os.path.join(root, "query_shape.npy"), np.asarray(q.shape))
    cos = float(np.mean(np.sum(q * db, axis=1)))
    print(f"[gen] query cos(q, db) mean = {cos:.4f}", flush=True)


def stage_gen(root: str, n_dummy_songs: int, dummy_segs: int,
              n_db_songs: int, db_segs: int, alpha: float,
              noise: float) -> None:
    done = os.path.join(root, "gen.done.json")
    want = dict(n_dummy_songs=n_dummy_songs, dummy_segs=dummy_segs,
                n_db_songs=n_db_songs, db_segs=db_segs, alpha=alpha,
                noise=noise)
    have = None
    if os.path.exists(done):
        with open(done) as f:
            have = json.load(f)
    if have == want:
        print("[gen] exists", flush=True)
        return
    if have is not None and {k: v for k, v in have.items() if k != "noise"} \
            == {k: v for k, v in want.items() if k != "noise"}:
        # only the query noise changed: the walks (and any store built from
        # them) are reusable; rewrite query.mm alone
        print(f"[gen] noise {have['noise']} -> {noise}: regenerating "
              "queries only", flush=True)
        _write_queries(root, n_db_songs, db_segs, noise)
        with open(done, "w") as f:
            json.dump(want, f)
        return
    print(f"[gen] dummy_db {n_dummy_songs:,} songs x {dummy_segs} segs "
          f"({n_dummy_songs * dummy_segs * D * 4 / 2**30:.1f} GiB)",
          flush=True)
    rng = np.random.default_rng(2024)
    _write_walks(os.path.join(root, "dummy_db"), n_dummy_songs, dummy_segs,
                 alpha, rng)
    print(f"[gen] db {n_db_songs} songs x {db_segs} segs", flush=True)
    _write_walks(os.path.join(root, "db"), n_db_songs, db_segs, alpha, rng)
    _write_queries(root, n_db_songs, db_segs, noise)
    with open(done, "w") as f:
        json.dump(want, f)


def stage_eval(root: str, index: str, nprobe: int, test_ids: str, device,
               kmeans_seed: int = 0) -> dict:
    """eval_fingerprints over ROOT's files; returns its summary. The
    ivf-sq8 store of k-means seed 0 is persisted in ROOT/ivf-sq8_store.npz
    (and ``sq8`` scans it); another seed builds its store without
    persisting it, leaving that file alone."""
    from nafp_tpu_torch.search.evaluate import eval_fingerprints
    cache = (os.path.join(root, "ivf-sq8_store.npz")
             if index in ("ivf-sq8", "sq8") and kmeans_seed == 0 else None)
    eval_fingerprints(root, emb_dummy_dir=root, index_type=index,
                      test_ids=test_ids, nprobe=nprobe, index_cache=cache,
                      device=device, kmeans_seed=kmeans_seed)
    with open(os.path.join(root, "eval_summary.json")) as f:
        return json.load(f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(RUN_ROOT,
                                                   "nafp_seq100x"))
    ap.add_argument("--n_dummy_songs", type=int, default=100_000)
    ap.add_argument("--segs_per_song", type=int, default=536)
    ap.add_argument("--n_db_songs", type=int, default=500)
    ap.add_argument("--db_segs", type=int, default=59)   # 30 s @ 0.5 s hop
    ap.add_argument("--alpha", type=float, default=0.7)
    ap.add_argument("--noise", type=float, default=0.066)
    ap.add_argument("--index", default="ivf-sq8")
    ap.add_argument("--nprobe", type=int, default=40,
                    help="probed lists for the IVF family")
    ap.add_argument("--test_ids", default="icassp")
    ap.add_argument("--stages", default="gen,eval")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    from nafp_tpu_torch.device import resolve_device
    dev = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.root, exist_ok=True)
    stages = set(args.stages.split(","))

    if "gen" in stages:
        stage_gen(args.root, args.n_dummy_songs, args.segs_per_song,
                  args.n_db_songs, args.db_segs, args.alpha, args.noise)

    line = {}
    if "eval" in stages:
        summary = stage_eval(args.root, args.index, args.nprobe,
                             args.test_ids, dev)
        line = {"protocol": "100x-sequence", "alpha": args.alpha,
                "noise": args.noise, **summary}
        with open(os.path.join(args.root, "results.jsonl"), "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
