#!/usr/bin/env python
"""The port's measurement entry points at the scales their JAX
counterparts define, on one card, recorded as JSON.

Each stage calls an entry point's ``main`` in this process and writes one
file into ``--out`` (default ``nafp_tpu_torch/measurements/``), with the
card's name and power limit as ``nvidia-smi`` prints them, the host's CPU
count and memory, and the free disk of ``--root``:

  host        torch_host.json: ``df -h`` of --root, ``free -g``, ``nproc``.
  protocol    torch_100x_protocol.json: ``extras/run_100x_protocol.py``
              at ``--n`` rows (53.6 M): sq8 against host ground truth,
              B1's exact top-1 (``--gt device``) against it, ivf-sq8 at
              nprobe 40 and 96, ivfpq, ivfpq-rr; the launches of each run;
              then B1, B2 and B3 timed per call (CUDA events) at the
              protocol's shapes, beside their bounds.
  sequence    torch_100x_sequence.json: ``extras/run_100x_sequence.py``
              (``--songs`` dummy songs x 536 segments): ivf-sq8 at nprobe 40
              and 96, then sq8 on the same store file.
  seeds       torch_100x_sequence_seeds.json: the sequence corpus's
              ivf-sq8 at nprobe 40, its k-means trained with each of
              SEEDS (the spread of top-1 over the k-means draws).
  suite       SEARCH_BENCH_torch.json: ``bench_search --suite`` (2 M rows,
              hnsw at ``--hnsw_n``).
  bench       torch_bench.json: ``bench.py`` at batch 1024, 512 and 2048.
  train_step  torch_bench_train_step.json: ``640_lamb`` at 640 and
              ``tpu_5120 --probe``.
  hnsw        torch_bench_hnsw.json: ``extras/bench_hnsw.py`` with the
              host's threads.

``--clean`` deletes a stage's files under --root once it is recorded.
The sequence stage writes ≈ 58 GiB (the 27.4 GB DB, a 27.5 GB merged
recon, the 6.9 GB store); ``--recon_dir`` moves the recon elsewhere, such
as a RAM disk.

Usage:
    python -m nafp_tpu_torch.extras.run_full_scale --root DIR
        [--stages host,protocol,...] [--out DIR] [--n 53600000]
        [--songs 100000] [--clean] [--recon_dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# H100 SXM dense peaks and HBM3 rate (NVIDIA's data sheet): the bounds
PEAK_TF32, PEAK_BF16, PEAK_BYTES = 495e12, 989e12, 3.35e12
# the seeds stage's k-means seeds
SEEDS = (0, 1, 2)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip()


def context(root: str) -> dict:
    return {"nvidia_smi": sh("nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader").splitlines()[0],
            "nproc": os.cpu_count(), "free_g": sh("free", "-g"),
            "df_root": sh("df", "-h", root),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def time_ms(fn, iters: int = 5) -> float:
    """Mean ms of one call over ``iters`` after a warm call (CUDA events)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def counted(fn, *args):
    """(fn(*args), the kernel launches it made)."""
    from nafp_tpu_torch.search import topk as T
    T.reset_launches()
    res = fn(*args)
    torch.cuda.synchronize()
    return res, dict(T.LAUNCHES)


def stage_protocol(root: str, n: int) -> dict:
    from nafp_tpu_torch.extras import run_100x_protocol as P
    base = ["--n", str(n), "--root", root]
    runs = []
    for extra in (["--index", "sq8", "--gt", "host"],
                  ["--index", "sq8", "--gt", "device", "--stages", "recall"],
                  ["--index", "ivf-sq8", "--gt", "host", "--nprobes",
                   "40,96"],
                  ["--index", "ivfpq", "--gt", "host"],
                  ["--index", "ivfpq-rr", "--gt", "host"]):
        t0 = time.perf_counter()
        res, launches = counted(P.main, base + extra)
        runs.append({"args": extra, "wall_s": round(time.perf_counter() - t0,
                                                    1),
                     "launches": launches, **res})
        print(json.dumps(runs[-1]), flush=True)
    # B1's exact top-1 against the host's, query by query (the host's
    # top-2 gap says where the two may differ)
    mm = P.load_mm(root)
    q, _ = P.make_queries(mm, 2048)
    host_i, v1, v2 = P.exact_gt_host(mm, q, root)            # cached
    same = P.exact_gt_top1(mm, q) == host_i
    clear = (v1 - v2) >= 1e-6
    b1 = {"nq": len(q), "equal": int(same.sum()), "clear": int(clear.sum()),
          "equal_where_clear": int((same & clear).sum())}
    print(json.dumps(b1), flush=True)
    return {"runs": runs, "b1_vs_host_gt": b1, "kernels": kernel_times(root)}


def kernel_times(root: str) -> dict:
    """B1, B2 and B3 per call at the 100x protocol's shapes: B1 over one
    --gt device chunk (Bq 512 x 2,097,152 rows, k 1 and 20), B2 over the
    whole sq8 store (Bq 1024, k 20), B3 over one decoded IVF-PQ chunk
    (Bq 512, k 20)."""
    from nafp_tpu_torch.device import chunked_device_put
    from nafp_tpu_torch.extras import run_100x_protocol as P
    from nafp_tpu_torch.search import index as PI
    from nafp_tpu_torch.search import topk as T
    dev = torch.device("cuda", 0)
    mm = P.load_mm(root)
    q, _ = P.make_queries(mm, 2048)
    qd = torch.from_numpy(q).to(dev)
    out = {}
    rows = 1 << 21
    chunk = chunked_device_put(mm[:rows], dev)
    for k in (1, 20):
        ms = time_ms(lambda: T.topk_ip(qd[:512], chunk, k))
        ops = 3 * 2.0 * 512 * rows * 128 / PEAK_TF32
        nbytes = (4.0 * (rows + 512) * 128 + 8.0 * 512 * k) / PEAK_BYTES
        out[f"B1_k{k}"] = dict(ms=ms, shape=f"Bq 512, N {rows}, k {k}",
                               bound_ms=1e3 * max(ops, nbytes),
                               bound_by="operations (3xTF32)"
                               if ops >= nbytes else "bytes")
    del chunk
    idx = P.stage_build(root, {}, index="sq8", device=dev)
    nrows = idx.vecs8.shape[0]
    ms = time_ms(lambda: T.topk_ip_sq8(qd[:1024], idx.vecs8, idx.scales,
                                       idx.rmask, 20))
    ops = 2.0 * 1024 * nrows * 128 / PEAK_BF16
    nbytes = (nrows * (128 + 8.0) + 4.0 * 1024 * 128) / PEAK_BYTES
    out["B2_k20"] = dict(ms=ms, shape=f"Bq 1024, N {nrows}, k 20",
                         bound_ms=1e3 * max(ops, nbytes),
                         bound_by="operations" if ops >= nbytes else "bytes")
    del idx
    idx = P.stage_build(root, {}, index="ivfpq", device=dev)
    lt = idx.LIST_TILE
    cs = min(idx.CHUNK_ROWS, idx.n_pad)
    sub = idx.sub_list[:cs // lt]
    dec = idx._decode_chunk(idx.codes[:cs], sub)
    bias = PI._pq_expand_bias(PI._pq_bias_list(qd[:512], idx.centroids,
                                               nprobe=idx.nprobe), sub)
    ids = idx.ids[:cs]
    ms = time_ms(lambda: T.topk_ip_masked(qd[:512], dec, ids, bias, 20, lt))
    # bytes: the decoded rows, ids and bias read once (the bound counts
    # no product of an unprobed or masked row)
    nbytes = (cs * (2.0 * 128 + 4) + 4.0 * bias.numel()) / PEAK_BYTES
    live = (bias > T.NEG / 2).repeat_interleave(lt, 1) & (ids >= 0)[None]
    ops = 2.0 * float(live.sum()) * 128 / PEAK_BF16
    out["B3_k20"] = dict(ms=ms, shape=f"Bq 512, N {cs} (one chunk), k 20, "
                         f"nprobe {idx.nprobe}",
                         bound_ms=1e3 * max(ops, nbytes),
                         bound_by="operations" if ops >= nbytes else "bytes")
    print(json.dumps(out), flush=True)
    return out


def link_recon(root: str, recon_dir=None) -> None:
    """Put evaluate's merged recon in ``recon_dir``, through a symlink in
    ``root``."""
    if recon_dir:
        os.makedirs(recon_dir, exist_ok=True)
        os.makedirs(root, exist_ok=True)
        link = os.path.join(root, "merged_recon.mm")
        if not os.path.lexists(link):
            os.symlink(os.path.join(recon_dir, "merged_recon.mm"), link)


def stage_sequence(root: str, songs: int, recon_dir=None) -> dict:
    """``recon_dir``: where evaluate's merged recon (27.5 GB at 100k
    songs) is written, through a symlink in ``root`` (a RAM disk, for a
    host whose disk cannot take the DB, the recon and the store)."""
    from nafp_tpu_torch.extras import run_100x_sequence as S
    link_recon(root, recon_dir)
    base = ["--root", root, "--n_dummy_songs", str(songs)]
    runs = []
    for extra in (["--index", "ivf-sq8", "--nprobe", "40"],
                  ["--index", "ivf-sq8", "--nprobe", "96", "--stages",
                   "eval"],
                  ["--index", "sq8", "--stages", "eval"]):
        t0 = time.perf_counter()
        res, launches = counted(S.main, base + extra)
        runs.append({"args": extra, "wall_s": round(time.perf_counter() - t0,
                                                    1),
                     "launches": launches, **res})
        print(json.dumps(runs[-1]), flush=True)
    return {"runs": runs}


def stage_seeds(root: str, songs: int, recon_dir=None) -> dict:
    """The sequence runner's ivf-sq8 at nprobe 40 with its k-means seeded
    by each of SEEDS (0 is the runner's own, and reuses its store)."""
    from nafp_tpu_torch.extras import run_100x_sequence as S
    link_recon(root, recon_dir)
    S.main(["--root", root, "--n_dummy_songs", str(songs), "--stages",
            "gen"])
    runs = []
    for seed in SEEDS:
        t0 = time.perf_counter()
        res, launches = counted(S.stage_eval, root, "ivf-sq8", 40, "icassp",
                                "cuda:0", seed)
        runs.append({"seed": seed, "wall_s": round(time.perf_counter() - t0,
                                                   1),
                     "launches": launches, **res})
        print(json.dumps(runs[-1]), flush=True)
    top1 = [r["rates"]["top1_exact"][0] for r in runs]
    return {"runs": runs, "top1_exact_at_1": top1,
            "range": [min(top1), max(top1)]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True,
                    help="working directory of the large files")
    ap.add_argument("--stages", default="host,protocol,suite,bench,"
                                        "train_step,hnsw,sequence")
    ap.add_argument("--out", default=os.path.join(PKG, "measurements"))
    ap.add_argument("--n", type=int, default=53_600_000)
    ap.add_argument("--songs", type=int, default=100_000)
    ap.add_argument("--hnsw_n", type=int, default=500_000)
    ap.add_argument("--clean", action="store_true")
    ap.add_argument("--recon_dir", default=None,
                    help="sequence stage: put the merged recon there "
                         "(e.g. /dev/shm/...) instead of under --root")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the full-scale runs measure the "
                           "card")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.root, exist_ok=True)
    stages = args.stages.split(",")

    def record(name, fn, sub=None):
        path = os.path.join(args.root, sub) if sub else args.root
        t0 = time.perf_counter()
        res = fn(path)
        res = {**context(args.root), "wall_s": round(time.perf_counter() - t0,
                                                     1), **res}
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(res, f, indent=1)
        print(f"[full-scale] wrote {name} ({res['wall_s']} s)", flush=True)
        if args.clean and sub:
            shutil.rmtree(path, ignore_errors=True)

    from nafp_tpu_torch import bench, bench_search
    from nafp_tpu_torch.extras import bench_hnsw, bench_train_step
    for stage in stages:
        if stage == "host":
            record("torch_host.json", lambda p: {})
        elif stage == "protocol":
            record("torch_100x_protocol.json",
                   lambda p: stage_protocol(p, args.n), "nafp_100x")
        elif stage == "sequence":
            record("torch_100x_sequence.json",
                   lambda p: stage_sequence(p, args.songs, args.recon_dir),
                   "nafp_seq100x")
        elif stage == "seeds":
            record("torch_100x_sequence_seeds.json",
                   lambda p: stage_seeds(p, args.songs, args.recon_dir),
                   "nafp_seq100x")
        elif stage == "suite":
            record("SEARCH_BENCH_torch.json", lambda p: bench_search.main(
                ["--suite", "--root", p, "--hnsw_n", str(args.hnsw_n),
                 "--out", os.path.join(p, "suite.json")]), "nafp_bench2m")
        elif stage == "bench":
            record("torch_bench.json", lambda p: {"runs": [
                bench.main(["--batch", str(b)]) for b in (1024, 512, 2048)]})
        elif stage == "train_step":
            record("torch_bench_train_step.json", lambda p: {"runs": [
                bench_train_step.main(["-c", "640_lamb", "--bsz", "640"]),
                bench_train_step.main(["-c", "tpu_5120", "--probe"])]})
        elif stage == "hnsw":
            record("torch_bench_hnsw.json", lambda p: {"rows": bench_hnsw.main(
                ["--root", p, "--threads", str(os.cpu_count() or 1)])},
                "nafp_hnsw")
        else:
            raise ValueError(f"unknown stage {stage!r}")


if __name__ == "__main__":
    main()
