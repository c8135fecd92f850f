"""Time kernel B3 (``topk_ip_masked``) over its scan grid's CTAs per SM.

The wrapper plans about ``MASKED_CTAS_PER_SM`` scan CTAs per SM (one wave
of the two that fit at d 128 up to k 80). This script times the kernel at
the ``-i ivfpq`` / ``-i ivfpq-rr`` protocol shape for other values of that
constant, on the card, with CUDA events::

    python -m nafp_tpu_torch.extras.sweep_b3_grid [--ctas 1,2,4] [--k 20,80]

The store is made on the card from ``--seed``: 619,500 unit bf16 rows in
256 lists of random sizes, each list padded to 128-row subtiles (padding
rows masked, id -1), the total to a multiple of 1024; 512 unit queries,
each probing 40 random lists. It prints one line per (k, CTAs per SM) and
then the results as a dict {k: {ctas: ms}}.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from nafp_tpu_torch.device import resolve_device
from nafp_tpu_torch.search import topk as T

N_ROWS, NLIST, LIST_TILE, NPROBE, BQ, D = 619_500, 256, 128, 40, 512, 128


def make_store(seed: int, device: torch.device):
    """(q, db, ids, bias) of the protocol shape (module docstring)."""
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(N_ROWS, rng.dirichlet(np.full(NLIST, 2.0)))
    padded = np.maximum(-(-counts // LIST_TILE), 1) * LIST_TILE
    n_pad = int(padded.sum()) + (-int(padded.sum())) % 1024
    ids = np.full(n_pad, -1, np.int32)
    sub_list = np.full(n_pad // LIST_TILE, -1, np.int64)
    start, first_id = 0, np.cumsum(counts) - counts
    for li in range(NLIST):
        ids[start:start + counts[li]] = first_id[li] + np.arange(counts[li])
        sub_list[start // LIST_TILE:(start + padded[li]) // LIST_TILE] = li
        start += padded[li]
    probed = np.zeros((BQ, NLIST + 1), bool)         # column NLIST: filler
    for r in range(BQ):
        probed[r, rng.choice(NLIST, NPROBE, replace=False)] = True
    bias = np.where(probed[:, sub_list], 0.0, T.NEG).astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit(n):
        x = torch.randn(n, D, generator=gen, device=device)
        return x / x.norm(dim=1, keepdim=True)
    return (unit(BQ), unit(n_pad).to(torch.bfloat16),
            torch.from_numpy(ids).to(device),
            torch.from_numpy(bias).to(device).contiguous())


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup``, CUDA events."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main(argv: Optional[Sequence[str]] = None
         ) -> Dict[int, Dict[int, float]]:
    ap = argparse.ArgumentParser(
        prog="python -m nafp_tpu_torch.extras.sweep_b3_grid",
        description="Time kernel B3 over its grid's CTAs per SM.")
    ap.add_argument("--ctas", default="1,2,4")
    ap.add_argument("--k", default="20,80")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device()
    q, db, ids, bias = make_store(args.seed, dev)
    print(f"[B3 grid sweep] Bq {BQ}, N {db.shape[0]} bf16 x {D}, {NPROBE} of "
          f"{NLIST} lists probed, on {torch.cuda.get_device_name(dev)}",
          flush=True)
    keep = T.MASKED_CTAS_PER_SM
    res: Dict[int, Dict[int, float]] = {}
    try:
        for k in (int(x) for x in args.k.split(",")):
            res[k] = {}
            for c in (int(x) for x in args.ctas.split(",")):
                T.MASKED_CTAS_PER_SM = c
                grid = T._grid(BQ, db.shape[0], dev, c)[1] * -(-BQ // T.QB)
                res[k][c] = time_ms(lambda: T.topk_ip_masked(
                    q, db, ids, bias, k, LIST_TILE))
                print(f"k {k:3d}  CTAs per SM {c}  ({grid} scan CTAs): "
                      f"{res[k][c]:.3f} ms", flush=True)
    finally:
        T.MASKED_CTAS_PER_SM = keep
    print(res)
    return res


if __name__ == "__main__":
    main()
