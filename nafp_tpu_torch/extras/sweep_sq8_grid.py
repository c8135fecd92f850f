"""Time kernel B2 (``topk_ip_sq8``) over its scan's CTAs per SM.

The sq8 scan (``csrc/sq8_scan.cuh``, B2's and B4a's) takes 64 queries per
CTA, and its wrapper plans one wave of the CTAs an SM holds. This script
times B2 at the ``-i sq8`` protocol shape for each CTAs per SM, on the
card, with CUDA events::

    python -m nafp_tpu_torch.extras.sweep_sq8_grid [--ctas 0,1,2,4] \\
        [--k 20,80]

CTAs per SM 0 is the wrapper's own plan (as many as one SM holds); more
than an SM holds runs in several waves. The store is made on the card from
``--seed``: 620,544 int8 rows (unit rows quantised per row, as the sq8
index stores them), 1 % tombstones and the pad rows past 619,500 masked;
1024 unit queries. It prints each k's shared memory, CTAs per SM and
registers, one line per (k, CTAs per SM), then the results as a dict
{k: {ctas: ms}}.
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import torch

from nafp_tpu_torch import kernels
from nafp_tpu_torch.device import resolve_device
from nafp_tpu_torch.extras.sweep_b3_grid import time_ms
from nafp_tpu_torch.search import topk as T

N_ROWS, N_VALID, BQ, D = 620_544, 619_500, 1024, 128


def make_store(seed: int, device: torch.device):
    """(q, vecs8, scales, rmask) of the protocol shape (module
    docstring)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def unit(n):
        x = torch.randn(n, D, generator=gen, device=device)
        return x / x.norm(dim=1, keepdim=True)
    x = unit(N_ROWS)
    scales = x.abs().amax(dim=1) / 127.0
    vecs8 = torch.round(x / scales[:, None]).clamp(-127, 127).to(torch.int8)
    dead = torch.rand(N_ROWS, generator=gen, device=device) < 0.01
    dead[N_VALID:] = True
    rmask = torch.where(dead, T.NEG, 0.0).to(torch.float32).contiguous()
    scales = torch.where(dead, 0.0, scales).contiguous()
    return unit(BQ), vecs8.contiguous(), scales, rmask


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, Dict[int, float]]:
    ap = argparse.ArgumentParser(
        prog="python -m nafp_tpu_torch.extras.sweep_sq8_grid",
        description="Time kernel B2 over its CTAs per SM.")
    ap.add_argument("--ctas", default="0,1,2,4")
    ap.add_argument("--k", default="20,80")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device()
    q, vecs8, scales, rmask = make_store(args.seed, dev)
    sms = T._sm_count(dev)
    print(f"[B2 grid sweep] Bq {BQ}, N {N_ROWS} int8 x {D} (1% tombstones), "
          f"on {torch.cuda.get_device_name(dev)}, {sms} SMs", flush=True)
    fn, counts = T._lib_fn("topk_sq8"), {"sweep": 0}
    res: Dict[int, Dict[int, float]] = {}
    for k in (int(x) for x in args.k.split(",")):
        smem, per_sm, regs = kernels.occupancy("topk_sq8", D, k)
        print(f"k {k:3d}: {smem} B shared memory, {per_sm} CTAs per SM, "
              f"{regs} registers", flush=True)
        res[k] = {}
        for c in (int(x) for x in args.ctas.split(",")):
            grid = T._plan_chunks(BQ, N_ROWS, sms, c or per_sm)[1] * -(
                -BQ // T.QB)
            res[k][c] = time_ms(lambda: T.launch_sq8(
                fn, "topk_sq8", counts, "sweep", q, vecs8, scales, rmask, k,
                ctas_per_sm=c or None))
            print(f"k {k:3d}  CTAs per SM {c or f'{per_sm} (plan)'}  "
                  f"({grid} CTAs, {grid / (per_sm * sms):.2f} waves): "
                  f"{res[k][c]:.3f} ms", flush=True)
    print(res)
    return res


if __name__ == "__main__":
    main()
