#!/usr/bin/env python
"""Train-step microbench at any batch size, on one card.

Counterpart of ``extras/bench_train_step.py``. Times the port's real
``TrainStep`` (the trainer's loss, augmentation, optimizer and schedule)
on one device-resident synthetic batch (the JAX script's draws:
``default_rng(0)`` anchors, replicas, bg x 0.1, IR x 0.1), so no upload
sits in the timed window, and reports step ms, segments/s, whether the
loss is finite, and device memory from ``device_memory_stats`` (in use
after the steps, the peak of the run, the card's total).

``--probe`` halves the batch after a ``torch.cuda.OutOfMemoryError``
until the step fits, and reports the largest working size; any other
error propagates.

Usage:
    python -m nafp_tpu_torch.extras.bench_train_step -c tpu_5120 \\
        [--steps 20] [--probe]
    python -m nafp_tpu_torch.extras.bench_train_step -c 640_lamb --bsz 640
    (--cpu: on the CPU; its times are CPU times)
"""
from __future__ import annotations

import argparse
import gc
import json
import time

import numpy as np
import torch

GIB = 2 ** 30


def measure(cfg, bsz: int, steps: int, device=None) -> dict:
    from nafp_tpu_torch.configuration import update_config
    from nafp_tpu_torch.data.loader import MAX_IR_LENGTH
    from nafp_tpu_torch.device import device_memory_stats, resolve_device
    from nafp_tpu_torch.optim.schedules import build_optimizer
    from nafp_tpu_torch.train import trainer as T

    dev = resolve_device(device)
    cfg = {k: (dict(v) if isinstance(v, dict) else v) for k, v in cfg.items()}
    update_config(cfg, "BSZ", "TR_BATCH_SZ", bsz)
    update_config(cfg, "BSZ", "TR_N_ANCHOR", bsz // 2)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    melspec_fn, specaug_fn, model, _ = T.build_fp(cfg)
    model.to(dev)
    optimizer, schedule = build_optimizer(cfg, model, 100 * 184)
    loss_fn = T._make_loss_fn(cfg, melspec_fn, specaug_fn, model, train=True,
                              aug_keys=frozenset(("bg", "ir")))
    step_fn = T.TrainStep(cfg, model, optimizer, schedule, loss_fn, dev)

    n_anchor = bsz // 2
    seg = int(int(cfg["MODEL"]["FS"]) * float(cfg["MODEL"]["DUR"]))
    rng = np.random.default_rng(0)
    host = {
        "anchors": rng.standard_normal((n_anchor, seg)).astype(np.float32),
        "replicas": rng.standard_normal((n_anchor, seg)).astype(np.float32),
        "bg": rng.standard_normal((n_anchor, seg)).astype(np.float32) * .1,
        "ir": rng.standard_normal((n_anchor, MAX_IR_LENGTH)).astype(
            np.float32) * .1,
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    loss, _ = step_fn(batch)                       # warm-up
    float(loss)                                    # host sync
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, _ = step_fn(batch)
    f = float(loss)                                # one sync for the chain
    dt = (time.perf_counter() - t0) / steps
    mem = device_memory_stats(dev)[dev.index or 0]

    def gib(key):
        return round(mem[key] / GIB, 2) if mem.get(key) else None
    return {
        "bsz": bsz,
        "step_ms": round(1000 * dt, 2),
        "segments_per_sec": round(bsz / dt, 1),
        "loss_finite": bool(np.isfinite(f)),
        "hbm_in_use_gib": gib("bytes_in_use"),
        "hbm_peak_gib": gib("peak_bytes_in_use"),
        "hbm_limit_gib": gib("bytes_limit"),
        "backend": mem["kind"],
    }


def main(argv=None) -> dict:
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("-c", "--config", default="tpu_5120")
    ap.add_argument("--bsz", type=int, default=None,
                    help="override BSZ.TR_BATCH_SZ (default: the preset's)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--probe", action="store_true",
                    help="halve the batch after an out-of-memory error until "
                         "the step fits; report the largest working size")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    cfg = load_config(args.config)
    bsz = args.bsz or int(cfg["BSZ"]["TR_BATCH_SZ"])
    while True:
        try:
            row = measure(cfg, bsz, args.steps, dev)
        except torch.cuda.OutOfMemoryError as e:
            if not args.probe or bsz <= 16:
                raise
            print(json.dumps({"bsz": bsz, "error": str(e).splitlines()[0]
                              [:200]}), flush=True)
        else:
            print(json.dumps(row), flush=True)
            return row
        # the failed attempt's tensors are unreachable once the handler
        # has left: return their memory before the next size
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        bsz //= 2


if __name__ == "__main__":
    main()
