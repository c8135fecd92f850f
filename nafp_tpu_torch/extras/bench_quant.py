#!/usr/bin/env python
"""Inference with the activations stored at one byte (``MODEL.ACT_STORE``)
against the bf16 baseline.

Counterpart of ``extras/bench_quant.py``. The encoder moves its
inter-layer activations through device memory at two bytes an element in
bf16; ``ACT_STORE`` stores them at one (int8 with the fixed scale 16, or
float8_e4m3fn) and widens them before the next convolution, which can
halve that traffic only if the conversions cost less than the bytes they
save. So it is measured: log-mel + encoder at full width (the ``default``
preset, random weights from seed 42, the JAX package's init key) on one
device-resident batch of random waveforms (seed 0), ``--iters`` calls
timed with CUDA events after two warm-up calls.

Prints one JSON line per mode (bf16, int8, fp8) with the JAX script's
keys: ``act_store``, ``segs_per_sec``, ``ms_per_batch`` and, for int8
and fp8, ``cos_vs_bf16_min`` / ``cos_vs_bf16_mean`` (the cosine of each
quantised fingerprint with its bf16 one: the accuracy gate for using
ACT_STORE in ``generate``), plus the ``device``. ``main`` returns the
lines.

Usage:
    python -m nafp_tpu_torch.extras.bench_quant [--batch 1024]
        [--iters 20] [-c default] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

BATCH = 1024
ITERS = 20
MODES = (None, "int8", "fp8")
INIT_SEED = 42


def main(argv=None) -> list:
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.device import resolve_device
    from nafp_tpu_torch.models.nnfp import get_fingerprinter
    from nafp_tpu_torch.ops.melspec import get_melspec_fn

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("-c", "--config", default="default",
                    help="preset name or YAML path")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (its times are CPU times)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)
    cuda = dev.type == "cuda"

    cfg = load_config(args.config)
    melspec_fn, mcfg = get_melspec_fn(cfg)
    state = get_fingerprinter(cfg, seed=INIT_SEED).state_dict()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.batch, mcfg.n_samples), generator=gen, device=dev)

    lines, ref = [], None
    for mode in MODES:
        cfg["MODEL"]["ACT_STORE"] = mode
        model = get_fingerprinter(cfg)
        model.load_state_dict(state)
        model.to(dev).eval()
        with torch.inference_mode():
            emb = model(melspec_fn(x)).float()         # warm-up
            model(melspec_fn(x))
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.iters):
                    model(melspec_fn(x))
                end.record()
                torch.cuda.synchronize(dev)
                ms = start.elapsed_time(end) / args.iters
            else:
                t0 = time.perf_counter()
                for _ in range(args.iters):
                    model(melspec_fn(x))
                ms = (time.perf_counter() - t0) * 1e3 / args.iters
        line = {"act_store": mode or "bf16",
                "segs_per_sec": round(args.batch / ms * 1e3, 1),
                "ms_per_batch": round(ms, 3),
                "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
        if ref is None:
            ref = emb
        else:
            cos = (ref * emb).sum(1)
            line["cos_vs_bf16_min"] = round(float(cos.min()), 4)
            line["cos_vs_bf16_mean"] = round(float(cos.mean()), 4)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
