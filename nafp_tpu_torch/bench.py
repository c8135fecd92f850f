#!/usr/bin/env python
"""Headline benchmark of the port: fingerprinting throughput on one card.

Counterpart of ``bench.py``. Times the device pipeline, waveform ->
log-mel -> FingerPrinter -> 128-d fingerprint, at full width (the
``default`` preset, random weights from seed 0) on a device-resident
batch: the timed window holds ``--iters`` calls and one host sync at its
end. Prints one JSON line with ``bench.py``'s keys
    {"metric", "value", "unit", "vs_baseline"}
plus ``gflop_per_call`` and, on a card, ``tflops`` and ``mfu``: the
FLOPs of one call, counted from the port's own model (2 per multiply-add
of the log-mel's two matmuls, every convolution and DivEnc's two einsums,
at the run's shapes), over the timed window, and that rate over the
card's dense bf16 peak. A card missing from ``PEAK_BF16_TFLOPS`` gets no
``mfu``.

Usage:
    python -m nafp_tpu_torch.bench [--batch 1024] [--iters 20]
        [-c default] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import time

import torch

BASELINE_SEGS_PER_SEC = 10_000.0  # BASELINE.md north-star
BATCH = 1024
ITERS = 20
# Dense bf16 tensor-core peak (TFLOP/s, no sparsity) by
# torch.cuda.get_device_name, from NVIDIA's data sheets.
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,     # SXM
    "NVIDIA H100 PCIe": 756.0,
}


def flops_per_call(model, mcfg, batch: int) -> float:
    """FLOPs of one log-mel + encoder call on ``batch`` segments, 2 per
    multiply-add: the framed DFT (frames x n_fft x 2K) and the mel
    filterbank (frames x K x n_mels) per segment; per convolution, output
    positions x input channels x kernel cells; DivEnc's two einsums."""
    n_freq = mcfg.n_fft // 2 + 1
    macs = mcfg.n_frames * (mcfg.n_fft * 2 * n_freq + n_freq * mcfg.n_mels)
    for layer in model.conv_layers:
        for conv in (layer.conv_1x3, layer.conv_3x1):
            c_out, c_in, kh, kw = conv.weight.shape
            oh, ow = conv.out_hw
            macs += c_out * oh * ow * c_in * kh * kw
    q, s, u0 = model.div_enc.w1.shape
    u1 = model.div_enc.w2.shape[2]
    macs += q * s * u0 + q * u0 * u1
    return 2.0 * batch * macs


def main(argv=None) -> dict:
    from nafp_tpu_torch.configuration import load_config
    from nafp_tpu_torch.device import resolve_device
    from nafp_tpu_torch.models.nnfp import get_fingerprinter
    from nafp_tpu_torch.ops.melspec import get_melspec_fn

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("-c", "--config", default="default",
                    help="preset name or YAML path (MODEL.FRONT_HIDDEN_CH "
                         "sets the channel plan)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (its times are CPU times)")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else None)

    cfg = load_config(args.config)
    melspec_fn, mcfg = get_melspec_fn(cfg)
    model = get_fingerprinter(cfg, seed=0).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.batch, mcfg.n_samples), generator=gen, device=dev)

    def fingerprint():
        return model(melspec_fn(x))

    with torch.inference_mode():
        for _ in range(2):                     # warm-up, full host syncs
            fingerprint().cpu()
        t0 = time.perf_counter()
        out = None
        for _ in range(args.iters):
            out = fingerprint()
        out.cpu()                              # the one sync, at the end
        dt = time.perf_counter() - t0

    segs_per_sec = args.batch * args.iters / dt
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    line = {
        "metric": "fingerprint_throughput",
        "value": round(segs_per_sec, 1),
        "unit": "segments/sec/chip",
        "vs_baseline": round(segs_per_sec / BASELINE_SEGS_PER_SEC, 3),
        "batch": args.batch,
        "device": kind,
    }
    flops = flops_per_call(model, mcfg, args.batch)
    line["gflop_per_call"] = round(flops / 1e9, 3)
    if dev.type == "cuda":                     # a device rate only
        achieved_tflops = flops * args.iters / dt / 1e12
        line["tflops"] = round(achieved_tflops, 1)
        peak = PEAK_BF16_TFLOPS.get(kind)
        if peak:
            line["mfu"] = round(achieved_tflops / peak, 4)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
