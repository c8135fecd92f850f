#!/usr/bin/env python
"""Offline synthesis of fixed augmented query WAVs.

Counterpart of ``extras/dataset2wav.py`` (reference
``extras/dataset2wav.py:47-121``, the tool that produced the shipped
``test-query-db-500-30s`` queries). It runs the validation (or test-db)
songs' segments through the replica pipeline with *deterministic*, evenly
spread offsets (the loader's ``experimental_mode``) and the time-domain
augmentation chain (background mix, then IR), on ``cuda:0`` unless
``--cpu``, and writes each augmented segment as a 16-bit PCM WAV
``OUT_DIR/NNNNNN.wav``: the JAX script's files and names. Batch ``i``
draws its SNRs and amplitudes from a generator seeded by ``seed + i``
(the JAX script's key; the same law, not the same draws).

Usage:
    python -m nafp_tpu_torch.extras.dataset2wav OUT_DIR [-c CONFIG]
        [--split val|test] [--n_pos 1] [--seed 42] [--cpu]
"""
from __future__ import annotations

import os
import wave
from typing import Callable, Dict, Optional

import click
import numpy as np
import torch


def synthesize(cfg: dict, out_dir: str, split: str = "val", n_pos: int = 1,
               seed: int = 42, device=None,
               draws: Optional[Callable[[int, int], Dict]] = None) -> int:
    """Write the augmented segments of ``split`` to ``out_dir``; returns
    how many. ``draws(batch_index, n_rows)`` replaces the generator's
    background-mix draws with ``{"snr": (n, 1), "amp": (n, 1)}``."""
    from nafp_tpu_torch.data.catalog import Dataset, _glob_wavs
    from nafp_tpu_torch.data.loader import SegmentLoader, prefetch
    from nafp_tpu_torch.device import resolve_device
    from nafp_tpu_torch.ops.tdaug import augment_replicas

    dev = resolve_device(device)
    ds = Dataset(cfg)
    if split == "val":
        fps = _glob_wavs(ds.source_root_dir, "val-query-db-500-30s/**/*.wav")
        bg, ir, snr = ds.val_bg_fps, ds.val_ir_fps, tuple(ds.val_snr)
    else:
        fps = _glob_wavs(ds.source_root_dir,
                         "test-query-db-500-30s/db/**/*.wav")
        bg, ir, snr = ds.ts_bg_fps, ds.ts_ir_fps, tuple(ds.ts_snr)
    loader = SegmentLoader(
        fps, bsz=ds.ts_batch_sz * (1 + n_pos), n_anchor=ds.ts_batch_sz,
        duration=ds.dur, hop=ds.hop, fs=ds.fs, shuffle=False,
        random_offset_anchor=False, bg_fps=bg, ir_fps=ir,
        experimental_mode=True, reduce_batch_first_half=True,
        drop_the_last_non_full_batch=False, seed=seed)

    def to_dev(batch, key):
        return (torch.from_numpy(np.asarray(batch[key], np.float32)).to(dev)
                if key in batch else None)

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    gen = torch.Generator(device=dev)
    for bi, batch in enumerate(prefetch(loader)):
        xp = to_dev(batch, "replicas")
        gen.manual_seed(seed + bi)
        xq = augment_replicas(xp, to_dev(batch, "bg"), to_dev(batch, "ir"),
                              gen, snr, use_bg=bool(bg), use_ir=bool(ir),
                              **(draws(bi, len(xp)) if draws else {}))
        xq = xq.cpu().numpy()
        n_valid = int(batch["n_valid"]) * max(1, loader.n_pos_per_anchor)
        for i in range(n_valid):
            pcm = (np.clip(xq[i], -1, 1) * 32767).astype(np.int16)
            with wave.open(os.path.join(out_dir, f"{n:06d}.wav"), "w") as w:
                w.setnchannels(1)
                w.setsampwidth(2)
                w.setframerate(ds.fs)
                w.writeframes(pcm.tobytes())
            n += 1
    return n


@click.command()
@click.argument("out_dir", required=True)
@click.option("--config", "-c", default="default")
@click.option("--split", default="val", type=click.Choice(["val", "test"]))
@click.option("--n_pos", default=1, type=click.INT,
              help="Augmented versions per segment.")
@click.option("--seed", default=42, type=click.INT)
@click.option("--cpu", is_flag=True, default=False,
              help="Run on the CPU instead of cuda:0.")
def main(out_dir, config, split, n_pos, seed, cpu):
    from nafp_tpu_torch.configuration import load_config
    n = synthesize(load_config(config), out_dir, split, n_pos, seed,
                   device="cpu" if cpu else None)
    print(f"wrote {n} augmented query WAVs to {out_dir}")


if __name__ == "__main__":
    main()
