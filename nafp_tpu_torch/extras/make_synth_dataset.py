#!/usr/bin/env python
"""Synthesize a self-contained nafp dataset for end-to-end drives.

The port's own copy of the JAX package's synthetic-corpus writer (numpy
and ``wave`` only): the same songs, the same files, byte for byte.
Builds the exact directory layout the catalog expects (reference
``model/dataset.py:129-308`` / ``nafp_tpu_torch/data/catalog.py``) out of
harmonic-mixture "songs" written as 8 kHz 16-bit mono PCM WAV:

    ROOT/music/train-10k-30s/**.wav
    ROOT/music/val-query-db-500-30s/**.wav
    ROOT/music/test-dummy-db-100k-full/**.wav
    ROOT/music/test-query-db-500-30s/{db,query}/**.wav   (query = noisy db)
    ROOT/aug/bg/{tr,ts}/**.wav  ROOT/aug/ir/{tr,ts}/**.wav
    ROOT/aug/speech/{train,test,dev}/**.wav   (common-voice split names)

Queries are degraded copies (additive noise + small gain) of the db songs,
so a trained fingerprinter must retrieve them — the same construction as
the reference's pre-synthesized test-query set (``extras/dataset2wav.py``
there), just cheap and deterministic.

Usage:
    python -m nafp_tpu_torch.extras.make_synth_dataset ROOT [--n_train 60]
        [--n_query 100] [--n_dummy 100] [--sec 10]
    (or run this file by its path, as chip_smoke.py and run_convergence do)
"""
from __future__ import annotations

import argparse
import os
import wave

import numpy as np

FS = 8000


def write_wav(path: str, x: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pcm = (np.clip(x, -1.0, 1.0) * 32767).astype(np.int16)
    with wave.open(path, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(FS)
        w.writeframes(pcm.tobytes())


def song(seed: int, sec: float) -> np.ndarray:
    """Harmonic mixture with slow AM so segments are distinguishable."""
    r = np.random.default_rng(seed)
    t = np.arange(int(FS * sec)) / FS
    x = np.zeros_like(t)
    for _ in range(4):
        f0 = r.uniform(80, 3600)
        am = 1.0 + 0.5 * np.sin(2 * np.pi * r.uniform(0.1, 1.5) * t
                                + r.uniform(0, 6))
        x += r.uniform(0.2, 0.5) * am * np.sin(2 * np.pi * f0 * t
                                               + r.uniform(0, 6))
    return 0.8 * x / np.abs(x).max()


def speech_like(seed: int, sec: float) -> np.ndarray:
    """Filtered-noise bursts with pauses — a crude speech stand-in."""
    r = np.random.default_rng(seed)
    n = int(FS * sec)
    x = np.zeros(n)
    i = 0
    while i < n:
        burst = int(r.uniform(0.1, 0.4) * FS)
        gap = int(r.uniform(0.05, 0.3) * FS)
        seg = r.standard_normal(burst)
        # crude low-pass: cumulative mean over a short window
        k = int(r.uniform(4, 16))
        seg = np.convolve(seg, np.ones(k) / k, mode="same")
        x[i:i + burst] = seg[: max(0, min(burst, n - i))]
        i += burst + gap
    m = np.abs(x).max()
    return 0.7 * x / m if m > 0 else x


def build(root: str, n_train: int, n_query: int, n_dummy: int,
          sec: float) -> None:
    rng = np.random.default_rng(1234)
    for i in range(n_train):
        write_wav(f"{root}/music/train-10k-30s/{i:04d}.wav", song(i, sec))
    for i in range(max(8, n_train // 4)):
        write_wav(f"{root}/music/val-query-db-500-30s/{i:04d}.wav",
                  song(10_000 + i, sec))
    for i in range(n_query):
        db = song(20_000 + i, sec)
        write_wav(f"{root}/music/test-query-db-500-30s/db/{i:04d}.wav", db)
        noisy = (db * rng.uniform(0.7, 1.0)
                 + 0.05 * rng.standard_normal(len(db)))
        write_wav(f"{root}/music/test-query-db-500-30s/query/{i:04d}.wav",
                  noisy)
    for i in range(n_dummy):
        write_wav(f"{root}/music/test-dummy-db-100k-full/{i:04d}.wav",
                  song(30_000 + i, sec))
    # Speech uses the common-voice split names the catalog globs
    # (train/test/dev, the catalog's speech globs); bg/ir use tr/ts.
    for split, sp_split in (("tr", "train"), ("ts", "test")):
        base = 40_000 if split == "tr" else 50_000
        for i in range(6):
            write_wav(f"{root}/aug/bg/{split}/{i:02d}.wav",
                      song(base + i, sec) * 0.5)
            write_wav(f"{root}/aug/speech/{sp_split}/{i:02d}.wav",
                      speech_like(base + 100 + i, sec))
            ir = (np.exp(-np.arange(800) / 100.0)
                  * np.random.default_rng(base + 200 + i).standard_normal(800))
            write_wav(f"{root}/aug/ir/{split}/{i:02d}.wav", 0.3 * ir)
    for i in range(4):  # dev/ split backs VAL_SPEECH_AUG
        write_wav(f"{root}/aug/speech/dev/{i:02d}.wav",
                  speech_like(60_000 + i, sec))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root")
    p.add_argument("--n_train", type=int, default=60)
    p.add_argument("--n_query", type=int, default=100)
    p.add_argument("--n_dummy", type=int, default=100)
    p.add_argument("--sec", type=float, default=10.0)
    a = p.parse_args()
    build(a.root, a.n_train, a.n_query, a.n_dummy, a.sec)
    print(f"dataset written under {a.root}")


if __name__ == "__main__":
    main()
