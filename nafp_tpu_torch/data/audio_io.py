"""Host-side audio + fingerprint-store IO.

WAV decode mirrors the reference's stdlib-``wave`` path
(``model/utils/audio_utils.py:221-264``): 16-bit PCM at the configured rate,
scaled by 2^-15, zero-padded to the segment length. Fingerprints use the
same on-disk contract as the reference (``model/generate.py:154-161``,
``eval/eval_faiss.py:18-62``): float32 ``{key}.mm`` memmap + sidecar
``{key}_shape.npy``.
"""
from __future__ import annotations

import os
import wave
from typing import Optional, Tuple

import numpy as np


def wav_info(path: str) -> Tuple[int, int]:
    """Return (n_frames, sample_rate) from the WAV header."""
    with wave.open(path, "r") as w:
        return w.getnframes(), w.getframerate()


def load_wav_segment(path: str,
                     start_frame: int,
                     n_frames: int,
                     expected_fs: Optional[int] = None) -> np.ndarray:
    """Load ``n_frames`` samples starting at ``start_frame`` as float32.

    Short reads (segment running past EOF) are zero-padded at the tail,
    matching ``load_audio`` (audio_utils.py:241-264).
    """
    with wave.open(path, "r") as w:
        if expected_fs is not None and w.getframerate() != expected_fs:
            raise ValueError(f"{path}: sample rate {w.getframerate()} != "
                             f"expected {expected_fs}")
        if w.getsampwidth() != 2:
            raise NotImplementedError(f"{path}: only 16-bit PCM supported")
        start = max(0, min(start_frame, w.getnframes()))
        w.setpos(start)
        raw = w.readframes(min(n_frames, w.getnframes() - start))
    x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 2 ** 15
    out = np.zeros(n_frames, np.float32)
    out[:len(x)] = x
    return out


# ---------------------------------------------------------------------------
# Fingerprint memmap store ({key}.mm + {key}_shape.npy)
# ---------------------------------------------------------------------------
def create_memmap(out_dir: str, key: str, shape: Tuple[int, int]) -> np.memmap:
    os.makedirs(out_dir, exist_ok=True)
    arr = np.memmap(os.path.join(out_dir, f"{key}.mm"), dtype="float32",
                    mode="w+", shape=shape)
    np.save(os.path.join(out_dir, f"{key}_shape.npy"), np.asarray(shape))
    return arr


def load_memmap(source_dir: str, key: str, shape_only: bool = False,
                display: bool = True):
    """Load ``{key}.mm`` read-only (reference load_memmap_data,
    eval_faiss.py:18-62 — minus the append/mutate-in-place mode, which our
    eval pipeline does not need)."""
    shape = tuple(np.load(os.path.join(source_dir, f"{key}_shape.npy")))
    if shape_only:
        return shape
    data = np.memmap(os.path.join(source_dir, f"{key}.mm"), dtype="float32",
                     mode="r", shape=shape)
    if display:
        print(f"Loaded {shape[0]:,} items from {source_dir}/{key}.mm")
    return data, shape
