"""Traffic audio made from a seed, on the device.

``songs`` is the benchmark's frozen copy of the synthetic song law of the
port's ``extras/make_synth_dataset.song``: four partials, each a sine of
frequency U(80, 3600) Hz and amplitude U(0.2, 0.5) under a slow amplitude
modulation 1 + 0.5·sin(2π·U(0.1, 1.5)·t + U(0, 6)), the sum scaled to a
peak of 0.8. The draws come from a ``torch.Generator`` on the device
instead of numpy's, and the phases are taken in float64.

``bg_mix`` is the frozen copy of the port's ``ops/tdaug.bg_mix_batch``
law: signal and noise RMS-normalised, mixed as 10^(snr/20)·x + noise,
max-normalised and scaled by the amplitude; a row whose signal or noise is
silent is the plain sum.
"""
from __future__ import annotations

import math
import os
import wave
from typing import Sequence

import numpy as np
import torch

PARTIALS = 4


def songs(gen: torch.Generator, n: int, sec: float, fs: int,
          device) -> torch.Tensor:
    """(n, sec·fs) float32 songs."""
    t = torch.arange(int(fs * sec), device=device, dtype=torch.float64) / fs
    u = torch.rand((n, PARTIALS, 5), generator=gen, device=device,
                   dtype=torch.float64)
    f0 = 80 + u[..., 0] * (3600 - 80)
    fam = 0.1 + u[..., 1] * 1.4
    ph_am, ph = u[..., 2] * 6, u[..., 3] * 6
    amp = 0.2 + u[..., 4] * 0.3
    x = torch.zeros((n, t.numel()), device=device, dtype=torch.float64)
    for p in range(PARTIALS):
        am = 1.0 + 0.5 * torch.sin(2 * math.pi * torch.frac(
            fam[:, p, None] * t) + ph_am[:, p, None])
        x += amp[:, p, None] * am * torch.sin(2 * math.pi * torch.frac(
            f0[:, p, None] * t) + ph[:, p, None])
    x = 0.8 * x / x.abs().amax(dim=1, keepdim=True)
    return x.float()


def _max_normalize(x: torch.Tensor) -> torch.Tensor:
    m = x.abs().amax(dim=-1, keepdim=True)
    return torch.where(m > 0, x / torch.where(m > 0, m, 1.0), x)


def bg_mix(x: torch.Tensor, noise: torch.Tensor, snr_db: torch.Tensor,
           amp: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` mixed with rows of ``noise`` at ``snr_db`` (n, 1),
    scaled by ``amp`` (n, 1)."""
    t = x.shape[-1]
    rms_x = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) / t)
    rms_n = torch.sqrt(torch.sum(noise * noise, dim=-1, keepdim=True) / t)
    xn = x / torch.where(rms_x > 0, rms_x, 1.0)
    nn_ = noise / torch.where(rms_n > 0, rms_n, 1.0)
    mixed = 10.0 ** (snr_db / 20.0) * xn + nn_
    silent = ((x.abs().amax(dim=-1, keepdim=True) == 0)
              | (noise.abs().amax(dim=-1, keepdim=True) == 0))
    mixed = torch.where(silent, x + noise, mixed)
    return amp * _max_normalize(mixed)


def draw_snr_amp(gen: torch.Generator, n: int, snr: Sequence[float],
                 amp: Sequence[float], device):
    """(snr dB, amplitude), each (n, 1): U[snr] and 10^U[log10 amp]."""
    u = torch.rand((2, n, 1), generator=gen, device=device)
    lo, hi = min(snr), max(snr)
    a0, a1 = math.log10(amp[0]), math.log10(amp[1])
    return lo + u[0] * (hi - lo), 10.0 ** (a0 + u[1] * (a1 - a0))


def segments(x: torch.Tensor, seg: int, hop: int) -> torch.Tensor:
    """(n, L) songs -> (n · n_seg, seg) segments at ``hop``, song-major:
    the catalogue order of the port's segment lists (no segment past the
    end of a song when (L - seg) is a multiple of hop)."""
    return x.unfold(1, seg, hop).reshape(-1, seg)


def pcm16(x: torch.Tensor) -> np.ndarray:
    """Songs as the int16 samples a 16-bit WAV of them holds."""
    return (x.clamp(-1.0, 1.0) * 32767).to(torch.int16).cpu().numpy()


def write_wavs(folder: str, pcm: np.ndarray, fs: int) -> None:
    """One 16-bit mono WAV per row, named in catalogue order."""
    os.makedirs(folder, exist_ok=True)
    for i, row in enumerate(pcm):
        with wave.open(os.path.join(folder, f"{i:05d}.wav"), "w") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(fs)
            w.writeframes(row.tobytes())


def read_wav(path: str) -> np.ndarray:
    """A 16-bit mono WAV's samples as float32 in [-1, 1)."""
    with wave.open(path, "r") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
