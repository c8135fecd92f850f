"""Log-power mel-spectrogram frontend in PyTorch.

Counterpart of ``nafp_tpu/ops/melspec.py`` (the reference's kapre
frontend, ``model/fp/melspec/melspectrogram.py:10-141``):

- zero padding of ``n_fft//2`` per side (no reflection), so 1 s @ 8 kHz /
  hop 256 yields exactly 32 frames;
- framing, then the Hann-windowed real DFT as one f32 matmul against a
  precomputed ``(n_fft, 2*(n_fft//2+1))`` basis, magnitude
  ``sqrt(re² + im² + 1e-30)``;
- Slaney mel filterbank → ``+0.06`` offset (``+0.1`` for ``variant='lite'``)
  → log10 → subtract the max over the WHOLE batch → clip at −80 dB;
  ``melspec_maxnorm`` then rescales by half the batch minimum;
- output layout ``(B, F, T, 1)``, as in the JAX package.

The max is taken over the whole batch, so a segment's features depend on
the batch it rides in: generation feeds the same static zero-padded batches
as the JAX package to reproduce its memmaps.

The numpy constants (DFT basis, mel filterbank) are the JAX package's,
value for value. Both matmuls run in full f32: TF32 is switched off on the
card (``device.set_f32_precision``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Mel filterbank (librosa/kapre convention: HTK=False, norm='slaney')
# ---------------------------------------------------------------------------
def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    mel = np.where(log_region,
                   min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz)
                   / logstep,
                   mel)
    return mel


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    f = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)
    return f


def mel_filterbank(fs: int, n_fft: int, n_mels: int,
                   f_min: float, f_max: float) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_fft//2 + 1, n_mels)``
    (librosa.filters.mel(htk=False, norm='slaney'))."""
    n_freq = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, fs / 2.0, n_freq)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max),
                                     n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalization: equal-area triangles.
    enorm = 2.0 / (mel_pts[2 + np.arange(n_mels)] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.T.astype(np.float32)  # (n_freq, n_mels)


# ---------------------------------------------------------------------------
# Windowed real-DFT basis
# ---------------------------------------------------------------------------
def dft_basis(n_fft: int) -> np.ndarray:
    """Hann-windowed real-DFT basis, shape ``(n_fft, 2*(n_fft//2+1))``.

    Columns are [cos_0..cos_K, -sin_0..-sin_K] so that ``frames @ basis``
    yields [Re(X_k), Im(X_k)] per frame (periodic Hann window)."""
    n_freq = n_fft // 2 + 1
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    angle = -2.0 * np.pi * t * k / n_fft
    re = np.cos(angle) * window[:, None]
    im = np.sin(angle) * window[:, None]
    return np.concatenate([re, im], axis=1).astype(np.float32)


class MelSpecConfig(NamedTuple):
    fs: int = 8000
    dur: float = 1.0
    n_fft: int = 1024
    stft_hop: int = 256
    n_mels: int = 256
    f_min: float = 300.0
    f_max: float = 4000.0
    amin: float = 1e-10          # reference Melspec_layer amin (:36)
    dynamic_range: float = 80.0  # clip floor in dB (:37,:109)
    scale_offset: float = 0.06   # the '+0.06' quirk (:104)
    segment_norm: bool = False   # 'melspec_maxnorm' variant (:110-111)

    @property
    def n_samples(self) -> int:
        return int(self.fs * self.dur)

    @property
    def n_frames(self) -> int:
        padded = self.n_samples + 2 * (self.n_fft // 2)
        return 1 + (padded - self.n_fft) // self.stft_hop

    @classmethod
    def from_cfg(cls, cfg: Dict[str, Any]) -> "MelSpecConfig":
        m = cfg["MODEL"]
        return cls(fs=int(m["FS"]), dur=float(m["DUR"]),
                   n_fft=int(m["STFT_WIN"]), stft_hop=int(m["STFT_HOP"]),
                   n_mels=int(m["N_MELS"]), f_min=float(m["F_MIN"]),
                   f_max=float(m["F_MAX"]),
                   segment_norm=(m.get("FEAT", "melspec") == "melspec_maxnorm"))


@functools.lru_cache(maxsize=8)
def _constants(cfg: MelSpecConfig):
    """(DFT basis, mel filterbank) as numpy f32; the frame index the JAX
    package gathers with is ``unfold``'s window here."""
    return (dft_basis(cfg.n_fft),
            mel_filterbank(cfg.fs, cfg.n_fft, cfg.n_mels, cfg.f_min,
                           cfg.f_max))


def melspectrogram(x: torch.Tensor, cfg: MelSpecConfig) -> torch.Tensor:
    """Log-power mel-spectrogram of a waveform batch.

    Args:
      x: ``(B, T_samples)`` or ``(B, 1, T_samples)`` float32 tensor.
      cfg: MelSpecConfig.

    Returns:
      ``(B, n_mels, n_frames, 1)`` float32 log-mel features in [-80, 0],
      on ``x``'s device.
    """
    if x.ndim == 3:
        x = x[:, 0, :]
    if x.shape[-1] != cfg.n_samples:
        raise ValueError(f"waveform length {x.shape[-1]} != expected "
                         f"{cfg.n_samples} (fs*dur)")
    basis_np, mel_fb_np = _constants(cfg)
    basis = torch.from_numpy(basis_np).to(x.device)
    mel_fb = torch.from_numpy(mel_fb_np).to(x.device)
    x = x.to(torch.float32)
    pad = cfg.n_fft // 2
    xp = F.pad(x, (pad, pad))
    frames = xp.unfold(1, cfg.n_fft, cfg.stft_hop)      # (B, T, n_fft)
    assert frames.shape[1] == cfg.n_frames
    spec = torch.matmul(frames, basis)                  # (B, T, 2K)
    n_freq = cfg.n_fft // 2 + 1
    re, im = spec[..., :n_freq], spec[..., n_freq:]
    mag = torch.sqrt(re * re + im * im + 1e-30)         # |STFT|
    mel = torch.matmul(mag, mel_fb)                     # (B, T, n_mels)

    # Reference post-processing chain (melspectrogram.py:102-112).
    mel = mel + cfg.scale_offset
    mel = torch.log(torch.clamp(mel, min=cfg.amin)) / math.log(10.0)
    mel = mel - mel.max()                               # max over the batch
    mel = torch.clamp(mel, min=-cfg.dynamic_range)
    if cfg.segment_norm:
        mn = mel.min() / 2
        mel = (mel - mn) / torch.abs(mn + 1e-10)
    return mel.transpose(1, 2).unsqueeze(-1)            # (B, F, T, 1)


def get_melspec_fn(cfg: Dict[str, Any], variant: str = "default"):
    """``x -> logmel`` closure from a config dict, and its MelSpecConfig.

    ``variant='lite'`` reproduces the mobile-export frontend's +0.1 scale
    offset (reference ``melspectrogram_tflite.py:88``), the only numerical
    difference from the main path's +0.06."""
    mcfg = MelSpecConfig.from_cfg(cfg)
    if variant == "lite":
        mcfg = mcfg._replace(scale_offset=0.1)
    elif variant != "default":
        raise ValueError(variant)
    return functools.partial(melspectrogram, cfg=mcfg), mcfg
