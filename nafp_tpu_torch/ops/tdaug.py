"""Time-domain augmentation on the device: SNR background mix + IR reverb.

Counterpart of ``nafp_tpu/ops/tdaug.py`` (reference
``model/utils/audio_utils.py:28-137``, driven from
``dataloader_keras.py:223-311``). The host loader only reads raw
waveforms; the mixing runs batched on the device:

- ``bg_mix_batch``: per-sample SNR ~ U[min, max] dB, RMS-normalised signal
  and noise mixed as ``10^(snr/20) * x + bg``, max-normalised, scaled by
  a log-uniform amplitude in [0.1, 1]; a row whose signal or noise is all
  zeros falls back to the plain sum ``x + bg``.
- ``ir_aug_batch``: rFFT -> multiply -> irFFT of length ``max(T, L)``
  with the impulse response cut at 600 taps (75 ms at 8 kHz), truncated
  to T, max-normalised. With L <= T this is the circular convolution the
  JAX package computes, kept as it is (not a linear one).

Random draws come from a ``torch.Generator`` on the batch's device; the
draws themselves (``snr``, ``amp``) can be passed in instead, so a test
feeds this package and the JAX one the same values.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from nafp_tpu_torch.data.loader import MAX_IR_LENGTH


def _max_normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-row max-normalise; zero rows pass through."""
    m = x.abs().amax(dim=-1, keepdim=True)
    return torch.where(m > 0, x / torch.where(m > 0, m, 1.0), x)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float,
             device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def draw_bg_mix(gen: torch.Generator, b: int,
                snr_range: Tuple[float, float] = (0.0, 10.0),
                amp_range: Tuple[float, float] = (0.1, 1.0),
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(snr dB, amplitude), each (b, 1): U[snr range] and 10^U[log10 amp
    range]."""
    snr = _uniform(gen, (b, 1), min(snr_range), max(snr_range), device)
    amp = 10.0 ** _uniform(gen, (b, 1), math.log10(amp_range[0]),
                           math.log10(amp_range[1]), device)
    return snr, amp


def bg_mix_batch(x: torch.Tensor, bg: torch.Tensor,
                 gen: Optional[torch.Generator] = None,
                 snr_range: Tuple[float, float] = (0.0, 10.0),
                 amp_range: Tuple[float, float] = (0.1, 1.0),
                 snr: Optional[torch.Tensor] = None,
                 amp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mix each row of ``x`` (B, T) with ``bg`` (B, T) at a random SNR
    (``snr``/``amp`` (B, 1) given, or drawn from ``gen``)."""
    b, t = x.shape
    if snr is None or amp is None:
        snr, amp = draw_bg_mix(gen, b, snr_range, amp_range, x.device)
    rms_x = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) / t)
    rms_bg = torch.sqrt(torch.sum(bg * bg, dim=-1, keepdim=True) / t)
    x_n = x / torch.where(rms_x > 0, rms_x, 1.0)
    bg_n = bg / torch.where(rms_bg > 0, rms_bg, 1.0)
    mixed = 10.0 ** (snr / 20.0) * x_n + bg_n
    degenerate = ((x.abs().amax(dim=-1, keepdim=True) == 0)
                  | (bg.abs().amax(dim=-1, keepdim=True) == 0))
    mixed = torch.where(degenerate, x + bg, mixed)
    return amp * _max_normalize(mixed)


def ir_aug_batch(x: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
    """Convolve each row of ``x`` (B, T) with its impulse response (B, L),
    L cut at ``MAX_IR_LENGTH``: FFT product of length max(T, L), truncated
    to T, max-normalised."""
    t = x.shape[-1]
    ir = ir[:, :MAX_IR_LENGTH]
    n = max(t, ir.shape[-1])
    X = torch.fft.rfft(x.float(), n=n, dim=-1)
    H = torch.fft.rfft(ir.float(), n=n, dim=-1)
    y = torch.fft.irfft(X * H, n=n, dim=-1)[:, :t]
    return _max_normalize(y).to(x.dtype)


def augment_replicas(xp: torch.Tensor,
                     bg: Optional[torch.Tensor],
                     ir: Optional[torch.Tensor],
                     gen: Optional[torch.Generator] = None,
                     snr_range: Tuple[float, float] = (0.0, 10.0),
                     use_bg: bool = True,
                     use_ir: bool = True,
                     speech: Optional[torch.Tensor] = None,
                     use_speech: bool = False,
                     snr: Optional[torch.Tensor] = None,
                     amp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The replica-side chain: noise mix, then IR reverb. With bg and
    speech both on, the two are summed and mixed once
    (dataloader_keras.py:248-253); anchors are never augmented."""
    use_bg = use_bg and bg is not None
    use_speech = use_speech and speech is not None
    noise = (bg + speech if use_bg and use_speech
             else bg if use_bg else speech if use_speech else None)
    if noise is not None:
        xp = bg_mix_batch(xp, noise, gen, snr_range, snr=snr, amp=amp)
    if use_ir and ir is not None:
        xp = ir_aug_batch(xp, ir)
    return xp
