"""Plain log-mel front end and FingerPrinter forward pass, in float32.

Written from the model's description (arXiv:2010.11910; the reference's
kapre front end ``model/fp/melspec/melspectrogram.py`` and encoder
``model/fp/nnfp.py``), with no kernel, cache or batching of the port:

- log-mel: the waveform zero-padded by n_fft/2 on each side, framed at the
  STFT hop, a periodic-Hann-windowed real DFT, the magnitude
  sqrt(re² + im² + 1e-30), a Slaney mel filterbank (librosa's
  ``htk=False, norm='slaney'``), + 0.06, log10 of it clamped at 1e-10,
  minus the max over the whole batch, clamped at -80;
- encoder: see ``arch``; LayerNorm eps 1e-3 with the biased variance,
  ELU before each norm, DivEnc on the NHWC flattening, L2 normalisation
  x · rsqrt(max(sum x², 1e-12)).

``precision``: 'f32' (the reference: every product in float32, TF32 off)
or 'fp8' (the control: every convolution's and DivEnc's operands rounded
to float8_e4m3fn, products summed in float32; in training the gradients
pass the rounding unrounded).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import arch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, brk = 200.0 / 3, 1000.0
    return np.where(f >= brk, brk / f_sp + np.log(np.maximum(f, brk) / brk)
                    / (np.log(6.4) / 27.0), f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, brk = 200.0 / 3, 1000.0
    return np.where(m >= brk / f_sp,
                    brk * np.exp(np.log(6.4) / 27.0 * (m - brk / f_sp)),
                    m * f_sp)


def mel_filterbank(fs, n_fft, n_mels, f_min, f_max) -> np.ndarray:
    """(n_fft/2 + 1, n_mels) Slaney filterbank."""
    freqs = np.linspace(0.0, fs / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max),
                                 n_mels + 2))
    w = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, c, hi = pts[i], pts[i + 1], pts[i + 2]
        up = (freqs - lo) / (c - lo)
        down = (hi - freqs) / (hi - c)
        w[i] = np.maximum(0.0, np.minimum(up, down)) * 2.0 / (hi - lo)
    return w.T


def dft_basis(n_fft: int) -> np.ndarray:
    """(n_fft, 2K) [Re | Im] columns of the Hann-windowed real DFT."""
    n = np.arange(n_fft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / n_fft)
    k = np.arange(n_fft // 2 + 1)
    ang = 2 * np.pi * np.outer(n, k) / n_fft
    return np.concatenate([np.cos(ang), -np.sin(ang)], 1) * win[:, None]


class LogMel:
    def __init__(self, m: Dict[str, Any], device):
        self.n_fft, self.hop = int(m["STFT_WIN"]), int(m["STFT_HOP"])
        self.basis = torch.tensor(dft_basis(self.n_fft), dtype=torch.float32,
                                  device=device)
        self.fb = torch.tensor(mel_filterbank(
            int(m["FS"]), self.n_fft, int(m["N_MELS"]), float(m["F_MIN"]),
            float(m["F_MAX"])), dtype=torch.float32, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """(B, samples) waveforms -> (B, mels, frames) features."""
        p = self.n_fft // 2
        frames = F.pad(x.float(), (p, p)).unfold(1, self.n_fft, self.hop)
        spec = frames @ self.basis
        k = self.n_fft // 2 + 1
        mag = torch.sqrt(spec[..., :k] ** 2 + spec[..., k:] ** 2 + 1e-30)
        mel = torch.log10(torch.clamp(mag @ self.fb + 0.06, min=1e-10))
        mel = torch.clamp(mel - mel.max(), min=-80.0)
        return mel.transpose(1, 2)


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` rounded to fp8 for the products; gradients pass in float32
    (an fp8 forward pass, its backward unrounded)."""
    if precision == "fp8":
        return x + (x.to(torch.float8_e4m3fn).float() - x).detach()
    return x


def _same_pad(n: int, k: int, s: int):
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def encode(feat: torch.Tensor, w: Dict[str, torch.Tensor],
           m: Dict[str, Any], precision: str = "f32") -> torch.Tensor:
    """(B, mels, frames) features -> (B, d) unit fingerprints."""
    x = feat[:, None].float()
    for c in arch.convs(m):
        ph = _same_pad(c.in_hw[0], c.kernel[0], c.stride[0])
        pw = _same_pad(c.in_hw[1], c.kernel[1], c.stride[1])
        x = F.conv2d(F.pad(_round(x, precision), (pw[0], pw[1], ph[0], ph[1])),
                     _round(w[f"{c.name}.weight"], precision),
                     w[f"{c.name}.bias"], stride=c.stride)
        x = F.elu(x)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(1, 2, 3), keepdim=True)
        x = ((x - mean) / torch.sqrt(var + 1e-3) * w[f"{c.norm}.gamma"]
             + w[f"{c.norm}.beta"])
    b = x.shape[0]
    q = int(m["EMB_SZ"])
    xs = x.permute(0, 2, 3, 1).reshape(b, q, -1)
    h = F.elu(torch.einsum("bqs,qsu->bqu", _round(xs, precision),
                           _round(w["div_enc.w1"], precision))
              + w["div_enc.b1"])
    g = (torch.einsum("bqu,quv->bqv", _round(h, precision),
                      _round(w["div_enc.w2"], precision))
         + w["div_enc.b2"])[..., 0]
    return g * torch.rsqrt(torch.clamp((g * g).sum(-1, keepdim=True),
                                       min=1e-12))


def fingerprints(x: torch.Tensor, w, m, logmel: LogMel,
                 precision: str = "f32") -> torch.Tensor:
    """One batch of waveforms -> fingerprints (the batch sets the log-mel
    max, as the port's static batches do)."""
    return encode(logmel(x), w, m, precision)
