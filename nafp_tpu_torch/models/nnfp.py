"""FingerPrinter encoder as PyTorch modules (NCHW).

Counterpart of ``nafp_tpu/models/nnfp.py`` (reference ``model/fp/nnfp.py``):

    IN (B,F,T,1) >> [ConvLayer]x8 >> Flatten >> DivEnc >> L2-normalize >> (B,128)

- ConvLayer = Conv1x3 -> ELU -> Norm -> Conv3x1 -> ELU -> Norm, strides
  ``DEFAULT_STRIDES``, channels ``DEFAULT_CHANNELS``. The convolutions pad
  like TF/Flax ``'SAME'``: with stride 2 the padding is asymmetric, the
  extra cell at the end, so it is applied with ``F.pad`` (torch's
  ``padding='same'`` refuses stride > 1).
- ``layer_norm2d`` normalises each sample over the whole (C,F,T) volume in
  f32 with eps 1e-3, with a scale and offset per position (C,F,T).
  ``layer_norm1d`` normalises over channels; ``batch_norm`` applies running
  statistics (inference only in this slice).
- DivEnc: q slices of the flattened feature, each Dense(32, elu) ->
  Dense(1), as two batched einsums.
- Flatten happens in NHWC order, as in the JAX package, so the DivEnc
  weights carry over unchanged.

Mixed precision (``MODEL.MIXED_PRECISION``, the default): convolutions and
DivEnc take bf16 inputs (DivEnc accumulates in f32, as the TPU's
bf16 x bf16 -> f32 products); normalisation statistics and the final
L2-normalize run in f32; parameters are always f32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# [(freq, time) stride of conv1x3, (freq, time) stride of conv3x1] per layer
# (reference nnfp.py:194-197).
DEFAULT_STRIDES: Tuple[Tuple[Tuple[int, int], Tuple[int, int]], ...] = (
    ((1, 2), (2, 1)), ((1, 2), (2, 1)),
    ((1, 2), (2, 1)), ((1, 2), (2, 1)),
    ((1, 1), (2, 1)), ((1, 2), (2, 1)),
    ((1, 1), (2, 1)), ((1, 2), (2, 1)),
)
DEFAULT_CHANNELS: Tuple[int, ...] = (128, 128, 256, 256, 512, 512, 1024, 1024)
NORMS = ("layer_norm2d", "layer_norm1d", "batch_norm")


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF/Flax 'SAME' padding of one dimension: total
    max((ceil(n/s)-1)*s + k - n, 0), the odd cell at the end."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Module):
    """Conv2d with 'SAME' padding for any stride, on an (F, T) input of
    known size (the padding is fixed at construction)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int], in_hw: Tuple[int, int]):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        nn.init.xavier_uniform_(self.weight)
        self.stride = stride
        (h, w), (kh, kw), (sh, sw) = in_hw, kernel, stride
        ph, pw = _same_pad(h, kh, sh), _same_pad(w, kw, sw)
        self.pad = (pw[0], pw[1], ph[0], ph[1])  # F.pad order: last dim first
        self.out_hw = (math.ceil(h / sh), math.ceil(w / sw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        xp = F.pad(x, self.pad)
        if dt == torch.bfloat16 and x.device.type == "cpu":
            # PyTorch's CPU bf16 convolution returns wrong values (and NaN
            # without a bias) at some of this model's shapes, e.g. a
            # (4, 512, 8, 3) input to the stride-(1, 2) 1x3 conv of layer 5.
            # Same numerics as the card's bf16 convolution: bf16 operands,
            # f32 sums, bf16 result.
            w = self.weight.to(dt).float()
            return F.conv2d(xp.float(), w, self.bias.to(dt).float(),
                            stride=self.stride).to(dt)
        return F.conv2d(xp, self.weight.to(dt), self.bias.to(dt),
                        stride=self.stride)


class LayerNorm2d(nn.Module):
    """TF-style LayerNormalization(axis=(1,2,3)) after an ELU: per-sample
    statistics over the whole (C,F,T) volume in f32, per-position
    scale/offset, output cast back to the compute dtype."""

    def __init__(self, shape: Tuple[int, int, int], eps: float = 1e-3):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(shape))   # (C, F, T)
        self.beta = nn.Parameter(torch.zeros(shape))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(x)
        xf = x.float()
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.gamma + self.beta).to(x.dtype)


class LayerNorm1d(nn.Module):
    """ELU, then Flax ``nn.LayerNorm(epsilon=1e-3)`` over channels in f32
    (fast variance E[x²] − E[x]², clipped at 0)."""

    def __init__(self, ch: int, eps: float = 1e-3):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(x)
        xf = x.float()
        mean = xf.mean(dim=1, keepdim=True)
        var = torch.clamp(xf.square().mean(dim=1, keepdim=True)
                          - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale[:, None, None]
        y = (xf - mean) * mul + self.bias[:, None, None]
        return y.to(x.dtype)


class BatchNormInference(nn.Module):
    """ELU, then Flax ``nn.BatchNorm(use_running_average=True,
    epsilon=1e-3)`` over channels in f32. Training-mode statistics come
    with the training slice."""

    def __init__(self, ch: int, eps: float = 1e-3):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "the training slice: batch_norm training statistics are not ported")
        x = F.elu(x)
        xf = x.float()
        mul = torch.rsqrt(self.running_var + self.eps) * self.scale
        y = ((xf - self.running_mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)


def _norm(kind: str, shape: Tuple[int, int, int]) -> nn.Module:
    if kind == "layer_norm2d":
        return LayerNorm2d(shape)
    if kind == "layer_norm1d":
        return LayerNorm1d(shape[0])
    if kind == "batch_norm":
        return BatchNormInference(shape[0])
    raise ValueError(f"MODEL.BN must be one of {NORMS}, got {kind!r}")


class ConvLayer(nn.Module):
    """Separable-style conv block (reference ``nnfp.py:20-83``)."""

    def __init__(self, in_ch: int, hidden_ch: int,
                 strides: Tuple[Tuple[int, int], Tuple[int, int]],
                 in_hw: Tuple[int, int], norm: str = "layer_norm2d"):
        super().__init__()
        self.conv_1x3 = SameConv2d(in_ch, hidden_ch, (1, 3), strides[0], in_hw)
        hw1 = self.conv_1x3.out_hw
        self.norm_1 = _norm(norm, (hidden_ch, *hw1))
        self.conv_3x1 = SameConv2d(hidden_ch, hidden_ch, (3, 1), strides[1],
                                   hw1)
        self.out_hw = self.conv_3x1.out_hw
        self.norm_2 = _norm(norm, (hidden_ch, *self.out_hw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm_1(self.conv_1x3(x))
        return self.norm_2(self.conv_3x1(x))


def _lowp_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Products of ``dtype``-rounded operands accumulated in f32 (the TPU's
    bf16 x bf16 -> f32 mode); plain f32 when ``dtype`` is f32."""
    return torch.einsum(eq, a.to(dtype).float(), b.to(dtype).float())


class DivEncLayer(nn.Module):
    """Divide-and-encode head as two batched einsums (reference
    ``nnfp.py:86-156``)."""

    def __init__(self, d: int, q: int = 128,
                 unit_dim: Tuple[int, int] = (32, 1)):
        super().__init__()
        if d % q:
            raise ValueError(f"flattened dim {d} not divisible by q={q}")
        s = d // q
        u0, u1 = unit_dim
        self.q = q
        self.w1 = nn.Parameter(torch.empty(q, s, u0))
        self.b1 = nn.Parameter(torch.zeros(q, u0))
        self.w2 = nn.Parameter(torch.empty(q, u0, u1))
        self.b2 = nn.Parameter(torch.zeros(q, u1))
        for w in (self.w1, self.w2):   # per-slice glorot
            lim = math.sqrt(6.0 / (w.shape[1] + w.shape[2]))
            nn.init.uniform_(w, -lim, lim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, d = x.shape
        xs = x.reshape(b, self.q, d // self.q)
        h = _lowp_einsum("bqs,qsu->bqu", xs, self.w1, dtype) + self.b1
        h = F.elu(h).to(dtype)
        out = _lowp_einsum("bqu,quv->bqv", h, self.w2, dtype) + self.b2
        return out[..., 0]  # (B, Q)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """tf.math.l2_normalize semantics: x * rsqrt(max(sum(x²), eps))."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(torch.clamp(sq, min=eps))


class FingerPrinter(nn.Module):
    """The fingerprint encoder g(f(.)) (reference ``nnfp.py:159-231``).

    ``input_hw`` is the log-mel (F, T): layer_norm2d's per-position
    parameters depend on it, as in the JAX package, where the first call
    fixes their shapes."""

    def __init__(self, input_hw: Tuple[int, int], emb_sz: int = 128,
                 front_hidden_ch: Sequence[int] = DEFAULT_CHANNELS,
                 front_strides: Sequence = DEFAULT_STRIDES,
                 fc_unit_dim: Tuple[int, int] = (32, 1),
                 norm: str = "layer_norm2d", use_l2layer: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        ch = list(front_hidden_ch)
        if ch[-1] % emb_sz != 0:  # round up (nnfp.py:211-212)
            ch[-1] = (ch[-1] // emb_sz + 1) * emb_sz
        layers, in_ch, hw = [], 1, tuple(input_hw)
        for i in range(len(front_strides)):
            layer = ConvLayer(in_ch, ch[i], front_strides[i], hw, norm)
            layers.append(layer)
            in_ch, hw = ch[i], layer.out_hw
        self.conv_layers = nn.ModuleList(layers)
        self.div_enc = DivEncLayer(in_ch * hw[0] * hw[1], q=emb_sz,
                                   unit_dim=fc_unit_dim)
        self.use_l2layer = use_l2layer
        self.dtype = dtype

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """f(.): conv stack + NHWC flatten -> (B, D). ``x`` is (B,F,T,1)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)          # NHWC -> NCHW
        for layer in self.conv_layers:
            x = layer(x)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.div_enc(self.front(x), self.dtype).float()
        if self.use_l2layer:
            g = l2_normalize(g)
        return g


def get_fingerprinter(cfg: Dict[str, Any]) -> FingerPrinter:
    """Build from a config dict (reference ``nnfp.py:234-258``).

    ``MODEL.FRONT_HIDDEN_CH`` overrides the channel plan (small ablations
    and test models). ``MODEL.ACT_STORE`` (int8/fp8 activation storage) is
    not ported yet and raises."""
    from nafp_tpu_torch.ops.melspec import MelSpecConfig
    m = cfg["MODEL"]
    if m.get("ACT_STORE"):
        raise NotImplementedError(
            "MODEL.ACT_STORE is not ported yet (later slice, see ROADMAP)")
    mcfg = MelSpecConfig.from_cfg(cfg)
    dtype = torch.bfloat16 if m.get("MIXED_PRECISION", True) else torch.float32
    return FingerPrinter(input_hw=(mcfg.n_mels, mcfg.n_frames),
                         emb_sz=int(m["EMB_SZ"]),
                         front_hidden_ch=tuple(m.get("FRONT_HIDDEN_CH",
                                                     DEFAULT_CHANNELS)),
                         norm=m["BN"], dtype=dtype)
