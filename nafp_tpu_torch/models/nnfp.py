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
  ``layer_norm1d`` normalises over channels; ``batch_norm`` normalises
  by the batch's statistics in training (Flax semantics: biased variance
  E[x²] − E[x]² in f32, running averages with momentum 0.99; under a
  ``torch.distributed`` group of more than one rank, the whole global
  batch's, as Flax's ``axis_name`` BatchNorm) and by the running
  statistics in eval mode.
- DivEnc: q slices of the flattened feature, each Dense(32, elu) ->
  Dense(1), as two batched einsums.
- Flatten happens in NHWC order, as in the JAX package, so the DivEnc
  weights carry over unchanged.

Mixed precision (``MODEL.MIXED_PRECISION``, the default): convolutions and
DivEnc take bf16 inputs (DivEnc accumulates in f32, as the TPU's
bf16 x bf16 -> f32 products); normalisation statistics and the final
L2-normalize run in f32; parameters are always f32.

``MODEL.ACT_STORE`` ('int8' or 'fp8'; inference only, keyed on the
module's eval mode): every ConvLayer stores its two normalised
activations at one byte an element and widens them back to the compute
dtype before the next convolution, as the JAX package's
``_compress_act``/``_decompress_act``: 'int8' is ``round(x·16)`` clamped
to ±127 (a fixed power-of-two scale, no calibration), 'fp8' is
``torch.float8_e4m3fn``.

Initialisation draws from a ``torch.Generator`` seeded by the caller
(never the global RNG): glorot-uniform convolution kernels and per-slice
glorot DivEnc weights, zero biases, unit scales, as the Flax initialisers
(the same law, not the same draws).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nafp_tpu_torch.ops.layernorm2d import layer_norm2d
from nafp_tpu_torch.parallel.mesh import all_reduce_sum, world

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
ACT_STORES = (None, "int8", "fp8")
# Fixed int8 activation scale of ACT_STORE 'int8': the normalised
# activations are ~ gamma·N(0,1) + beta, so ±127/16 = ±7.9 covers them in
# steps of 1/16; a power of two, so the dequantising multiply is exact.
_INT8_ACT_SCALE = 16.0
# float8_e4m3fn has no infinity: 448 is its largest value, and |x| above
# the midpoint 464 rounds to the NaN code in XLA and ml_dtypes (its sign
# kept), where PyTorch's cast saturates at 448
_FP8_ROUNDS_TO_NAN = 464.0


def _compress_act(x: torch.Tensor, mode: Optional[str]) -> torch.Tensor:
    """An activation at one byte an element: 'int8' rounds x·16 half to
    even (``jnp.round``'s rule) in f32 and clamps to ±127; 'fp8' rounds to
    float8_e4m3fn half to even from f32 (exact from bf16), a value past
    the format's range to NaN, as XLA's convert; None passes ``x``
    through."""
    if mode == "int8":
        return torch.clamp(torch.round(x.float() * _INT8_ACT_SCALE),
                           -127.0, 127.0).to(torch.int8)
    if mode == "fp8":
        xf = x.float()
        code = xf.to(torch.float8_e4m3fn).view(torch.uint8)
        nan = torch.where(torch.signbit(xf), 0xFF, 0x7F).to(torch.uint8)
        return torch.where(xf.abs() > _FP8_ROUNDS_TO_NAN, nan,
                           code).view(torch.float8_e4m3fn)
    return x


def _decompress_act(x: torch.Tensor, mode: Optional[str],
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of _compress_act into ``dtype``; a tensor that was not
    compressed (the log-mel input, a float tap) passes through."""
    if mode == "int8" and x.dtype == torch.int8:
        return x.to(dtype) * (1.0 / _INT8_ACT_SCALE)
    if mode == "fp8" and x.dtype == torch.float8_e4m3fn:
        return x.to(dtype)
    return x


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int,
             gen: torch.Generator) -> None:
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-lim, lim, generator=gen)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF/Flax 'SAME' padding of one dimension: total
    max((ceil(n/s)-1)*s + k - n, 0), the odd cell at the end."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Module):
    """Conv2d with 'SAME' padding for any stride, on an (F, T) input of
    known size (the padding is fixed at construction)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: Tuple[int, int], in_hw: Tuple[int, int],
                 gen: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        rf = kernel[0] * kernel[1]     # Flax glorot on HWIO: fans x H*W
        _glorot_(self.weight, in_ch * rf, out_ch * rf,
                 gen or torch.Generator().manual_seed(0))
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
    scale/offset, output cast back to the compute dtype
    (``ops/layernorm2d.py``: the CUDA kernel pair on the card, the plain
    expression on the CPU)."""

    def __init__(self, shape: Tuple[int, int, int], eps: float = 1e-3):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(shape))   # (C, F, T)
        self.beta = nn.Parameter(torch.zeros(shape))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm2d(x, self.gamma, self.beta, self.eps)


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


class BatchNorm(nn.Module):
    """ELU, then Flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3,
    dtype=float32)`` over channels.

    Training mode: the batch's statistics over (B, F, T) in f32, with the
    biased fast variance ``max(E[x²] − E[x]², 0)`` (Flax's default; unlike
    ``nn.BatchNorm2d``, whose running variance is unbiased), and running
    averages ``r = 0.99·r + 0.01·batch`` updated in place (buffers, not
    parameters: no optimiser touches them). Under a process group of more
    than one rank, the batch mean and E[x²] are averaged over the ranks
    with gradient (each rank holds an equal share of the global batch), so
    the running averages are the same on every rank. Eval mode: the
    running statistics."""

    def __init__(self, ch: int, eps: float = 1e-3, momentum: float = 0.99):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))
        self.eps = eps
        self.momentum = momentum

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(x)
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = xf.square().mean(dim=(0, 2, 3))
            _, size = world()
            if size > 1:
                mean, mean2 = (all_reduce_sum(torch.stack([mean, mean2]))
                               / size).unbind(0)
            var = torch.clamp(mean2 - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean.detach())
                self.running_var.copy_(m * self.running_var
                                       + (1 - m) * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.scale
        y = ((xf - mean[:, None, None]) * mul[:, None, None]
             + self.bias[:, None, None])
        return y.to(x.dtype)


def _norm(kind: str, shape: Tuple[int, int, int]) -> nn.Module:
    if kind == "layer_norm2d":
        return LayerNorm2d(shape)
    if kind == "layer_norm1d":
        return LayerNorm1d(shape[0])
    if kind == "batch_norm":
        return BatchNorm(shape[0])
    raise ValueError(f"MODEL.BN must be one of {NORMS}, got {kind!r}")


class ConvLayer(nn.Module):
    """Separable-style conv block (reference ``nnfp.py:20-83``). With
    ``act_store`` set and the module in eval mode, its input is widened
    from, and its two normalised activations are stored at, one byte an
    element (``dtype``: the compute dtype they widen to)."""

    def __init__(self, in_ch: int, hidden_ch: int,
                 strides: Tuple[Tuple[int, int], Tuple[int, int]],
                 in_hw: Tuple[int, int], norm: str, gen: torch.Generator,
                 act_store: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_store, self.dtype = act_store, dtype
        self.conv_1x3 = SameConv2d(in_ch, hidden_ch, (1, 3), strides[0], in_hw,
                                   gen)
        hw1 = self.conv_1x3.out_hw
        self.norm_1 = _norm(norm, (hidden_ch, *hw1))
        self.conv_3x1 = SameConv2d(hidden_ch, hidden_ch, (3, 1), strides[1],
                                   hw1, gen)
        self.out_hw = self.conv_3x1.out_hw
        self.norm_2 = _norm(norm, (hidden_ch, *self.out_hw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = None if self.training else self.act_store
        x = self.norm_1(self.conv_1x3(_decompress_act(x, q, self.dtype)))
        x = _decompress_act(_compress_act(x, q), q, self.dtype)
        return _compress_act(self.norm_2(self.conv_3x1(x)), q)


def _lowp_einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """Products of ``dtype``-rounded operands accumulated in f32 (the TPU's
    bf16 x bf16 -> f32 mode); plain f32 when ``dtype`` is f32."""
    return torch.einsum(eq, a.to(dtype).float(), b.to(dtype).float())


class DivEncLayer(nn.Module):
    """Divide-and-encode head as two batched einsums (reference
    ``nnfp.py:86-156``)."""

    def __init__(self, d: int, gen: torch.Generator, q: int = 128,
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
            _glorot_(w, w.shape[1], w.shape[2], gen)

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
    fixes their shapes. ``seed`` seeds the generator the weights are
    drawn from. ``act_store`` (None, 'int8', 'fp8'): the activation
    storage of inference (eval mode)."""

    def __init__(self, input_hw: Tuple[int, int], emb_sz: int = 128,
                 front_hidden_ch: Sequence[int] = DEFAULT_CHANNELS,
                 front_strides: Sequence = DEFAULT_STRIDES,
                 fc_unit_dim: Tuple[int, int] = (32, 1),
                 norm: str = "layer_norm2d", use_l2layer: bool = True,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 act_store: Optional[str] = None):
        super().__init__()
        if act_store not in ACT_STORES:
            raise ValueError(f"MODEL.ACT_STORE must be int8|fp8, got "
                             f"{act_store}")
        gen = torch.Generator().manual_seed(seed)
        ch = list(front_hidden_ch)
        if ch[-1] % emb_sz != 0:  # round up (nnfp.py:211-212)
            ch[-1] = (ch[-1] // emb_sz + 1) * emb_sz
        layers, in_ch, hw = [], 1, tuple(input_hw)
        for i in range(len(front_strides)):
            layer = ConvLayer(in_ch, ch[i], front_strides[i], hw, norm, gen,
                              act_store, dtype)
            layers.append(layer)
            in_ch, hw = ch[i], layer.out_hw
        self.conv_layers = nn.ModuleList(layers)
        self.div_enc = DivEncLayer(in_ch * hw[0] * hw[1], gen, q=emb_sz,
                                   unit_dim=fc_unit_dim)
        self.norm = norm
        self.use_l2layer = use_l2layer
        self.dtype = dtype
        self.act_store = act_store

    def front(self, x: torch.Tensor) -> torch.Tensor:
        """f(.): conv stack + NHWC flatten -> (B, D). ``x`` is (B,F,T,1)."""
        x = x.permute(0, 3, 1, 2).to(self.dtype)          # NHWC -> NCHW
        for layer in self.conv_layers:
            x = layer(x)
        x = _decompress_act(x, None if self.training else self.act_store,
                            self.dtype)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = self.div_enc(self.front(x), self.dtype).float()
        if self.use_l2layer:
            g = l2_normalize(g)
        return g

    def taps(self, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Mini-search validation taps: f, L2(f), L2(g(f)) in f32."""
        f = self.front(x).float()
        g = l2_normalize(self.div_enc(f, self.dtype).float())
        return f, l2_normalize(f), g


def get_fingerprinter(cfg: Dict[str, Any],
                      seed: Optional[int] = None) -> FingerPrinter:
    """Build from a config dict (reference ``nnfp.py:234-258``).

    ``MODEL.FRONT_HIDDEN_CH`` overrides the channel plan (small ablations
    and test models); ``MODEL.ACT_STORE`` ('int8', 'fp8' or empty) sets
    the activation storage of inference (any other value raises). ``seed``
    seeds the initial weights (0 when None: weights that a checkpoint then
    replaces)."""
    from nafp_tpu_torch.ops.melspec import MelSpecConfig
    m = cfg["MODEL"]
    mcfg = MelSpecConfig.from_cfg(cfg)
    dtype = torch.bfloat16 if m.get("MIXED_PRECISION", True) else torch.float32
    return FingerPrinter(input_hw=(mcfg.n_mels, mcfg.n_frames),
                         emb_sz=int(m["EMB_SZ"]),
                         front_hidden_ch=tuple(m.get("FRONT_HIDDEN_CH",
                                                     DEFAULT_CHANNELS)),
                         norm=m["BN"], dtype=dtype,
                         seed=0 if seed is None else int(seed),
                         act_store=m.get("ACT_STORE") or None)
