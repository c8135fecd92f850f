"""LayerNorm2d after an ELU, the encoder's norm: the CUDA kernel pair of
``csrc/layernorm2d.cu`` (forward and backward) and its plain version.

The function (``models/nnfp.py`` ``LayerNorm2d``): ELU in the compute
dtype, per-sample statistics over the whole (C, F, T) volume in f32, a
scale and an offset per position (f32), the output cast back to the
compute dtype. The JAX package leaves it to XLA's fusion; eager PyTorch
splits it into ~35 f32 kernels per norm, forward and backward, which the
kernel pair replaces for CUDA tensors.

``layer_norm2d`` launches the kernels for CUDA tensors (or raises) and
takes the plain version, today's expression with autograd through it, for
CPU tensors. ``LAUNCHES`` counts wrapper calls that reached the card: one
a forward, one a backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from nafp_tpu_torch import kernels

THREADS = 256           # csrc/layernorm2d.cu THREADS
UNROLL = 2              # csrc U: vectors a thread takes per chunk
DTYPES = (torch.bfloat16, torch.float32)
# Reduce CTAs of the backward asked for per SM: several waves of 256-thread
# CTAs at any volume
CTAS_PER_SM = 16
# The backward's per-(batch chunk, position) partials of dgamma and dbeta
# (f32, written once and read once) stay under this share of the
# activation's bytes
SCRATCH_SHARE = 0.1
MAX_N = 1 << 24         # per-sample counts stay exact in f32

LAUNCHES: Dict[str, int] = {"layer_norm2d": 0, "layer_norm2d_backward": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def layer_norm2d_plain(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version: ELU, f32 statistics over (C, F, T), the
    per-position affine, the result in x's dtype."""
    x = F.elu(x)
    xf = x.float()
    mean = xf.mean(dim=(1, 2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def layer_norm2d(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float = 1e-3) -> torch.Tensor:
    """LayerNorm2d of ELU(x): x (B, C, F, T) bf16 or f32, contiguous or
    channels last (the encoder's layout: its input's permute makes the
    convolutions keep channels last); gamma and beta (C, F, T) f32. The
    kernel pair for CUDA tensors, the plain version for CPU tensors;
    differentiable in all three."""
    _check_args(x, gamma, beta)
    if kernels.all_on_cpu(x, gamma, beta):
        return layer_norm2d_plain(x, gamma, beta, eps)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _LayerNorm2d.apply(x, gamma, beta, float(eps))
    return _forward(x, gamma, beta, float(eps))[0]    # inference


def _check_args(x: torch.Tensor, gamma: torch.Tensor,
                beta: torch.Tensor) -> None:
    if x.dim() != 4:
        raise ValueError(f"x: shape {tuple(x.shape)}, expected (B, C, F, T)")
    if x.dtype not in DTYPES:
        raise TypeError(f"x: dtype {x.dtype}, expected one of {DTYPES}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected "
                            f"torch.float32")
        if tuple(t.shape) != tuple(x.shape[1:]):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"(C, F, T) = {tuple(x.shape[1:])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous")
    _channels(x)
    if gamma.numel() >= MAX_N:
        raise ValueError(f"x: {gamma.numel()} elements a sample, at most "
                         f"{MAX_N - 1}")


def _channels(x: torch.Tensor) -> int:
    """0 for x contiguous in (B, C, F, T) order, C for channels last; raises
    for any other layout."""
    if x.is_contiguous():
        return 0
    if x.is_contiguous(memory_format=torch.channels_last):
        return x.shape[1]
    raise ValueError("x: must be contiguous (or channels last)")


class Plan(NamedTuple):
    """How the kernels split one call (``plan``)."""
    vec: int             # elements a load: 16 bytes, or 1
    chunks: int          # items a sample of the forward and of dx
    cols: int            # position chunks of the backward reduce
    rows_per_chunk: int  # samples of one of its batch chunks
    n_bc: int            # its batch chunks


def plan(rows: int, n: int, elem_bytes: int, aligned: bool,
         sms: int) -> Plan:
    """The split of a call over ``rows`` samples of ``n`` elements of
    ``elem_bytes`` on a card of ``sms`` SMs; ``aligned``: every pointer
    allows 16-byte loads. The forward and the backward's dx take items of
    256·vec·2 elements. The backward's reduce takes position chunks of
    32·vec·2 and as many batch chunks as give ``CTAS_PER_SM`` CTAs per SM,
    at most what keeps its dgamma/dbeta partials under ``SCRATCH_SHARE`` of
    the activation."""
    vec = 16 // elem_bytes
    if not aligned or n % vec:
        vec = 1
    chunks = -(-n // (THREADS * vec * UNROLL))
    cols = -(-n // (32 * vec * UNROLL))
    # partials: n_bc·n f32 twice, written and read: 16·n_bc·n bytes
    max_bc = max(1, int(SCRATCH_SHARE * rows * elem_bytes) // 16)
    n_bc = max(1, min(rows, max_bc, -(-CTAS_PER_SM * sms // cols)))
    rows_per_chunk = -(-rows // n_bc)
    return Plan(vec, chunks, cols, rows_per_chunk, -(-rows // rows_per_chunk))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _plan_for(x: torch.Tensor, *ts: torch.Tensor) -> Plan:
    """``plan`` for x (B, C, F, T) and the tensors read beside it."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *ts))
    return plan(x.shape[0], x.shape[1] * x.shape[2] * x.shape[3],
                x.element_size(), aligned, _sm_count(x.device.index or 0))


def _dy_layout(dy: torch.Tensor, ch: int) -> Tuple[int, ...]:
    """(n2, n3, s0, s1, s2, s3): dy's per-sample dims in x's memory order,
    (C, F, T) or, channels last, (F, T, C), without those of size 1 and
    each merged into the next inner one where dy is dense across them (a
    contiguous dy is one dim of n elements), and its strides (the batch's
    0 for a single sample)."""
    st, (_, c, f, t) = dy.stride(), dy.shape
    dims = ([(f, st[2]), (t, st[3]), (c, st[1])] if ch
            else [(c, st[1]), (f, st[2]), (t, st[3])])
    merged = []
    for size, stride in dims:
        if size == 1:
            continue
        if merged and merged[-1][1] == size * stride:
            merged[-1] = (merged[-1][0] * size, stride)
        else:
            merged.append((size, stride))
    merged = [(1, 0)] * (3 - len(merged)) + merged
    s0 = st[0] if dy.shape[0] > 1 else 0
    return (merged[1][0], merged[2][0], s0, merged[0][1], merged[1][1],
            merged[2][1])


def _dy_loadable(dy: torch.Tensor, layout: Tuple[int, ...], vec: int) -> bool:
    """Whether the kernels read dy through ``layout``: int32 strides and,
    for loads of ``vec`` elements, whole aligned vectors along the innermost
    dim."""
    n3, st = layout[1], layout[2:]
    if max(st) >= 2 ** 31:
        return False
    return vec == 1 or (st[3] == 1 and n3 % vec == 0 and dy.data_ptr() % 16
                        == 0 and all(s % vec == 0 for s in st[:3]))


_ARGTYPES = {
    "_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_void_p] * 6,
    "_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
    + [ctypes.c_void_p] * 8,
}


@functools.lru_cache(maxsize=None)
def _lib_fn(entry: str):
    return kernels.function("layernorm2d", _ARGTYPES[entry], entry)


def _call(entry: str, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        err = _lib_fn(entry)(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"nafp_layernorm2d{entry} kernel launch failed: "
                           f"CUDA error {err}")


def _forward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float) -> Tuple[torch.Tensor, ...]:
    """y (x's layout), the per-sample mean and rstd (f32), and gamma in x's
    memory order (channels last: the kernel's copy; else gamma itself)."""
    rows, n, dev = x.shape[0], gamma.numel(), x.device
    ch = _channels(x)
    y = torch.empty_like(x)
    if rows == 0:
        none = torch.empty(0, dtype=torch.float32, device=dev)
        return y, none, none, gamma
    p = _plan_for(x, gamma, beta)
    # one f32 buffer: gamma and beta in memory order (channels last; first,
    # so aligned for 16-byte loads), the per-sample mean and rstd, the
    # items' statistics
    gbn = 2 * n if ch else 0
    buf = torch.empty(gbn + 2 * rows + rows * p.chunks * 3,
                      dtype=torch.float32, device=dev)
    gb, mean, rstd = (buf[:gbn], buf[gbn:gbn + rows],
                      buf[gbn + rows:gbn + 2 * rows])
    _call("_fwd", dev, x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), rows,
          n, int(x.dtype == torch.bfloat16), p.vec, p.chunks, ch, eps,
          buf.data_ptr() + 4 * (gbn + 2 * rows), gb.data_ptr(), y.data_ptr(),
          mean.data_ptr(), rstd.data_ptr())
    LAUNCHES["layer_norm2d"] += 1
    return y, mean, rstd, gb[:n] if ch else gamma


def _backward(dy: torch.Tensor, x: torch.Tensor, gamma_mem: torch.Tensor,
              mean: torch.Tensor, rstd: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dx (x's layout), dgamma and dbeta ((C, F, T) f32) from dy (x's dtype,
    any strides: a layout the kernels cannot load 16 bytes at a time from is
    copied into x's first) and what ``_forward`` returned."""
    rows, dev = x.shape[0], x.device
    n, ch = gamma_mem.numel(), _channels(x)
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty_like(x)
    dgamma = torch.empty(x.shape[1:], **f32)
    dbeta = torch.empty(x.shape[1:], **f32)
    if rows == 0:
        return dx, dgamma.zero_(), dbeta.zero_()
    p = _plan_for(x, gamma_mem)
    layout = _dy_layout(dy, ch)
    if not _dy_loadable(dy, layout, p.vec):
        dy = dy.contiguous(memory_format=torch.channels_last if ch
                           else torch.contiguous_format)
        layout = _dy_layout(dy, ch)
    # one f32 scratch: the batch chunks' dgamma and dbeta partials (none
    # with one chunk), the per-(sample, chunk) sums, their means
    pn, parts = (p.n_bc * n if p.n_bc > 1 else 0), rows * p.cols * 2
    buf = torch.empty(2 * pn + parts + rows * 2, **f32)
    at = buf.data_ptr()
    _call("_bwd", dev, dy.data_ptr(), x.data_ptr(), gamma_mem.data_ptr(),
          mean.data_ptr(), rstd.data_ptr(), rows, n,
          int(x.dtype == torch.bfloat16), p.vec, p.cols, p.rows_per_chunk, ch,
          *layout, at + 8 * pn, at + 4 * (2 * pn + parts), at, at + 4 * pn,
          dgamma.data_ptr(), dbeta.data_ptr(), dx.data_ptr())
    LAUNCHES["layer_norm2d_backward"] += 1
    return dx, dgamma, dbeta


class _LayerNorm2d(torch.autograd.Function):
    """The kernel pair as an autograd function: the forward saves x, the
    per-sample mean and rstd (f32) and gamma in x's memory order, nothing of
    the activation's size in f32."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd, gamma_mem = _forward(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma_mem, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, gamma_mem, mean, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = _backward(dy.to(x.dtype), x, gamma_mem, mean,
                                      rstd)
        return dx, dgamma, dbeta, None
