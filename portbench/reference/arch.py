"""The FingerPrinter's shapes, from a configuration's ``model`` section.

arXiv:2010.11910 (and the reference's ``model/fp/nnfp.py``): a log-mel
input (F mels, T frames) through eight ConvLayers, each a 1x3 and a 3x1
convolution with 'SAME' padding, every convolution followed by ELU and a
LayerNorm over the whole (C, F, T) volume with a scale and an offset per
position; the NHWC-flattened output through DivEnc (``EMB_SZ`` slices, each
Dense(32, ELU) then Dense(1)) and an L2 normalisation.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Tuple


class Conv(NamedTuple):
    name: str                    # parameter prefix, the port's module path
    c_in: int
    c_out: int
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    in_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    norm: str                    # prefix of the LayerNorm that follows


def n_samples(m: Dict[str, Any]) -> int:
    return int(round(float(m["FS"]) * float(m["DUR"])))


def n_frames(m: Dict[str, Any]) -> int:
    n_fft, hop = int(m["STFT_WIN"]), int(m["STFT_HOP"])
    padded = n_samples(m) + 2 * (n_fft // 2)
    return 1 + (padded - n_fft) // hop


def channels(m: Dict[str, Any]) -> List[int]:
    ch = [int(c) for c in m["FRONT_HIDDEN_CH"]]
    emb = int(m["EMB_SZ"])
    if ch[-1] % emb:                      # rounded up to a multiple of d
        ch[-1] = (ch[-1] // emb + 1) * emb
    return ch


def convs(m: Dict[str, Any]) -> List[Conv]:
    out, c_in = [], 1
    hw = (int(m["N_MELS"]), n_frames(m))
    for i, (c, (s13, s31)) in enumerate(zip(channels(m),
                                            m["FRONT_STRIDES"])):
        for j, (kern, stride) in enumerate((((1, 3), tuple(s13)),
                                            ((3, 1), tuple(s31)))):
            o = (math.ceil(hw[0] / stride[0]), math.ceil(hw[1] / stride[1]))
            cname = "conv_1x3" if j == 0 else "conv_3x1"
            out.append(Conv(f"conv_layers.{i}.{cname}", c_in, c,
                            kern, stride, hw, o,
                            f"conv_layers.{i}.norm_{j + 1}"))
            c_in, hw = c, o
    return out


def flat_dim(m: Dict[str, Any]) -> int:
    last = convs(m)[-1]
    return last.c_out * last.out_hw[0] * last.out_hw[1]


def param_shapes(m: Dict[str, Any]) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's name and shape, named as the port's state_dict."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for c in convs(m):
        shapes[f"{c.name}.weight"] = (c.c_out, c.c_in) + c.kernel
        shapes[f"{c.name}.bias"] = (c.c_out,)
        shapes[f"{c.norm}.gamma"] = (c.c_out,) + c.out_hw
        shapes[f"{c.norm}.beta"] = (c.c_out,) + c.out_hw
    q = int(m["EMB_SZ"])
    u0, u1 = (int(u) for u in m["FC_UNIT_DIM"])
    s = flat_dim(m) // q
    shapes["div_enc.w1"] = (q, s, u0)
    shapes["div_enc.b1"] = (q, u0)
    shapes["div_enc.w2"] = (q, u0, u1)
    shapes["div_enc.b2"] = (q, u1)
    return shapes
