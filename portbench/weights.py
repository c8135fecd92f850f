"""Random FingerPrinter weights from a seed, made on the device.

One uniform draw of every parameter at once from a ``torch.Generator`` on
the device, cut into leaves named as the port's state_dict and scaled per
leaf: convolution kernels and DivEnc weights glorot-uniform (fans times
the kernel cells, per DivEnc slice), as the Flax initialisers; biases
U(-0.05, 0.05); LayerNorm scales U(0.8, 1.2) and offsets U(-0.1, 0.1), so
that no parameter sits at an identity a fault could hide behind. The same
tensors go to the port and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from portbench.reference import arch

# torch.Generator seeds are 64-bit; the run's seed is any whole number
SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A device generator for one named stream of a run's draws."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + stream) & SEED_MASK)


def make(m: Dict[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = arch.param_shapes(m)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.rand(total, generator=generator(seed, 1, device),
                      device=device) * 2 - 1            # U(-1, 1)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[1]
        if leaf == "weight":                           # (O, I, kh, kw)
            rf = shape[2] * shape[3]
            lim = math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))
            out[name] = u * lim
        elif leaf in ("w1", "w2"):                     # (q, in, out)
            out[name] = u * math.sqrt(6.0 / (shape[1] + shape[2]))
        elif leaf == "gamma":
            out[name] = 1.0 + 0.2 * u
        elif leaf == "beta":
            out[name] = 0.1 * u
        else:                                          # biases
            out[name] = 0.05 * u
    return out
