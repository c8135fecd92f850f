"""LAMB's kernels against their byte bound over the traced window, in %.

The least time is the traffic the steps of the window need at the card's
memory bandwidth, whatever implements the update: per step and parameter
of the configuration (``reference/arch.param_shapes``; 16,939,008 at
``nnfp-640-lamb``), p, the gradient and the two moments read and p and the
moments written once in f32, 28 bytes. The time spent is the summed device
time of the kernels whose names hold ``lamb_`` (the port's
``csrc/lamb.cu``). None where no such kernel ran.
"""
import math

from portbench import peaks
from portbench.reference import arch

KERNEL = "lamb_"
BYTES_PER_PARAM = 28     # p, g, m, v read; p, m, v written; f32


def n_params(model) -> int:
    return sum(math.prod(s) for s in arch.param_shapes(model).values())


def read(ctx):
    hbm = peaks.peak(ctx.kind, "hbm_bytes")
    spent = sum(s for name, s in ctx.trace["kernel_s"].items()
                if KERNEL in name)
    n = ctx.counts.get("steps")
    if not (hbm and spent and n):
        return None
    return 100.0 * n * BYTES_PER_PARAM * n_params(ctx.work["model"]) / hbm \
        / spent
