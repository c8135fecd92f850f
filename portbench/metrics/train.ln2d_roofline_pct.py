"""LayerNorm2d's kernels against their byte bound over the traced window,
in %.

The least time is the traffic the segments trained in the window need at
the card's memory bandwidth, whatever implements the norm: per segment and
over the configuration's norms, C·F·T elements of the compute dtype read
and written five times (the forward's input and output, the backward's
dy, x and dx), 10 bytes an element in bf16. The time spent is the summed
device time of the kernels whose names hold ``ln2d_`` (the port's
``csrc/layernorm2d.cu``). None where no such kernel ran.
"""
from portbench import peaks
from portbench.reference import arch

KERNEL = "ln2d_"
TENSORS = 5          # forward x, y; backward dy, x, dx


def least_bytes_per_segment(model) -> int:
    elem = 2 if model.get("MIXED_PRECISION", True) else 4
    return TENSORS * elem * sum(c.c_out * c.out_hw[0] * c.out_hw[1]
                                for c in arch.convs(model))


def read(ctx):
    hbm = peaks.peak(ctx.kind, "hbm_bytes")
    spent = sum(s for name, s in ctx.trace["kernel_s"].items()
                if KERNEL in name)
    n = ctx.counts.get("segments")
    if not (hbm and spent and n):
        return None
    return 100.0 * n * least_bytes_per_segment(ctx.work["model"]) / hbm \
        / spent
