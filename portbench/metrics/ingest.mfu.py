"""Log-mel and encoder FLOPs of every segment fingerprinted in the traced
window (``portbench.work.segment_flops``, the frozen copy of the port's
``bench.flops_per_call``) over the window and the card's dense bf16 peak,
in %."""
from portbench import peaks, work


def read(ctx):
    peak = peaks.peak(ctx.kind, "bf16_flops")
    n = ctx.counts.get("segments")
    if not (peak and n):
        return None
    return 100.0 * n * work.segment_flops(ctx.work["model"]) \
        / ctx.window_s / peak
