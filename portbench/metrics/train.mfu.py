"""The train step's FLOPs over the traced window against the card's dense
bf16 peak, in %. Per segment trained: three times the encoder's forward
FLOPs (the forward once, the backward as twice the forward: the products
for the input's and for the weights' gradients) and the log-mel's once,
since no gradient flows into the waveform (``portbench.work.
train_segment_flops``)."""
from portbench import peaks, work


def read(ctx):
    peak = peaks.peak(ctx.kind, "bf16_flops")
    n = ctx.counts.get("segments")
    if not (peak and n):
        return None
    return 100.0 * n * work.train_segment_flops(ctx.work["model"]) \
        / ctx.window_s / peak
