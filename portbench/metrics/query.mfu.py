"""The whole query step's useful FLOPs over the traced window against the
card's dense bf16 peak, in %: the search's products (2·N·d for each query
segment searched) and the re-rank's (2·d for each window row scored, b
clips x sl·k_probe candidates x sl rows a block)."""
from portbench import peaks, work


def read(ctx):
    peak = peaks.peak(ctx.kind, "bf16_flops")
    blocks = ctx.counts.get("blocks")
    if not (peak and blocks):
        return None
    w = ctx.work
    flops = work.search_flops(ctx.counts.get("search_rows", 0), w["n_rows"],
                              w["d"])
    flops += sum(work.rerank_flops(b, sl, w["k"], w["d"])
                 for sl, b in blocks)
    return 100.0 * flops / ctx.window_s / peak
