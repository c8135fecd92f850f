"""The whole IVF-PQ query step's useful FLOPs over the traced window
against the card's dense bf16 peak, in %: the search's products (2·d for
each row of a probed list, the port's counter ``ivfpq.probed_rows``, read
from ``nafp_tpu_torch.utils.profiling.snapshot()``) and the re-rank's (2·d
for each window row scored, b clips x sl·k_probe candidates x sl rows a
block). None where the port records no such counter."""
from portbench import peaks, work, work_pq


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no counters
        return None
    probed = snapshot()["counts"].get("ivfpq.probed_rows")
    peak = peaks.peak(ctx.kind, "bf16_flops")
    blocks = ctx.counts.get("blocks")
    if not (probed and peak and blocks):
        return None
    w = ctx.work
    flops = work_pq.search_flops(probed, w["d"])
    flops += sum(work.rerank_flops(b, sl, w["k"], w["d"])
                 for sl, b in blocks)
    return 100.0 * flops / ctx.window_s / peak
