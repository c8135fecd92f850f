"""The IVF-PQ search function's share of its roofline over the traced
window, in %: its least time over the stream time of the searches.

The stream time is the device_s of the port's device span
``ivfpq.search`` around each whole ``IVFPQIndex.search`` call (probe,
decode, scan and the copies of the results; the device's idle time
inside included), read from ``nafp_tpu_torch.utils.profiling.snapshot()``.
The least time is summed over the calls, one per block of ``n`` clips at
``sl`` segments (``n·sl`` query rows): the larger of 2·d products for
each probed row at the dense bf16 peak and every input and output byte
once at the memory bandwidth (``portbench.work_pq``). A call's probed
rows are its query rows times the window's probed rows per query row
(the port's counter ``ivfpq.probed_rows`` over the rows searched). None
where the port records no such span or counter.
"""
from portbench import peaks, work_pq


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    snap = snapshot()
    s = snap["spans"].get("ivfpq.search")
    probed = snap["counts"].get("ivfpq.probed_rows")
    bf16 = peaks.peak(ctx.kind, "bf16_flops")
    hbm = peaks.peak(ctx.kind, "hbm_bytes")
    blocks = ctx.counts.get("blocks")
    if not (s and s["device_s"] and probed and bf16 and hbm and blocks):
        return None
    per_row = probed / sum(n * sl for sl, n in blocks)
    least = sum(work_pq.search_least_seconds(n * sl, per_row * n * sl,
                                             ctx.work, bf16, hbm)
                for sl, n in blocks)
    return 100.0 * least / s["device_s"]
