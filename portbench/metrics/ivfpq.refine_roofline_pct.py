"""The IVF-PQ re-rank's share of its roofline over the traced window, in
%: its least time over the device_s of the port's device span
``ivfpq.refine`` (the stream interval of every block's refine, the
device's idle time inside included), read from
``nafp_tpu_torch.utils.profiling.snapshot()``.

The least time is every byte of the function once at the memory
bandwidth (``portbench.work_rr``): for each of the port's counted rows
(the counter ``ivfpq.refine_rows``, the caller's query rows times the
shortlist width) its raw row, id and score, and for each query row
searched (n·sl a block of n clips at sl segments) its query in and its k
answers out. None where the port records no such span or counter.
"""
from portbench import peaks, work_rr


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    snap = snapshot()
    s = snap["spans"].get("ivfpq.refine")
    rows = snap["counts"].get("ivfpq.refine_rows")
    hbm = peaks.peak(ctx.kind, "hbm_bytes")
    blocks = ctx.counts.get("blocks")
    if not (s and s["device_s"] and rows and hbm and blocks):
        return None
    w = ctx.work
    nq = sum(n * sl for sl, n in blocks)
    least = work_rr.refine_least_seconds(rows, nq, w["d"], w["k"], hbm)
    return 100.0 * least / s["device_s"]
