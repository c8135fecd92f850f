"""B1's share of its roofline over the traced window, in %.

B1's device time is the sum of its kernels' time, by name, in the trace
(``scan_kernel`` and ``merge_kernel`` of ``csrc/topk_f32.cu``; the cell
runs no other top-k kernel). The least time is summed over B1's calls,
one per block of at most 512 query rows of an ``index.search``: the larger
of 2·rows·N·d useful products at the dense TF32 peak and every input and
output byte once at the memory bandwidth (``portbench.work``), whatever
implements the exact f32 top-k.
"""
from portbench import peaks, work

KERNELS = ("scan_kernel", "merge_kernel")


def read(ctx):
    tf32 = peaks.peak(ctx.kind, "tf32_flops")
    hbm = peaks.peak(ctx.kind, "hbm_bytes")
    spent = sum(s for name, s in ctx.trace["kernel_s"].items()
                if any(k in name for k in KERNELS))
    rows = ctx.counts.get("b1_rows", [])
    if not (tf32 and hbm and spent and rows):
        return None
    least = sum(work.topk_f32_least_seconds(bq, ctx.work["n_rows"],
                                            ctx.work["d"], ctx.work["k"],
                                            tf32, hbm) for bq in rows)
    return 100.0 * least / spent
