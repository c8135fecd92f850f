"""Share of the traced window in the port's device span ``ivfpq.refine``
of ``IVFPQIndex.search`` (``-i ivfpq-rr``): each query block's exact
re-rank of its shortlist (the gather of the raw rows, the f32 product and
the top-k selection), in %. Its device_s, the stream interval (the
device's idle time inside included, the selection's host wait too), read
from ``nafp_tpu_torch.utils.profiling.snapshot()``. None where the port
records no such span, or no device time (off the card)."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("ivfpq.refine")
    v = None if s is None else s["device_s"]
    return None if v is None else 100.0 * v / ctx.window_s
