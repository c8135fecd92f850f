"""Share of the traced window in the port's device span ``ivfpq.probe``
of ``IVFPQIndex.search``: the staging of the query blocks (upload, f32
``q · centroid`` and the top ``nprobe`` lists as a 0 / NEG bias), the
probed union and the coverage decision with its copy, in %. Its
device_s, the stream interval (the device's idle time inside included),
read from ``nafp_tpu_torch.utils.profiling.snapshot()``. None where the
port records no such span, or no device time (off the card)."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("ivfpq.probe")
    v = None if s is None else s["device_s"]
    return None if v is None else 100.0 * v / ctx.window_s
