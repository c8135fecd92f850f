"""Share of the traced window in ``index.search`` outside its waits (the
blocks' uploads, the launches, the L2 recovery on the host), in %: the
port's own span ``index.search`` (total_s) less its child span
``index.wait`` (total_s), read from
``nafp_tpu_torch.utils.profiling.snapshot()``. None where the port
records no such span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    spans = snapshot()["spans"]
    s = spans.get("index.search")
    if s is None:
        return None
    w = spans.get("index.wait")
    v = s["total_s"] - (0.0 if w is None else w["total_s"])
    return 100.0 * v / ctx.window_s
