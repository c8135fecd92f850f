"""Share of the traced window in the index's waits on the card: the
``.cpu()`` of each query block's scores and ids, which holds B1's time,
in %: the port's own span ``index.wait`` (total_s), read from
``nafp_tpu_torch.utils.profiling.snapshot()``. None where the port
records no such span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("index.wait")
    v = None if s is None else s["total_s"]
    return None if v is None else 100.0 * v / ctx.window_s
