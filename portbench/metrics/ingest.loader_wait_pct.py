"""Share of the traced window in ``generate``'s wait on its loader: the
consumer's ``q.get()`` in ``data/loader.py::prefetch``, in %: the port's
own span ``loader.wait`` (total_s), read from
``nafp_tpu_torch.utils.profiling.snapshot()``. None where the port
records no such span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("loader.wait")
    v = None if s is None else s["total_s"]
    return None if v is None else 100.0 * v / ctx.window_s
