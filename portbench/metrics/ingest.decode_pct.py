"""Share of the traced window in the decode thread's busy time: the seconds
``prefetch``'s worker spent in ``loader[i]``, handed over with each
batch, in %: the port's own counter ``loader.decode_s``, read from
``nafp_tpu_torch.utils.profiling.snapshot()``. None where the port
records no such counter."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    v = snapshot()["counts"].get("loader.decode_s")
    return None if v is None else 100.0 * v / ctx.window_s
