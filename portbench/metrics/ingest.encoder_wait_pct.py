"""Share of the traced window in ``generate``'s waits on the encoder: the
``.cpu()`` of each batch's fingerprints, in %: the port's own span
``generate.wait`` (total_s), read from
``nafp_tpu_torch.utils.profiling.snapshot()``. None where the port
records no such span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("generate.wait")
    v = None if s is None else s["total_s"]
    return None if v is None else 100.0 * v / ctx.window_s
