"""Share of the traced window in the protocol's wait on the re-rank: the
``.cpu()`` of each block's ranked candidates and their validity, in %:
the port's own span ``query.rerank_wait`` (total_s), read from
``nafp_tpu_torch.utils.profiling.snapshot()``. None where the port
records no such span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("query.rerank_wait")
    v = None if s is None else s["total_s"]
    return None if v is None else 100.0 * v / ctx.window_s
