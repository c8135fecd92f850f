"""Share of the traced window in the protocol's host assembly of each
block: the fill of ``q_seq`` and ``n_seg`` and the hit -> candidate-
start arithmetic, in %: the port's own span ``query.assemble``
(total_s), read from ``nafp_tpu_torch.utils.profiling.snapshot()``. None
where the port records no such span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("query.assemble")
    v = None if s is None else s["total_s"]
    return None if v is None else 100.0 * v / ctx.window_s
