"""Share of the traced window in the protocol's re-rank call: the uploads
of each block's query sequences and candidates, the re-rank's launches
through ``topk_low_index`` and the device waits inside them, up to the
``.cpu()`` of the answers, in %: the port's own span ``query.rerank``
(total_s), read from ``nafp_tpu_torch.utils.profiling.snapshot()``.
None where the port records no such span."""


def read(ctx):
    try:
        from nafp_tpu_torch.utils.profiling import snapshot
    except ImportError:       # a port that records no spans
        return None
    s = snapshot()["spans"].get("query.rerank")
    v = None if s is None else s["total_s"]
    return None if v is None else 100.0 * v / ctx.window_s
