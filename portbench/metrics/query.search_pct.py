"""Share of the traced window inside ``index.search``, in %: the span a
wrapper of the benchmark's own puts on the index instance (host clock,
the host round trip of each 512-query block included)."""


def read(ctx):
    s = ctx.spans.get("search")
    return None if s is None else 100.0 * s / ctx.window_s
