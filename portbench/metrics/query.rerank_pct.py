"""Share of the traced window inside the protocol's block call but outside
``index.search``, in %: the re-rank and the host assembly of the block."""


def read(ctx):
    block, search = ctx.spans.get("block"), ctx.spans.get("search")
    if block is None or search is None:
        return None
    return 100.0 * (block - search) / ctx.window_s
