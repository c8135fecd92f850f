"""Device idle share of the traced window, in %: 100 minus the busy share,
busy being the union of the device's kernel, copy and memset intervals."""


def read(ctx):
    if not ctx.trace or not ctx.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.window_s)
