"""Input Gpixel/s: every input pixel of the batches completed in the
window, over the window's whole time (host clock)."""


def read(ctx):
    if not ctx.batches:
        return None
    return ctx.batches * ctx.counts["in_pixels"] / ctx.window_s * 1e-9
