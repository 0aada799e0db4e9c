"""Seconds from process start to the window's first batch: imports, the
libraries, the frames, the operator and plans, the warm-up."""


def read(ctx):
    return ctx.setup_s
