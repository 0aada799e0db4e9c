"""Share of the traced window in which no kernel, copy or set runs on
the card (profiler), in percent."""


def read(ctx):
    tr = ctx.trace
    if not tr or not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
