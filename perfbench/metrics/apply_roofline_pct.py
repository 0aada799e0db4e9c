"""The batch's bound (``count.py``: its bytes over the card's memory
bandwidth, or its operations over the float32 rate where larger) over
the summed device time of the traced calls' kernels, copies and sets
(profiler), per batch, in percent."""

from perfbench.count import bound_s


def read(ctx):
    tr = ctx.trace
    if not tr or not tr.get("device_s") or ctx.peak is None:
        return None
    return 100.0 * bound_s(ctx.counts, ctx.peak) * tr["calls"] / tr["device_s"]
