"""Host ms from a call's start to its return, before the synchronise:
the median over the window's untraced calls."""

import numpy as np


def read(ctx):
    if not ctx.enqueue_ms:
        return None
    return float(np.median(np.asarray(ctx.enqueue_ms)))
