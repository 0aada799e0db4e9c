"""The 95th percentile, over every batch of the window, of the ms from
the call's start to its synchronised completion (host clock)."""

import numpy as np


def read(ctx):
    if not ctx.batch_ms:
        return None
    return float(np.percentile(np.asarray(ctx.batch_ms), 95.0))
