"""Host us of a call's kernel launches: per traced call, the program's
``aa.launch.*`` spans (each call into a CUDA library) summed, median
over the traced calls (profiler trace, ``perfbench/spans.py``)."""

from perfbench.spans import median_of


def read(ctx):
    return median_of(ctx, "launch_us")
