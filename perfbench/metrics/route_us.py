"""Host us of a call's route choice: per traced call, the program's
``aa.spec`` (the input and its grid) and ``aa.route`` (the route choice
and its cached lookups, until the route's callable is in hand) spans
inside its ``aa.interpolate``, median over the traced calls (profiler
trace, ``perfbench/spans.py``)."""

from perfbench.spans import median_of


def read(ctx):
    return median_of(ctx, "route_us")
