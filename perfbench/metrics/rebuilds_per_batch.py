"""Cold paths run per batch in the traced stretch of the window: the
program's ``build.*`` spans (a table's hash ``build.digest`` among them)
and ``cache.<name>.miss`` marks from the first traced call to the last
traced synchronise, over the traced calls; 0 in a steady state (profiler
trace, ``perfbench/spans.py``)."""

from perfbench.spans import rebuilds_per_call


def read(ctx):
    return rebuilds_per_call(ctx)
