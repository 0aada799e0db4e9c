"""Host us of the wrappers' own work in a call: per traced call, the
program's ``aa.interpolate`` span less its ``aa.spec``, ``aa.route`` and
``aa.launch.*`` spans (checks, plan and table lookups, output
allocation, autograd glue), median over the traced calls (profiler
trace, ``perfbench/spans.py``)."""

from perfbench.spans import median_of


def read(ctx):
    return median_of(ctx, "wrapper_us")
