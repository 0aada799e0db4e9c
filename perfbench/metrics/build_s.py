"""Host seconds of the program's cold paths: its ``BUILDS`` (each
``build.*`` span's count and seconds, kept with or without a profiler)
summed over every span but the disk plan cache's (``build.operator``,
``band_plan``, ``shear_plan``, ``shear3_plan``, ``tiles``, ``upload``
and ``digest``, the first hash of each table), read when the run ends.
The check's reference runs none of the program, and a window that
rebuilds nothing (``rebuilds_per_batch`` 0) adds none, so this is the
set-up's (program counter, ``perfbench/spans.py``)."""

from perfbench.spans import builds


def read(ctx):
    return builds(ctx, disk=False)
