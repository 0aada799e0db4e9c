"""Host seconds of the program's disk plan cache: its ``BUILDS`` seconds
of ``build.plan_save`` and ``build.plan_load`` (``cuda_shear.
kernel_plan_cached``: each look in the cache and each save), read when
the run ends; 0 where the route keeps no plan on disk (program counter,
``perfbench/spans.py``)."""

from perfbench.spans import builds


def read(ctx):
    return builds(ctx, disk=True)
