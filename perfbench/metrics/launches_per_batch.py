"""The program's kernel launches over the window (the entry's
``launch.*`` counters: for ``area_average_interpolate`` the ``LAUNCHES``
of ``ops/cuda_apply``, ``cuda_apply_2d``, ``cuda_shear``,
``cuda_shear3``) divided by the batches."""


def read(ctx):
    if not ctx.batches or ctx.device == "cpu":
        return None
    n = sum(v for k, v in ctx.launches.items() if k.startswith("launch."))
    return n / ctx.batches
