"""Host seconds of the geometry: ``api.build_operator`` (the host
weight-gen, where the operator is prebuilt) and the first synchronised
call in set-up (the shear and stage plans, built anew in every run, the
band plans and table uploads), less a second synchronised call on the
same batch, which stands for the call's enqueue and device time (host
clock)."""


def read(ctx):
    return ctx.setup.get("geometry_s")
