"""moe_share.* (model step): the device time of the grouped MoE layer's
kernels (route, layout, grouped products, combine) over the traced
sub-window's busy device time, in percent.  Nothing where the trace holds
no such kernel (a program without the grouped dispatch)."""

#: every kernel of the grouped MoE layer (``repro_torch/kernels/
#: moe_grouped``: route, layout, products, combine) has this in its name
LAYER_KERNELS = "moe_grouped_"


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.time_of(LAYER_KERNELS)
    busy = ctx.trace.busy_s()
    if t <= 0 or busy <= 0:
        return None
    return 100.0 * t / busy
