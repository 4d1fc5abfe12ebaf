"""b1_roofline.* (kernels): the least time B1's launches in the sub-window
need (per layer and decode step, max(operations / bf16 peak, bytes / HBM
bandwidth) of its real rows, a shared page's bytes once) over their
device time, split and merge kernels both, in percent."""
from portbench.roofline import formulas as F


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.time_of("paged_decode")
    if t <= 0:
        return None
    p = ctx.peaks
    need = sum(F.least_time(*F.b1_step(ctx.shape, s.decode_ctx,
                                       s.decode_kv),
                            p["bf16_flops"], p["hbm_bytes_per_s"])
               for s in ctx.rec.steps if s.decode_ctx)
    return 100.0 * ctx.shape.num_layers * need / t
