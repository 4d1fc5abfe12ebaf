"""b2_roofline.* (kernels): the least time B2's launches in the sub-window
need, counting only the rows that prefill in each round (a page they
share once), over their device time, in percent."""
from portbench.roofline import formulas as F


def read(ctx):
    if ctx.trace is None:
        return None
    t = ctx.trace.time_of("paged_prefill")
    if t <= 0:
        return None
    p = ctx.peaks
    need = sum(F.least_time(*F.b2_round(ctx.shape, rnd, kv),
                            p["bf16_flops"], p["hbm_bytes_per_s"])
               for s in ctx.rec.steps for rnd, kv in zip(s.rounds,
                                                          s.round_kv))
    return 100.0 * ctx.shape.num_layers * need / t
