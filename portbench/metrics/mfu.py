"""mfu.* (model step): operations the sub-window's useful tokens need
(``roofline.formulas.step_ops``: prompt positions not served from cache
and not recomputed, generated tokens; an MoE token meets its routed
experts and the shared expert only) over the traced sub-window's length
times the card's bf16 peak, in percent."""
from portbench.roofline import formulas as F


def read(ctx):
    if ctx.trace is None or not ctx.rec.steps:
        return None
    ops = sum(F.step_ops(ctx.shape, s.decode_ctx, s.rounds)
              for s in ctx.rec.steps)
    return 100.0 * ops / (ctx.trace.window_s * ctx.peaks["bf16_flops"])
