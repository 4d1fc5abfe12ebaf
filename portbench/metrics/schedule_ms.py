"""schedule_ms.* (scheduler): host ms a step inside the program's
``engine.schedule`` span (``Scheduler.get_next_batch``: admission, the
preemption choice, the cost model), over the ``engine.step`` spans of
the traced sub-window."""
from portbench import program_spans as P


def read(ctx):
    if ctx.trace is None:
        return None
    return P.per_step_ms(ctx.trace, P.PREFIX + "schedule")
