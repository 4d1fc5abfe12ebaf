"""step_wall_ms.* (engine): host-clock time inside ``Engine.step`` over the
window, per step."""


def read(ctx):
    w = ctx.rec.step_walls
    return 1e3 * sum(w) / len(w) if w else None
