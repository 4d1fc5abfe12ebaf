"""device_idle.* (device): 1 - the union of device operation intervals
over the traced sub-window, in percent."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
