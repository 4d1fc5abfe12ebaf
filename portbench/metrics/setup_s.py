"""setup_s: seconds from process start to the window's opening (build,
weights, pool, graph capture)."""


def read(ctx):
    return ctx.setup_s
