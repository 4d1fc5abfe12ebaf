"""output_tokens_per_s: every output token the window produced, over the
window's length."""


def read(ctx):
    rec = ctx.rec
    return sum(len(st.token_times) for st in rec.reqs.values()) \
        / rec.window_s
