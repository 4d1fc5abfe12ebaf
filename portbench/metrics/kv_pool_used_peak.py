"""kv_pool_used_peak (KV manager): the most pages live in the KV pool after
any step of the window (the sequences' block tables and the prefix
registry's pages, each physical page once) over the pages the pool holds,
in percent: how much of the memory the cell reserves for KV its traffic
uses."""


def read(ctx):
    rec = ctx.rec
    return 100.0 * rec.pool_peak_pages / rec.pool_pages \
        if rec.pool_pages else None
