"""The card's idle share of the traced window: 100 * (1 - the union of
its kernels', copies' and sets' intervals over the window's length)."""

from portbench import trace


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return 100.0 * (1.0 - trace.busy_us(tr) / (tr.end - tr.start))
