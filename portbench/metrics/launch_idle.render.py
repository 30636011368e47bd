"""The card's idle share of the traced window while the host launches a
frame's chunk: in `render.launch` (the pixel ids, the frame's tables and
carry in `render.prepare`, the graph's copy-in and the enqueue of its
sample replays). A part of `idle_share.render`
(`span_idle.idle_share_in`); None where the program has no such span."""

from portbench import span_idle

SPANS = ("render.launch",)


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return span_idle.idle_share_in(tr, SPANS)
