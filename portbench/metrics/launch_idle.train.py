"""The card's idle share of the traced window while the host launches a
training step: in `step.launch` (`zero_grad`, `apply_params`, the seed
word and tables in `step.prepare`, the graph's copy-in and replay, the
leaves' `.grad`). A part of `idle_share.train`
(`span_idle.idle_share_in`); None where the program has no such span."""

from portbench import span_idle

SPANS = ("step.launch",)


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return span_idle.idle_share_in(tr, SPANS)
