"""The card's idle share of the traced window while the host runs the
optimizer's eager update: in `step.optimizer` (`opt.step()`). A part of
`idle_share.train` (`span_idle.idle_share_in`); None where the program
has no such span."""

from portbench import span_idle

SPANS = ("step.optimizer",)


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return span_idle.idle_share_in(tr, SPANS)
