"""The card's idle share of the traced window while the host finishes a
frame: in `render.copy_out` (the sum's copy to the host, with its wait
for the last samples) or `render.to_image` (the mean, gamma and clamp on
the host). A part of `idle_share.render` (`span_idle.idle_share_in`);
None where the program has no such spans."""

from portbench import span_idle

SPANS = ("render.copy_out", "render.to_image")


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return span_idle.idle_share_in(tr, SPANS)
