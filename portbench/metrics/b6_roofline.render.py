"""B6's share of its roofline in the traced frames (`rooflines.py`)."""

from portbench import rooflines


def read(ctx):
    return rooflines.share(ctx, "b6")
