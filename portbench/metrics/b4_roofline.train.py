"""B4's share of its roofline in the traced steps (`rooflines.py`)."""

from portbench import rooflines


def read(ctx):
    return rooflines.share(ctx, "b4")
