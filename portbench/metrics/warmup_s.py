"""Seconds of the harness's span around the first calls of the entry
point: its warm-up, the graph's capture and instantiation."""


def read(ctx):
    return ctx["spans"].seconds("warmup")
