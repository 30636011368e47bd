"""Seconds of the harness's span around the port's `compile_scene`."""


def read(ctx):
    return ctx["spans"].seconds("scene_build")
