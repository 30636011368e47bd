"""Device operations (kernels, copies, sets) a traced step."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None:
        return None
    return len(tr.ops) / ctx["units"]
