"""Device operations (kernels, copies, fills) a call, from the trace."""


def read(name, ctx):
    return len(ctx.device) / ctx.calls if ctx.device else None
