"""Host seconds of the calls before the window: the first (eager, on a
side stream) and the second (capturing) call, and one replay."""


def read(name, ctx):
    return ctx.spans.get("capture_s")
