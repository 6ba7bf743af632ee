"""Percent of the card's float32 peak: the plain algorithm's operations a
call (counted by ``reference/``; a step's backward as twice its forward)
over the peak rate times the seconds a call of the untraced window."""


def read(name, ctx):
    peak = ctx.peaks.get("float32_flops_per_s")
    if not peak or not ctx.flops:
        return None
    return 100.0 * ctx.flops / (peak * ctx.seconds_per_call)
