"""Percent of the traced window of whole calls in which no operation ran
on the device: 1 - union of the device operations' intervals / window."""


def read(name, ctx):
    if not ctx.device or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
