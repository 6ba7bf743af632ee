"""Device milliseconds a call of one layer's kernels (``kernels/*.json``)."""

from portbench.trace import matching


def layer_ms(ctx, layer):
    if layer not in ctx.layers:
        return None
    events = matching(ctx.device, ctx.layers[layer])
    if not events:
        return None
    return sum(dur for _, _, dur in events) / 1e3 / ctx.calls
