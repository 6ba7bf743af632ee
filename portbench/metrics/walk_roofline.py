"""Share of the memory roofline of the walk kernels: the bytes the
dynamics nodes need (each input read once, each output written once, in
float32, counted from the shapes by ``reference/``) over the peak rate,
against the walk kernels' device time a call."""

from portbench.metrics._layer import layer_ms


def read(name, ctx):
    ms = layer_ms(ctx, "walk")
    rate = ctx.peaks.get("bytes_per_s")
    if not ms or not rate or not ctx.walk_bytes:
        return None
    return 100.0 * (ctx.walk_bytes / rate) / (ms / 1e3)
