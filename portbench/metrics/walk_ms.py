"""Device ms a call of the port's own dynamics (walk) kernels."""

from portbench.metrics._layer import layer_ms


def read(name, ctx):
    return layer_ms(ctx, "walk")
