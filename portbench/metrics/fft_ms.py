"""Device ms a call of cuFFT's kernels."""

from portbench.metrics._layer import layer_ms


def read(name, ctx):
    return layer_ms(ctx, "fft")
