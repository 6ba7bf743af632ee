"""Device ms a call of cuBLAS's matrix-product kernels."""

from portbench.metrics._layer import layer_ms


def read(name, ctx):
    return layer_ms(ctx, "gemm")
