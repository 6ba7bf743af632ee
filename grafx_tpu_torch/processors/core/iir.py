"""Biquad-cascade IIR filter core, exact backend.

The port of :class:`grafx_tpu.processors.core.iir.IIRFilter` with its
exact blocked state-space backend (:func:`grafx_tpu_torch.ops.iir.
biquad_exact`; backend aliases ``"ssm"`` and ``"lfilter"`` as in the
reference).  The ``"fsm"`` approximation and the ``"scan"`` oracle are
not ported yet.
"""

from torch import nn

from grafx_tpu_torch.ops.iir import biquad_exact, biquad_exact_apply, biquad_exact_build

EXACT_BACKENDS = ("exact", "ssm", "lfilter")


class IIRFilter(nn.Module):
    """A serial stack of biquads applied by the exact blocked filter.

    Args:
        order: filter order per section (only 2 is supported).
        backend: ``"exact"`` (aliases ``"ssm"``, ``"lfilter"``).  The
            default is ``grafx_tpu``'s, ``"fsm"``, which is not ported
            yet and raises.
        exact_block_size: block length of the exact blocked filter.
    """

    def __init__(self, order=2, backend="fsm", exact_block_size=128):
        super().__init__()
        if order != 2:
            raise ValueError("Only second-order sections are supported.")
        if backend not in EXACT_BACKENDS:
            raise NotImplementedError(
                f"IIR backend {backend!r} is not ported yet; use 'exact'."
            )
        self.backend = backend
        self.exact_block_size = exact_block_size

    def precompute(self, Bs, As):
        """Build the parameter-dependent kernels once (``precompute``
        hook): a dict of tensors with leading dims ``(B, C_f)``, which
        the render executor slices per stage like parameter rows."""
        B, C_f, K, _ = Bs.shape
        cache = biquad_exact_build(
            Bs.reshape(-1, K, 3), As.reshape(-1, K, 3),
            block_size=self.exact_block_size,
        )
        return {k: v.reshape((B, C_f) + v.shape[1:]) for k, v in cache.items()}

    def forward(self, input_signal, Bs=None, As=None, cache=None):
        """Apply the cascade to ``(B, C_in, L)`` signals, from
        ``(B, C_filter, K, 3)`` coefficients or a :meth:`precompute`
        cache; the channel dims broadcast."""
        B, C_in, L = input_signal.shape
        if cache is not None:
            C_f = next(iter(cache.values())).shape[1]
            C = max(C_in, C_f)
            x = input_signal.expand(B, C, L).reshape(-1, L)
            cache_b = {
                k: v.expand((B, C) + v.shape[2:]).reshape((-1,) + v.shape[2:])
                for k, v in cache.items()
            }
            y = biquad_exact_apply(x, cache_b, block_size=self.exact_block_size)
            return y.reshape(B, C, L)
        C = max(C_in, Bs.shape[1])
        K = Bs.shape[-2]
        x = input_signal.expand(B, C, L).reshape(-1, L)
        Bs_b = Bs.expand(B, C, K, 3).reshape(-1, K, 3)
        As_b = As.expand(B, C, K, 3).reshape(-1, K, 3)
        y = biquad_exact(x, Bs_b, As_b, block_size=self.exact_block_size)
        return y.reshape(B, C, L)
