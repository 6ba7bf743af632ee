"""Biquad-cascade IIR filter core, exact backend.

The port of :class:`grafx_tpu.processors.core.iir.IIRFilter` with its
exact blocked state-space backend (:func:`grafx_tpu_torch.ops.iir.
biquad_exact`; backend aliases ``"ssm"`` and ``"lfilter"`` as in the
reference).  The ``"fsm"`` approximation and the ``"scan"`` oracle are
not ported yet.  The filter streams block by block with its state
carried across blocks (``stream_zero_state`` / ``stream``).
"""

from torch import nn

from grafx_tpu_torch.ops.iir import (
    biquad_exact,
    biquad_exact_apply,
    biquad_exact_build,
    biquad_exact_zero_state,
)

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
            C = max(C_in, next(iter(cache.values())).shape[1])
            x = input_signal.expand(B, C, L).reshape(-1, L)
            y = biquad_exact_apply(
                x, self._broadcast_cache(cache, B, C), block_size=self.exact_block_size
            )
            return y.reshape(B, C, L)
        C = max(C_in, Bs.shape[1])
        K = Bs.shape[-2]
        x = input_signal.expand(B, C, L).reshape(-1, L)
        Bs_b = Bs.expand(B, C, K, 3).reshape(-1, K, 3)
        As_b = As.expand(B, C, K, 3).reshape(-1, K, 3)
        y = biquad_exact(x, Bs_b, As_b, block_size=self.exact_block_size)
        return y.reshape(B, C, L)

    # -- streaming (block-wise processing with carried filter state) ----

    @staticmethod
    def _broadcast_cache(cache, B, C):
        return {
            k: v.expand((B, C) + v.shape[2:]).reshape((-1,) + v.shape[2:])
            for k, v in cache.items()
        }

    def stream_zero_state(self, cache, num_channels, block_len):
        """Initial streaming state for :meth:`stream`: the blocked
        filter's eigenbasis state (zeros) for a :meth:`precompute` cache
        and the input channel count.  ``block_len`` must be a multiple of
        ``exact_block_size`` (checked here, once per stream)."""
        if block_len % self.exact_block_size:
            raise ValueError(
                f"streaming block_len ({block_len}) must be a multiple of"
                f" exact_block_size ({self.exact_block_size})."
            )
        B, C_f = next(iter(cache.values())).shape[:2]
        C = max(num_channels, C_f)
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in cache.items()}
        return biquad_exact_zero_state(flat, B * C)

    def stream(self, input_signal, state, cache):
        """One streaming block: ``(B, C_in, block) -> (B, C, block)`` and
        the carried state.  Streamed blocks reproduce the one-shot
        :meth:`forward` to float round-off."""
        B, C_in, L = input_signal.shape
        C = max(C_in, next(iter(cache.values())).shape[1])
        x = input_signal.expand(B, C, L).reshape(-1, L)
        y, state = biquad_exact_apply(
            x, self._broadcast_cache(cache, B, C), block_size=self.exact_block_size,
            state_in=state, return_state=True,
        )
        return y.reshape(B, C, L), state
