"""Biquad-cascade IIR filter core.

The port of :class:`grafx_tpu.processors.core.iir.IIRFilter` with its
three backends:

* ``"fsm"`` (the default, as in the reference) — the frequency-sampling
  FIR approximation (:func:`grafx_tpu_torch.ops.iir.iir_fsm_fir`) and a
  causal FFT convolution;
* ``"exact"`` (aliases ``"ssm"``, ``"lfilter"``) — the exact blocked
  state-space filter (:func:`grafx_tpu_torch.ops.iir.biquad_exact`);
* ``"scan"`` — the sequential loop over time, the test oracle.

The fsm and exact filters stream block by block with their state carried
across blocks (``stream_zero_state`` / ``stream``): the FIR convolution's
overlap-add tail, the blocked filter's eigenbasis state.
"""

from torch import nn

from grafx_tpu_torch.ops.fftconv import conv_stream_zero_tail, fft_convolve, fft_convolve_stream
from grafx_tpu_torch.ops.iir import (
    biquad_exact,
    biquad_exact_apply,
    biquad_exact_build,
    biquad_exact_zero_state,
    biquad_scan,
    iir_fsm_fir,
)

EXACT_BACKENDS = ("exact", "ssm", "lfilter")


class IIRFilter(nn.Module):
    """A serial stack of biquads applied by the selected backend.

    Args:
        order: filter order per section (only 2 is supported).
        backend: ``"fsm"``, ``"exact"`` (aliases ``"ssm"``, ``"lfilter"``)
            or ``"scan"``.
        fsm_fir_len: FIR length (and DTFT sample count) of the fsm backend.
        exact_block_size: block length of the exact blocked filter.

    The reference's ``flashfftconv``, ``fsm_max_input_len`` and
    ``fsm_regularization`` arguments are accepted and ignored, as
    ``grafx_tpu`` does.
    """

    def __init__(
        self,
        order=2,
        backend="fsm",
        fsm_fir_len=4000,
        exact_block_size=128,
        flashfftconv=False,
        fsm_max_input_len=2**17,
        fsm_regularization=False,
        **_ignored,
    ):
        super().__init__()
        if order != 2:
            raise ValueError("Only second-order sections are supported.")
        if backend not in ("fsm", "scan") + EXACT_BACKENDS:
            raise ValueError(f"Unsupported backend: {backend}")
        self.backend = backend
        self.fsm_fir_len = fsm_fir_len
        self.exact_block_size = exact_block_size

    def precompute(self, Bs, As):
        """Build the parameter-dependent work once (``precompute`` hook): a
        dict of tensors with leading dims ``(B, C_f)``, which the render
        executor slices per stage like parameter rows.  The fsm backend's
        is its FIR bank, the exact backend's the blocked kernels; the scan
        oracle passes the coefficients through."""
        if self.backend == "fsm":
            return {"firs": iir_fsm_fir(Bs, As, self.fsm_fir_len)}
        if self.backend == "scan":
            return {"Bs": Bs, "As": As}
        B, C_f, K, _ = Bs.shape
        cache = biquad_exact_build(
            Bs.reshape(-1, K, 3), As.reshape(-1, K, 3),
            block_size=self.exact_block_size,
        )
        return {k: v.reshape((B, C_f) + v.shape[1:]) for k, v in cache.items()}

    def forward(self, input_signals, Bs=None, As=None, cache=None):
        """Apply the cascade to ``(B, C_in, L)`` signals, from
        ``(B, C_filter, K, 3)`` coefficients or a :meth:`precompute`
        cache; the channel dims broadcast."""
        B, C_in, L = input_signals.shape
        if cache is not None and "Bs" in cache:  # the scan oracle's pass-through
            Bs, As, cache = cache["Bs"], cache["As"], None
        if self.backend == "fsm":
            firs = cache["firs"] if cache is not None else iir_fsm_fir(Bs, As, self.fsm_fir_len)
            return fft_convolve(input_signals, firs, mode="causal", pad_mode="pow2")
        if cache is not None:
            C = max(C_in, next(iter(cache.values())).shape[1])
            x = input_signals.expand(B, C, L).reshape(-1, L)
            y = biquad_exact_apply(
                x, self._broadcast_cache(cache, B, C), block_size=self.exact_block_size
            )
            return y.reshape(B, C, L)
        C = max(C_in, Bs.shape[1])
        K = Bs.shape[-2]
        x = input_signals.expand(B, C, L).reshape(-1, L)
        Bs_b = Bs.expand(B, C, K, 3).reshape(-1, K, 3)
        As_b = As.expand(B, C, K, 3).reshape(-1, K, 3)
        if self.backend == "scan":
            y = biquad_scan(x, Bs_b, As_b)
        else:
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
        """Initial streaming state for :meth:`stream` from a
        :meth:`precompute` cache and the input channel count: the FIR
        convolution's overlap-add tail (fsm) or the blocked filter's
        eigenbasis state (exact; ``block_len`` must then be a multiple of
        ``exact_block_size``, checked here, once per stream), zeros."""
        if self.backend == "fsm":
            B, C_f, fir_len = cache["firs"].shape
            firs = cache["firs"]
            return conv_stream_zero_tail(
                (B, max(num_channels, C_f)), fir_len, firs.dtype, firs.device
            )
        if self.backend not in EXACT_BACKENDS:
            raise NotImplementedError(
                f"streaming is not supported for backend {self.backend!r}"
            )
        if block_len % self.exact_block_size:
            raise ValueError(
                f"streaming block_len ({block_len}) must be a multiple of"
                f" exact_block_size ({self.exact_block_size})."
            )
        B, C_f = next(iter(cache.values())).shape[:2]
        C = max(num_channels, C_f)
        flat = {k: v.reshape((-1,) + v.shape[2:]) for k, v in cache.items()}
        return biquad_exact_zero_state(flat, B * C)

    def stream(self, input_signals, state, cache):
        """One streaming block: ``(B, C_in, block) -> (B, C, block)`` and
        the carried state.  Streamed blocks reproduce the one-shot
        :meth:`forward` to float round-off."""
        if self.backend == "fsm":
            return fft_convolve_stream(input_signals, cache["firs"], state)
        B, C_in, L = input_signals.shape
        C = max(C_in, next(iter(cache.values())).shape[1])
        x = input_signals.expand(B, C, L).reshape(-1, L)
        y, state = biquad_exact_apply(
            x, self._broadcast_cache(cache, B, C), block_size=self.exact_block_size,
            state_in=state, return_state=True,
        )
        return y.reshape(B, C, L), state
