"""Processor containers: dry/wet mixing, serial chains, parallel mixes and
gain-staging regularization (the port of
:mod:`grafx_tpu.processors.container`; reference:
src/grafx/processors/container.py:10-299).

Aux losses travel as the second element of a returned tuple (the render
executor's ``intermediates`` side channel).  Each container streams
(``stream_init`` / ``stream_step``) and joins LTI fusion where its members
do (``lti_kind``, ``fir_kernel``, ``biquad_kernel``; render/fuse.py).
A container takes the render executor's ``noise_key`` and hands member
``i`` that takes one ``fold_in(noise_key, i)``, so stochastic processors
keep per-call noise at any depth of nesting, as in ``grafx_tpu``.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from grafx_tpu_torch import random
from grafx_tpu_torch.processors.core.utils import accepts_noise_key, lti_kind_of, rms_difference


def _split_output(out):
    return out if isinstance(out, tuple) else (out, None)


def _maybe_key(processor, noise_key, i=0):
    """Keyword arguments that hand member ``i`` its key,
    ``fold_in(noise_key, i)``, where it takes one (``processor`` a
    processor or its ``fir_kernel``)."""
    if noise_key is None or not accepts_noise_key(processor):
        return {}
    return {"noise_key": random.fold_in(noise_key, i)}


def _inner_stream_init(processor, num_channels, block_len, params, noise_key, i):
    """Streaming dispatch for a wrapped processor: a stateful one gets
    ``stream_init`` (with member ``i``'s key where it takes one); a
    memoryless one is called on each block (render/streaming.py)."""
    if hasattr(processor, "stream_init"):
        kwargs = {**params, **_maybe_key(processor, noise_key, i)}
        state, cache = processor.stream_init(num_channels, block_len, **kwargs)
        return state, ("stream", cache)
    return None, ("call", dict(params))


def _inner_stream_step(processor, x, state, tagged_cache):
    kind, cache = tagged_cache
    if kind == "stream":
        return processor.stream_step(x, state, cache)
    out, _ = _split_output(processor(x, **cache))
    return out, state


class DryWet(nn.Module):
    """Mix the wrapped processor's wet output with the dry input by a
    sigmoid weight (reference: container.py:10-82).

    Args:
        processor: any SISO processor.
        external_param: if ``True``, the dry/wet weight comes through
            ``common_parameters`` and is not in ``parameter_size``.
    """

    def __init__(self, processor, external_param=True):
        super().__init__()
        self.processor = processor
        self.external_param = external_param

    def forward(self, input_signals, drywet_weight, noise_key=None, **processor_kwargs):
        out, intermediates = _split_output(
            self.processor(input_signals, **processor_kwargs,
                           **_maybe_key(self.processor, noise_key))
        )
        w = torch.sigmoid(drywet_weight).reshape(-1, 1, 1)
        mixed = w * out + (1.0 - w) * input_signals
        return mixed if intermediates is None else (mixed, intermediates)

    def stream_init(self, num_channels, block_len, drywet_weight=None, noise_key=None,
                    **processor_kwargs):
        state, cache = _inner_stream_init(self.processor, num_channels, block_len,
                                          processor_kwargs, noise_key, 0)
        return state, {"inner": cache, "w": drywet_weight}

    def stream_step(self, x, state, cache):
        out, state = _inner_stream_step(self.processor, x, state, cache["inner"])
        w = torch.sigmoid(cache["w"]).reshape(-1, 1, 1)
        return w * out + (1.0 - w) * x, state

    def parameter_size(self):
        size = dict(self.processor.parameter_size())
        if not self.external_param:
            size["drywet_weight"] = (1,)
        return size

    @property
    def lti_kind(self):
        """A dry/wet mix of an FIR-LTI processor is FIR-LTI, ``h = w h_wet
        + (1-w) d_shift``, when the weight is the node's own parameter
        (``external_param=False``).  The IIR family has no parallel-sum
        form."""
        if self.external_param:
            return None
        return "fir" if lti_kind_of(self.processor) == "fir" else None

    def fir_kernel(self, drywet_weight, noise_key=None, **processor_kwargs):
        # the key itself, not a fold: grafx_tpu's DryWet.fir_kernel hands it on as is
        if noise_key is not None and accepts_noise_key(self.processor.fir_kernel):
            processor_kwargs = {**processor_kwargs, "noise_key": noise_key}
        h_wet, shift, aux = self.processor.fir_kernel(**processor_kwargs)
        w = torch.sigmoid(drywet_weight).reshape(-1, 1, 1)
        dry = F.pad(1.0 - w, (shift, h_wet.shape[-1] - shift - 1))  # (1 - w) d_shift
        return w * h_wet + dry, shift, aux


class SerialChain(nn.Module):
    """Apply processors in order, nesting their parameters by name
    (reference: container.py:85-148)."""

    def __init__(self, processors):
        super().__init__()
        self.processors = dict(processors)
        # registered so that .to(device) reaches the members' buffers
        self.member_modules = nn.ModuleList(self.processors.values())

    def forward(self, input_signals, noise_key=None, **processors_kwargs):
        out = input_signals
        intermediates = {}
        for i, (k, processor) in enumerate(self.processors.items()):
            out, inter = _split_output(
                processor(out, **processors_kwargs[k], **_maybe_key(processor, noise_key, i))
            )
            if inter is not None:
                intermediates[k] = inter
        return out, intermediates

    def stream_init(self, num_channels, block_len, noise_key=None, **kwargs):
        states, caches = {}, {}
        for i, (k, processor) in enumerate(self.processors.items()):
            states[k], caches[k] = _inner_stream_init(processor, num_channels, block_len,
                                                      kwargs[k], noise_key, i)
        return states, caches

    def stream_step(self, x, state, cache):
        out, new_state = x, {}
        for k, processor in self.processors.items():
            out, new_state[k] = _inner_stream_step(processor, out, state[k], cache[k])
        return out, new_state

    def parameter_size(self):
        return {k: v.parameter_size() for k, v in self.processors.items()}

    @property
    def lti_kind(self):
        """A chain whose members all share one LTI family is itself in
        that family (IRs convolve, cascades concatenate); mixed or non-LTI
        members make it opaque."""
        kinds = {lti_kind_of(p) for p in self.processors.values()}
        if len(kinds) == 1:
            kind = kinds.pop()
            if kind in ("fir", "iir"):
                return kind
        return None

    def fir_kernel(self, noise_key=None, **processors_kwargs):
        from grafx_tpu_torch.render.fuse import compose_fir_kernels

        return compose_fir_kernels(list(self.processors.items()), processors_kwargs, noise_key)

    def biquad_kernel(self, **processors_kwargs):
        from grafx_tpu_torch.render.fuse import compose_biquad_kernels

        return compose_biquad_kernels(list(self.processors.items()), processors_kwargs)


class ParallelMix(nn.Module):
    """Weighted sum of parallel processor outputs: DARTS-style processor
    selection (reference: container.py:151-222).

    Args:
        processors: name -> processor dict.
        activation: ``"softmax"`` (weights sum to 1) or ``"softplus"``
            (non-negative, ~1/K at zero).
    """

    def __init__(self, processors, activation="softmax"):
        super().__init__()
        if activation not in ("softmax", "softplus"):
            raise ValueError(f"Unsupported activation: {activation}")
        self.processors = dict(processors)
        # registered so that .to(device) reaches the members' buffers
        self.member_modules = nn.ModuleList(self.processors.values())
        self.activation = activation
        self.mult = 1.0 / (math.log(2) * len(self.processors))

    def _weights(self, parallel_weights):
        if self.activation == "softmax":
            return torch.softmax(parallel_weights, dim=-1)
        return F.softplus(parallel_weights) * self.mult

    def forward(self, input_signals, parallel_weights, noise_key=None, **processors_kwargs):
        weights = self._weights(parallel_weights)
        out, intermediates = 0, {}
        for i, (k, processor) in enumerate(self.processors.items()):
            y, inter = _split_output(
                processor(input_signals, **processors_kwargs[k],
                          **_maybe_key(processor, noise_key, i))
            )
            if inter is not None:
                intermediates[k] = inter
            out = out + y * weights[..., i, None, None]
        return out, intermediates

    def stream_init(self, num_channels, block_len, parallel_weights=None, noise_key=None,
                    **kwargs):
        states, caches = {}, {}
        for i, (k, processor) in enumerate(self.processors.items()):
            states[k], caches[k] = _inner_stream_init(processor, num_channels, block_len,
                                                      kwargs[k], noise_key, i)
        return states, {"inner": caches, "parallel_weights": parallel_weights}

    def stream_step(self, x, state, cache):
        weights = self._weights(cache["parallel_weights"])
        out, new_state = 0, {}
        for i, (k, processor) in enumerate(self.processors.items()):
            y, new_state[k] = _inner_stream_step(processor, x, state[k], cache["inner"][k])
            out = out + y * weights[..., i, None, None]
        return out, new_state

    def parameter_size(self):
        size = {k: v.parameter_size() for k, v in self.processors.items()}
        size["parallel_weights"] = len(self.processors)
        return size

    @property
    def lti_kind(self):
        """A weighted sum of FIR-LTI branches is FIR-LTI: the branch IRs
        shift-align and sum (a sum of cascades is not a cascade)."""
        return "fir" if all(lti_kind_of(p) == "fir" for p in self.processors.values()) else None

    def fir_kernel(self, parallel_weights, noise_key=None, **kwargs):
        weights = self._weights(parallel_weights)
        kernels, intermediates = [], {}
        for i, (k, processor) in enumerate(self.processors.items()):
            h, s, aux = processor.fir_kernel(
                **kwargs[k], **_maybe_key(processor.fir_kernel, noise_key, i)
            )
            if aux:
                intermediates[k] = aux
            kernels.append((h, s))
        # shift-align: a branch with shift s_i under the total shift S is
        # the same operator as its IR delayed by S - s_i
        shift = max(s for _, s in kernels)
        total_len = max(h.shape[-1] + shift - s for h, s in kernels)
        C = max(h.shape[-2] for h, _ in kernels)
        h_sum = 0
        for i, (h, s) in enumerate(kernels):
            h = F.pad(h, (shift - s, total_len - h.shape[-1] - shift + s))
            h = h.expand(h.shape[:-2] + (C, h.shape[-1]))
            h_sum = h_sum + h * weights[..., i, None, None]
        return h_sum, shift, intermediates or None


class GainStagingRegularization(nn.Module):
    """Wrap a processor and report |log-RMS in - log-RMS out| through the
    intermediates under ``key`` (reference: container.py:231-299)."""

    def __init__(self, processor, key="gain_reg"):
        super().__init__()
        self.processor = processor
        self.key = key

    def forward(self, input_signals, noise_key=None, **processor_kwargs):
        out, intermediates = _split_output(
            self.processor(input_signals, **processor_kwargs,
                           **_maybe_key(self.processor, noise_key))
        )
        intermediates = {} if intermediates is None else dict(intermediates)
        if self.key in intermediates:
            raise ValueError(f"the wrapped processor already reports {self.key!r}")
        intermediates[self.key] = rms_difference(input_signals, out)
        return out, intermediates

    def stream_init(self, num_channels, block_len, noise_key=None, **kwargs):
        # the gain-staging loss is training-time only: a stream passes
        # through the wrapped processor
        return _inner_stream_init(self.processor, num_channels, block_len, kwargs, noise_key, 0)

    def stream_step(self, x, state, cache):
        return _inner_stream_step(self.processor, x, state, cache)

    def parameter_size(self):
        return self.processor.parameter_size()
