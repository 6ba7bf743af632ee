"""Block-wise streaming renderer: the render plan run one audio block at
a time, with every stateful processor carrying its state across blocks
(the port of :mod:`grafx_tpu.render.streaming`).

* exact-IIR filters carry the blocked cascade's eigenbasis state,
* ballistics and one-pole smoothers carry the last envelope sample,
* FIR convolutions (reverbs) carry an overlap-add tail or a partitioned
  frequency-domain delay line,

so the streamed output equals the one-shot :func:`render_grafx` output to
float round-off.

Processor contract (besides ``forward``):

* ``stream_init(num_channels, block_len, **params) -> (state, cache)``
  builds the carried state and a cache (IRs, filter kernels) from the
  stage's parameter rows, once;
* ``stream_step(*x_blocks, state, cache) -> (y_block, new_state)``, one
  positional signal per inlet.

Processors without these methods are memoryless (gains, stereo tools,
distortions without DC removal) and are called on each block.  Streaming
is inference only: the renderer builds and steps under
``torch.no_grad()``, and collects no aux losses.

On the card a block step replays a captured CUDA graph, and
``step_many`` one graph of its k block steps, the counterparts of
``grafx_tpu``'s jitted step and its ``lax.scan``
(:mod:`~grafx_tpu_torch.render.compiled`).

Typical use::

    streamer = StreamRenderer(processors, render_data, params, block_len=4096)
    state = streamer.init_state()
    for block in blocks:                      # (num_sources, C, block_len)
        y, state = streamer(block, state)     # one CUDA-graph replay
"""

import inspect

import torch

from grafx_tpu_torch import random
from grafx_tpu_torch.data.configs import UTILITY_TYPES
from grafx_tpu_torch.render.compiled import CapturedFunction
from grafx_tpu_torch.render.core import aggregate_tensor, read_tensor_or_tensor_dict
from grafx_tpu_torch.render.graph import _access_rows, _read_rows_from_stages, _row_sources


class StreamRenderer:
    """Stream a prepared render plan block by block.

    Args:
        processors: node type -> processor (as for :func:`render_grafx`).
        render_data: the static plan from :func:`prepare_render`.
        parameters: per-type parameters (dim 0 = node batch), frozen for
            the life of the stream; build a new renderer to change them.
        block_len: audio samples per block.  Must be a multiple of every
            exact-IIR filter's ``exact_block_size`` (checked here).
        num_channels: audio channels (2 for stereo graphs).
        rng: an optional key (:mod:`grafx_tpu_torch.random`) for
            stochastic processors: stage ``i`` whose ``stream_init`` takes
            a ``noise_key`` gets ``fold_in(rng, i)``, as the one-shot
            render hands it, so its noise is drawn once, at init.
        common_parameters: optional ``common_parameters`` (as for
            :func:`render_grafx`), frozen like ``parameters``; a tensor in
            place of a dict is a ``DryWet``'s ``drywet_weight``.
        jit: on the card, replay a CUDA graph of the block step captured
            per block and state shapes (the first call of a shape runs
            eagerly, the second captures), and of ``step_many``'s k steps
            per k; every call returns fresh tensors, and the renderer's
            caches are baked into the graphs.  ``False`` steps eagerly (the
            kernels' launch counters then count every block).  The CPU
            runs eagerly either way.
    """

    def __init__(
        self,
        processors,
        render_data,
        parameters,
        block_len=4096,
        num_channels=2,
        rng=None,
        common_parameters=None,
        jit=True,
    ):
        if render_data.method == "one-by-one":
            raise ValueError("streaming requires a scheduled plan (beam/greedy/fixed).")
        self.processors = processors
        self.render_data = render_data
        self.block_len = block_len
        self.num_channels = num_channels
        self._row_src = _row_sources(render_data)
        self._step_fn, self._step_many_fn = self._step, self._step_many
        if jit:
            self._step_fn = CapturedFunction(self._step, name="StreamRenderer.__call__")
            self._step_many_fn = CapturedFunction(self._step_many, name="StreamRenderer.step_many")

        # per-stage states and caches, built once
        self._caches = {}
        self._init_states = {}
        with torch.no_grad():
            for i in range(1, render_data.max_order + 1):
                stage = render_data.iter_list[i]
                node_type = stage.node_type
                if node_type not in processors:
                    continue
                proc = processors[node_type]
                if getattr(proc, "remove_dc", False):
                    raise ValueError(
                        f"processor {node_type!r} uses remove_dc=True (a"
                        " full-signal mean); streamed blocks would differ"
                        " from the one-shot render."
                    )
                params_i = read_tensor_or_tensor_dict(
                    parameters.get(node_type, {}), stage.parameter_read, dim=0
                )
                if common_parameters is not None:
                    common_i = read_tensor_or_tensor_dict(
                        common_parameters, stage.dest_write, dim=0
                    )
                    if not isinstance(common_i, dict):
                        common_i = {"drywet_weight": common_i}
                    params_i = {**params_i, **common_i}
                if not hasattr(proc, "stream_init"):
                    self._caches[i] = ("call", params_i)  # memoryless
                    continue
                if len(stage.source_reads) > 1:
                    # a multi-inlet (MIMO) stateful stage streams when its
                    # stream_step takes one positional signal per inlet
                    n_pos = sum(
                        p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                                   inspect.Parameter.POSITIONAL_OR_KEYWORD)
                        for p in inspect.signature(proc.stream_step).parameters.values()
                    )
                    if n_pos != len(stage.source_reads) + 2:
                        raise NotImplementedError(
                            f"stage {i} ({node_type!r}) has"
                            f" {len(stage.source_reads)} inlets but its"
                            f" stream_step takes {n_pos} positional args;"
                            " a multi-inlet stateful processor must"
                            " accept (sig_1, ..., sig_k, state, cache)."
                        )
                if rng is not None and "noise_key" in inspect.signature(
                    proc.stream_init
                ).parameters:
                    params_i = {**params_i, "noise_key": random.fold_in(rng, i)}
                state, cache = proc.stream_init(num_channels, block_len, **params_i)
                self._init_states[i] = state
                self._caches[i] = ("stream", cache)

    def init_state(self):
        """Fresh carried state for a new stream."""
        return dict(self._init_states)

    def _step(self, x_block, stream_state, caches=None):
        """One block; ``caches`` in place of the renderer's own (the
        serving export passes them as the program's arguments)."""
        caches = self._caches if caches is None else caches
        rd = self.render_data
        stage_outputs = [x_block]
        new_state = {}
        output = None
        for i in range(1, rd.max_order + 1):
            stage = rd.iter_list[i]
            stage_inputs = [
                aggregate_tensor(
                    _read_rows_from_stages(stage_outputs, _access_rows(read), self._row_src, 0),
                    aggregate,
                    dim=0,
                )
                for read, aggregate in zip(stage.source_reads, stage.aggregations)
            ]
            node_type = stage.node_type
            if node_type in self.processors:
                kind, cache = caches[i]
                proc = self.processors[node_type]
                if kind == "stream":
                    output, new_state[i] = proc.stream_step(*stage_inputs, stream_state[i], cache)
                else:
                    output = proc(*stage_inputs, **cache)
                    if isinstance(output, tuple):  # drop aux while streaming
                        output = output[0]
            elif node_type in UTILITY_TYPES:
                output = stage_inputs
            else:
                raise ValueError(f"Wrong node type given: {node_type}")

            if isinstance(output, list):
                if len(output) == 1:
                    output = output[0]
                else:
                    stacked = torch.stack(output, dim=-3)
                    output = stacked.reshape((-1,) + stacked.shape[-2:])
            stage_outputs.append(output)
        return output, new_state

    def _step_many(self, x_blocks, stream_state, caches=None):
        ys = []
        for x in x_blocks:
            y, stream_state = self._step(x, stream_state, caches)
            ys.append(y)
        return torch.stack(ys), stream_state

    @torch.no_grad()
    def __call__(self, x_block, stream_state):
        """Process one block ``(num_sources, C, block_len)``; returns
        ``(y_block, new_stream_state)``."""
        if x_block.shape[-1] != self.block_len:
            raise ValueError(
                f"block length {x_block.shape[-1]} != configured {self.block_len}"
            )
        return self._step_fn(x_block, stream_state)

    @torch.no_grad()
    def step_many(self, x_blocks, stream_state):
        """Process ``k`` consecutive blocks ``(k, num_sources, C,
        block_len)``: the single-block step over the leading axis, the
        same math as ``k`` calls, in one CUDA-graph replay on the card.
        Returns ``(y_blocks, new_stream_state)`` with ``y_blocks`` stacked
        on the leading axis."""
        if x_blocks.dim() < 2 or x_blocks.shape[-1] != self.block_len:
            raise ValueError(
                f"x_blocks must be (k, ..., {self.block_len}); got {tuple(x_blocks.shape)}"
            )
        return self._step_many_fn(x_blocks, stream_state)
