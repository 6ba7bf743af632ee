"""The render executor: run a static render plan.

The port of :mod:`grafx_tpu.render.graph`, with its three buffer modes:

* ``"stages"``: every stage's output stays its own tensor and reads
  resolve into them as slices (after ``reorder_for_fast_render`` most
  reads are one view, no copy).  Under ``jax.jit`` the assembled signal
  buffer is free when unused; eager torch would really build it (about
  400 MB per request on the ``bench.py`` console), so it is assembled
  only on request;
* ``"array"``: one ``(.., num_buffers, C, L)`` buffer, written out of
  place stage by stage as ``grafx_tpu``'s functional buffer is;
* a ``"one-by-one"`` plan renders into a list of per-node tensors,
  whatever mode is asked for, so a node may change its signal's length.

:func:`make_render_fn` compiles the render, as ``grafx_tpu``'s does: on
the card it replays a CUDA graph (:mod:`.compiled`); a one-by-one plan
runs eagerly, as ``grafx_tpu`` skips ``jax.jit`` for it.
"""

import torch

from grafx_tpu_torch import random
from grafx_tpu_torch.data.configs import UTILITY_TYPES
from grafx_tpu_torch.processors.core.utils import accepts_noise_key
from grafx_tpu_torch.render.compiled import CapturedFunction
from grafx_tpu_torch.render.core import (
    _access_rows,
    aggregate_tensor,
    create_signal_buffer,
    expand_tensor_or_tensor_dict,
    flatten_batch_and_node,
    read_tensor_or_tensor_dict,
    write_tensor,
)


def _row_sources(render_data):
    """Static map buffer_row -> (stage index, row within that stage's
    output).  Every buffer row is written exactly once by a known stage,
    so reads resolve directly into per-stage outputs."""
    row_src = {}
    for j, stage in enumerate(render_data.iter_list):
        dw = stage.dest_write
        if dw.method == "none":
            continue
        rows = range(dw.idx[0], dw.idx[1]) if dw.method == "slice" else dw.idx
        for p, r in enumerate(rows):
            if r in row_src:
                raise ValueError(
                    f"Render plan writes buffer row {r} twice (stages"
                    f" {row_src[r][0]} and {j}); 'stages' buffer mode"
                    " requires single-assignment rows — use"
                    " buffer_mode='array' for plans that reuse rows."
                )
            row_src[r] = (j, p)
    return row_src


def _read_rows_from_stages(stage_outputs, rows, row_src, dim,
                           channel_broadcast=False):
    """Gather buffer rows as slices of per-stage outputs; consecutive rows
    from the same stage coalesce into one slice.  ``channel_broadcast``
    broadcasts each part's channel dim to the common maximum (signal
    buffer assembly for MIMO graphs that mix mono and stereo rows)."""
    runs = []  # (stage, lo, hi)
    for r in rows:
        try:
            j, p = row_src[r]
        except KeyError:
            raise ValueError(
                f"Render plan reads buffer row {r} which no stage writes"
                " (malformed plan: an edge references a node output that"
                " is never produced)."
            ) from None
        if runs and runs[-1][0] == j and runs[-1][2] == p:
            runs[-1][2] = p + 1
        else:
            runs.append([j, p, p + 1])
    parts = [stage_outputs[j].narrow(dim, lo, hi - lo) for j, lo, hi in runs]
    if len(parts) == 1:
        return parts[0]
    if channel_broadcast:
        c_max = max(p.shape[-2] for p in parts)
        parts = [p.expand(p.shape[:-2] + (c_max, p.shape[-1])) for p in parts]
    return torch.cat(parts, dim=dim)


def render_grafx(
    processors,
    input_signals,
    per_type_parameters,
    render_data,
    common_parameters=None,
    parameters_grad=True,
    input_signal_grad=False,
    buffer_mode="auto",
    rng=None,
    return_buffer=False,
):
    """Render an audio graph.

    Args:
        processors: dict mapping node-type name to a processor callable
            ``f(*signals, **params) -> signals [, intermediates]``.
        input_signals: ``(|V_0|, C, L)`` or ``(B, |V_0|, C, L)`` tensor.
        per_type_parameters: nested dict, type -> name -> tensor whose
            dim 0 is the node batch, on the device of ``input_signals``.
        render_data: the static :class:`RenderData` plan.
        common_parameters: an optional dict of tensors whose dim 0 is the
            graph's ``|V|`` nodes, shared by every node type: each stage
            reads its nodes' rows (``stage.dest_write``) as keyword
            arguments (e.g. ``DryWet``'s external ``drywet_weight``).
        rng: an optional key (:mod:`grafx_tpu_torch.random`) on the
            device of ``input_signals``.  Stage ``i`` whose processor takes
            a ``noise_key`` gets ``fold_in(rng, i)``, as in ``grafx_tpu``:
            the same key renders the same noise, a new key new noise.
            Without it such processors draw their own default noise.
        parameters_grad, input_signal_grad: accepted and ignored, as in
            ``grafx_tpu`` (autograd follows ``requires_grad``).
        buffer_mode: ``"stages"``, ``"array"`` or ``"auto"`` (``"array"``
            for a one-by-one plan, else ``"stages"``); a one-by-one plan
            always renders into its list of rows (module docstring).
            Outputs are the same in every mode.
        return_buffer: in ``"stages"`` mode, also assemble the ``(..,
            num_buffers, C, L)`` signal buffer (a full copy of every
            node's output); the other modes return theirs always.

    Returns:
        ``(output_signals, intermediates_list, signal_buffer)``;
        ``signal_buffer`` is ``None`` in ``"stages"`` mode unless
        ``return_buffer``, and a list for a one-by-one plan.
    """
    if buffer_mode not in ("auto", "stages", "array"):
        raise ValueError(f"Unknown buffer_mode: {buffer_mode}")
    method = render_data.method
    if buffer_mode == "auto":
        buffer_mode = "array" if method == "one-by-one" else "stages"
    use_stages = buffer_mode == "stages" and method != "one-by-one"
    ndim = input_signals.dim()
    rng_types = (
        {t for t, p in processors.items() if accepts_noise_key(p)} if rng is not None else set()
    )

    # Per-type precompute (docs/processors.md): a processor exposing
    # ``precompute(**params)`` builds its parameter-dependent kernels
    # once for all nodes of the type; each stage slices the cache like
    # parameter rows and receives it via ``_cache=``.
    precomputed = {}
    for _type, _proc in processors.items():
        if hasattr(_proc, "precompute") and _type in per_type_parameters:
            cache = _proc.precompute(**per_type_parameters[_type])
            if cache is not None:
                precomputed[_type] = cache

    if ndim == 3:
        node_dim = 0
        postprocess = None
    elif ndim == 4:
        batch_size, _, channels, audio_len = input_signals.shape
        node_dim = 1
        postprocess = flatten_batch_and_node
        per_type_parameters = expand_tensor_or_tensor_dict(
            per_type_parameters, expand=batch_size, dim=0
        )
        precomputed = {
            k: expand_tensor_or_tensor_dict(v, expand=batch_size, dim=0)
            for k, v in precomputed.items()
        }
        if common_parameters is not None:
            common_parameters = expand_tensor_or_tensor_dict(
                common_parameters, expand=batch_size, dim=0
            )
    else:
        raise ValueError(f"input_signals has {ndim} dims; expected 3 or 4.")

    num_sources = render_data.iter_list[0].dest_write.num_rows
    if input_signals.shape[node_dim] != num_sources:
        raise ValueError(
            f"Expected {num_sources} input signals (the graph's 'in' nodes),"
            f" got {input_signals.shape[node_dim]}."
        )

    if use_stages:
        row_src = _row_sources(render_data)
        stage_outputs = [input_signals]
        signal_buffer = None
    else:
        signal_buffer = create_signal_buffer(method, render_data.num_buffers, input_signals)
    intermediates_list = []
    output_signals = None

    for i in range(1, render_data.max_order + 1):
        stage = render_data.iter_list[i]

        stage_inputs = []
        for read, aggregate in zip(stage.source_reads, stage.aggregations):
            if use_stages:
                sig = _read_rows_from_stages(
                    stage_outputs, _access_rows(read), row_src, node_dim
                )
            else:
                sig = read_tensor_or_tensor_dict(signal_buffer, read, dim=node_dim)
            sig = aggregate_tensor(sig, aggregate, dim=node_dim)
            if ndim == 4:
                sig = flatten_batch_and_node(sig)
            stage_inputs.append(sig)

        node_type = stage.node_type
        if node_type in processors:
            parameters = read_tensor_or_tensor_dict(
                per_type_parameters.get(node_type, {}),
                stage.parameter_read,
                dim=node_dim,
                postprocess=postprocess,
            )
            common_i = {}
            if common_parameters is not None:
                common_i = read_tensor_or_tensor_dict(
                    common_parameters, stage.dest_write, dim=node_dim, postprocess=postprocess
                )
            if node_type in rng_types:
                common_i = {**common_i, "noise_key": random.fold_in(rng, i)}
            if node_type in precomputed:
                cache_i = read_tensor_or_tensor_dict(
                    precomputed[node_type],
                    stage.parameter_read,
                    dim=node_dim,
                    postprocess=postprocess,
                )
                output = processors[node_type](
                    *stage_inputs, **parameters, **common_i, _cache=cache_i
                )
            else:
                output = processors[node_type](*stage_inputs, **parameters, **common_i)
            if isinstance(output, tuple):
                output_signals, intermediates = output
                intermediates_list.append(intermediates)
            else:
                output_signals = output
        elif node_type in UTILITY_TYPES:
            output_signals = stage_inputs
        else:
            raise ValueError(f"Wrong node type given: {node_type}")

        if isinstance(output_signals, list):
            if len(output_signals) == 1:
                output_signals = output_signals[0]
            else:
                # per-node outlets become contiguous buffer rows
                stacked = torch.stack(output_signals, dim=-3)
                output_signals = stacked.reshape((-1,) + stacked.shape[-2:])

        if ndim == 4:
            # a one-by-one node may change the signal's length
            frame = output_signals.shape[-2:] if method == "one-by-one" else (channels, audio_len)
            output_signals = output_signals.reshape((batch_size, -1, *frame))
        if use_stages:
            stage_outputs.append(output_signals)
        else:
            signal_buffer = write_tensor(
                method, signal_buffer, output_signals, stage.dest_write, dim=node_dim
            )

    if use_stages and return_buffer:
        written = [r for r in range(render_data.num_buffers) if r in row_src]
        signal_buffer = _read_rows_from_stages(
            stage_outputs, written, row_src, node_dim, channel_broadcast=True
        )
    return output_signals, intermediates_list, signal_buffer


def make_render_fn(processors, render_data, jit=True, donate_buffer=False, buffer_mode="auto"):
    """Build a render closure over static (processors, plan) with
    signature ``f(input_signals, per_type_parameters,
    common_parameters=None, rng=None, return_buffer=False)`` (the
    counterpart of :func:`grafx_tpu.render.graph.make_render_fn`).

    With ``jit`` (the default, as in ``grafx_tpu``) a call on the card
    replays a CUDA graph captured per input shapes and parameter tree
    (:class:`~grafx_tpu_torch.render.compiled.CapturedFunction`: the
    first call with a new signature runs eagerly, the second captures),
    with the parameters, the common parameters and the key passed in, and
    returns fresh tensors: a replay with a new ``rng`` draws new noise.
    It refuses parameters that need autograd (pass ``jit=False`` to
    differentiate through the render).  A one-by-one plan always runs
    eagerly, as ``grafx_tpu`` skips ``jax.jit`` for it.  On the CPU both
    run the same eager code.  ``buffer_mode`` is
    :func:`render_grafx`'s; ``donate_buffer`` is accepted and unused, as
    in ``grafx_tpu``.  Each call builds its own closure (``grafx_tpu``
    shares closures between equal plans to share their compiled XLA
    program; a capture here is made per closure).
    """

    def render_fn(input_signals, per_type_parameters, common_parameters=None, rng=None,
                  return_buffer=False):
        return render_grafx(
            processors,
            input_signals,
            per_type_parameters,
            render_data,
            common_parameters=common_parameters,
            buffer_mode=buffer_mode,
            rng=rng,
            return_buffer=return_buffer,
        )

    if jit and render_data.method != "one-by-one":
        return CapturedFunction(render_fn, name="make_render_fn(jit=True)")
    return render_fn
